// Fused LayerNorm -> Linear forward for sm_90a.
//
// Replaces the TPU kernel oatx/ops/pallas/ln_linear.py `_fwd_pallas` (body
// `_kernel` :47-55) and computes what its `_fwd_xla` (:80-88) computes:
//   z = bf16(LN(x) * gamma + beta)          f32 statistics and affine
//   y = bf16(z @ W^T + b)                   f32 accumulation, f32 bias
// Bound by operations (2*R*K*N flops against R*K + N*K + R*N bf16 values).
// See oatx_torch/ops/kernels/ln_linear.py for the numbers and the design.
//
// Layouts: x (R, K) bf16 row-major; W = Linear.weight (N, K) bf16 in torch
// layout, read as a column-major WMMA B operand; gamma, beta, b f32;
// y (R, N) bf16.
//
// Block: BM = 64 rows x BN = 128 output columns, 8 warps. The warps write
// the rows' bf16 z tile into shared memory (a warp per row), then walk K in
// chunks of KC = 64: the chunk of W's BN rows arrives in shared memory by
// cp.async (two buffers: chunk c+1 loads while chunk c is multiplied) and
// each warp accumulates a 32 x 32 piece of the tile in 2 x 2 f32 WMMA
// fragments. The epilogue stages the f32 tile in the freed W buffers, adds
// the bias and stores 16-byte bf16 vectors. Rows past R are zero in the z
// tile and are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;         // rows per block
constexpr int BN = 128;        // output columns per block
constexpr int KC = 64;         // K columns per staged W chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ZPAD = 8;        // bf16 padding per z row: spreads banks, keeps 32 B fragment alignment
constexpr int WLD = KC + 8;    // bf16 row stride of a staged W chunk (144 B)
constexpr int CLD = BN + 4;    // f32 row stride of the epilogue tile
constexpr size_t W_BUF = (size_t)BN * WLD;  // bf16 elements per W buffer

static_assert((size_t)BM * CLD * 4 <= 2 * W_BUF * 2, "epilogue tile must fit the W buffers");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// W[n0 .. n0+BN, k0 .. k0+kcount) -> ws (BN rows, stride WLD); kcount % 16 == 0.
__device__ __forceinline__ void load_w_chunk(__nv_bfloat16* ws, const __nv_bfloat16* w,
                                             int n0, int k0, int kcount, int K) {
  const int vpr = kcount >> 3;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BN * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    cp_async16(ws + r * WLD + v * 8, w + (size_t)(n0 + r) * K + k0 + v * 8);
  }
}

size_t smem_bytes(int K) {
  return (size_t)BM * (K + ZPAD) * 2   // z tile, bf16
         + 2 * W_BUF * 2;              // two W chunks, bf16 (the epilogue tile reuses them)
}

__global__ void __launch_bounds__(THREADS)
ln_linear_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
                 int R, int K, int N, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ZLD = K + ZPAD;
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem);
  // BM * ZLD * 2 = 128 * (K + 8) bytes: the W buffers start 128-byte aligned
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)BM * ZLD * 2);
  float* cs = reinterpret_cast<float*>(wbuf);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + KC - 1) / KC;

  // the first W chunk loads while the LayerNorm runs
  load_w_chunk(wbuf, w, n0, 0, min(KC, K), K);
  cp_async_commit();

  // 1. LayerNorm of the block's rows into the bf16 z tile; rows past R are 0.
  for (int r = warp; r < BM; r += WARPS) {
    const int row = row0 + r;
    __nv_bfloat16* zr = zs + r * ZLD;
    if (row >= R) {
      for (int c = lane; c < K; c += 32) zr[c] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat16* xr = x + (size_t)row * K;
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s += __bfloat162float(xr[c]);
    const float mean = warp_sum(s) / K;
    float v = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = __bfloat162float(xr[c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / K + eps);
    for (int c = lane; c < K; c += 32) {
      const float z = (__bfloat162float(xr[c]) - mean) * rstd;
      zr[c] = __float2bfloat16(z * gamma[c] + beta[c]);
    }
  }

  // 2. acc[i][j] = rows 32*wm + 16*i, cols 32*wn + 16*j of the tile.
  const int wm = warp & 1, wn = warp >> 1;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kc = 0; kc < nk; ++kc) {
    const int k0 = kc * KC;
    if (kc + 1 < nk) {
      const int k1 = k0 + KC;
      load_w_chunk(wbuf + ((kc + 1) & 1) * W_BUF, w, n0, k1, min(KC, K - k1), K);
      cp_async_commit();
      cp_async_wait<1>();  // chunk kc has landed (this thread's copies)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk kc (and, the first time, the z tile) visible to all
    const __nv_bfloat16* ws = wbuf + (kc & 1) * W_BUF;
    const int kcount = min(KC, K - k0);
    for (int kk = 0; kk < kcount; kk += 16) {
      FragA a[2];
      FragB bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], zs + (size_t)(32 * wm + 16 * i) * ZLD + k0 + kk, ZLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], ws + (32 * wn + 16 * j) * WLD + kk, WLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with buffer kc & 1 before it is refilled
  }

  // 3. y = bf16(acc + b): the f32 tile goes through the (now free) W buffers.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (32 * wm + 16 * i) * CLD + 32 * wn + 16 * j, acc[i][j],
                              CLD, wmma::mem_row_major);
  __syncthreads();
  constexpr int VPR = BN / 8;  // 16-byte output vectors per tile row
  for (int i = threadIdx.x; i < BM * VPR; i += THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * 8;
    const int row = row0 + r;
    if (row >= R) continue;
    __align__(16) __nv_bfloat16 out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(cs[r * CLD + c + e] + b[n0 + c + e]);
    *reinterpret_cast<uint4*>(y + (size_t)row * N + n0 + c) = *reinterpret_cast<const uint4*>(out);
  }
}

}  // namespace

// Dynamic shared memory the kernel needs at width K (the wrapper refuses
// K above the 227 KB a block may use).
extern "C" long long ln_linear_smem_bytes(int K) { return (long long)smem_bytes(K); }

// K % 16 == 0, N % 128 == 0, x and W 16-byte aligned (checked by the Python
// wrapper). Returns cudaGetLastError() after the launch.
extern "C" int ln_linear_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* b, void* y, int R, int K,
                                  int N, float eps, void* stream) {
  if (R <= 0 || K <= 0 || K % 16 || N <= 0 || N % BN) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  cudaError_t e = cudaFuncSetAttribute(ln_linear_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((R + BM - 1) / BM, N / BN);
  ln_linear_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), R, K, N, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* oatx_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
