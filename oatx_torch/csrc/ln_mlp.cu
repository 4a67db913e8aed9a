// Fused LayerNorm -> fc1 -> GELU -> fc2 forward for sm_90a.
//
// Replaces the TPU kernel oatx/ops/pallas/ln_mlp.py `_fwd_pallas` (body
// `_kernel` :84-95) and computes what its `_fwd_xla` (:124-135) computes:
//   z = bf16(LN(x) * gamma + beta)          f32 statistics
//   h = bf16(GELU(z @ W1 + b1))             f32 accumulation, exact erf
//   y = bf16(h @ W2 + b2)                   f32 accumulation, f32 biases
// The hidden tensor never leaves the block. See
// oatx_torch/ops/kernels/ln_mlp.py for the bound and the design notes.
//
// Layouts: x (R, K) bf16 row-major; W1 = fc1.weight (H, K) bf16 and
// W2 = fc2.weight (N, H) bf16 in torch Linear layout, read as column-major
// WMMA B operands; gamma, beta, b1, b2 f32; y (R, N) bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 32;        // rows per block
constexpr int HC = 128;       // hidden columns per chunk (16 per warp)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ZPAD = 8;       // bf16 padding per z row: spreads banks, keeps 32 B alignment
constexpr int PLD = HC + 4;   // f32 row stride of the pre-activation chunk
constexpr int HLD = HC + 8;   // bf16 row stride of the hidden chunk

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int K) {
  return (size_t)BM * (K + ZPAD) * 2   // z tile, bf16
         + (size_t)BM * PLD * 4        // pre-activation chunk, f32
         + (size_t)BM * HLD * 2        // hidden chunk, bf16
         + (size_t)WARPS * 16 * 16 * 4;  // per-warp epilogue staging, f32
}

// NF: 16-column output fragments per warp; the block covers N = 8 * 16 * NF.
template <int NF>
__global__ void __launch_bounds__(THREADS)
ln_mlp_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
              const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
              const float* __restrict__ b2, __nv_bfloat16* __restrict__ y,
              int R, int K, int H, float eps) {
  constexpr int N = WARPS * NF * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ZLD = K + ZPAD;
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* p = smem + (size_t)BM * ZLD * 2;
  float* pre = reinterpret_cast<float*>(p);
  p += (size_t)BM * PLD * 4;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(p);
  p += (size_t)BM * HLD * 2;
  float* stage = reinterpret_cast<float*>(p);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;

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
  __syncthreads();

  FragC acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int c0 = 0; c0 < H; c0 += HC) {
    // 2a. pre[:, 16w .. 16w+16) = z @ W1[:, c0 + 16w ..) for both 16-row halves.
    {
      FragC p0, p1;
      wmma::fill_fragment(p0, 0.f);
      wmma::fill_fragment(p1, 0.f);
      const __nv_bfloat16* wcol = w1 + (size_t)(c0 + warp * 16) * K;
      for (int k0 = 0; k0 < K; k0 += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(b, wcol + k0, K);
        wmma::load_matrix_sync(a, zs + k0, ZLD);
        wmma::mma_sync(p0, a, b, p0);
        wmma::load_matrix_sync(a, zs + 16 * ZLD + k0, ZLD);
        wmma::mma_sync(p1, a, b, p1);
      }
      wmma::store_matrix_sync(pre + warp * 16, p0, PLD, wmma::mem_row_major);
      wmma::store_matrix_sync(pre + 16 * PLD + warp * 16, p1, PLD, wmma::mem_row_major);
    }
    __syncthreads();
    // 2b. h = bf16(GELU(pre + b1)), exact erf.
    for (int i = threadIdx.x; i < BM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      const float v = pre[r * PLD + c] + b1[c0 + c];
      hs[r * HLD + c] = __float2bfloat16(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
    }
    __syncthreads();
    // 2c. y[:, warp's NF*16 columns) += h @ W2[c0 .. c0+HC, cols].
#pragma unroll 1
    for (int kk = 0; kk < HC; kk += 16) {
      FragA a0, a1;
      wmma::load_matrix_sync(a0, hs + kk, HLD);
      wmma::load_matrix_sync(a1, hs + 16 * HLD + kk, HLD);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, w2 + (size_t)(warp * NF * 16 + j * 16) * H + c0 + kk, H);
        wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }
    // the next chunk's 2a writes only `pre`; its 2b writes `hs` after a
    // __syncthreads that every warp reaches only once its 2c is done
  }

  // 3. y = bf16(acc + b2), staged per fragment through shared memory.
  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int col0 = warp * NF * 16 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const int row = row0 + i * 16 + r;
        if (row < R) y[(size_t)row * N + col0 + c] = __float2bfloat16(st[e] + b2[col0 + c]);
      }
      __syncwarp();
    }
  }
}

template <int NF>
int launch(const void* x, const void* gamma, const void* beta, const void* w1,
           const void* b1, const void* w2, const void* b2, void* y, int R, int K,
           int H, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(K);
  cudaError_t e = cudaFuncSetAttribute(ln_mlp_kernel<NF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((R + BM - 1) / BM);
  ln_mlp_kernel<NF><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(y), R, K, H, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// K % 16 == 0, K <= 1024, H % 128 == 0, N == 128 * NF with 1 <= NF <= 8
// (checked by the Python wrapper). Returns cudaGetLastError() after launch.
extern "C" int ln_mlp_fwd_bf16(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* y, int R, int K, int H, int N,
                               float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N / (16 * WARPS)) {
    case 1: return launch<1>(x, gamma, beta, w1, b1, w2, b2, y, R, K, H, eps, s);
    case 2: return launch<2>(x, gamma, beta, w1, b1, w2, b2, y, R, K, H, eps, s);
    case 3: return launch<3>(x, gamma, beta, w1, b1, w2, b2, y, R, K, H, eps, s);
    case 4: return launch<4>(x, gamma, beta, w1, b1, w2, b2, y, R, K, H, eps, s);
    case 5: return launch<5>(x, gamma, beta, w1, b1, w2, b2, y, R, K, H, eps, s);
    case 6: return launch<6>(x, gamma, beta, w1, b1, w2, b2, y, R, K, H, eps, s);
    case 7: return launch<7>(x, gamma, beta, w1, b1, w2, b2, y, R, K, H, eps, s);
    case 8: return launch<8>(x, gamma, beta, w1, b1, w2, b2, y, R, K, H, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* oatx_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
