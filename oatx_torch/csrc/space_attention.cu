// Divided space attention forward for sm_90a, CLS-first token order.
//
// Replaces the TPU kernel oatx/ops/pallas/spacetime_attention.py
// `_space_attention_fwd_pallas` (body `_space_kernel` :30-57) and computes what
// its `_space_attention_reference` (:87-110) computes, for q, k, v of shape
// (B, T, H, 64) with T = 1 + F*N, q pre-scaled:
//   * the CLS query (t = 0) attends over all T keys;
//   * each frame's N patch queries attend over [CLS key + that frame's N keys];
//   * logits and softmax in f32, p rounded to bf16 before P.V, f32
//     accumulation, output bf16.
// One launch, grid (F + 1, H, B): block (f < F, h, b) takes frame f of head h
// (WMMA bf16 fragments, K and V of the group in shared memory), block
// (F, h, b) takes the CLS row. Strides come in elements, so q/k/v may be
// views into the fused qkv output. See oatx_torch/ops/kernels/space_attention.py
// for the bound and the design notes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int DH = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KLD = DH + 8;   // bf16 row stride of the K, V and Q tiles
constexpr int OLD = DH + 4;   // f32 row stride of the output staging tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int s_ld(int NP) { return NP + 8; }
__host__ __device__ inline int s_floats(int NP) {
  return 16 * (s_ld(NP) > OLD ? s_ld(NP) : OLD);
}
__host__ __device__ inline size_t warp_bytes(int NP) {
  return (size_t)s_floats(NP) * 4 + (size_t)16 * s_ld(NP) * 2 + (size_t)16 * KLD * 2;
}
size_t group_smem(int NP) { return (size_t)2 * NP * KLD * 2 + WARPS * warp_bytes(NP); }
size_t cls_smem(int T) { return ((size_t)((T + 3) / 4 * 4) + DH + 2 * DH + 2 * WARPS) * 4; }

// Block-wide reduction over the block's 4 warps; `red` holds WARPS floats.
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// The CLS row of one (b, h): softmax over all T keys.
__device__ void cls_row(const __nv_bfloat16* qb, const __nv_bfloat16* kb,
                        const __nv_bfloat16* vb, __nv_bfloat16* ob, long long kst,
                        long long vst, int T, unsigned char* smem) {
  float* lg = reinterpret_cast<float*>(smem);
  float* qs = lg + (T + 3) / 4 * 4;
  float* part = qs + DH;
  float* red = part + 2 * DH;
  for (int d = threadIdx.x; d < DH; d += THREADS) qs[d] = __bfloat162float(qb[d]);
  __syncthreads();
  float m = -INFINITY;
  for (int j = threadIdx.x; j < T; j += THREADS) {
    const __nv_bfloat16* kr = kb + (long long)j * kst;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < DH; c += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(kr + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += qs[c + i] * __bfloat162float(e[i]);
    }
    lg[j] = acc;
    m = fmaxf(m, acc);
  }
  m = block_reduce(m, red, true);
  float s = 0.f;
  for (int j = threadIdx.x; j < T; j += THREADS) {
    const float e = expf(lg[j] - m);
    lg[j] = e;
    s += e;
  }
  s = block_reduce(s, red + WARPS, false);
  for (int j = threadIdx.x; j < T; j += THREADS)
    lg[j] = __bfloat162float(__float2bfloat16(lg[j] / s));  // p in bf16
  __syncthreads();
  const int d = threadIdx.x % DH, half = threadIdx.x / DH;  // 2 halves of the keys
  float acc = 0.f;
  for (int j = half; j < T; j += THREADS / DH)
    acc += lg[j] * __bfloat162float(vb[(long long)j * vst + d]);
  part[half * DH + d] = acc;
  __syncthreads();
  if (threadIdx.x < DH) ob[threadIdx.x] = __float2bfloat16(part[threadIdx.x] + part[DH + threadIdx.x]);
}

__global__ void __launch_bounds__(THREADS)
space_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       long long qsb, long long qst, long long qsh,
                       long long ksb, long long kst, long long ksh,
                       long long vsb, long long vst, long long vsh,
                       long long osb, long long ost, long long osh,
                       int T, int F, int N, int NP) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  __nv_bfloat16* ob = o + b * osb + h * osh;
  if (f == F) {
    cls_row(qb, kb, vb, ob, kst, vst, T, smem);
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int SLD = s_ld(NP);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + NP * KLD;
  unsigned char* wb = smem + (size_t)2 * NP * KLD * 2 + warp * warp_bytes(NP);
  float* S = reinterpret_cast<float*>(wb);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(wb + (size_t)s_floats(NP) * 4);
  __nv_bfloat16* Qs = P + 16 * SLD;

  // Group keys/values: row 0 = the CLS token, rows 1..N = frame f, rest 0.
  const long long t_frame = 1 + (long long)f * N;
  for (int i = threadIdx.x; i < NP * (DH / 8); i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (r <= N) {
      const long long t = r == 0 ? 0 : t_frame + r - 1;
      kv = *reinterpret_cast<const uint4*>(kb + t * kst + c);
      vv = *reinterpret_cast<const uint4*>(vb + t * vst + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * KLD + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * KLD + c) = vv;
  }
  __syncthreads();

  const int n_qt = (N + 15) / 16, n_kt = NP / 16;
  for (int qt = warp; qt < n_qt; qt += WARPS) {
    for (int i = lane; i < 16 * (DH / 8); i += 32) {
      const int r = i >> 3, c = (i & 7) * 8;
      const int qi = qt * 16 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (qi < N) val = *reinterpret_cast<const uint4*>(qb + (t_frame + qi) * qst + c);
      *reinterpret_cast<uint4*>(Qs + r * KLD + c) = val;
    }
    __syncwarp();

    // S = Q K^T (f32) for the 16 queries of this tile against all NP keys.
    FragA qa[DH / 16];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wmma::load_matrix_sync(qa[kk], Qs + kk * 16, KLD);
    for (int kt = 0; kt < n_kt; ++kt) {
      FragC s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        FragBc kf;
        wmma::load_matrix_sync(kf, Ks + kt * 16 * KLD + kk * 16, KLD);
        wmma::mma_sync(s, qa[kk], kf, s);
      }
      wmma::store_matrix_sync(S + kt * 16, s, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // Row softmax over the N + 1 valid keys; P = bf16(e / sum), 0 past them.
    for (int r = 0; r < 16; ++r) {
      float* sr = S + r * SLD;
      float m = -INFINITY;
      for (int c = lane; c <= N; c += 32) m = fmaxf(m, sr[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c <= N; c += 32) {
        const float e = expf(sr[c] - m);
        sr[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      __nv_bfloat16* pr = P + r * SLD;
      for (int c = lane; c < NP; c += 32)
        pr[c] = __float2bfloat16(c <= N ? sr[c] / sum : 0.f);
    }
    __syncwarp();

    // O = P V (f32), staged through S, written as bf16.
    FragC oacc[DH / 16];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) wmma::fill_fragment(oacc[c], 0.f);
    for (int kt = 0; kt < n_kt; ++kt) {
      FragA pa;
      wmma::load_matrix_sync(pa, P + kt * 16, SLD);
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        FragBr vf;
        wmma::load_matrix_sync(vf, Vs + kt * 16 * KLD + c * 16, KLD);
        wmma::mma_sync(oacc[c], pa, vf, oacc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < DH / 16; ++c)
      wmma::store_matrix_sync(S + c * 16, oacc[c], OLD, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * DH; i += 32) {
      const int r = i / DH, d = i % DH;
      const int qi = qt * 16 + r;
      if (qi < N) ob[(t_frame + qi) * ost + d] = __float2bfloat16(S[r * OLD + d]);
    }
    __syncwarp();
  }
}

}  // namespace

// Shared memory the launch needs for T = 1 + F*N tokens (the wrapper checks
// it against the card's per-block limit before launching).
extern "C" long long space_attention_smem_bytes(int T, int F) {
  const int N = (T - 1) / F;
  const int NP = (N + 1 + 15) / 16 * 16;
  const size_t g = group_smem(NP), c = cls_smem(T);
  return (long long)(g > c ? g : c);
}

// q, k, v, o: (B, T, H, 64) bf16 with the given element strides (last dim
// contiguous, 16-byte aligned rows). Returns cudaGetLastError() after launch.
extern "C" int space_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        long long qsb, long long qst, long long qsh,
                                        long long ksb, long long kst, long long ksh,
                                        long long vsb, long long vst, long long vsh,
                                        long long osb, long long ost, long long osh,
                                        int B, int T, int H, int F, void* stream) {
  const int N = (T - 1) / F;
  const int NP = (N + 1 + 15) / 16 * 16;
  const size_t smem = (size_t)space_attention_smem_bytes(T, F);
  cudaError_t e = cudaFuncSetAttribute(space_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(F + 1, H, B);
  space_attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, T, F, N, NP);
  return (int)cudaGetLastError();
}

extern "C" const char* oatx_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
