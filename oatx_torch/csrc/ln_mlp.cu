// Fused LayerNorm -> fc1 -> GELU -> fc2 forward for sm_90a (TMA + wgmma).
//
// Replaces the TPU kernel oatx/ops/pallas/ln_mlp.py `_fwd_pallas` (body
// `_kernel` :84-95) and computes what its `_fwd_xla` (:124-135) computes:
//   z = bf16(LN(x) * gamma + beta)          f32 statistics and affine
//   h = bf16(GELU(z @ W1^T + b1))           f32 accumulation, exact erf
//   y = bf16(h @ W2^T + b2)                 f32 accumulation, f32 biases
// Bound by operations: 4*R*K*H flops against R*K + 2*K*H + R*N bf16 values
// (at the ViT-B MLP, K = N = 768, H = 3072, 0.030 ms at R = 3140); held back
// instead by the L2 -> SM rate of the TMA ring and by the tiles' tails.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py, device busy
// per call, PERF.md §6): 0.051 / 0.120 / 0.200 ms at R = 785 / 3140 / 6280,
// against 0.455 / 0.459 / 0.926 for the one-kernel WMMA design it replaced
// (32-row blocks streaming W1 and W2 from L2) in the same call, and 0.028 /
// 0.068 / 0.131 for cuBLAS's layer_norm -> linear -> gelu -> linear.
//
// Layouts: x (R, K) bf16 row-major; W1 = fc1.weight (H, K) and W2 =
// fc2.weight (N, H) bf16 in torch layout, both K-major for their product
// (the wgmma "TN" case, no transpose); h (R, H) bf16 row-major, the
// caller's workspace; gamma, beta, b1, b2 f32; y (R, N) bf16.
//
// Two products on hopper.cuh's mainloop (persistent grid, TMA ring of 4
// stages, wgmma m64n256k16 from shared memory, TMA-store epilogue):
//   ln_mlp_up_kernel    LayerNorm prologue, z @ W1^T, + b1 -> GELU -> bf16
//                       -> h, 128 x 256 tiles of h;
//   ln_mlp_down_kernel  h @ W2^T + b2 -> y, 128 x 256 tiles of y, the TMA'd
//                       h chunk the A operand as it lands.
// When y has too few tiles to fill the card (bucket 1: 7 x 3 tiles of
// K = 3072 for 132 SMs), the wrapper splits the second product's K (the
// hidden dimension) into `split` ranges: ln_mlp_part_kernel writes each
// range's f32 sum into the caller's workspace (split, Rp, N), and
// ln_mlp_sum_kernel adds them in order, then b2 (deterministic: no atomics).
//
// Why h goes through device memory, where the TPU kernel kept it in VMEM:
// a block that held its rows' whole y in wgmma accumulators would need
// BM x 768 f32, 384 KB at BM = 128 (1.5x the SM's 256 KB register file)
// and 192 KB at BM = 64, the smallest wgmma tile, before fc1's own
// accumulators. Splitting y's columns across blocks recomputes fc1. h is
// 38.6 MB of bf16 at R = 6280, written once and read once (≈ 23 µs at
// 3.35 TB/s, much of it from the 50 MB L2), against ≈ 700 MB of operand
// traffic from L2 for the two products.
#include "hopper.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_up_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw1,
                 const __grid_constant__ CUtensorMap tmh, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ b1, int R, int K,
                 int H, float eps) {
  extern __shared__ unsigned char smem_raw[];
  mainloop<true, Epi::kBiasGelu>(smem_raw, &tmx, &tmw1, &tmh, gamma, beta, b1, R, K, H, 1, 0,
                                 eps);
}

__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_down_kernel(const __grid_constant__ CUtensorMap tmh, const __grid_constant__ CUtensorMap tmw2,
                   const __grid_constant__ CUtensorMap tmy, const float* __restrict__ b2, int R,
                   int H, int N) {
  extern __shared__ unsigned char smem_raw[];
  mainloop<false, Epi::kBias>(smem_raw, &tmh, &tmw2, &tmy, nullptr, nullptr, b2, R, H, N, 1, 0,
                              0.f);
}

__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_part_kernel(const __grid_constant__ CUtensorMap tmh, const __grid_constant__ CUtensorMap tmw2,
                   const __grid_constant__ CUtensorMap tmp, int R, int H, int N, int split,
                   int Rp) {
  extern __shared__ unsigned char smem_raw[];
  mainloop<false, Epi::kPartial>(smem_raw, &tmh, &tmw2, &tmp, nullptr, nullptr, nullptr, R, H, N,
                                 split, Rp, 0.f);
}

// y = bf16(part[0] + part[1] + ... + b2), four columns a thread
__global__ void __launch_bounds__(256)
ln_mlp_sum_kernel(const float4* __restrict__ part, const float* __restrict__ b2,
                  __nv_bfloat162* __restrict__ y, int R, int Rp, int N, int split) {
  const int n4 = N / 4;
  const long long total = (long long)R * n4, plane = (long long)Rp * n4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float4 a = part[i];
    for (int s = 1; s < split; ++s) {
      const float4 b = part[s * plane + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const float4 bias = *reinterpret_cast<const float4*>(b2 + (int)(i % n4) * 4);
    y[2 * i] = __floats2bfloat162_rn(a.x + bias.x, a.y + bias.y);
    y[2 * i + 1] = __floats2bfloat162_rn(a.z + bias.z, a.w + bias.w);
  }
}

int launch(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
           const void* w2, const void* b2, void* y, void* h, void* part, int R, int K, int H,
           int N, int split, float eps, cudaStream_t stream) {
  const int Rp = (R + BM - 1) / BM * BM;
  // encoded per call: the weights are fresh bf16 casts each call
  CUtensorMap tmx, tmw1, tmh_out, tmh_in, tmw2, tmy;
  int e = encode(&tmx, x, K, R, BM);
  if (!e) e = encode(&tmw1, w1, K, H, BN);
  if (!e) e = encode(&tmh_out, h, H, R, 64);
  if (!e) e = encode(&tmh_in, h, H, R, BM);
  if (!e) e = encode(&tmw2, w2, H, N, BN);
  if (!e) e = split == 1 ? encode(&tmy, y, N, R, 64) : encode(&tmy, part, N, split * Rp, 64, true);
  int grid = 0;
  if (!e) e = prepare(ln_mlp_up_kernel, Rp / BM * ((H + BN - 1) / BN), &grid);
  if (e) return e;
  ln_mlp_up_kernel<<<grid, THREADS, SMEM, stream>>>(
      tmx, tmw1, tmh_out, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(b1), R, K, H, eps);
  if ((e = (int)cudaGetLastError())) return e;
  const int tiles = Rp / BM * ((N + BN - 1) / BN);
  if (split == 1) {
    if ((e = prepare(ln_mlp_down_kernel, tiles, &grid))) return e;
    ln_mlp_down_kernel<<<grid, THREADS, SMEM, stream>>>(tmh_in, tmw2, tmy,
                                                         static_cast<const float*>(b2), R, H, N);
    return (int)cudaGetLastError();
  }
  if ((e = prepare(ln_mlp_part_kernel, tiles * split, &grid))) return e;
  ln_mlp_part_kernel<<<grid, THREADS, SMEM, stream>>>(tmh_in, tmw2, tmy, R, H, N, split, Rp);
  if ((e = (int)cudaGetLastError())) return e;
  const long long quads = (long long)R * N / 4;
  const int blocks = (int)(quads / 256 + 1 < 8LL * num_sms() ? quads / 256 + 1 : 8LL * num_sms());
  ln_mlp_sum_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(part),
                                                static_cast<const float*>(b2),
                                                static_cast<__nv_bfloat162*>(y), R, Rp, N, split);
  return (int)cudaGetLastError();
}

}  // namespace

// K, H and N multiples of 8 (TMA's 16-byte row strides); 1 <= split <=
// ceil(H / 64); x, W1, W2, gamma, beta and b2 16-byte aligned (checked by
// the Python wrapper). h: (R, H) bf16; part: (split, ceil(R / 128) * 128,
// N) f32 when split > 1, else unused. Returns cudaGetLastError() after the
// launches, or the error that kept one from launching.
extern "C" int ln_mlp_fwd_bf16(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* y, void* h, void* part, int R, int K, int H, int N,
                               int split, float eps, void* stream) {
  if (R <= 0 || K <= 0 || K % 8 || H <= 0 || H % 8 || N <= 0 || N % 8 || split < 1 ||
      split > (H + KC - 1) / KC || (split > 1 && !part))
    return (int)cudaErrorInvalidValue;
  return launch(x, gamma, beta, w1, b1, w2, b2, y, h, part, R, K, H, N, split, eps,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* oatx_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
