// Fused LayerNorm -> Linear forward for sm_90a (TMA + wgmma).
//
// Replaces the TPU kernel oatx/ops/pallas/ln_linear.py `_fwd_pallas` (body
// `_kernel` :47-55) and computes what its `_fwd_xla` (:80-88) computes:
//   z = bf16(LN(x) * gamma + beta)          f32 statistics and affine
//   y = bf16(z @ W^T + b)                   f32 accumulation, f32 bias
// Bound by operations (2*R*K*N flops against R*K + N*K + R*N bf16 values);
// this design is held back by the L2 -> SM rate of its TMA loads instead.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py, PERF.md
// §6): 0.095 ms at the train step's (6280, 768 -> 2304), 233 TFLOP/s;
// 0.089-0.091 ms in turns with the WMMA kernel it replaced, 0.488 ms.
//
// Layouts: x (R, K) bf16 row-major; W = Linear.weight (N, K) bf16 in torch
// layout; both are K-major, the wgmma "TN" case (no transpose flag);
// gamma, beta, b f32; y (R, N) bf16.
//
// The kernel is hopper.cuh's mainloop with the LayerNorm prologue and the
// bias epilogue, over 128 x 256 tiles of y: per row tile the statistics
// pass, then z written in place over each x chunk and fed to wgmma from
// shared memory. z never leaves shared memory.
#include "hopper.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 1)
ln_linear_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 const __grid_constant__ CUtensorMap tmy, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ bias, int R, int K,
                 int N, float eps) {
  extern __shared__ unsigned char smem_raw[];
  mainloop<true, Epi::kBias>(smem_raw, &tmx, &tmw, &tmy, gamma, beta, bias, R, K, N, 1, 0, eps);
}

int launch(const void* x, const void* gamma, const void* beta, const void* w, const void* b,
           void* y, int R, int K, int N, float eps, cudaStream_t stream) {
  CUtensorMap tmx, tmw, tmy;  // encoded per call: W is a fresh bf16 cast each call
  int e = encode(&tmx, x, K, R, BM);
  if (!e) e = encode(&tmw, w, K, N, BN);
  if (!e) e = encode(&tmy, y, N, R, 64);
  int grid = 0;
  if (!e) e = prepare(ln_linear_kernel, (R + BM - 1) / BM * ((N + BN - 1) / BN), &grid);
  if (e) return e;
  ln_linear_kernel<<<grid, THREADS, SMEM, stream>>>(
      tmx, tmw, tmy, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(b), R, K, N, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// K % 8 == 0 and N % 8 == 0 (TMA's 16-byte row strides); x, W, gamma and
// beta 16-byte aligned (checked by the Python wrapper). Returns
// cudaGetLastError() after the launch, or the error that kept it from
// launching.
extern "C" int ln_linear_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* b, void* y, int R, int K, int N,
                                  float eps, void* stream) {
  if (R <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8) return (int)cudaErrorInvalidValue;
  return launch(x, gamma, beta, w, b, y, R, K, N, eps, static_cast<cudaStream_t>(stream));
}

extern "C" const char* oatx_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
