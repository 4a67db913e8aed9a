// Hopper (sm_90a) pieces shared by the TMA + wgmma kernels (ln_linear.cu,
// ln_mlp.cu): PTX wrappers for mbarriers, TMA and wgmma; the host-side
// tensor-map encoding; and the persistent producer/consumer mainloop
//   out = epilogue(A' @ B^T)        A (R, K), B (N, K), both bf16, K-major
// with an optional LayerNorm prologue (A' = bf16(LN(A) * gamma + beta),
// written in place over each A chunk) and one of three epilogues:
//   kBias      out = bf16(acc + bias)
//   kBiasGelu  out = bf16(GELU(acc + bias)), exact erf
//   kPartial   out = acc as f32, the sum over one of `split` K ranges
//
// A persistent grid, one block per SM, walks the work units: BM x BN =
// 128 x 256 output tiles, times `split` K ranges, each block a contiguous
// run of them in (row tile, column tile, K range) order. Two consumer
// warpgroups own 64 rows each; one producer warp issues every TMA load into
// a ring of S = 4 stages of (A chunk 128 x 64, B chunk 256 x 64), both in
// the 128-byte swizzle. With the LayerNorm, per unit first the nk A chunks
// alone, SPS to a stage (the statistics pass, only when the row tile
// changes), then nk (A, B) pairs. mbarriers per stage: full (TMA landed),
// empty (every consumer warp is done with it). The consumers
//   1. (LayerNorm) take each row's (count, mean, M2) by Chan's update per
//      16-byte vector, f32, from the A chunks in shared memory (8 threads
//      per row, combined by shuffles);
//   2. per chunk, (LayerNorm) write z = bf16((x - mean) * rstd * gamma +
//      beta) over their rows of the A chunk, in place and in the same
//      swizzle, fence it for the async proxy and sync the warpgroup; then
//      issue 4 wgmma m64n256k16 (A and B by shared-memory descriptors, f32
//      accumulators in registers); the LayerNorm of chunk c overlaps the
//      tensor cores' work on chunk c - 1;
//   3. write the epilogue through swizzled boxes of 64 rows x 128 bytes in
//      shared memory, stored by TMA, while the producer loads the next unit.
// TMA reads 0 past K, R and N, and clips its stores to the tensor's edges.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 64;      // K columns per chunk (128 bytes of bf16)
constexpr int NWG = 2;      // consumer warpgroups, 64 rows each
constexpr int BM = 64 * NWG, BN = 256;  // output tile
constexpr int S = 4;        // ring stages
constexpr int THREADS = NWG * 128 + 32;  // consumer warpgroups, the producer warp
constexpr int X_BYTES = BM * KC * 2;
constexpr int STAGE = X_BYTES + BN * KC * 2;
constexpr int SPS = STAGE / X_BYTES;  // A chunks per statistics stage
constexpr int EPI_BUFS = 2;  // 64-row x 128-byte output boxes per consumer warpgroup
constexpr int SMEM = 1024 + S * STAGE + NWG * EPI_BUFS * 8192 + 2 * 8 * S;

enum class Epi { kBias, kBiasGelu, kPartial };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed. A wait of more
// than 2^33 cycles (seconds) traps: a load that never lands becomes a launch
// error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  long long t0 = 0;
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most one committed TMA store group still reading shared memory
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// K-major operand, 128-byte swizzle: rows of 128 B, 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Pin the accumulators after a wgmma wait: later reads may not move above it.
__device__ __forceinline__ void fence_regs(float (&d)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// exact GELU, as torch.nn.functional.gelu computes it in f32
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// The mainloop above, run by every thread of a THREADS-thread block with
// SMEM bytes of dynamic shared memory at `smem_raw`. tma, tmb: the A and B
// tensor maps (boxes of BM and BN rows); tmo: the output's (boxes of 64
// rows; f32 for kPartial, where K range s writes rows s * part_rows + r).
// gamma, beta: the LayerNorm's affine (LN only); bias: kBias, kBiasGelu.
template <bool LN, Epi EPI>
__device__ __forceinline__ void mainloop(unsigned char* smem_raw, const CUtensorMap* tma,
                                         const CUtensorMap* tmb, const CUtensorMap* tmo,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         const float* __restrict__ bias, int R, int K, int N,
                                         int split, int part_rows, float eps) {
  // the 128B swizzle repeats every 1024 bytes: stages start 1024-aligned
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* epi = smem + (size_t)S * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + NWG * EPI_BUFS * 8192);
  uint64_t* empty = full + S;
  // product chunks, statistics loads
  const int nk = (K + KC - 1) / KC, ns = LN ? (nk + SPS - 1) / SPS : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this block's units: a contiguous run of the (row tile, column tile, K
  // range) order, so consecutive units mostly share their rows, and the
  // statistics pass runs only when the row tile changes
  const int ntn = (N + BN - 1) / BN, nunits = (R + BM - 1) / BM * ntn * split;
  const int u_begin = (int)((long long)blockIdx.x * nunits / gridDim.x);
  const int u_end = (int)((long long)(blockIdx.x + 1) * nunits / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // a consumer warp is done with stage s
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };

  if (warp == NWG * 4) {
    // producer: load j (counted over the block's units) fills stage j % S
    // once load j - S was released, so it runs up to S loads ahead, across
    // units too
    if (lane == 0) {
      int j = 0;
      for (int u = u_begin; u < u_end; ++u) {
        const int t = u / split, m = t / ntn, row0 = m * BM, n0 = (t - m * ntn) * BN;
        const int r = u - t * split, kc0 = r * nk / split, kc1 = (r + 1) * nk / split;
        const bool stats = LN && (u == u_begin || m != (u - 1) / split / ntn);
        for (int p = stats ? 0 : ns; p < ns + kc1 - kc0; ++p, ++j) {
          const int s = j % S;
          if (j >= S) mbar_wait(&empty[s], ((j / S) - 1) & 1);
          unsigned char* st = smem + (size_t)s * STAGE;
          if (p < ns) {  // statistics: up to SPS A chunks fill the stage
            const int c0 = p * SPS, c = min(SPS, nk - c0);
            mbar_expect_tx(&full[s], c * X_BYTES);
            for (int i = 0; i < c; ++i)
              tma_load(st + i * X_BYTES, tma, &full[s], (c0 + i) * KC, row0);
          } else {
            const int k0 = (kc0 + p - ns) * KC;
            mbar_expect_tx(&full[s], STAGE);
            tma_load(st, tma, &full[s], k0, row0);
            tma_load(st + X_BYTES, tmb, &full[s], k0, n0);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup wg owns tile rows 64*wg .. 64*wg + 63. Thread t
    // owns the 16-byte vector v of rows vr + 16*i (i < 4) of that band; in
    // the 128B swizzle those hold the logical 8-column group g of the chunk.
    const int wg = warp >> 2, t = threadIdx.x & 127;
    const int vr = t >> 3, v = t & 7, g = v ^ (vr & 7);
    const int band = (wg * 64 + vr) * 128 + v * 16;  // byte offset of row vr's vector
    unsigned char* ebuf = epi + wg * EPI_BUFS * 8192;
    float rstd[4], shift[4];  // per row: (x - mean) * rstd = x * rstd + shift
    int j = 0;                // the producer's load count
    for (int u = u_begin; u < u_end; ++u) {
      const int tl = u / split, m = tl / ntn, row0 = m * BM, n0 = (tl - m * ntn) * BN;
      const int kr = u - tl * split, kc0 = kr * nk / split, kc1 = (kr + 1) * nk / split;
      if (LN && (u == u_begin || m != (u - 1) / split / ntn)) {
        // 1. statistics: Chan's update of (count, mean, M2) per 8-value vector
        float mean[4] = {0.f, 0.f, 0.f, 0.f}, m2[4] = {0.f, 0.f, 0.f, 0.f}, cnt = 0.f;
        for (int kc = 0; kc < nk; ++kc) {
          const int s = j % S;
          if (kc % SPS == 0) mbar_wait(&full[s], (j / S) & 1);
          if (kc * KC + g * 8 < K) {
            const float w = 8.f / (cnt + 8.f), wd = cnt * w;
            const unsigned char* st =
                smem + (size_t)s * STAGE + (kc % SPS) * X_BYTES + band;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uint4 raw = *reinterpret_cast<const uint4*>(st + i * 16 * 128);
              const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
              float f[8];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 p = __bfloat1622float2(h[e]);
                f[2 * e] = p.x;
                f[2 * e + 1] = p.y;
              }
              const float m8 =
                  (((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]))) * 0.125f;
              float q8 = 0.f;
#pragma unroll
              for (int e = 0; e < 8; ++e) q8 += (f[e] - m8) * (f[e] - m8);
              const float d = m8 - mean[i];
              mean[i] += d * w;
              m2[i] += q8 + d * d * wd;
            }
            cnt += 8.f;
          }
          if (kc % SPS == SPS - 1 || kc == nk - 1) {  // the stage is read
            release(s);
            ++j;
          }
        }
        // combine the 8 threads of each row (lanes differing in bits 0-2), in a
        // form that is symmetric in the two halves so all 8 agree bit for bit
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float n = cnt, mu = mean[i], q = m2[i];
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            const float n2 = __shfl_xor_sync(0xffffffffu, n, o);
            const float mu2 = __shfl_xor_sync(0xffffffffu, mu, o);
            const float q2 = __shfl_xor_sync(0xffffffffu, q, o);
            const float nt = __fadd_rn(n, n2);
            if (nt > 0.f) {
              const float d = __fsub_rn(mu, mu2);
              q = __fadd_rn(__fadd_rn(q, q2),
                            __fdiv_rn(__fmul_rn(__fmul_rn(d, d), __fmul_rn(n, n2)), nt));
              mu = __fdiv_rn(__fadd_rn(__fmul_rn(n, mu), __fmul_rn(n2, mu2)), nt);
            }
            n = nt;
          }
          rstd[i] = rsqrtf(q / K + eps);
          shift[i] = -mu * rstd[i];
        }
      }

      // 2. product: (LayerNorm: z chunk in place of the A chunk, then) 4
      // wgmma k16 steps per chunk
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kc = kc0; kc < kc1; ++kc, ++j) {
        const int s = j % S;
        unsigned char* st = smem + (size_t)s * STAGE;
        if constexpr (LN) {
          const int c0 = kc * KC + g * 8;
          float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0, b0 = g0, b1 = g0;
          if (c0 < K) {  // past K gamma = beta = 0, so z = 0 there
            g0 = __ldg(reinterpret_cast<const float4*>(gamma + c0));
            g1 = __ldg(reinterpret_cast<const float4*>(gamma + c0 + 4));
            b0 = __ldg(reinterpret_cast<const float4*>(beta + c0));
            b1 = __ldg(reinterpret_cast<const float4*>(beta + c0 + 4));
          }
          const float ga[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float be[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          mbar_wait(&full[s], (j / S) & 1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint4* p = reinterpret_cast<uint4*>(st + band + i * 16 * 128);
            uint4 raw = *p;
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h[e]);
              h[e] = __floats2bfloat162_rn(
                  fmaf(fmaf(f.x, rstd[i], shift[i]), ga[2 * e], be[2 * e]),
                  fmaf(fmaf(f.y, rstd[i], shift[i]), ga[2 * e + 1], be[2 * e + 1]));
            }
            *p = raw;
          }
          // z is read by the async proxy (wgmma): fence, then the warpgroup syncs
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        } else {
          mbar_wait(&full[s], (j / S) & 1);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint32_t da = smem_u32(st) + wg * 64 * 128, db = smem_u32(st + X_BYTES);
#pragma unroll
        for (int k = 0; k < KC / 16; ++k)
          wgmma_n256(acc, desc_sw128(da + 32 * k), desc_sw128(db + 32 * k));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // chunk kc - 1 is done: its stage may be refilled
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kc > kc0) release((j - 1) % S);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      release((j - 1) % S);

      // 3. the epilogue, one box of 64 rows x 128 bytes at a time: acc[2p],
      // acc[2p+1] hold row 16*(warp%4) + lane/4 + 8*(p%2), columns
      // 8*(p/2) + 2*(lane%4) and the next; the box is written in the 128B
      // swizzle (conflict-free) and stored by TMA while the next one fills
      const int r = (warp & 3) * 16 + (lane >> 2), rows0 = row0 + wg * 64;
      constexpr int ESZ = EPI == Epi::kPartial ? 4 : 2;  // output bytes per value
      constexpr int BOX = 128 / ESZ, PAIRS = BOX / 4;    // columns, pairs per thread
#pragma unroll
      for (int h = 0; h < BN / BOX; ++h) {
        unsigned char* buf = ebuf + (h % EPI_BUFS) * 8192;
        if (t == 0) bulk_wait_read_1();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
          const int p = PAIRS * h + q, rr = r + 8 * (q & 1), c = (q >> 1) * 8 + 2 * (lane & 3);
          unsigned char* dst = buf + rr * 128 + ((((c * ESZ) >> 4) ^ (rr & 7)) << 4) + (c * ESZ & 15);
          if constexpr (EPI == Epi::kPartial) {
            *reinterpret_cast<float2*>(dst) = make_float2(acc[2 * p], acc[2 * p + 1]);
          } else {
            const int col = n0 + BOX * h + c;
            const float bl = col < N ? bias[col] : 0.f, bh = col < N ? bias[col + 1] : 0.f;
            float v0 = acc[2 * p] + bl, v1 = acc[2 * p + 1] + bh;
            if constexpr (EPI == Epi::kBiasGelu) {
              v0 = gelu(v0);
              v1 = gelu(v1);
            }
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (t == 0) {
          if (n0 + BOX * h < N && rows0 < R)
            tma_store(tmo, buf, n0 + BOX * h, (EPI == Epi::kPartial ? kr * part_rows : 0) + rows0);
          bulk_commit();
        }
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---- host side ----

int num_sms() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// (rows, cols) row-major, bf16 (or f32), boxes of box_rows x 128 bytes in the
// 128B swizzle; loads read 0 past the edges, stores are clipped to them.
int encode(CUtensorMap* map, const void* ptr, int cols, int rows, int box_rows, bool f32 = false) {
  const PFN_cuTensorMapEncodeTiled fn = encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  const int esz = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esz), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
         const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Lets a mainloop kernel take SMEM bytes of shared memory and sets `grid`
// to its persistent grid over `units` work units; 0 or the CUDA error.
template <typename Kernel>
int prepare(Kernel* kernel, int units, int* grid) {
  *grid = units < num_sms() ? units : num_sms();
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

}  // namespace
