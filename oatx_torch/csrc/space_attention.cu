// Divided space attention for sm_90a, CLS-first token order: the forward,
// and the backward that recomputes from the forward's row statistics.
//
// Replaces the TPU kernel oatx/ops/pallas/spacetime_attention.py
// `_space_attention_fwd_pallas` (body `_space_kernel` :30-57) and computes what
// its `_space_attention_reference` (:87-110) computes, for q, k, v of shape
// (B, T, H, Dh) with Dh 64 or 80 (every head dim of the ViT table: B/16, L/16
// and H/14) and T = 1 + F*N, N + 1 <= 272 keys a frame group (17 key tiles:
// 257 at 224² / patch 14 and at 256² / patch 16), q pre-scaled:
//   * the CLS query (t = 0) attends over all T keys;
//   * each frame's N patch queries attend over [CLS key + that frame's N keys];
//   * logits and softmax in f32 in the reference's order (max, exp, sum,
//     then p = bf16(e / sum), no online rescaling), f32 accumulation of P.V,
//     output bf16. e is the SFU's 2^x of the logit scaled by log2(e), and
//     e / sum is e times the correctly rounded 1/sum: both within two f32
//     ulps of expf and of the quotient, far below p's bf16 rounding.
// The backward is the VJP of that function (oatx differentiates the same
// reference with jax.vjp, :123-127): with P = exp(S - lse) in f32,
//   dV = bf16(P)^T dO,  dP = dO V^T,  D = rowsum(P * dP),  dS = P * (dP - D),
//   dQ = dS K,  dK = dS^T Q,
// each product from bf16 operands (dS and P rounded) summed in f32. That
// departs from the reference, which forms dQ and dK from f32 dS (and rounds
// dP to bf16 through p's cast): chip_smoke.py measures both versions'
// distance from the exact f64 gradient (`grad_rel_exact`, PERF.md §6).
//
// What bounds it on an H100: bytes. The forward reads q, k, v and writes o,
// 4 * B*T*H*Dh bf16 (19.3 MB for ViT-B at B = 4: 5.8 us at 3.35 TB/s; 42 MB
// for ViT-H at B = 4, T = 1025: 12.5 us) for 4 * B*H*(T + F*N*(N+1))*Dh
// flops (1.91 GFLOP: 1.9 us at 989 TFLOP/s). The backward reads q, k, v, dO
// and writes dq, dk, dv (7 tensors, 67 MB at ViT-B, B = 8: 20 us) for 5
// products of the forward's 2 (9.5 GFLOP: 9.7 us).
//
// Tiles in shared memory. A Dh-64 row is 128 bytes, 8 16-byte chunks,
// XOR-swizzled by the row (chunk c of row r at c ^ (r & 7)). A Dh-80 row is
// 160 bytes, 10 chunks, which that swizzle cannot permute; it is stored at a
// padded pitch of 88 bf16 (176 bytes, 11 chunks, the last never read). Every
// ldmatrix phase reads one chunk of 8 consecutive rows r..r+7, which land in
// bank groups (11 r + c) mod 8: 11 is odd, so the 8 rows hit 8 distinct
// groups and the reads are free of bank conflicts, as under the swizzle. The
// pad costs 10 % of the tile (107 KB for a Dh-80 forward block at 272 keys
// against 97 KB unpadded); the Dh-64 code is unchanged.
//
// Forward, one launch (after a memset of its counters). Blocks of 4 warps
// take units in the order they start (an atomic counter): first the frame
// groups' units, each a range of 16-query tiles of one (frame, head, batch)
// group. A group unit copies the group's K and V (CLS row + N frame rows,
// zero-padded to NP = 16*KT rows) into shared memory once with 16-byte
// cp.async through the strides (61 KB at Dh 64, N = 196: 3 blocks, 12 warps,
// per SM; 2 blocks at Dh 80 or past 256 keys, where a block takes 107 / 78
// KB and S alone 136 registers a thread). Each warp owns 16 query rows:
// S = Q K^T by mma.sync m16n8k16 (bf16 -> f32; Dh / 16 k-steps, the fifth of
// Dh 80 by ldmatrix.x2) into 8*KT registers while V still lands, padded keys
// set to -inf, the row max and sum over the quad shuffles of the C layout,
// and p packed straight into the A fragments of O = P V (the C layout of
// m16n8k16 is its A layout; V by ldmatrix.trans). O (Dh / 2 f32 registers)
// goes out through the warp's staging tile as 16-byte stores. S and P never
// leave registers; the key loop is not split, so the reference's order
// stands. The wrapper picks how many units share a group's query tiles from
// the batch (`_query_split`), to fill one wave.
// The last unit of each group (it has the fewest tiles) also writes the CLS
// query's logits against the group's keys (K is in shared memory) and counts
// its frame done. Then come B*H*F CLS units, one per (frame, head, batch):
// each waits for its (b, h)'s F frames of logits (units that started before
// it, so the wait cannot deadlock), takes their max and sum (every unit in
// the same order, so all get the same bits), p of its frame's keys and their
// P V in f32; the last of the F to finish (an integer ticket) adds the F
// partials in frame order. So the CLS row, whose T keys one block streams
// too slowly, spreads over F blocks that fill the group units' tail.
// With `lse`, every row's log-sum-exp is written for the backward.
//
// Backward, three launches, no float atomics: bitwise the same from run to
// run. `space_attention_cls_bwd_kernel`, one block per (frame, head, batch):
// the CLS query's P = exp(s - lse) and dP = dO.v over the frame's keys, to a
// workspace. `space_attention_bwd_kernel`, one block per (frame, head, batch)
// with the group's Q, K, V and dO in shared memory (4 tiles, 110 KB at Dh 64,
// N = 196: 2 blocks per SM; 191 KB at Dh 80, N = 256: 1 block): the CLS
// row's D over all T keys (the same order in every block), dS_cls and
// bf16(P_cls) of its keys; the CLS row's dq summed over its keys (a
// partial); phase 1, each warp per 16-query tile takes D over the keys in
// 16-key chunks, then dS and dq = dS K (complete in the block); phase 2,
// each warp per 16-key tile walks the queries, recomputes P^T and dP^T, sums
// dk = dS^T Q and dv = bf16(P)^T dO, adds the CLS query's share to the frame
// keys and writes the CLS key's partial.
// `space_attention_cls_key_kernel` sums the F partials of the CLS row's dq and
// of the CLS key's dk, dv in frame order, with the CLS row's own term.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_KT = 17;  // N + 1 <= 272 keys per group
constexpr float LOG2E = 1.4426950408889634f;

// A tile row of D bf16: 64 (swizzled, 128 bytes) or 80 (at a padded pitch of
// 88, 176 bytes; the note at the top says why)
template <int D>
__host__ __device__ constexpr int pitch() {
  static_assert(D == 64 || D == 80, "head dim 64 or 80");
  return D == 64 ? 64 : D + 8;
}

// ---------------------------------------------------------------- helpers

// element offset of (row, 16-byte chunk c) in a tile: at Dh 64, chunk
// XOR-swizzled by the row (8 rows at one chunk hit 8 bank groups); at Dh 80
// the padded pitch does that (11 chunks a row, 11 odd)
template <int D>
__device__ __forceinline__ int swz(int row, int c) {
  if constexpr (D == 64) return row * D + ((c ^ (row & 7)) << 3);
  else return row * pitch<D>() + (c << 3);
}

// Row and chunk of the i-th 16-byte chunk of a tile of CH-chunk rows (as
// shifts at CH = 8, the Dh-64 code)
template <int CH>
__device__ __forceinline__ int row_of(int i) {
  if constexpr (CH == 8) return i >> 3;
  else return i / CH;
}
template <int CH>
__device__ __forceinline__ int chunk_of(int i) {
  if constexpr (CH == 8) return i & 7;
  else return i % CH;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2.approx: 2 ulps; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Block-wide max or sum in a fixed order (warp tree, then warps in order);
// `red` holds WARPS floats.
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// Copies rows 0..NP-1 of a group into a tile: row 0 the CLS token, rows
// 1..N frame f's tokens (t_frame + r - 1), the rest zero.
template <int D>
__device__ __forceinline__ void load_group(bf16* dst, const bf16* base, long long st,
                                           long long t_frame, int N, int NP) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < NP * CH; i += THREADS) {
    const int r = row_of<CH>(i), c = chunk_of<CH>(i);
    const bool ok = r <= N;
    const long long t = r == 0 ? 0 : t_frame + r - 1;
    cp_async16(dst + swz<D>(r, c), base + (ok ? t : 0) * st + c * 8, ok);
  }
}

// Copies frame tokens row0..row0+n_rows-1 (t_frame + row) into a tile (rows
// past N zero), by the threads [tid, tid + count).
template <int D>
__device__ __forceinline__ void load_frame(bf16* dst, const bf16* base, long long st,
                                           long long t_frame, int row0, int n_rows, int N,
                                           int tid, int count) {
  constexpr int CH = D / 8;
  for (int i = tid; i < n_rows * CH; i += count) {
    const int r = row_of<CH>(i), c = chunk_of<CH>(i);
    const bool ok = row0 + r < N;
    cp_async16(dst + swz<D>(r, c), base + (ok ? t_frame + row0 + r : 0) * st + c * 8, ok);
  }
}

// Half `half` (D / 2 values) of a D-value bf16 row in global memory, as f32.
template <int D>
__device__ __forceinline__ void load_half_row(float (&x)[D / 2], const bf16* p, int half) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + half * (D / 2) + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[c * 8 + i] = __bfloat162float(e[i]);
  }
}

// x . row r of a tile by a thread pair (half 0, half 1): each sums its D / 2
// dims in order, then the halves are added (the same bits in both). Every
// lane of the warp must call it.
template <int D>
__device__ __forceinline__ float pair_dot(const float (&x)[D / 2], const bf16* tile, int r,
                                          int half) {
  float d = 0.f;
#pragma unroll
  for (int cc = 0; cc < D / 16; ++cc) {
    const uint4 u = *reinterpret_cast<const uint4*>(tile + swz<D>(r, half * (D / 16) + cc));
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) d = fmaf(x[cc * 8 + i], __bfloat162float(e[i]), d);
  }
  return d + __shfl_xor_sync(0xffffffffu, d, 1);
}

// Weighted sum of the rows of a tile, sum_r w[r] * row r, over rows
// [0, n_rows): thread (ks = tid / 8, dc = tid % 8) takes dims dc*8..+7 of
// rows ks, ks + 16, ... (and, at Dh 80, dc < 2 also dims 64 + dc*8..+7);
// then the 16 key slots are added in a fixed order (lanes 8 and 16 apart,
// then the warps in order). Returns dim tid's sum to threads tid < D. `part`
// holds WARPS x D floats.
template <int D>
__device__ float weighted_row_sum(const float* w, const bf16* tile, int n_rows, float* part) {
  constexpr int XC = D / 8 - 8;  // chunks past the first 8
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, dc = tid & 7;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float acc2[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = tid >> 3; r < n_rows; r += THREADS / 8) {
    const float p = w[r];
    const uint4 u = *reinterpret_cast<const uint4*>(tile + swz<D>(r, dc));
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, __bfloat162float(e[i]), acc[i]);
    if constexpr (XC > 0) {
      if (dc < XC) {
        const uint4 u2 = *reinterpret_cast<const uint4*>(tile + swz<D>(r, 8 + dc));
        const bf16* e2 = reinterpret_cast<const bf16*>(&u2);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc2[i] = fmaf(p, __bfloat162float(e2[i]), acc2[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    if constexpr (XC > 0) {
      acc2[i] += __shfl_xor_sync(0xffffffffu, acc2[i], 8);
      acc2[i] += __shfl_xor_sync(0xffffffffu, acc2[i], 16);
    }
  }
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) part[warp * D + dc * 8 + i] = acc[i];
    if constexpr (XC > 0) {
      if (dc < XC) {
#pragma unroll
        for (int i = 0; i < 8; ++i) part[warp * D + 64 + dc * 8 + i] = acc2[i];
      }
    }
  }
  __syncthreads();
  float x = 0.f;
  if (tid < D) {
    x = part[tid];
#pragma unroll
    for (int ww = 1; ww < WARPS; ++ww) x += part[ww * D + tid];
  }
  __syncthreads();
  return x;
}

// A fragments of a 16 x D tile (rows 0..15 from `tile`, a multiple of 8
// rows into a tile), D / 16 k-steps.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&fa)[D / 16][4], const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(fa[kk], tile + swz<D>(lane & 15, 2 * kk + (lane >> 4)));
}

// s (one n8 tile) = 16 rows (A fragments fa) times rows row0..row0+7 of a
// tile: k-steps in pairs by ldmatrix.x4 (all loads first), and at Dh 80 the
// fifth by ldmatrix.x2.
template <int D>
__device__ __forceinline__ void product8(float (&s)[4], const uint32_t (&fa)[D / 16][4],
                                         const bf16* tile, int row0, int lane) {
  constexpr int KP = D / 32;
  s[0] = s[1] = s[2] = s[3] = 0.f;
  uint32_t b[KP][4];
#pragma unroll
  for (int p = 0; p < KP; ++p)
    ldsm_x4(b[p], tile + swz<D>(row0 + (lane & 7), 4 * p + (lane >> 3)));
  uint32_t bt[2];
  if constexpr (D % 32)
    ldsm_x2(bt, tile + swz<D>(row0 + (lane & 7), D / 8 - 2 + ((lane >> 3) & 1)));
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    mma(s, fa[2 * p], b[p][0], b[p][1]);
    mma(s, fa[2 * p + 1], b[p][2], b[p][3]);
  }
  if constexpr (D % 32) mma(s, fa[D / 16 - 1], bt[0], bt[1]);
}

// ---------------------------------------------------------------- forward

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;    // (B, H, T) or null
  float* logit;   // (B, H, T4), T4 = T rounded up to 4: the CLS query's logits
  float* part;    // (B, H, F, Dh): the CLS row's P V over one frame's keys
  unsigned* ctr;  // zeroed: [0] units started, then per (b, h) frames whose
                  // logits are out, then per (b, h) CLS partials written
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh;
  int B, T, H, F, N, split, tiles_per_block;
};

// S = Q K^T for one warp's 16 query rows (A fragments qa) against NP = 16*KT
// keys of the tile Ks.
template <int D, int KT>
__device__ __forceinline__ void qk_tile(float (&s)[2 * KT][4], const uint32_t (&qa)[D / 16][4],
                                        const bf16* Ks, int lane) {
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) product8<D>(s[j], qa, Ks, j * 8, lane);
}

// Writes a warp's 16 x D f32 tile (C layout, D / 8 n-tiles) as bf16 rows of
// dst (row stride st) through the warp's staging tile, as 16-byte stores;
// rows >= n_valid are not stored.
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4], bf16* stage, bf16* dst,
                                           long long st, int n_valid, int lane) {
  constexpr int CH = D / 8;
  const int r0 = lane >> 2, q4 = lane & 3;
  __syncwarp();
#pragma unroll
  for (int d = 0; d < CH; ++d) {
    *reinterpret_cast<uint32_t*>(stage + swz<D>(r0, d) + 2 * q4) = pack_bf16(o[d][0], o[d][1]);
    *reinterpret_cast<uint32_t*>(stage + swz<D>(r0 + 8, d) + 2 * q4) =
        pack_bf16(o[d][2], o[d][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = row_of<CH>(i), c = chunk_of<CH>(i);
    if (r < n_valid)
      *reinterpret_cast<uint4*>(dst + r * st + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(r, c));
  }
  __syncwarp();
}

// ld.acquire of a counter another block adds to
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The CLS row of (b, h) over frame f's keys (and the CLS key, f = 0), unit i
// = bh * F + f: once every frame's logits are written, the exact softmax
// statistics over all T logits, p = bf16(e / sum) of those keys and their
// P V; the last of the F units adds the partials in frame order.
template <int D, int NP>
__device__ void cls_unit(const FwdArgs& a, int i, unsigned char* smem) {
  const int f = i % a.F, bh = i / a.F, b = bh / a.H, h = bh % a.H;
  const int T = a.T, T4 = (T + 3) & ~3, N = a.N, tid = threadIdx.x;
  bf16* Vs = reinterpret_cast<bf16*>(smem);
  float* lg = reinterpret_cast<float*>(Vs + NP * pitch<D>());  // the T logits
  float* w = lg + T4;
  float* red = w + NP;
  float* part = red + 2 * WARPS;
  int* last = reinterpret_cast<int*>(part + WARPS * D);
  const long long t_frame = 1 + (long long)f * N;
  load_group<D>(Vs, a.v + b * a.vsb + h * a.vsh, a.vst, t_frame, N, NP);
  cp_async_commit();
  // the F frames' logits come from units that started before this one
  if (tid == 0)
    while (load_acquire(a.ctr + 1 + bh) < (unsigned)a.F) __nanosleep(128);
  __syncthreads();
  const float* lrow = a.logit + (long long)bh * T4;
  for (int j = 4 * tid; j < T4; j += 4 * THREADS) cp_async16(lg + j, lrow + j, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float m = -INFINITY;
  for (int j = tid; j < T; j += THREADS) m = fmaxf(m, lg[j]);
  m = block_reduce(m, red, true);
  const float mb = m * LOG2E;
  float l = 0.f;
  for (int j = tid; j < T; j += THREADS) l += ex2(fmaf(lg[j], LOG2E, -mb));
  l = block_reduce(l, red + WARPS, false);
  const float inv = __frcp_rn(l);
  for (int r = tid; r < NP; r += THREADS) {
    const bool ok = r <= N && (r > 0 || f == 0);
    w[r] = ok ? bf16_round(ex2(fmaf(lg[r ? t_frame + r - 1 : 0], LOG2E, -mb)) * inv) : 0.f;
  }
  if (a.lse && f == 0 && tid == 0) a.lse[(long long)bh * T] = m + logf(l);
  __syncthreads();
  const float x = weighted_row_sum<D>(w, Vs, N + 1, part);
  float* pf = a.part + (long long)bh * a.F * D;
  if (tid < D) pf[f * D + tid] = x;
  __threadfence();
  __syncthreads();
  unsigned* ticket = a.ctr + 1 + a.B * a.H + bh;
  if (tid == 0) *last = atomicAdd(ticket, 1u) == (unsigned)a.F - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (tid < D / 2) {
    float x0 = 0.f, x1 = 0.f;
    for (int ff = 0; ff < a.F; ++ff) {
      const float2 u = __ldcg(reinterpret_cast<const float2*>(pf + ff * D) + tid);
      x0 += u.x;
      x1 += u.y;
    }
    *reinterpret_cast<uint32_t*>(a.o + b * a.osb + h * a.osh + 2 * tid) = pack_bf16(x0, x1);
  }
}

// Units in the order their blocks started (a counter, not blockIdx): first
// B*H*F*split frame-group units, then B*H*F CLS units, which wait only for
// units that started before them.
// Resident blocks per SM (__launch_bounds__): 3 at Dh 64 up to 256 keys,
// else 2 (shared memory, and S's 8*KT registers a thread).
template <int D, int KT>
__global__ void __launch_bounds__(THREADS, (D == 64 && KT <= 16) ? 3 : 2)
    space_attention_kernel(const FwdArgs a) {
  constexpr int NP = 16 * KT, P = pitch<D>(), KS = D / 16, CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int unit;
  if (threadIdx.x == 0) unit = (int)atomicAdd(a.ctr, 1u);
  __syncthreads();
  const int n_group_units = a.B * a.H * a.F * a.split;
  if (unit >= n_group_units) {
    cls_unit<D, NP>(a, unit - n_group_units, smem);
    return;
  }
  int i = unit;
  const int sp = i % a.split;
  i /= a.split;
  const int f = i % a.F;
  i /= a.F;
  const int h = i % a.H, b = i / a.H;
  const int N = a.N, n_qt = (N + 15) / 16;
  const int qt1 = min(n_qt, (sp + 1) * a.tiles_per_block);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, r0 = lane >> 2, q4 = lane & 3;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * P;
  bf16* Qs = Vs + NP * P + warp * 16 * P;  // the warp's Q tile, then its O staging
  const long long t_frame = 1 + (long long)f * N;
  const long long bh = (long long)b * a.H + h;
  const bf16* qb = a.q + b * a.qsb + h * a.qsh;
  // K and the warps' first Q tiles in one commit group, V in the next: the
  // first S = Q K^T and its softmax run while V lands
  const int qt0 = sp * a.tiles_per_block;
  load_group<D>(Ks, a.k + b * a.ksb + h * a.ksh, a.kst, t_frame, N, NP);
  if (qt0 + warp < qt1)
    load_frame<D>(Qs, qb, a.qst, t_frame, (qt0 + warp) * 16, 16, N, lane, 32);
  cp_async_commit();
  load_group<D>(Vs, a.v + b * a.vsb + h * a.vsh, a.vst, t_frame, N, NP);
  cp_async_commit();
  // the group's last block (it has the fewest tiles) writes the CLS query's
  // logits against the group's keys
  const bool cls_logits = sp == a.split - 1;
  const int half = tid & 1;
  float qv[D / 2];
  if (cls_logits) load_half_row<D>(qv, qb, half);
  cp_async_wait<1>();
  __syncthreads();
  if (cls_logits) {
    for (int rb = 0; rb <= N; rb += THREADS / 2) {
      const int r = rb + (tid >> 1);
      const float d = pair_dot<D>(qv, Ks, min(r, NP - 1), half);
      if (!half && r <= N && (r > 0 || f == 0))
        a.logit[bh * ((a.T + 3) & ~3) + (r ? t_frame + r - 1 : 0)] = d;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(a.ctr + 1 + bh, 1u);  // this frame's logits are out
  }

  bf16* ob = a.o + b * a.osb + h * a.osh + t_frame * a.ost;
  const int rounds = (qt1 - qt0 + WARPS - 1) / WARPS;  // the same for every warp
#pragma unroll 1
  for (int it = 0; it < rounds; ++it) {
    const int qt = qt0 + it * WARPS + warp, row = qt * 16;
    const bool has_tile = qt < qt1;
    uint32_t pp[KT][4];  // p = bf16(e / sum), the A fragments of P V
    float m0 = 0.f, m1 = 0.f, l0 = 1.f, l1 = 1.f;
    if (has_tile) {
      uint32_t qa[KS][4];
      load_a<D>(qa, Qs, lane);
      float s[2 * KT][4];
      qk_tile<D, KT>(s, qa, Ks, lane);

      // padded keys (> N) to -inf, then max, exp, sum in f32 over the quad
      m0 = m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        if (j * 8 + 7 > N) {  // the n-tiles that hold padded keys
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j * 8 + 2 * q4 + e > N) s[j][e] = s[j][2 + e] = -INFINITY;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m0 = fmaxf(m0, s[j][e]);
          m1 = fmaxf(m1, s[j][2 + e]);
        }
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      const float mb0 = m0 * LOG2E, mb1 = m1 * LOG2E;
      l0 = l1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = ex2(fmaf(s[j][e], LOG2E, -mb0));
          s[j][2 + e] = ex2(fmaf(s[j][2 + e], LOG2E, -mb1));
          l0 += s[j][e];
          l1 += s[j][2 + e];
        }
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float i0 = __frcp_rn(l0), i1 = __frcp_rn(l1);
      // C layout of S = A layout of P: n-tiles 2kk, 2kk + 1 are k-step kk
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        pp[kk][0] = pack_bf16(s[2 * kk][0] * i0, s[2 * kk][1] * i0);
        pp[kk][1] = pack_bf16(s[2 * kk][2] * i1, s[2 * kk][3] * i1);
        pp[kk][2] = pack_bf16(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0);
        pp[kk][3] = pack_bf16(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1);
      }
    }
    if (it == 0) {  // V landed, for every warp
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!has_tile) continue;

    float o[CH][4];
#pragma unroll
    for (int d = 0; d < CH; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + swz<D>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  2 * dp + (lane >> 4)));
        mma(o[2 * dp], pp[kk], vb[0], vb[1]);
        mma(o[2 * dp + 1], pp[kk], vb[2], vb[3]);
      }
    }
    store_rows<D>(o, Qs, ob + row * a.ost, a.ost, N - row, lane);
    if (a.lse && q4 == 0) {
      float* lse = a.lse + bh * a.T + t_frame + row;
      if (row + r0 < N) lse[r0] = m0 + logf(l0);
      if (row + r0 + 8 < N) lse[r0 + 8] = m1 + logf(l1);
    }
    if (qt + WARPS < qt1) {
      load_frame<D>(Qs, qb, a.qst, t_frame, (qt + WARPS) * 16, 16, N, lane, 32);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
    }
  }
}

template <int D>
size_t group_smem(int KT) {
  return (size_t)(2 * 16 * KT + WARPS * 16) * pitch<D>() * 2;
}
template <int D>
size_t cls_smem(int NP, int T) {
  return (size_t)NP * pitch<D>() * 2 +
         (size_t)(((T + 3) & ~3) + NP + 2 * WARPS + WARPS * D + 1) * 4;
}

// Raises a kernel's dynamic shared memory ceiling once per device to the
// largest size asked for yet, not per call; `set_to` is that kernel's own.
template <typename Kernel>
cudaError_t smem_ceiling(Kernel* kernel, size_t bytes, size_t (&set_to)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (bytes > set_to[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    set_to[dev] = bytes;
  }
  return cudaSuccess;
}

// The forward kernel's shared memory for T tokens, and its ceiling raised to
// it (once per device).
template <int D, int KT>
cudaError_t fwd_smem(int T, size_t* smem) {
  static size_t set_to[64] = {};
  const size_t g = group_smem<D>(KT), c = cls_smem<D>(16 * KT, T);
  *smem = g > c ? g : c;
  return smem_ceiling(space_attention_kernel<D, KT>, *smem, set_to);
}

// Calls fn(std::integral_constant<int, Dh>(), std::integral_constant<int,
// K>()) for the instantiation that serves head dim Dh and KT key tiles: K =
// 13 (N + 1 = 197 keys at 224² / patch 16) takes every group of at most 208
// keys, its padded keys masked; K = 16 those up to 256; K = 17 those up to
// 272 (257 keys at 224² / patch 14 and 256² / patch 16).
template <typename Fn>
int with_shape(int Dh, int KT, Fn fn) {
  auto kt = [&](auto d) {
    if (KT <= 13) return fn(d, std::integral_constant<int, 13>());
    if (KT <= 16) return fn(d, std::integral_constant<int, 16>());
    return fn(d, std::integral_constant<int, 17>());
  };
  if (Dh == 64) return kt(std::integral_constant<int, 64>());
  return kt(std::integral_constant<int, 80>());
}

template <int D, int KT>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t e = fwd_smem<D, KT>(a.T, &smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(a.ctr, 0, (1 + 2 * (size_t)a.B * a.H) * sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned groups = (unsigned)(a.B * a.H * a.F);
  space_attention_kernel<D, KT><<<groups * (a.split + 1), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;  // (B, H, T)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* p_cls;   // (B, H, T): P of the CLS query over every key
  float* dp_cls;  // (B, H, T): dP of the CLS query
  float* part;    // (B, H, F, 3, Dh): the CLS row's dq, the CLS key's dk, dv over one frame
  float* term;    // (B, H, 2): dS and bf16(P) of the CLS query at the CLS key
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh, gsb, gst, gsh;
  int B, T, H, F, N;
};

// The CLS query of (b, h) against frame f's keys (and the CLS key, f = 0):
// P = exp(s - lse) and dP = dO.v, to the workspace.
template <int D>
__global__ void __launch_bounds__(THREADS) space_attention_cls_bwd_kernel(const BwdArgs a,
                                                                         int NP) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f = blockIdx.x % a.F, bh = blockIdx.x / a.F, b = bh / a.H, h = bh % a.H;
  const int N = a.N, tid = threadIdx.x, half = tid & 1;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * pitch<D>();
  const long long t_frame = 1 + (long long)f * N, row = (long long)bh * a.T;
  load_group<D>(Ks, a.k + b * a.ksb + h * a.ksh, a.kst, t_frame, N, NP);
  load_group<D>(Vs, a.v + b * a.vsb + h * a.vsh, a.vst, t_frame, N, NP);
  cp_async_commit();
  float qv[D / 2], gv[D / 2];
  load_half_row<D>(qv, a.q + b * a.qsb + h * a.qsh, half);
  load_half_row<D>(gv, a.dout + b * a.dsb + h * a.dsh, half);
  const float lb = a.lse[row] * LOG2E;
  cp_async_wait<0>();
  __syncthreads();
  for (int rb = 0; rb <= N; rb += THREADS / 2) {
    const int r = rb + (tid >> 1), rr = min(r, NP - 1);
    const float s = pair_dot<D>(qv, Ks, rr, half);
    const float dp = pair_dot<D>(gv, Vs, rr, half);
    if (!half && r <= N && (r > 0 || f == 0)) {
      const long long t = row + (r ? t_frame + r - 1 : 0);
      a.p_cls[t] = ex2(fmaf(s, LOG2E, -lb));
      a.dp_cls[t] = dp;
    }
  }
}

// S (or dP) of 16 rows (A fragments fa) against the 16 rows r0.. of a
// tile, as two n8 tiles, in qk_tile's k-step order.
template <int D>
__device__ __forceinline__ void product16(float (&s)[2][4], const uint32_t (&fa)[D / 16][4],
                                          const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) product8<D>(s[j], fa, tile, r0 + j * 8, lane);
}

// acc (16 x D) += x (16 x 16 in the C layout, packed to bf16 A fragments)
// times rows r0..r0+15 of a tile (by ldmatrix.trans).
template <int D>
__device__ __forceinline__ void accumulate16(float (&acc)[D / 8][4], const float (&x)[2][4],
                                             const bf16* tile, int r0, int lane) {
  const uint32_t fa[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[0][2], x[0][3]),
                          pack_bf16(x[1][0], x[1][1]), pack_bf16(x[1][2], x[1][3])};
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t fb[4];
    ldsm_x4_t(fb, tile + swz<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * dp + (lane >> 4)));
    mma(acc[2 * dp], fa, fb[0], fb[1]);
    mma(acc[2 * dp + 1], fa, fb[2], fb[3]);
  }
}

// Rows r (< 16, the C layout of acc) as bf16 pairs to dst (row stride st);
// rows >= n_valid are not stored.
template <int D>
__device__ __forceinline__ void store_pairs(const float (&acc)[D / 8][4], bf16* dst,
                                            long long st, int n_valid, int lane) {
  const int r0 = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    if (r0 < n_valid)
      *reinterpret_cast<uint32_t*>(dst + r0 * st + d * 8 + 2 * q4) =
          pack_bf16(acc[d][0], acc[d][1]);
    if (r0 + 8 < n_valid)
      *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * st + d * 8 + 2 * q4) =
          pack_bf16(acc[d][2], acc[d][3]);
  }
}

template <int D>
size_t bwd_smem(int N) {
  const int nq = (N + 15) / 16 * 16, np = (N + 1 + 15) / 16 * 16;
  return (size_t)(2 * nq + 2 * np) * pitch<D>() * 2 +
         (size_t)(2 * nq + 2 * np + 2 * WARPS + WARPS * D) * 4;
}

// One (frame, head, batch) group: dq of its N queries, dk and dv of its N
// frame keys (with the CLS query's share), the CLS key's partial, and the
// CLS row's dq over its keys.
template <int D>
__global__ void __launch_bounds__(THREADS, 2) space_attention_bwd_kernel(const BwdArgs a) {
  constexpr int P = pitch<D>(), KS = D / 16, CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  int i = blockIdx.x;
  const int f = i % a.F;
  i /= a.F;
  const int h = i % a.H, b = i / a.H;
  const int N = a.N, n_qt = (N + 15) / 16, NQ = n_qt * 16, n_kt = (N + 1 + 15) / 16;
  const int NP = n_kt * 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, r0 = lane >> 2, q4 = lane & 3;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + NQ * P;  // dO
  bf16* Ks = Gs + NQ * P;
  bf16* Vs = Ks + NP * P;
  float* lse_s = reinterpret_cast<float*>(Vs + NP * P);
  float* D_s = lse_s + NQ;
  float* wk = D_s + NQ;  // the CLS query's dS over this group's keys
  float* wv = wk + NP;   // and its bf16(P)
  float* red = wv + NP;
  float* part = red + 2 * WARPS;
  const long long t_frame = 1 + (long long)f * N;
  const long long bh = (long long)b * a.H + h, row = bh * a.T;
  load_frame<D>(Qs, a.q + b * a.qsb + h * a.qsh, a.qst, t_frame, 0, NQ, N, tid, THREADS);
  load_frame<D>(Gs, a.dout + b * a.dsb + h * a.dsh, a.dst, t_frame, 0, NQ, N, tid, THREADS);
  load_group<D>(Ks, a.k + b * a.ksb + h * a.ksh, a.kst, t_frame, N, NP);
  load_group<D>(Vs, a.v + b * a.vsb + h * a.vsh, a.vst, t_frame, N, NP);
  cp_async_commit();
  for (int r = tid; r < NQ; r += THREADS) lse_s[r] = r < N ? a.lse[row + t_frame + r] : 0.f;

  // the CLS row's D over all T keys, then its dS and bf16(P) over this
  // group's keys (row 0, the CLS key, in the dq partial only for f = 0)
  float dsum = 0.f;
  for (int j = tid; j < a.T; j += THREADS) dsum = fmaf(a.p_cls[row + j], a.dp_cls[row + j], dsum);
  const float D_cls = block_reduce(dsum, red, false);
  for (int r = tid; r < NP; r += THREADS) {
    const bool ok = r <= N && (r > 0 || f == 0);
    const long long t = row + (r ? t_frame + r - 1 : 0);
    const float p = ok ? a.p_cls[t] : 0.f;
    wk[r] = ok ? p * (a.dp_cls[t] - D_cls) : 0.f;
    wv[r] = bf16_round(p);
    if (f == 0 && r == 0) {
      a.term[bh * 2] = wk[0];
      a.term[bh * 2 + 1] = wv[0];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const float dq_cls = weighted_row_sum<D>(wk, Ks, N + 1, part);
  float* pf = a.part + (bh * a.F + f) * 3 * D;
  if (tid < D) pf[tid] = dq_cls;

  // phase 1: per 16-query tile, D over the keys, then dS and dq = dS K
#pragma unroll 1
  for (int qt = warp; qt < n_qt; qt += WARPS) {
    uint32_t qa[KS][4], ga[KS][4];
    load_a<D>(qa, Qs + qt * 16 * P, lane);
    load_a<D>(ga, Gs + qt * 16 * P, lane);
    const float l0 = lse_s[qt * 16 + r0] * LOG2E, l1 = lse_s[qt * 16 + r0 + 8] * LOG2E;
    float d0 = 0.f, d1 = 0.f;
    float s[2][4], dp[2][4];
#pragma unroll 2
    for (int kc = 0; kc < n_kt; ++kc) {
      product16<D>(s, qa, Ks, kc * 16, lane);
      product16<D>(dp, ga, Vs, kc * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kc * 16 + j * 8 + 2 * q4 + e <= N) {
            d0 = fmaf(ex2(fmaf(s[j][e], LOG2E, -l0)), dp[j][e], d0);
            d1 = fmaf(ex2(fmaf(s[j][2 + e], LOG2E, -l1)), dp[j][2 + e], d1);
          }
        }
      }
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    float dq[CH][4];
#pragma unroll
    for (int d = 0; d < CH; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
#pragma unroll 2
    for (int kc = 0; kc < n_kt; ++kc) {
      product16<D>(s, qa, Ks, kc * 16, lane);
      product16<D>(dp, ga, Vs, kc * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = kc * 16 + j * 8 + 2 * q4 + e <= N;
          s[j][e] = ok ? ex2(fmaf(s[j][e], LOG2E, -l0)) * (dp[j][e] - d0) : 0.f;
          s[j][2 + e] = ok ? ex2(fmaf(s[j][2 + e], LOG2E, -l1)) * (dp[j][2 + e] - d1) : 0.f;
        }
      }
      accumulate16<D>(dq, s, Ks, kc * 16, lane);
    }
    const int q0 = qt * 16;
    store_pairs<D>(dq, a.dq + b * a.gsb + h * a.gsh + (t_frame + q0) * a.gst, a.gst, N - q0,
                   lane);
    if (q4 == 0) {
      D_s[q0 + r0] = d0;
      D_s[q0 + r0 + 8] = d1;
    }
  }
  __syncthreads();

  // phase 2: per 16-key tile, walk the queries: dk = dS^T Q, dv = bf16(P)^T dO
  const bf16* qcls = a.q + b * a.qsb + h * a.qsh;
  const bf16* gcls = a.dout + b * a.dsb + h * a.dsh;
#pragma unroll 1
  for (int kt = warp; kt < n_kt; kt += WARPS) {
    uint32_t ka[KS][4], va[KS][4];
    load_a<D>(ka, Ks + kt * 16 * P, lane);
    load_a<D>(va, Vs + kt * 16 * P, lane);
    float dk[CH][4], dv[CH][4];
#pragma unroll
    for (int d = 0; d < CH; ++d) {
      dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
      dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
    }
#pragma unroll 2
    for (int qc = 0; qc < n_qt; ++qc) {
      float st[2][4], dpt[2][4], pt[2][4];
      product16<D>(st, ka, Qs, qc * 16, lane);
      product16<D>(dpt, va, Gs, qc * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qc * 16 + j * 8 + 2 * q4 + e;  // the query of this column
          const bool ok = qi < N;
          const float lb = lse_s[qi] * LOG2E, Dq = D_s[qi];
          const float p0 = ok ? ex2(fmaf(st[j][e], LOG2E, -lb)) : 0.f;
          const float p1 = ok ? ex2(fmaf(st[j][2 + e], LOG2E, -lb)) : 0.f;
          pt[j][e] = p0;
          pt[j][2 + e] = p1;
          st[j][e] = p0 * (dpt[j][e] - Dq);
          st[j][2 + e] = p1 * (dpt[j][2 + e] - Dq);
        }
      }
      accumulate16<D>(dk, st, Qs, qc * 16, lane);
      accumulate16<D>(dv, pt, Gs, qc * 16, lane);
    }
    // key rows kt*16 + r: row 0 the CLS key (a partial), 1..N frame keys
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kr = kt * 16 + r0 + hr * 8;
      if (kr > N) continue;
      if (kr == 0) {
#pragma unroll
        for (int d = 0; d < CH; ++d) {
          *reinterpret_cast<float2*>(pf + D + d * 8 + 2 * q4) = make_float2(dk[d][0], dk[d][1]);
          *reinterpret_cast<float2*>(pf + 2 * D + d * 8 + 2 * q4) =
              make_float2(dv[d][0], dv[d][1]);
        }
        continue;
      }
      // a frame key: add the CLS query's share, dS_cls q_cls and bf16(P_cls) dO_cls
      const float sk = wk[kr], sv = wv[kr];
      const long long go = b * a.gsb + h * a.gsh + (t_frame + kr - 1) * a.gst;
#pragma unroll
      for (int d = 0; d < CH; ++d) {
        const int col = d * 8 + 2 * q4;
        const float2 qf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qcls + col));
        const float2 gf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gcls + col));
        *reinterpret_cast<uint32_t*>(a.dk + go + col) =
            pack_bf16(fmaf(sk, qf.x, dk[d][2 * hr]), fmaf(sk, qf.y, dk[d][2 * hr + 1]));
        *reinterpret_cast<uint32_t*>(a.dv + go + col) =
            pack_bf16(fmaf(sv, gf.x, dv[d][2 * hr]), fmaf(sv, gf.y, dv[d][2 * hr + 1]));
      }
    }
  }
}

// The CLS row's dq and the CLS key's dk, dv of one (b, h): the F frame
// partials in frame order, then the CLS row's own term at the CLS key. One
// thread per column pair (D / 2 threads).
template <int D>
__global__ void __launch_bounds__(D / 2) space_attention_cls_key_kernel(const BwdArgs a) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, col = 2 * threadIdx.x;
  const float* pf = a.part + (long long)blockIdx.x * a.F * 3 * D;
  float acc[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  for (int f = 0; f < a.F; ++f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 u = *reinterpret_cast<const float2*>(pf + (f * 3 + c) * D + col);
      acc[c][0] += u.x;
      acc[c][1] += u.y;
    }
  }
  const float sk = a.term[blockIdx.x * 2], sv = a.term[blockIdx.x * 2 + 1];
  const float2 qf = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(a.q + b * a.qsb + h * a.qsh + col));
  const float2 gf = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(a.dout + b * a.dsb + h * a.dsh + col));
  const long long go = b * a.gsb + h * a.gsh + col;
  *reinterpret_cast<uint32_t*>(a.dq + go) = pack_bf16(acc[0][0], acc[0][1]);
  *reinterpret_cast<uint32_t*>(a.dk + go) =
      pack_bf16(fmaf(sk, qf.x, acc[1][0]), fmaf(sk, qf.y, acc[1][1]));
  *reinterpret_cast<uint32_t*>(a.dv + go) =
      pack_bf16(fmaf(sv, gf.x, acc[2][0]), fmaf(sv, gf.y, acc[2][1]));
}

template <int D>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  static size_t set_cls[64] = {}, set_grp[64] = {};
  const int NP = (a.N + 1 + 15) / 16 * 16;
  const size_t smem_cls = (size_t)2 * NP * pitch<D>() * 2, smem_grp = bwd_smem<D>(a.N);
  cudaError_t e = smem_ceiling(space_attention_cls_bwd_kernel<D>, smem_cls, set_cls);
  if (e == cudaSuccess) e = smem_ceiling(space_attention_bwd_kernel<D>, smem_grp, set_grp);
  if (e != cudaSuccess) return (int)e;
  const unsigned bh = (unsigned)(a.B * a.H);
  space_attention_cls_bwd_kernel<D><<<bh * a.F, THREADS, smem_cls, stream>>>(a, NP);
  space_attention_bwd_kernel<D><<<bh * a.F, THREADS, smem_grp, stream>>>(a);
  space_attention_cls_key_kernel<D><<<bh, D / 2, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

bool valid_shape(int T, int F, int Dh) {
  if ((Dh != 64 && Dh != 80) || F < 1 || (T - 1) % F) return false;
  const int N = (T - 1) / F;
  return N >= 1 && N + 1 <= 16 * MAX_KT;
}

}  // namespace

// The most tokens T whose CLS logits fit a CLS unit's shared memory (with
// the largest group, N + 1 = 272, at the widest head, Dh 80).
extern "C" int space_attention_max_tokens() {
  return (int)((232448 - cls_smem<80>(16 * MAX_KT, 0)) / 4) / 4 * 4;
}

// Forward. q, k, v, o: (B, T, H, Dh) bf16, Dh = head_dim (64 or 80), with
// the given element strides (last dim contiguous, 16-byte aligned rows); lse
// (B, H, T) f32 or null; ws f32 of B*H*(T4 + F*Dh) (T4 = T rounded up to 4)
// then 1 + 2*B*H ints, 16-byte aligned. T = 1 + F*N with N + 1 <= 272; the
// CLS row's shared memory holds the T logits (the wrapper refuses T past
// space_attention_max_tokens). `split` blocks share each frame group's
// ceil(N / 16) query tiles. Returns cudaGetLastError() after the memset and
// the launch.
extern "C" int space_attention_fwd_bf16_hd(const void* q, const void* k, const void* v, void* o,
                                           void* lse, void* ws, long long qsb, long long qst,
                                           long long qsh, long long ksb, long long kst,
                                           long long ksh, long long vsb, long long vst,
                                           long long vsh, long long osb, long long ost,
                                           long long osh, int B, int T, int H, int F,
                                           int split, int head_dim, void* stream) {
  if (!valid_shape(T, F, head_dim) || split < 1) return (int)cudaErrorInvalidValue;
  if (T > space_attention_max_tokens()) return (int)cudaErrorInvalidValue;
  const int N = (T - 1) / F;
  const int KT = (N + 1 + 15) / 16;
  const int n_qt = (N + 15) / 16;
  const int per = (n_qt + split - 1) / split;  // tiles per block; no block without one
  float* w = static_cast<float*>(ws);
  const long long bht = (long long)B * H * ((T + 3) & ~3);
  FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
            w, w + bht, reinterpret_cast<unsigned*>(w + bht + (long long)B * H * F * head_dim),
            qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh,
            B, T, H, F, N, (n_qt + per - 1) / per, per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_shape(head_dim, KT, [&](auto d, auto kt) {
    return launch_fwd<decltype(d)::value, decltype(kt)::value>(a, s);
  });
}

// The Dh-64 forward under its earlier C interface (no head_dim argument).
extern "C" int space_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, void* ws, long long qsb, long long qst,
                                        long long qsh, long long ksb, long long kst,
                                        long long ksh, long long vsb, long long vst,
                                        long long vsh, long long osb, long long ost,
                                        long long osh, int B, int T, int H, int F, int split,
                                        void* stream) {
  return space_attention_fwd_bf16_hd(q, k, v, o, lse, ws, qsb, qst, qsh, ksb, kst, ksh, vsb,
                                     vst, vsh, osb, ost, osh, B, T, H, F, split, 64, stream);
}

// The forward kernel's blocks resident on one SM, and its shared memory per
// block, for T = 1 + F*N tokens at head dim Dh (registers and shared memory
// as launched).
extern "C" int space_attention_fwd_occupancy_hd(int T, int F, int head_dim, int* blocks_per_sm,
                                                int* smem_bytes) {
  if (!valid_shape(T, F, head_dim)) return (int)cudaErrorInvalidValue;
  const int N = (T - 1) / F, KT = (N + 1 + 15) / 16;
  return with_shape(head_dim, KT, [&](auto d, auto kt) {
    constexpr int D = decltype(d)::value, K = decltype(kt)::value;
    size_t smem = 0;
    cudaError_t e = fwd_smem<D, K>(T, &smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, space_attention_kernel<D, K>, THREADS, smem);
    *smem_bytes = (int)smem;
    return (int)e;
  });
}

// Backward, from the forward's lse: q, k, v, dout (B, T, H, Dh) bf16, Dh =
// head_dim, by their element strides; dq, dk, dv (B, T, H, Dh) bf16 with one
// set of strides; ws f32 of B*H*(2*T + 3*F*Dh + 2) elements. Returns
// cudaGetLastError() after the three launches.
extern "C" int space_attention_bwd_bf16_hd(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, void* dq,
                                           void* dk, void* dv, void* ws, long long qsb,
                                           long long qst, long long qsh, long long ksb,
                                           long long kst, long long ksh, long long vsb,
                                           long long vst, long long vsh, long long dsb,
                                           long long dst, long long dsh, long long gsb,
                                           long long gst, long long gsh, int B, int T, int H,
                                           int F, int head_dim, void* stream) {
  if (!valid_shape(T, F, head_dim)) return (int)cudaErrorInvalidValue;
  const int N = (T - 1) / F;
  float* w = static_cast<float*>(ws);
  const long long bht = (long long)B * H * T;
  BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
            static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), w, w + bht, w + 2 * bht,
            w + 2 * bht + (long long)B * H * F * 3 * head_dim,
            qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh, gsb, gst, gsh,
            B, T, H, F, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? launch_bwd<64>(a, s) : launch_bwd<80>(a, s);
}

// The Dh-64 backward under its earlier C interface (no head_dim argument).
extern "C" int space_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, void* dq, void* dk,
                                        void* dv, void* ws, long long qsb, long long qst,
                                        long long qsh, long long ksb, long long kst,
                                        long long ksh, long long vsb, long long vst,
                                        long long vsh, long long dsb, long long dst,
                                        long long dsh, long long gsb, long long gst,
                                        long long gsh, int B, int T, int H, int F,
                                        void* stream) {
  return space_attention_bwd_bf16_hd(q, k, v, dout, lse, dq, dk, dv, ws, qsb, qst, qsh, ksb,
                                     kst, ksh, vsb, vst, vsh, dsb, dst, dsh, gsb, gst, gsh, B,
                                     T, H, F, 64, stream);
}

extern "C" const char* oatx_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
