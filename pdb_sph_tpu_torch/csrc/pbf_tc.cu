// The tensor-core forms of the two pair kernels, for Hopper (sm_90a).
//
// density_tc_kernel<kRd2Mma, kSumMma> replaces the `mxu_rd2` branch of the
// TPU kernel `_density_kernel` (pdb_sph_tpu/ops/pallas_pbf.py:445-455) and
// `_ksum`'s `mxu_sum` row reduction (:318-326) in its epilogue;
// project_tc_kernel<kProjMma, kSumMma> replaces `_project_kernel_mxu`
// (:525-582) and `_project_kernel` with `mxu_sum` (:477-523). The FP32 forms
// stay in pbf_window.cu; ops/cuda_pbf.py picks these when a switch of the
// pass is on in the geometry.
//
// Work split. pair_items.cuh schedules the work as for the FP32 kernels:
// items of at most `seg_len` candidates of one chunk on a persistent grid
// of four-warp blocks, raw float4 candidate rows through the bulk-copy
// ring, the chunk's item sums added in segment order. An item's partial is
// one float4 per own row: (s_rho, s_g2) for density, (S, acc_p x, y, z)
// with the hi.lo columns already folded in for kProjMma, (sx, sy, sz) for
// the kSumMma-only project. lambda, or the moved position, is formed once
// from the combined sums. Inside a block, the warps split the own rows into
// m16 tiles, the rows of an m16n8k16 `mma.sync` (in its accumulator
// fragment each thread holds rows g and g + 8, g = lane / 4, and candidate
// columns 2t and 2t + 1, t = lane % 4, of an 8-candidate tile);
// kColGroups of them split each staged tile's candidates instead, and
// their sums are the combine's groups, added in warp order.
//
// Staging. The rd2 and delta-p forms convert each arrived tile in shared
// memory into fragment planes: each candidate's bf16 hi/lo split, its rd2
// operand words, its float32 |c|^2 and lambda, computed once per (item,
// candidate), ~30 operations against ~own x 15 of pair work that they
// feed. The planes are padded so that the eight candidates and four words
// of a fragment fall on 32 banks. The kSumMma-only forms read the raw rows
// from the ring.
//
// rd2 on the tensor cores. The three products of `_dot3`
// (hi.hi + hi.lo + lo.hi) fit one k16 mma: A row i is
// [oh, oh, ol, 0...] and B column j is [ch, cl, ch, 0...] over (x, y, z), so
// one instruction gives the split dot in float32; A stays in registers for
// the item. |o|^2 and |c|^2 stay float32 on the CUDA cores, and rd2 =
// (|o|^2 - (dot + dot)) + |c|^2 keeps JAX's association.
//
// Per-pair terms in the accumulator layout. The clamp, rsqrt and the density
// terms (or project's s) run on the CUDA cores on the four elements each
// thread holds, and accumulate element-wise across the item's tiles, like
// the TPU's (OWN, CC) accumulators; the item's end reduces each thread's
// (row, column) sums to row sums.
//
// Row sums. Without kSumMma: quad shuffles. With kSumMma (`_ksum`'s
// Precision.HIGHEST matvec): one mma pair against an exact all-ones B, with
// each float32 sum split into three bf16 pieces (hi, mid, lo: all 24
// mantissa bits), so the products are exact and only the tensor core's
// float32 accumulation rounds. A one-piece bf16 row sum would be the TPU's
// precision fault over again.
//
// delta-p on the tensor cores (kProjMma): the FlashAttention-2 register
// reuse. The accumulator fragments of two adjacent 8-candidate tiles are
// exactly the A fragment of a k16 product over those 16 candidates, so s is
// split into bf16 sh/sl in registers and multiplied with B = the
// candidates' [ch | cl] (one mma) and [ch | 0] (a second), accumulating
// sh.ch + sl.ch in columns 0-2 and sh.cl in columns 3-5 over a staged
// tile. Each tile's product is added into the item's sums in float32 on
// the CUDA cores: kept in one mma accumulator over a whole chunk, the
// tensor core's rounding of the running sum put the positions up to
// 2.9e-6 from the plain version's (80k dam break, step 60, NVIDIA H100
// 80GB HBM3 at 700 W), the per-round sums 7.2e-7. The item's end adds the
// hi.lo columns into the hi.hi ones; the finish forms own3 + k * (own3 * S
// - acc_p), lambda carried through in column 3.
//
// The ragged tail. A converted tile is zero-filled up to the next multiple
// of 16 candidates, so no stale shared memory can be NaN, and every term of
// a column at or past the tile's count is masked to exactly 0; the forms
// that read the ring select a zero row past the count. No sentinel
// position is streamed.
//
// What bounds it. The same pair work as pbf_window.cu (one rsqrt and ~15
// float32 operations per pair on the CUDA cores), less the three deltas and
// their squares that the mma takes over; one mma per 16 x 8 pairs (two
// more per 16 x 16 for delta-p) is far below the tensor cores' rate, so
// the CUDA-core pair chain bounds it. `wgmma` would not help.
//
// Numerics. Build without --use_fast_math; rsqrt_normal is rsqrtf's value.
// |o|^2, |c|^2 and the final own3 * S - acc_p use round-to-nearest
// intrinsics so that nvcc does not contract them into FMAs the plain
// version does not have. Hopper's float32 accumulation inside an mma is not
// IEEE round-to-nearest; chip_smoke.py measures the kernels against their
// plain versions.

#include <cuda_bf16.h>

#include "pair_items.cuh"

namespace {

using namespace pair_items;

// 32-bit word planes of a candidate's rd2 B column: its words 0-2 and 4
// (word 3 repeats word 0)
constexpr int kRd2Planes = 4;
constexpr int kProjPlanes = 6;  // bf16 planes of delta-p's B: ch xyz, cl xyz
constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 1.0
// warps that split each staged tile's candidates, the other warps splitting
// the own rows (geometry.TC_COL_GROUPS); more where the own rows are too
// few for one m16 tile a warp. At own 64 on an NVIDIA H100 80GB HBM3 at
// 700 W (benchmarks_torch/geometry_ab.py --base-tc with each value): 2
// (two m16 tiles a warp, 58-123 registers) ran within -3 % to +10 % of 1
// (40-48), 4 (four m-tiles, 80-168 registers, with spills) 3-45 % slower.
constexpr int kColGroups = 1;
constexpr int kLd = kStageLen + 8;       // rd2 plane stride in words
constexpr int kLdq = kStageLen / 2 + 4;  // delta-p plane stride in words
// a converted tile: rd2 word planes and |c|^2; for delta-p also lambda and
// the bf16 planes
constexpr int kRd2PlaneBytes = (kRd2Planes * kLd + kStageLen) * 4;
constexpr int kProjPlaneBytes =
    kRd2PlaneBytes + (kStageLen + kProjPlanes * kLdq) * 4;

template <int kOwn>
constexpr int col_groups() {
  return kColGroups > 64 / kOwn ? kColGroups : 64 / kOwn;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo_k,
                                         __nv_bfloat16 hi_k) {
  // the lower k index in the lower 16 bits, as the mma fragments want
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo_k)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi_k)) << 16);
}

struct Split {
  __nv_bfloat16 hi, lo;
};

// `_bf16_split`: hi = bf16(a), lo = bf16(a - hi); the difference is exact.
__device__ __forceinline__ Split split2(float a) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(a);
  return {hi, __float2bfloat16_rn(__fsub_rn(a, __bfloat162float(hi)))};
}

// `_bf16_split` of two values at once, each pair packed as the mma
// fragments want it (a in the lower 16 bits): hi = bf16(a, b) and lo =
// bf16(a - hi_a, b - hi_b), one cvt.rn.bf16x2.f32 each, the same bits as
// split2 of each.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y));
  hi = pack(h.x, h.y);
  lo = pack(l.x, l.y);
}

// |p|^2 = (x x + y y) + z z, each step rounded, as the plain version does
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// d += A (16x16 bf16, row) . B (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Word w (k = 2w, 2w + 1) of an own row's rd2 A vector
// [ohx, ohy, ohz, ohx, ohy, ohz, olx, oly, olz, 0 ...].
__device__ __forceinline__ uint32_t rd2_a_word(const float4& p, int w) {
  const Split x = split2(p.x), y = split2(p.y), z = split2(p.z);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  switch (w) {
    case 0: return pack(x.hi, y.hi);
    case 1: return pack(z.hi, x.hi);
    case 2: return pack(y.hi, z.hi);
    case 3: return pack(x.lo, y.lo);
    case 4: return pack(z.lo, zero);
    default: return 0u;
  }
}

// The rd2 A fragment of rows (pa, pb) = (g, g + 8) for lane quad index t.
__device__ __forceinline__ void rd2_a_frag(const float4& pa, const float4& pb,
                                           int t, uint32_t (&a)[4]) {
  a[0] = rd2_a_word(pa, t);
  a[1] = rd2_a_word(pb, t);
  a[2] = rd2_a_word(pa, t + 4);
  a[3] = rd2_a_word(pb, t + 4);
}

// Convert candidate k's rd2 B column
// [chx, chy, chz, clx, cly, clz, chx, chy, chz, 0 ...] into its words 0, 1,
// 2 and 4 (word 3 = word 0), one per plane (plane stride kLd words), and
// its |c|^2.
__device__ __forceinline__ void stage_rd2(const float4& c, int k,
                                          uint32_t* words, float* cn2) {
  const Split x = split2(c.x), y = split2(c.y), z = split2(c.z);
  words[0 * kLd + k] = pack(x.hi, y.hi);
  words[1 * kLd + k] = pack(z.hi, x.lo);
  words[2 * kLd + k] = pack(y.lo, z.lo);
  words[3 * kLd + k] = pack(z.hi, __float2bfloat16_rn(0.f));
  cn2[k] = sq3(c.x, c.y, c.z);
}

// What every own m-tile of a warp reads of the 8-candidate tile at c0 for
// rd2: B column g's words t and t + 4, and |c|^2 of columns 2t, 2t + 1.
// Lane t = 3 reads word 0 for word 3, the same address as lane t = 0: a
// broadcast, no bank conflict.
struct Rd2Tile {
  uint32_t b0, b1;
  float2 cn;
};

__device__ __forceinline__ Rd2Tile rd2_tile(const uint32_t* words,
                                            const float* cn2, int c0, int g,
                                            int t) {
  const uint32_t w4 = words[3 * kLd + c0 + g];
  return {words[(t == 3 ? 0 : t) * kLd + c0 + g], t == 0 ? w4 : 0u,
          *reinterpret_cast<const float2*>(cn2 + c0 + 2 * t)};
}

// rd2[e] of rows (g, g + 8) x columns (2t, 2t + 1) of a tile, on2 = |o|^2
// of the two rows.
__device__ __forceinline__ void rd2_mma(const uint32_t (&a)[4],
                                        const float (&on2)[2],
                                        const Rd2Tile& b, float (&rd2)[4]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, a, b.b0, b.b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    rd2[e] = (on2[e >> 1] - (d[e] + d[e])) + (e & 1 ? b.cn.y : b.cn.x);
  }
}

// Row sums of a thread's (rows g, g + 8) x (columns 2t, 2t + 1) sums over
// the quad: (sum of row g, sum of row g + 8), in every lane of the quad.
template <bool kSumMma>
__device__ __forceinline__ float2 row_sums(const float (&acc)[4]) {
  if constexpr (kSumMma) {
    // acc -> hi + mid + lo, exact; A = [hi | mid] and [lo | 0] over k
    __nv_bfloat16 hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = __float2bfloat16_rn(acc[e]);
      const float r = __fsub_rn(acc[e], __bfloat162float(hi[e]));
      mid[e] = __float2bfloat16_rn(r);
      lo[e] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid[e])));
    }
    const uint32_t a1[4] = {pack(hi[0], hi[1]), pack(hi[2], hi[3]),
                            pack(mid[0], mid[1]), pack(mid[2], mid[3])};
    const uint32_t a2[4] = {pack(lo[0], lo[1]), pack(lo[2], lo[3]), 0u, 0u};
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma(d, a1, kOnes, kOnes);
    mma(d, a2, kOnes, kOnes);
    return make_float2(d[0], d[2]);
  } else {
    float a = acc[0] + acc[1];
    float b = acc[2] + acc[3];
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    b += __shfl_xor_sync(0xffffffffu, b, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    b += __shfl_xor_sync(0xffffffffu, b, 2);
    return make_float2(a, b);
  }
}

// The warp's place in the block: its column group (candidates c0 =
// 8 cg, 8 (cg + CG), ... of each tile, or 16-candidate steps for
// delta-p), the first of its MT m16 tiles of own rows, and the fragment
// indices g, t.
template <int kOwn>
struct Layout {
  static constexpr int CG = col_groups<kOwn>();
  static constexpr int MT = kOwn * CG / 64;  // m16 tiles a warp
  static_assert(MT >= 1 && kOwn * CG % 64 == 0, "own rows per warp");
  int g, t, cg, row0;

  __device__ __forceinline__ Layout() {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    cg = warp % CG;
    row0 = (warp / CG) * MT * 16;
  }

  // own row of element e's row half (0: row g, 1: g + 8) of m-tile m
  __device__ __forceinline__ int row(int m, int half) const {
    return row0 + m * 16 + g + 8 * half;
  }

  // the item's own rows (g, g + 8) of m-tile m, zero past n
  __device__ __forceinline__ void own_rows(const float4* __restrict__ pin,
                                           int chunk_row0, int n, int m,
                                           float4& pa, float4& pb) const {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    const int ia = chunk_row0 + row(m, 0);
    pa = ia < n ? pin[ia] : zero4;
    pb = ia + 8 < n ? pin[ia + 8] : zero4;
  }
};

// Candidate rows (col, col + 1) of a raw tile; in the ragged tail
// (kTail), a zero row past cnt.
template <bool kTail>
__device__ __forceinline__ void ring_pair(const float4* tile, int col, int cnt,
                                          float4 (&c)[2]) {
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  c[0] = !kTail || col < cnt ? tile[col] : zero4;
  c[1] = !kTail || col + 1 < cnt ? tile[col + 1] : zero4;
}

template <bool kRd2Mma, bool kSumMma, int kOwn_>
struct DensityTc {
  using L = Layout<kOwn_>;
  static constexpr int kOwn = kOwn_;
  static constexpr int kGroups = L::CG;
  static constexpr int kPlaneBytes = kRd2Mma ? kRd2PlaneBytes : 0;
  static constexpr int MT = L::MT;

  Consts k;
  L lay;
  uint32_t a[MT][4];   // kRd2Mma: the rows' rd2 A fragments
  float on2[MT][2];    // kRd2Mma: |o|^2 of rows g, g + 8
  float3 o[MT][2];     // otherwise: the rows' positions
  float s_rho[MT][4];  // sum (h^2 - rd2)^3
  float s_g2[MT][4];   // sum (h - r)^4 rd2

  __device__ __forceinline__ explicit DensityTc(const Consts& k_) : k(k_) {}

  __device__ __forceinline__ void begin(const float4* __restrict__ pin,
                                        int chunk_row0, int n) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float4 pa, pb;
      lay.own_rows(pin, chunk_row0, n, m, pa, pb);
      if constexpr (kRd2Mma) {
        rd2_a_frag(pa, pb, lay.t, a[m]);
        on2[m][0] = sq3(pa.x, pa.y, pa.z);
        on2[m][1] = sq3(pb.x, pb.y, pb.z);
      } else {
        o[m][0] = make_float3(pa.x, pa.y, pa.z);
        o[m][1] = make_float3(pb.x, pb.y, pb.z);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s_rho[m][e] = s_g2[m][e] = 0.f;
    }
  }

  __device__ __forceinline__ void convert(const float4* tile, int cnt,
                                          unsigned char* planes) const {
    uint32_t* words = reinterpret_cast<uint32_t*>(planes);
    float* cn2 = reinterpret_cast<float*>(words + kRd2Planes * kLd);
    const int cnt16 = (cnt + 15) & ~15;
    for (int j = threadIdx.x; j < cnt16; j += kThreads) {
      stage_rd2(j < cnt ? tile[j] : make_float4(0.f, 0.f, 0.f, 0.f), j, words,
                cn2);
    }
  }

  // the element's density terms, 0 past the tile's count
  __device__ __forceinline__ void terms(int m, int e, float rd2, bool live) {
    const float r2 = fmaxf(fminf(rd2, k.h2), k.eps);
    const float tt = k.h2 - r2;
    const float u = k.h - r2 * rsqrt_normal(r2);
    const float t2 = tt * tt;
    const float u2 = u * u;
    s_rho[m][e] += live ? t2 * tt : 0.f;
    s_g2[m][e] += live ? (u2 * u2) * r2 : 0.f;
  }

  // the 8-candidate tile at c0; only the ragged tail (kTail) masks
  template <bool kTail>
  __device__ __forceinline__ void tile8(const float4* tile,
                                        const unsigned char* planes, int c0,
                                        int cnt) {
    const int col = c0 + 2 * lay.t;
    const bool live[2] = {!kTail || col < cnt, !kTail || col + 1 < cnt};
    if constexpr (kRd2Mma) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(planes);
      const Rd2Tile b = rd2_tile(
          words, reinterpret_cast<const float*>(words + kRd2Planes * kLd), c0,
          lay.g, lay.t);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float rd2[4];
        rd2_mma(a[m], on2[m], b, rd2);
#pragma unroll
        for (int e = 0; e < 4; ++e) terms(m, e, rd2[e], live[e & 1]);
      }
    } else {
      float4 c[2];
      ring_pair<kTail>(tile, col, cnt, c);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float3& p = o[m][e >> 1];
          const float dx = p.x - c[e & 1].x;
          const float dy = p.y - c[e & 1].y;
          const float dz = p.z - c[e & 1].z;
          terms(m, e, dx * dx + dy * dy + dz * dz, live[e & 1]);
        }
      }
    }
  }

  __device__ __forceinline__ void consume(const float4* tile,
                                          const unsigned char* planes,
                                          int cnt) {
    int c0 = 8 * lay.cg;
#pragma unroll 2
    for (; c0 + 8 <= cnt; c0 += 8 * L::CG) tile8<false>(tile, planes, c0, cnt);
    if (c0 < cnt) tile8<true>(tile, planes, c0, cnt);
  }

  __device__ __forceinline__ void end(float4* red) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float2 rho = row_sums<kSumMma>(s_rho[m]);
      const float2 g2 = row_sums<kSumMma>(s_g2[m]);
      if (lay.t == 0) {
        float4* r = red + lay.cg * kOwn;
        r[lay.row(m, 0)] = make_float4(rho.x, g2.x, 0.f, 0.f);
        r[lay.row(m, 1)] = make_float4(rho.y, g2.y, 0.f, 0.f);
      }
    }
  }

  __device__ __forceinline__ float4 finish(float4 me, float4 s) const {
    return pair_items::finish<Pass::kLambda>(me, s, k);
  }
};

template <bool kProjMma, bool kSumMma, int kOwn_>
struct ProjectTc {
  static_assert(kProjMma || kSumMma, "the FP32 form is pbf_window.cu's");
  using L = Layout<kOwn_>;
  static constexpr int kOwn = kOwn_;
  static constexpr int kGroups = L::CG;
  static constexpr int kPlaneBytes = kProjMma ? kProjPlaneBytes : 0;
  static constexpr int MT = L::MT;

  Consts k;
  L lay;
  uint32_t a[MT][4];   // kProjMma: the rows' rd2 A fragments
  float on2[MT][2];    // kProjMma: |o|^2 of rows g, g + 8
  float3 o[MT][2];     // otherwise: the rows' positions
  float olam[MT][2];   // lambda_i + s_corr
  // kProjMma: element-wise s, and the delta-p mma sums added per tile;
  // otherwise element-wise s * (dx, dy, dz)
  float acc_s[MT][4], dp[MT][4];
  float ax[MT][4], ay[MT][4], az[MT][4];

  __device__ __forceinline__ explicit ProjectTc(const Consts& k_) : k(k_) {}

  __device__ __forceinline__ void begin(const float4* __restrict__ pin,
                                        int chunk_row0, int n) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float4 pa, pb;
      lay.own_rows(pin, chunk_row0, n, m, pa, pb);
      olam[m][0] = pa.w + k.s_corr;
      olam[m][1] = pb.w + k.s_corr;
      if constexpr (kProjMma) {
        rd2_a_frag(pa, pb, lay.t, a[m]);
        on2[m][0] = sq3(pa.x, pa.y, pa.z);
        on2[m][1] = sq3(pb.x, pb.y, pb.z);
      } else {
        o[m][0] = make_float3(pa.x, pa.y, pa.z);
        o[m][1] = make_float3(pb.x, pb.y, pb.z);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_s[m][e] = dp[m][e] = 0.f;
        ax[m][e] = ay[m][e] = az[m][e] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void convert(const float4* tile, int cnt,
                                          unsigned char* planes) const {
    uint32_t* words = reinterpret_cast<uint32_t*>(planes);
    float* cn2 = reinterpret_cast<float*>(words + kRd2Planes * kLd);
    float* lam = cn2 + kStageLen;
    __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(lam + kStageLen);
    const int cnt16 = (cnt + 15) & ~15;
    for (int j = threadIdx.x; j < cnt16; j += kThreads) {
      const float4 c = j < cnt ? tile[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      stage_rd2(c, j, words, cn2);
      lam[j] = c.w;
      const Split x = split2(c.x), y = split2(c.y), z = split2(c.z);
      const int lq = 2 * kLdq;  // plane stride in bf16
      q[0 * lq + j] = x.hi;
      q[1 * lq + j] = y.hi;
      q[2 * lq + j] = z.hi;
      q[3 * lq + j] = x.lo;
      q[4 * lq + j] = y.lo;
      q[5 * lq + j] = z.lo;
    }
  }

  // s of m-tile m's rows x the tile's columns (2t, 2t + 1), 0 past cnt
  __device__ __forceinline__ float pair_s(int m, int e, float rd2,
                                          float lam_j, bool live) const {
    const float r2 = fmaxf(fminf(rd2, k.h2), k.eps);
    const float u = k.h - r2 * rsqrt_normal(r2);
    const float v = (u * u) * (olam[m][e >> 1] + lam_j);
    return live ? v : 0.f;
  }

  // kProjMma: the 16 candidates at c0 into dpr, the tile's delta-p;
  // only the ragged tail (kTail) masks
  template <bool kTail>
  __device__ __forceinline__ void tile16(const unsigned char* planes, int c0,
                                         int cnt, float (&dpr)[MT][4]) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(planes);
    const float* cn2 = reinterpret_cast<const float*>(words + kRd2Planes * kLd);
    const float* lam = cn2 + kStageLen;
    const uint32_t* qwords = reinterpret_cast<const uint32_t*>(lam + kStageLen);
    const int g = lay.g, t = lay.t;
    const Rd2Tile b[2] = {rd2_tile(words, cn2, c0, g, t),
                          rd2_tile(words, cn2, c0 + 8, g, t)};
    const float2 lj[2] = {
        *reinterpret_cast<const float2*>(lam + c0 + 2 * t),
        *reinterpret_cast<const float2*>(lam + c0 + 8 + 2 * t)};
    // B column g: component g of candidates c0 + (2t, 2t+1, 2t+8, 2t+9);
    // columns 6 and 7 are zero (selects, so the warp stays converged)
    const int qg = g < kProjPlanes ? g : 0;
    uint32_t b0 = qwords[qg * kLdq + (c0 >> 1) + t];
    uint32_t b1 = qwords[qg * kLdq + (c0 >> 1) + 4 + t];
    b0 = g < kProjPlanes ? b0 : 0u;
    b1 = g < kProjPlanes ? b1 : 0u;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float s[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + 8 * h + 2 * t;
        float rd2[4];
        rd2_mma(a[m], on2[m], b[h], rd2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[h][e] = pair_s(m, e, rd2[e], e & 1 ? lj[h].y : lj[h].x,
                           !kTail || col + (e & 1) < cnt);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_s[m][e] += s[0][e] + s[1][e];
      // A over k = the 16 candidates: tile c0 in k 0-7, c0 + 8 in 8-15;
      // register r holds (row g, g + 8, g, g + 8)'s columns of tile r / 2
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_pair(s[r >> 1][2 * (r & 1)], s[r >> 1][2 * (r & 1) + 1], ah[r],
                   al[r]);
      }
      mma(dpr[m], ah, b0, b1);                            // sh.[ch | cl]
      mma(dpr[m], al, g < 3 ? b0 : 0u, g < 3 ? b1 : 0u);  // sl.[ch | 0]
    }
  }

  // the kSumMma-only form: the 8 candidates at c0 of the raw tile
  template <bool kTail>
  __device__ __forceinline__ void tile8(const float4* tile, int c0, int cnt) {
    const int col = c0 + 2 * lay.t;
    float4 c[2];
    ring_pair<kTail>(tile, col, cnt, c);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float3& p = o[m][e >> 1];
        const float dx = p.x - c[e & 1].x;
        const float dy = p.y - c[e & 1].y;
        const float dz = p.z - c[e & 1].z;
        const float s = pair_s(m, e, dx * dx + dy * dy + dz * dz, c[e & 1].w,
                               !kTail || col + (e & 1) < cnt);
        ax[m][e] += s * dx;
        ay[m][e] += s * dy;
        az[m][e] += s * dz;
      }
    }
  }

  __device__ __forceinline__ void consume(const float4* tile,
                                          const unsigned char* planes,
                                          int cnt) {
    if constexpr (kProjMma) {
      // this tile's delta-p on the tensor cores, added into dp in float32
      // on the CUDA cores, as the TPU adds each block's MXU product into
      // its accumulator
      float dpr[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dpr[m][e] = 0.f;
      }
      int c0 = 16 * lay.cg;
      for (; c0 + 16 <= cnt; c0 += 16 * L::CG) {
        tile16<false>(planes, c0, cnt, dpr);
      }
      if (c0 < cnt) tile16<true>(planes, c0, cnt, dpr);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[m][e] += dpr[m][e];
      }
    } else {
      int c0 = 8 * lay.cg;
#pragma unroll 2
      for (; c0 + 8 <= cnt; c0 += 8 * L::CG) tile8<false>(tile, c0, cnt);
      if (c0 < cnt) tile8<true>(tile, c0, cnt);
    }
  }

  __device__ __forceinline__ void end(float4* red) {
    float4* r = red + lay.cg * kOwn;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float4 out[2];
      if constexpr (kProjMma) {
        const float2 S = row_sums<kSumMma>(acc_s[m]);
        // dp columns 2t, 2t+1 of rows g, g+8; acc_p[a] = col a + col a+3
        const int q = (threadIdx.x & 31) & ~3;
        float c[2][6];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            c[h][2 * j] = __shfl_sync(0xffffffffu, dp[m][2 * h], q + j);
            c[h][2 * j + 1] =
                __shfl_sync(0xffffffffu, dp[m][2 * h + 1], q + j);
          }
        }
        out[0] = make_float4(S.x, c[0][0] + c[0][3], c[0][1] + c[0][4],
                             c[0][2] + c[0][5]);
        out[1] = make_float4(S.y, c[1][0] + c[1][3], c[1][1] + c[1][4],
                             c[1][2] + c[1][5]);
      } else {
        const float2 sx = row_sums<kSumMma>(ax[m]);
        const float2 sy = row_sums<kSumMma>(ay[m]);
        const float2 sz = row_sums<kSumMma>(az[m]);
        out[0] = make_float4(sx.x, sy.x, sz.x, 0.f);
        out[1] = make_float4(sx.y, sy.y, sz.y, 0.f);
      }
      if (lay.t == 0) {
        r[lay.row(m, 0)] = out[0];
        r[lay.row(m, 1)] = out[1];
      }
    }
  }

  __device__ __forceinline__ float4 finish(float4 me, float4 s) const {
    if constexpr (kProjMma) {
      // own3 + k * (own3 * S - acc_p), s = (S, acc_p)
      const float own3[3] = {me.x, me.y, me.z};
      const float acc_p[3] = {s.y, s.z, s.w};
      float out[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float diff = __fsub_rn(__fmul_rn(own3[j], s.x), acc_p[j]);
        out[j] = __fadd_rn(own3[j], __fmul_rn(k.k_proj, diff));
      }
      return make_float4(out[0], out[1], out[2], me.w);
    } else {
      return pair_items::finish<Pass::kProject>(me, s, k);
    }
  }
};

template <bool kRd2Mma, bool kSumMma, int kOwn>
__global__ void __launch_bounds__(kBlockThreads)
    density_tc_kernel(const float4* __restrict__ pin,
                      float4* __restrict__ pout,
                      const int* __restrict__ ranges,
                      const int* __restrict__ seg_prefix,
                      const int* __restrict__ seg_len_p,
                      float4* __restrict__ partials,
                      int* __restrict__ counters, int n, int num_chunks,
                      Consts k) {
  DensityTc<kRd2Mma, kSumMma, kOwn> body(k);
  run_items(body, pin, pout, ranges, seg_prefix, seg_len_p, partials,
            counters, n, num_chunks);
}

template <bool kProjMma, bool kSumMma, int kOwn>
__global__ void __launch_bounds__(kBlockThreads)
    project_tc_kernel(const float4* __restrict__ pin,
                      float4* __restrict__ pout,
                      const int* __restrict__ ranges,
                      const int* __restrict__ seg_prefix,
                      const int* __restrict__ seg_len_p,
                      float4* __restrict__ partials,
                      int* __restrict__ counters, int n, int num_chunks,
                      Consts k) {
  ProjectTc<kProjMma, kSumMma, kOwn> body(k);
  run_items(body, pin, pout, ranges, seg_prefix, seg_len_p, partials,
            counters, n, num_chunks);
}

template <bool kMma, bool kSumMma, int kOwn>
int launch_form(bool density, const Launch& a, const Consts& k) {
  if (density) {
    return launch_items<density_tc_kernel<kMma, kSumMma, kOwn>>(
        smem_bytes<DensityTc<kMma, kSumMma, kOwn>>(), a, k);
  }
  return launch_items<project_tc_kernel<kMma, kSumMma, kOwn>>(
      smem_bytes<ProjectTc<kMma, kSumMma, kOwn>>(), a, k);
}

// (the pass's mma switch, sum_mma) -> one of the three forms
template <int kOwn>
int launch_own(bool density, bool mma_on, bool sum_mma, const Launch& a,
               const Consts& k) {
  if (mma_on) {
    return sum_mma ? launch_form<true, true, kOwn>(density, a, k)
                   : launch_form<true, false, kOwn>(density, a, k);
  }
  if (sum_mma) return launch_form<false, true, kOwn>(density, a, k);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int own, bool density, bool mma_on, bool sum_mma,
             const Launch& a, const Consts& k) {
  switch (own) {
    case 32:
      return launch_own<32>(density, mma_on, sum_mma, a, k);
    case 64:
      return launch_own<64>(density, mma_on, sum_mma, a, k);
    case 128:
      return launch_own<128>(density, mma_on, sum_mma, a, k);
    case 256:
      return launch_own<256>(density, mma_on, sum_mma, a, k);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The FP32 launchers' arguments (pbf_window.cu: pin, pout, ranges,
// seg_prefix, seg_len, partials, counters, n, num_chunks, own), then the
// pass's two switches and its constants.
extern "C" int launch_density_tc(const void* pin, void* pout,
                                 const void* ranges, const void* seg_prefix,
                                 const void* seg_len, void* partials,
                                 void* counters, int n, int num_chunks,
                                 int own, int rd2_mma, int sum_mma, float h,
                                 float h2, float eps, float poly6, float l2,
                                 float inv_rho0, float relax_eps,
                                 void* stream) {
  return dispatch(own, true, rd2_mma, sum_mma,
                  {pin, pout, ranges, seg_prefix, seg_len, partials,
                   counters, n, num_chunks, stream},
                  {h, h2, eps, poly6, l2, inv_rho0, relax_eps, 0.f, 0.f});
}

extern "C" int launch_project_tc(const void* pin, void* pout,
                                 const void* ranges, const void* seg_prefix,
                                 const void* seg_len, void* partials,
                                 void* counters, int n, int num_chunks,
                                 int own, int proj_mma, int sum_mma, float h,
                                 float h2, float eps, float k_proj,
                                 float s_corr, void* stream) {
  return dispatch(own, false, proj_mma, sum_mma,
                  {pin, pout, ranges, seg_prefix, seg_len, partials,
                   counters, n, num_chunks, stream},
                  {h, h2, eps, 0.f, 0.f, 0.f, 0.f, k_proj, s_corr});
}

// The tensor-core launchers' interface version: 2 takes the work table (1,
// without this symbol, took one block per own-chunk and a `tile`).
extern "C" int pbf_tc_abi() { return 2; }
