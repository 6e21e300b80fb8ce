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
// Work split. As in pbf_window.cu, one block per own-chunk of `own` rows
// takes the chunk's nine exact candidate ranges, staged through shared memory
// `tile` candidates at a time. Inside the block, one warp takes 16 own rows
// (own / 16 warps), the rows of an m16n8k16 `mma.sync`: in its
// accumulator fragment each thread holds rows g and g + 8 (g = lane / 4) and
// candidate columns 2t and 2t + 1 (t = lane % 4) of an 8-candidate tile.
// While staging, each candidate's bf16 hi/lo split, its rd2 operand and its
// float32 |c|^2 are computed once, in shared memory.
//
// rd2 on the tensor cores. The three products of `_dot3`
// (hi.hi + hi.lo + lo.hi) fit one k16 mma: A row i is
// [oh, oh, ol, 0...] and B column j is [ch, cl, ch, 0...] over (x, y, z), so
// one instruction gives the split dot in float32; A stays in registers for
// the whole chunk. |o|^2 and |c|^2 stay float32 on the CUDA cores, and rd2 =
// (|o|^2 - (dot + dot)) + |c|^2 keeps JAX's association.
//
// Per-pair terms in the accumulator layout. The clamp, rsqrt and the density
// terms (or project's s) run on the CUDA cores on the four elements each
// thread holds, and accumulate element-wise across tiles, like the TPU's
// (OWN, CC) accumulators; the epilogue reduces each thread's (row, column)
// sums to row sums.
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
// round. Each round's product is added into the stream's sums in float32
// on the CUDA cores: kept in one mma accumulator over the whole stream,
// the tensor core's rounding of the running sum put the positions up to
// 2.9e-6 from the plain version's (80k dam break, step 60, NVIDIA H100
// 80GB HBM3 at 700 W), the per-round sums 7.2e-7. The epilogue adds the
// hi.lo columns into the hi.hi ones and forms own3 + k * (own3 * S -
// acc_p), lambda carried through in column 3.
//
// The ragged tail. A staged tile is zero-filled up to the next multiple of
// 16 candidates, so no stale shared memory can be NaN, and every term of a
// column at or past the tile's count is masked to exactly 0. No sentinel
// position is streamed.
//
// What bounds it. The same pair work as pbf_window.cu (one rsqrt and ~15
// float32 operations per pair on the CUDA cores), less the three deltas and
// their squares that the mma takes over; one mma per 8 candidates per warp
// (two more per 16 for delta-p) is far below the tensor cores' rate, so
// the CUDA-core pair chain still bounds it, and the heaviest own-chunk sets
// the time. Measured on that card, the rd2 and delta-p mma forms take 2-7 %
// longer than the same layout with FP32 pair math (the `kSumMma`-only
// forms), and the layout itself, twice the threads of pbf_window.cu's
// kernels on a chunk, is what makes these kernels up to 38 % faster than
// those on the settled dam. Shared memory is read as
// conflict-free 32-bit fragment words (the planes are padded so that the
// eight candidates and four words of a fragment fall on 32 banks) and
// 8-byte (|c|^2, lambda) pairs.
//
// Numerics. Build without --use_fast_math; rsqrtf kept. |o|^2, |c|^2 and the
// final own3 * S - acc_p use round-to-nearest intrinsics so that nvcc does
// not contract them into FMAs the plain version does not have. Hopper's
// float32 accumulation inside an mma is not IEEE round-to-nearest;
// chip_smoke.py measures the kernels against their plain versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWindows = 9;
constexpr int kRd2Words = 5;    // 32-bit words of a candidate's rd2 B column
constexpr int kProjPlanes = 6;  // bf16 planes of delta-p's B: ch xyz, cl xyz
constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 1.0

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

// Stage candidate k's rd2 B column
// [chx, chy, chz, clx, cly, clz, chx, chy, chz, 0 ...] as five words, one
// per plane (plane stride `ld` words), and its |c|^2.
__device__ __forceinline__ void stage_rd2(const float4& c, int k, int ld,
                                          uint32_t* words, float* cn2) {
  const Split x = split2(c.x), y = split2(c.y), z = split2(c.z);
  words[0 * ld + k] = pack(x.hi, y.hi);
  words[1 * ld + k] = pack(z.hi, x.lo);
  words[2 * ld + k] = pack(y.lo, z.lo);
  words[3 * ld + k] = pack(x.hi, y.hi);
  words[4 * ld + k] = pack(z.hi, __float2bfloat16_rn(0.f));
  cn2[k] = sq3(c.x, c.y, c.z);
}

// dot[e] for (rows g, g + 8) x (candidates c0 + 2t, c0 + 2t + 1) of the
// 8-candidate tile at c0: B column g's words t and t + 4.
__device__ __forceinline__ void rd2_dot(const uint32_t (&a)[4],
                                        const uint32_t* words, int ld, int c0,
                                        int g, int t, float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  const uint32_t b0 = words[t * ld + c0 + g];
  const uint32_t w4 = words[4 * ld + c0 + g];
  mma(d, a, b0, t == 0 ? w4 : 0u);
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

// Stage rounds of the chunk's windows: for each, candidates [0, cnt) of the
// round are in shared memory, zero-filled to a multiple of 16, when
// body(cnt) runs. stage(k, c) writes candidate k's shared form.
template <typename Stage, typename Body>
__device__ __forceinline__ void stream(const float4* __restrict__ pin,
                                       const int* __restrict__ win, int tile,
                                       Stage stage, Body body) {
  for (int w = 0; w < kWindows; ++w) {
    const int start = win[2 * w];
    const int end = win[2 * w + 1];
    for (int base = start; base < end; base += tile) {
      const int cnt = min(tile, end - base);
      const int cnt16 = (cnt + 15) & ~15;
      for (int k = threadIdx.x; k < cnt16; k += blockDim.x) {
        stage(k, k < cnt ? pin[base + k] : make_float4(0.f, 0.f, 0.f, 0.f));
      }
      __syncthreads();
      body(cnt);
      __syncthreads();
    }
  }
}

template <bool kRd2Mma, bool kSumMma>
__global__ void density_tc_kernel(const float4* __restrict__ pin,
                                  float4* __restrict__ pout,
                                  const int* __restrict__ ranges, int n,
                                  int tile, float h, float h2, float eps,
                                  float poly6, float l2, float inv_rho0,
                                  float relax_eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile + 8;  // plane stride in words: conflict-free fragments
  // kRd2Mma: five word planes, then |c|^2; otherwise the float4 candidates
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* cn2 = reinterpret_cast<float*>(words + kRd2Words * ld);
  float4* cand = reinterpret_cast<float4*>(smem);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int own = blockDim.x >> 1;  // 16 rows per 32-thread warp
  const int ia = blockIdx.x * own + (threadIdx.x >> 5) * 16 + g;
  const int ib = ia + 8;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 pa = ia < n ? pin[ia] : zero4;
  const float4 pb = ib < n ? pin[ib] : zero4;
  uint32_t a[4];
  float on2a = 0.f, on2b = 0.f;
  if constexpr (kRd2Mma) {
    rd2_a_frag(pa, pb, t, a);
    on2a = sq3(pa.x, pa.y, pa.z);
    on2b = sq3(pb.x, pb.y, pb.z);
  }

  float s_rho[4] = {0.f, 0.f, 0.f, 0.f};  // sum (h^2 - rd2)^3
  float s_g2[4] = {0.f, 0.f, 0.f, 0.f};   // sum (h - r)^4 rd2
  auto stage = [&](int k, const float4& c) {
    if constexpr (kRd2Mma) {
      stage_rd2(c, k, ld, words, cn2);
    } else {
      cand[k] = c;
    }
  };
  auto body = [&](int cnt) {
    for (int c0 = 0; c0 < cnt; c0 += 8) {
      float rd2[4];
      const int col = c0 + 2 * t;
      if constexpr (kRd2Mma) {
        float d[4];
        rd2_dot(a, words, ld, c0, g, t, d);
        const float2 cn = *reinterpret_cast<const float2*>(cn2 + col);
        rd2[0] = (on2a - (d[0] + d[0])) + cn.x;
        rd2[1] = (on2a - (d[1] + d[1])) + cn.y;
        rd2[2] = (on2b - (d[2] + d[2])) + cn.x;
        rd2[3] = (on2b - (d[3] + d[3])) + cn.y;
      } else {
        const float4 c[2] = {cand[col], cand[col + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4& o = e < 2 ? pa : pb;
          const float dx = o.x - c[e & 1].x;
          const float dy = o.y - c[e & 1].y;
          const float dz = o.z - c[e & 1].z;
          rd2[e] = dx * dx + dy * dy + dz * dz;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r2 = fmaxf(fminf(rd2[e], h2), eps);
        const float tt = h2 - r2;
        const float u = h - r2 * rsqrtf(r2);
        const float t2 = tt * tt;
        const float u2 = u * u;
        const bool live = col + (e & 1) < cnt;
        s_rho[e] += live ? t2 * tt : 0.f;
        s_g2[e] += live ? (u2 * u2) * r2 : 0.f;
      }
    }
  };
  stream(pin, ranges + blockIdx.x * (2 * kWindows), tile, stage, body);

  const float2 rho = row_sums<kSumMma>(s_rho);
  const float2 g2 = row_sums<kSumMma>(s_g2);
  if (t == 0) {
    // lambda as pbf_window.cu forms it: c = rho / rho0 - 1, -c / (g2 + eps)
    const float ca = (poly6 * rho.x) * inv_rho0 - 1.f;
    const float cb = (poly6 * rho.y) * inv_rho0 - 1.f;
    const float lam_a = -ca / (l2 * g2.x + relax_eps);
    const float lam_b = -cb / (l2 * g2.y + relax_eps);
    if (ia < n) pout[ia] = make_float4(pa.x, pa.y, pa.z, lam_a);
    if (ib < n) pout[ib] = make_float4(pb.x, pb.y, pb.z, lam_b);
  }
}

template <bool kProjMma, bool kSumMma>
__global__ void project_tc_kernel(const float4* __restrict__ pin,
                                  float4* __restrict__ pout,
                                  const int* __restrict__ ranges, int n,
                                  int tile, float h, float h2, float eps,
                                  float k_proj, float s_corr) {
  static_assert(kProjMma || kSumMma, "the FP32 form is pbf_window.cu's");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile + 8;       // rd2 plane stride in words
  const int ldq = tile / 2 + 4;  // delta-p plane stride in words
  // kProjMma: rd2 word planes, |c|^2, lambda, delta-p bf16 planes;
  // otherwise the float4 candidates
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* cn2 = reinterpret_cast<float*>(words + kRd2Words * ld);
  float* lam = cn2 + tile;
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(lam + tile);
  const uint32_t* qwords = reinterpret_cast<const uint32_t*>(planes);
  float4* cand = reinterpret_cast<float4*>(smem);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int own = blockDim.x >> 1;
  const int ia = blockIdx.x * own + (threadIdx.x >> 5) * 16 + g;
  const int ib = ia + 8;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 pa = ia < n ? pin[ia] : zero4;
  const float4 pb = ib < n ? pin[ib] : zero4;
  const float olam[2] = {pa.w + s_corr, pb.w + s_corr};
  uint32_t a[4];
  float on2[2] = {0.f, 0.f};
  if constexpr (kProjMma) {
    rd2_a_frag(pa, pb, t, a);
    on2[0] = sq3(pa.x, pa.y, pa.z);
    on2[1] = sq3(pb.x, pb.y, pb.z);
  }

  // kProjMma: acc_s (element-wise s) and the delta-p mma accumulator dp;
  // otherwise element-wise s * (dx, dy, dz)
  float acc_s[4] = {0.f, 0.f, 0.f, 0.f};
  float dp[4] = {0.f, 0.f, 0.f, 0.f};
  float ax[4] = {0.f, 0.f, 0.f, 0.f};
  float ay[4] = {0.f, 0.f, 0.f, 0.f};
  float az[4] = {0.f, 0.f, 0.f, 0.f};
  auto stage = [&](int k, const float4& c) {
    if constexpr (kProjMma) {
      stage_rd2(c, k, ld, words, cn2);
      lam[k] = c.w;
      const Split x = split2(c.x), y = split2(c.y), z = split2(c.z);
      const int lq = 2 * ldq;  // plane stride in bf16
      planes[0 * lq + k] = x.hi;
      planes[1 * lq + k] = y.hi;
      planes[2 * lq + k] = z.hi;
      planes[3 * lq + k] = x.lo;
      planes[4 * lq + k] = y.lo;
      planes[5 * lq + k] = z.lo;
    } else {
      cand[k] = c;
    }
  };
  // s for the 8-candidate tile at c0: s[e] for (rows g, g + 8) x
  // (candidates c0 + 2t, c0 + 2t + 1), 0 past cnt
  auto pair_s = [&](int c0, int cnt, float (&s)[4], float (&dx)[4],
                    float (&dy)[4], float (&dz)[4]) {
    const int col = c0 + 2 * t;
    float rd2[4];
    float lj[2];
    if constexpr (kProjMma) {
      float d[4];
      rd2_dot(a, words, ld, c0, g, t, d);
      const float2 cn = *reinterpret_cast<const float2*>(cn2 + col);
      const float2 l = *reinterpret_cast<const float2*>(lam + col);
      lj[0] = l.x;
      lj[1] = l.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rd2[e] = (on2[e >> 1] - (d[e] + d[e])) + (e & 1 ? cn.y : cn.x);
      }
    } else {
      const float4 c[2] = {cand[col], cand[col + 1]};
      lj[0] = c[0].w;
      lj[1] = c[1].w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4& o = e < 2 ? pa : pb;
        dx[e] = o.x - c[e & 1].x;
        dy[e] = o.y - c[e & 1].y;
        dz[e] = o.z - c[e & 1].z;
        rd2[e] = dx[e] * dx[e] + dy[e] * dy[e] + dz[e] * dz[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r2 = fmaxf(fminf(rd2[e], h2), eps);
      const float u = h - r2 * rsqrtf(r2);
      const float v = (u * u) * (olam[e >> 1] + lj[e & 1]);
      s[e] = col + (e & 1) < cnt ? v : 0.f;
    }
  };
  auto body = [&](int cnt) {
    if constexpr (kProjMma) {
      // this round's delta-p on the tensor cores, added into dp in float32
      // on the CUDA cores, as the TPU adds each block's MXU product into
      // its accumulator
      float dpr[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < cnt; c0 += 16) {
        float s0[4], s1[4], unused[4];
        pair_s(c0, cnt, s0, unused, unused, unused);
        pair_s(c0 + 8, cnt, s1, unused, unused, unused);
        Split sp[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_s[e] += s0[e] + s1[e];
          sp[e] = split2(s0[e]);
          sp[e + 4] = split2(s1[e]);
        }
        // A over k = the 16 candidates: s0 in k 0-7, s1 in k 8-15
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ah[r] = pack(sp[2 * r].hi, sp[2 * r + 1].hi);
          al[r] = pack(sp[2 * r].lo, sp[2 * r + 1].lo);
        }
        // B column g: component g of candidates c0 + (2t, 2t+1, 2t+8, 2t+9);
        // columns 6 and 7 are zero (selects, so the warp stays converged)
        const int qg = g < kProjPlanes ? g : 0;
        uint32_t b0 = qwords[qg * ldq + (c0 >> 1) + t];
        uint32_t b1 = qwords[qg * ldq + (c0 >> 1) + 4 + t];
        b0 = g < kProjPlanes ? b0 : 0u;
        b1 = g < kProjPlanes ? b1 : 0u;
        mma(dpr, ah, b0, b1);                            // sh.[ch | cl]
        mma(dpr, al, g < 3 ? b0 : 0u, g < 3 ? b1 : 0u);  // sl.[ch | 0]
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[e] += dpr[e];
    } else {
      for (int c0 = 0; c0 < cnt; c0 += 8) {
        float s[4], dx[4], dy[4], dz[4];
        pair_s(c0, cnt, s, dx, dy, dz);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ax[e] += s[e] * dx[e];
          ay[e] += s[e] * dy[e];
          az[e] += s[e] * dz[e];
        }
      }
    }
  };
  stream(pin, ranges + blockIdx.x * (2 * kWindows), tile, stage, body);

  float out[2][3];
  if constexpr (kProjMma) {
    const float2 S = row_sums<kSumMma>(acc_s);
    // dp columns 2t, 2t+1 of rows g, g+8; acc_p[a] = col a + col a+3
    const int q = lane & ~3;
    float c[2][6];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        c[r][2 * j] = __shfl_sync(0xffffffffu, dp[2 * r], q + j);
        c[r][2 * j + 1] = __shfl_sync(0xffffffffu, dp[2 * r + 1], q + j);
      }
    }
    const float Sr[2] = {S.x, S.y};
    const float4* o[2] = {&pa, &pb};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float own3[3] = {o[r]->x, o[r]->y, o[r]->z};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float acc_p = c[r][j] + c[r][j + 3];
        const float diff = __fsub_rn(__fmul_rn(own3[j], Sr[r]), acc_p);
        out[r][j] = __fadd_rn(own3[j], __fmul_rn(k_proj, diff));
      }
    }
  } else {
    const float2 sx = row_sums<kSumMma>(ax);
    const float2 sy = row_sums<kSumMma>(ay);
    const float2 sz = row_sums<kSumMma>(az);
    out[0][0] = pa.x + k_proj * sx.x;
    out[0][1] = pa.y + k_proj * sy.x;
    out[0][2] = pa.z + k_proj * sz.x;
    out[1][0] = pb.x + k_proj * sx.y;
    out[1][1] = pb.y + k_proj * sy.y;
    out[1][2] = pb.z + k_proj * sz.y;
  }
  if (t == 0) {
    if (ia < n) pout[ia] = make_float4(out[0][0], out[0][1], out[0][2], pa.w);
    if (ib < n) pout[ib] = make_float4(out[1][0], out[1][1], out[1][2], pb.w);
  }
}

// Dynamic shared memory of each form, in bytes.
int density_tc_smem(int tile, bool rd2_mma) {
  return rd2_mma ? (kRd2Words * (tile + 8) + tile) * 4 : tile * 16;
}

int project_tc_smem(int tile, bool proj_mma) {
  return proj_mma ? (kRd2Words * (tile + 8) + 2 * tile +
                     kProjPlanes * (tile / 2 + 4)) * 4
                  : tile * 16;
}

}  // namespace

extern "C" int launch_density_tc(const void* pin, void* pout,
                                 const void* ranges, int n, int num_chunks,
                                 int threads, int tile, int rd2_mma,
                                 int sum_mma, float h, float h2, float eps,
                                 float poly6, float l2, float inv_rho0,
                                 float relax_eps, void* stream) {
  auto* kernel = rd2_mma ? (sum_mma ? density_tc_kernel<true, true>
                                    : density_tc_kernel<true, false>)
                         : density_tc_kernel<false, true>;
  if (!rd2_mma && !sum_mma) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<num_chunks, threads, density_tc_smem(tile, rd2_mma),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pin), static_cast<float4*>(pout),
      static_cast<const int*>(ranges), n, tile, h, h2, eps, poly6, l2,
      inv_rho0, relax_eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_project_tc(const void* pin, void* pout,
                                 const void* ranges, int n, int num_chunks,
                                 int threads, int tile, int proj_mma,
                                 int sum_mma, float h, float h2, float eps,
                                 float k_proj, float s_corr, void* stream) {
  auto* kernel = proj_mma ? (sum_mma ? project_tc_kernel<true, true>
                                     : project_tc_kernel<true, false>)
                          : project_tc_kernel<false, true>;
  if (!proj_mma && !sum_mma) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<num_chunks, threads, project_tc_smem(tile, proj_mma),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pin), static_cast<float4*>(pout),
      static_cast<const int*>(ranges), n, tile, h, h2, eps, k_proj, s_corr);
  return static_cast<int>(cudaGetLastError());
}
