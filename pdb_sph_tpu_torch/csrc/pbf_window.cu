// The FP32 pair kernels of the PBF constraint solve, for Hopper (sm_90a).
//
// What each replaces. window_kernel<kLambda> is K1, the TPU kernel
// `_density_kernel` (pdb_sph_tpu/ops/pallas_pbf.py:424, launched by
// density_pass :608); window_kernel<kRho> serves the diagnostic density of
// diagnostics_fn (core/step.py), which the JAX package computes in plain
// XLA; window_kernel<kProject> is K2, `_project_kernel` (:477, launched by
// project_pass :633). All three stream what `_pair_loop` (:333) streamed.
//
// The work. Every (own row, candidate) pair that the body evaluates costs
// its distance, deltas and rd2: 8 flops, an FMA counted as 2. Only a pair
// within h, whose terms the clamp does not zero, needs the rest of the
// body: ~10 flops (lambda), ~4 (rho) or ~11 (project), and one rsqrt
// except for rho. The plan hands each own row ~7-8 candidates per pair
// within h (the 27 cells of the chunk's cell span; `candidates_per_pair`
// in the benchmark), so the kernels are bound by the pairs they evaluate,
// far above the bytes (~2.7 MB in and out at 80k, < 1 us).
//
// The cull. Most candidates lie beyond h of every row of the chunk, so the
// body does not see them. Each item splits its chunk's own rows into
// kCull groups (two halves at the median of the coordinate along the
// longest axis of the rows' box, for own >= 64; the whole chunk for own
// 32), and takes each group's axis-aligned box over the rows it writes
// (i < n); a block's next item of the same chunk keeps them. Each warp
// tests its runs of eight candidates of a staged tile (a quarter of it)
// against each box by the squared distance from the box,
// sum_a max(0, lo_a - c_a, c_a - hi_a)^2, one lane a candidate, and copies
// each group's survivors into a list of its own (a ballot and popc
// prefix). It then meets each survivor with the group's rows, which each
// lane holds R / kCull of, four survivors at a time (own 64) so that the
// warp has independent chains to issue. A pair is thus evaluated only when
// its candidate can reach its row's group: per pair within h, ~3.8
// evaluations in place of the plan's ~7.6 at own 64 (`evals_per_pair` and
// `candidates_per_pair` in the benchmark). The survivors are copies, not
// indices into the tile, and each warp keeps its own, because the cut
// shows only when little but the pair body is left per evaluation
// (PERF.md, PR 17: index lists and lists shared across the warps cost as
// much as the pairs they saved).
//
// Why the cull is conservative. A candidate is dropped only when the box
// distance, computed with each product and sum rounded apart, is at least
// h^2 (1 + 2^-16). Per axis the body's rounded delta is at least the
// rounded gap to the box (rounding is monotone and every row lies in the
// box), and the body's rd2, with or without FMA contraction, is at least
// (1 - 6 u) times the box distance (u = 2^-24). So a dropped pair has a
// body rd2 of at least h^2: the clamp would have set tt = 0 and u to a few
// ulps of h, terms far below a float32 sum's last bit. The margin keeps
// ~1e-5 of the shell at h that it need not. `cull_survivors` in
// ops/cuda_pbf.py repeats the predicate bit for bit in plain torch.
//
// The design. pair_items.cuh schedules the work: items of at most
// `seg_len` candidates of one chunk on a persistent grid, their tiles
// staged through a bulk-copy ring by a producer warp, and a segment-order
// combine with no float atomics. The four body warps' sums are the
// combine's groups, added in warp order. The grouping (integer keys, ties
// broken by the row), each warp's candidates and the order of its lists
// depend only on the input, so two launches give bitwise-equal output.
//
// The counter. A launcher given `evals` (an int64 on the card) adds the
// (own row, survivor) pairs its blocks evaluated: a register sum per warp
// and one integer atomic per block at its exit. A null pointer counts
// nothing.
//
// Numerics follow the JAX kernels: rd2 is clamped to [eps, h^2], which
// zeroes every pair at or beyond h without a branch; r = rd2 * rsqrt(rd2),
// the accurate-to-2-ulp MUFU.RSQ of rsqrtf (rsqrt_normal); the constant
// factors are applied once after the stream. Build without
// --use_fast_math: reduced-precision pair math kept the fluid from settling
// on the TPU although the CPU parity tests passed.
//
// Launchers take raw pointers and the stream, never synchronise, and
// return cudaGetLastError() so a refused launch is reported at once.

#include "pair_items.cuh"

#include <math_constants.h>

namespace {

using namespace pair_items;

// candidates of a stage that each warp tests: runs of eight, every fourth
constexpr int kCullPerWarp = kStageLen / kWarps;
// the cull's margin on h^2 (the header's note)
constexpr float kCullMargin = 1.0f + 1.0f / 65536.0f;

// A float's bits as an unsigned integer in the float's order.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (min x, y, z, max x, y, z) over a warp's lanes; NaN is ignored, as
// fminf and fmaxf do
__device__ __forceinline__ void warp_box(float (&v)[6]) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = fminf(v[a], __shfl_xor_sync(0xffffffffu, v[a], d));
      v[3 + a] = fmaxf(v[3 + a], __shfl_xor_sync(0xffffffffu, v[3 + a], d));
    }
  }
}

__device__ __forceinline__ void empty_box(float (&v)[6]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = CUDART_INF_F;
    v[3 + a] = -CUDART_INF_F;
  }
}

__device__ __forceinline__ void grow_box(float (&v)[6], float4 p) {
  v[0] = fminf(v[0], p.x);
  v[1] = fminf(v[1], p.y);
  v[2] = fminf(v[2], p.z);
  v[3] = fmaxf(v[3], p.x);
  v[4] = fmaxf(v[4], p.y);
  v[5] = fmaxf(v[5], p.z);
}

// What an item's grouping leaves in shared memory: the keys and the row of
// each rank (kCull > 1), the warps' partial boxes of the chunk, and the
// box of each 32 rows in rank order; each warp's survivors of a tile, a
// list per cull group; and the warps' survivor counts at the block's exit.
template <int kOwn, int kCull>
struct CullShared {
  static constexpr int kRanked = kCull > 1 ? kOwn : 4;
  alignas(16) unsigned key[kRanked];
  int at[kRanked];
  float part[kWarps][6];
  float block[kOwn / 32][6];
  float4 list[kWarps][kCull][kCullPerWarp];
  unsigned survivors[kWarps];
};

// R own rows per lane, R / kCull of each cull group: lane l holds ranks
// g * own / kCull + 32 s + l (s < R / kCull) of group g.
// kLambda's sums are (rho, g2), kRho's (rho), kProject's sum_j (h - r)^2
// (lambda_i + s_corr + lambda_j) (p_i - p_j) with lambda_i carried through
// (the self pair has dx = dy = dz = 0 exactly and adds s * 0).
template <Pass kPass, int R>
struct WindowBody {
  static constexpr int kOwn = 32 * R;
  static constexpr int kGroups = kWarps;
  static constexpr int kCull = R >= 2 ? 2 : 1;
  static constexpr int kRg = R / kCull;
  static constexpr int kGroupRows = kOwn / kCull;
  // the pair work reads the ring: each warp culls and consumes its own
  // candidates of a tile, and leaves it when done
  static constexpr int kPlaneBytes = 0;
  using Shared = CullShared<kOwn, kCull>;

  // the block's one Shared
  static __device__ __forceinline__ Shared& shared() {
    __shared__ Shared sh;
    return sh;
  }

  Consts k;
  int lane, warp;
  // the chunk of the block's last item: its next item of the same chunk
  // keeps the grouping, the rows and the boxes
  int row0_last;
  // this warp's survivors over the block's items (each meets the
  // kGroupRows rows of its group): at most the launch's candidates times
  // kCull, far below 2^32
  unsigned survivors;
  float4 me[kCull][kRg];
  float olam[kCull][kRg];  // lambda_i + s_corr (kProject)
  float a0[kCull][kRg], a1[kCull][kRg], a2[kCull][kRg];

  // the chunk row at rank q
  __device__ __forceinline__ int row_at(int q) const {
    if constexpr (kCull > 1) {
      return shared().at[q];
    } else {
      return q;
    }
  }

  // Rank the chunk's rows along the longest axis of their box: keys of the
  // coordinate's order with the low bits the row (unique, so ties go by
  // the row), rows past n last; sh.at[rank] = row.
  __device__ __forceinline__ void rank_rows(const float4* __restrict__ pin,
                                            int row0, int n) {
    Shared& sh = shared();
    constexpr int kMine = (kOwn + kThreads - 1) / kThreads;
    float4 p[kMine];
    float v[6];
    empty_box(v);
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int t = threadIdx.x + kThreads * m;
      if (t < kOwn) {
        p[m] = pin[row0 + t];
        if (row0 + t < n) grow_box(v, p[m]);
      }
    }
    warp_box(v);
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 6; ++a) sh.part[warp][a] = v[a];
    }
    consumer_sync();
    float ext[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float l = sh.part[0][a], h = sh.part[0][3 + a];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        l = fminf(l, sh.part[w][a]);
        h = fmaxf(h, sh.part[w][3 + a]);
      }
      ext[a] = h - l;
    }
    // the first of the longest extents (no array indexed at run time)
    int axis = ext[1] > ext[0] ? 1 : 0;
    if (ext[2] > fmaxf(ext[0], ext[1])) axis = 2;
    constexpr unsigned kLow = unsigned(kOwn - 1);
    unsigned key[kMine];
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int t = threadIdx.x + kThreads * m;
      if (t < kOwn) {
        const float c = axis == 0 ? p[m].x : (axis == 1 ? p[m].y : p[m].z);
        const unsigned o = row0 + t < n ? order_key(c) : 0xffffffffu;
        key[m] = (o & ~kLow) | unsigned(t);
        sh.key[t] = key[m];
      }
    }
    consumer_sync();
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int t = threadIdx.x + kThreads * m;
      if (t < kOwn) {
        int rank = 0;
        const uint4* keys = reinterpret_cast<const uint4*>(sh.key);
#pragma unroll 4
        for (int j = 0; j < kOwn / 4; ++j) {
          const uint4 q = keys[j];
          rank += int(q.x < key[m]) + int(q.y < key[m]) + int(q.z < key[m]) +
                  int(q.w < key[m]);
        }
        sh.at[rank] = t;
      }
    }
    consumer_sync();
  }

  // The item's own rows into registers, grouped, and each group's box.
  __device__ __forceinline__ void begin(const float4* __restrict__ pin,
                                        int row0, int n) {
    if (row0 == row0_last) {
#pragma unroll
      for (int g = 0; g < kCull; ++g) {
#pragma unroll
        for (int s = 0; s < kRg; ++s) a0[g][s] = a1[g][s] = a2[g][s] = 0.f;
      }
      return;
    }
    row0_last = row0;
    if constexpr (kCull > 1) rank_rows(pin, row0, n);
    Shared& sh = shared();
#pragma unroll
    for (int g = 0; g < kCull; ++g) {
#pragma unroll
      for (int s = 0; s < kRg; ++s) {
        const int row = row_at(g * kGroupRows + 32 * s + lane);
        me[g][s] = pin[row0 + row];
        olam[g][s] = me[g][s].w + k.s_corr;
        a0[g][s] = a1[g][s] = a2[g][s] = 0.f;
        // the box of these 32 rows (block g * kRg + s), summed by one warp
        const int b = g * kRg + s;
        if (b % kWarps == warp) {
          float v[6];
          empty_box(v);
          if (row0 + row < n) grow_box(v, me[g][s]);
          warp_box(v);
          if (lane == 0) {
#pragma unroll
            for (int a = 0; a < 6; ++a) sh.block[b][a] = v[a];
          }
        }
      }
    }
    consumer_sync();  // the blocks' boxes, read by every tile's cull
  }

  // the squared distance from candidate c to the box (lo, hi), each
  // product and sum rounded apart (cull_survivors repeats it in plain
  // torch)
  static __device__ __forceinline__ float box_dist2(const float (&lo)[3],
                                                    const float (&hi)[3],
                                                    float4 c) {
    const float ex =
        fmaxf(0.f, fmaxf(__fsub_rn(lo[0], c.x), __fsub_rn(c.x, hi[0])));
    const float ey =
        fmaxf(0.f, fmaxf(__fsub_rn(lo[1], c.y), __fsub_rn(c.y, hi[1])));
    const float ez =
        fmaxf(0.f, fmaxf(__fsub_rn(lo[2], c.z), __fsub_rn(c.z, hi[2])));
    return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                     __fmul_rn(ez, ez));
  }

  // kUnroll survivors of group g, c[0] .. c[kUnroll - 1], against the
  // group's rows of this lane, as independent chains.
  template <int kUnroll>
  __device__ __forceinline__ void pairs(int g, const float4 (&c)[kUnroll]) {
#pragma unroll
    for (int s = 0; s < kRg; ++s) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 cj = c[u];
        const float dx = me[g][s].x - cj.x;
        const float dy = me[g][s].y - cj.y;
        const float dz = me[g][s].z - cj.z;
        float rd2 = dx * dx + dy * dy + dz * dz;
        rd2 = fmaxf(fminf(rd2, k.h2), k.eps);
        // Each output has a pair body of its own. The lambda body keeps
        // this order (u before t2, both sums last): with the rho sum
        // moved above the rsqrt, nvcc gave the one-block-per-chunk
        // kernel 31 registers in place of 34 and it ran ~11 % slower.
        if constexpr (kPass == Pass::kLambda) {
          const float tt = k.h2 - rd2;
          const float uu = k.h - rd2 * rsqrt_normal(rd2);
          const float t2 = tt * tt;
          const float u2 = uu * uu;
          a0[g][s] += t2 * tt;
          a1[g][s] += (u2 * u2) * rd2;
        } else if constexpr (kPass == Pass::kRho) {
          const float tt = k.h2 - rd2;
          a0[g][s] += (tt * tt) * tt;
        } else {
          const float uu = k.h - rd2 * rsqrt_normal(rd2);
          const float sc = (uu * uu) * (olam[g][s] + cj.w);
          a0[g][s] += sc * dx;
          a1[g][s] += sc * dy;
          a2[g][s] += sc * dz;
        }
      }
    }
  }

  // The pair work of a staged tile. Warp w culls its runs of eight
  // candidates (from 8 (w + 4 r)) against every group's box, one lane a
  // candidate, and copies the survivors of each group into its own list in
  // lane order (a ballot and popc prefix); then it runs the pair body of
  // each survivor against its group's rows, kUnroll survivors at a time so
  // that it has independent chains to issue, and the rest one at a time.
  __device__ __forceinline__ void consume(const float4* cand,
                                          const unsigned char*, int cnt) {
    constexpr int kUnroll = kRg >= 4 ? 1 : 4 / kRg;
    Shared& sh = shared();
    float4(&mine)[kCull][kCullPerWarp] = sh.list[warp];
    const float h2c = __fmul_rn(k.h2, kCullMargin);
    const unsigned below = (1u << lane) - 1u;
    float lo[kCull][3], hi[kCull][3];
#pragma unroll
    for (int g = 0; g < kCull; ++g) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[g][a] = sh.block[g * kRg][a];
        hi[g][a] = sh.block[g * kRg][3 + a];
#pragma unroll
        for (int s = 1; s < kRg; ++s) {
          lo[g][a] = fminf(lo[g][a], sh.block[g * kRg + s][a]);
          hi[g][a] = fmaxf(hi[g][a], sh.block[g * kRg + s][3 + a]);
        }
      }
    }
    int found[kCull];
#pragma unroll
    for (int g = 0; g < kCull; ++g) found[g] = 0;
    // eight lanes read eight neighbouring candidates (no bank conflict);
    // the warps take turns at runs of eight
#pragma unroll
    for (int i0 = 0; i0 < kCullPerWarp; i0 += 32) {
      const int j = (lane & 7) + 8 * (warp + kWarps * ((i0 + lane) >> 3));
      const float4 c = cand[j < cnt ? j : 0];
#pragma unroll
      for (int g = 0; g < kCull; ++g) {
        const bool keep = j < cnt && box_dist2(lo[g], hi[g], c) < h2c;
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        if (keep) mine[g][found[g] + __popc(m & below)] = c;
        found[g] += __popc(m);
      }
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kCull; ++g) {
      survivors += found[g];
      int s = 0;
      for (; s + kUnroll <= found[g]; s += kUnroll) {
        float4 c[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) c[u] = mine[g][s + u];
        pairs(g, c);
      }
      if constexpr (kUnroll > 1) {
        for (; s < found[g]; ++s) {
          const float4 c[1] = {mine[g][s]};
          pairs(g, c);
        }
      }
    }
    __syncwarp();  // the list is read before the next tile's cull writes it
  }

  __device__ __forceinline__ void end(float4* red) const {
#pragma unroll
    for (int g = 0; g < kCull; ++g) {
#pragma unroll
      for (int s = 0; s < kRg; ++s) {
        const int row = row_at(g * kGroupRows + 32 * s + lane);
        red[warp * kOwn + row] =
            make_float4(a0[g][s], a1[g][s], a2[g][s], 0.f);
      }
    }
  }

  __device__ __forceinline__ float4 finish(float4 me_i, float4 s) const {
    return pair_items::finish<kPass>(me_i, s, k);
  }
};

template <Pass kPass, int R>
__global__ void __launch_bounds__(kBlockThreads)
    window_kernel(const float4* __restrict__ pin, float4* __restrict__ pout,
                  const int* __restrict__ ranges,
                  const int* __restrict__ seg_prefix,
                  const int* __restrict__ seg_len_p,
                  float4* __restrict__ partials, int* __restrict__ counters,
                  int n, int num_chunks, Consts k,
                  unsigned long long* __restrict__ evals) {
  using Body = WindowBody<kPass, R>;
  Body body;
  body.k = k;
  body.lane = threadIdx.x & 31;
  body.warp = threadIdx.x >> 5;
  body.survivors = 0;
  body.row0_last = -1;
  run_items(body, pin, pout, ranges, seg_prefix, seg_len_p, partials,
            counters, n, num_chunks);
  if (evals == nullptr) return;
  // the block's evaluated pairs: one atomic per block
  typename Body::Shared& sh = Body::shared();
  if (body.lane == 0 && body.warp < kWarps) {
    sh.survivors[body.warp] = body.survivors;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sh.survivors[w];
    if (sum != 0) atomicAdd(evals, sum * Body::kGroupRows);
  }
}

template <Pass kPass, int R>
int launch_window(const Launch& a, const Consts& k, void* evals) {
  return launch_items<window_kernel<kPass, R>>(
      smem_bytes<WindowBody<kPass, R>>(), a, k,
      static_cast<unsigned long long*>(evals));
}

// own rows per chunk -> rows per lane
template <Pass kPass>
int dispatch(int own, const Launch& a, const Consts& k, void* evals) {
  switch (own) {
    case 32:
      return launch_window<kPass, 1>(a, k, evals);
    case 64:
      return launch_window<kPass, 2>(a, k, evals);
    case 128:
      return launch_window<kPass, 4>(a, k, evals);
    case 256:
      return launch_window<kPass, 8>(a, k, evals);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The work table's arguments, after (pin, pout, ranges): seg_prefix
// (num_chunks + 1 int32, items before each chunk), seg_len (one int32, the
// plan's segment length), partials (float4 per own row of each item),
// counters (num_chunks + 2 int32, all 0 between launches). `evals`, last
// before the stream: an int64 that the launch adds its evaluated (own row,
// survivor) pairs to, or null.
extern "C" int launch_density_lambda(const void* pin, void* pout,
                                     const void* ranges,
                                     const void* seg_prefix,
                                     const void* seg_len, void* partials,
                                     void* counters, int n, int num_chunks,
                                     int own, float h, float h2, float eps,
                                     float poly6, float l2, float inv_rho0,
                                     float relax_eps, void* evals,
                                     void* stream) {
  return dispatch<Pass::kLambda>(
      own,
      {pin, pout, ranges, seg_prefix, seg_len, partials, counters, n,
       num_chunks, stream},
      {h, h2, eps, poly6, l2, inv_rho0, relax_eps, 0.f, 0.f}, evals);
}

extern "C" int launch_density_rho(const void* pin, void* pout,
                                  const void* ranges, const void* seg_prefix,
                                  const void* seg_len, void* partials,
                                  void* counters, int n, int num_chunks,
                                  int own, float h2, float eps, float poly6,
                                  void* evals, void* stream) {
  return dispatch<Pass::kRho>(
      own,
      {pin, pout, ranges, seg_prefix, seg_len, partials, counters, n,
       num_chunks, stream},
      {0.f, h2, eps, poly6, 0.f, 0.f, 0.f, 0.f, 0.f}, evals);
}

extern "C" int launch_project(const void* pin, void* pout, const void* ranges,
                              const void* seg_prefix, const void* seg_len,
                              void* partials, void* counters, int n,
                              int num_chunks, int own, float h, float h2,
                              float eps, float k_proj, float s_corr,
                              void* evals, void* stream) {
  return dispatch<Pass::kProject>(
      own,
      {pin, pout, ranges, seg_prefix, seg_len, partials, counters, n,
       num_chunks, stream},
      {h, h2, eps, 0.f, 0.f, 0.f, 0.f, k_proj, s_corr}, evals);
}

// The launchers' interface version: 3 takes the evaluated-pair counter
// `evals`; 2 took the work table without it; 1, without this symbol, took
// one block per own-chunk.
extern "C" int pbf_window_abi() { return 3; }

extern "C" const char* pbf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
