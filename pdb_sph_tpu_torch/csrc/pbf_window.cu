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
// kCull groups and takes each group's axis-aligned box over the rows it
// writes (i < n); a block's next item of the same chunk keeps them. For
// own >= 64 the groups are a k-d split in two cuts: the rows are ranked
// along the longest axis of their box and cut at the median into halves,
// then each half is ranked along the longest axis of its own box and cut
// at its own median, so group 2 h + q is quarter q of half h (own / 4
// rows); own 32 keeps the whole chunk as one group. Body warp w takes
// group w and every candidate of a staged tile (at own 32 the four warps
// take the one group and a quarter of the tile each, runs of eight in
// turn), tests them against the group's box by the squared distance from
// the box, sum_a max(0, lo_a - c_a, c_a - hi_a)^2, one lane a candidate,
// and appends the survivors to a list of its own (a ballot and popc
// prefix, no branch). It then meets the survivors with the group's rows,
// four at a time a lane so that each lane has independent chains to
// issue; a group of 16 rows (own 64) lies across each half-warp, whose
// halves hold the same rows, take alternate survivors and add their sums
// of a row at the item's end. Fewer than a step of survivors wait in the
// list for the item's next tile, and the last for the item's end, so
// each item pays one masked step a warp. A pair is thus evaluated only
// when its candidate can reach its row's group: per pair within h, ~3.3
// evaluations in place of the plan's ~7.6 at own 64 (~4.3 with two
// halves; `evals_per_pair` and `candidates_per_pair` in the benchmark).
// The survivors are copies, not indices into the tile, and each warp
// keeps its own (PERF.md, section 6: index lists and lists shared across
// the warps cost as much as the pairs they saved). A warp a group, and not
// the four groups over each warp's lanes, because the card says so
// (PERF.md, section 6): four lists, four boxes and four tails a warp cost
// more than the quarter of the pairs they save, while a warp a group
// needs one of each; the groups' work in an item differs (up to ~1.4x
// the mean), and the lists cannot be shared without a barrier a tile. At
// own 64 the registers are capped at 56 (seven blocks an SM, the most
// that the shared memory allows), and K2, whose three sums leave the
// fewest registers, reads its box from shared memory once a tile.
//
// Why the cull is conservative, box by box. A candidate is dropped from a
// group only when its distance from the group's box, computed with each
// product and sum rounded apart, is at least h^2 (1 + 2^-16). Per axis the
// body's rounded delta is at least the rounded gap to the box (rounding is
// monotone and every row of the group lies in its box), and the body's
// rd2, with or without FMA contraction, is at least (1 - 6 u) times the
// box distance (u = 2^-24). So a pair dropped with its row's group has a
// body rd2 of at least h^2: the clamp would have set tt = 0 and u to a few
// ulps of h, terms far below a float32 sum's last bit. The margin keeps
// ~1e-5 of the shell at h that it need not. A candidate dropped by one
// group and kept by another meets only the rows of the other.
// `cull_groups` and `cull_survivors` in ops/cuda_pbf.py repeat the
// grouping, the boxes and the predicate bit for bit in plain torch.
//
// The design. pair_items.cuh schedules the work: items of at most
// `seg_len` candidates of one chunk on a persistent grid, their tiles
// staged through a bulk-copy ring by a producer warp, and a segment-order
// combine with no float atomics. The four body warps' sums are the
// combine's groups, added in warp order where they share the rows (own
// 32); from own 64 on each warp writes its group's rows alone. The
// grouping (integer keys, ties broken by the row), each warp's
// candidates, the order of its list and the half-warps' turns at it
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
// each rank (kCull > 1), the warps' partial boxes of the chunk and the box
// of each 32 ranks of the first cut; each warp's list of survivors and the
// box of its group (kProject); and the warps' survivor counts at the
// block's exit.
template <int kOwn, int kCull, int kListLen>
struct CullShared {
  static constexpr int kRanked = kCull > 1 ? kOwn : 4;
  alignas(16) unsigned key[kRanked];
  int at[kRanked];
  float part[kWarps][6];
  float block[kOwn / 32][6];
  float4 list[kWarps][kListLen];
  float box[kWarps][6];
  unsigned survivors[kWarps];
};

// 32 R own rows in kCull cull groups of kGroupRows rows. With four groups
// (own >= 64) body warp w takes group w and every candidate of a tile;
// with one (own 32) each of the four warps takes the group's rows and a
// quarter of every tile. A group lies across kWarpRows lanes: lane l holds
// ranks g * kGroupRows + 32 s + l % kWarpRows (s < kRg), so with 16-row
// groups (own 64) both halves of the warp hold the same rows, and half
// l / 16 takes every other survivor.
// kLambda's sums are (rho, g2), kRho's (rho), kProject's sum_j (h - r)^2
// (lambda_i + s_corr + lambda_j) (p_i - p_j) with lambda_i carried through
// (the self pair has dx = dy = dz = 0 exactly and adds s * 0).
template <Pass kPass, int R>
struct WindowBody {
  static constexpr int kOwn = 32 * R;
  static constexpr int kCull = R >= 2 ? 4 : 1;
  // warps that share a group, each taking runs of eight of every
  // kShare-th
  static constexpr int kShare = kWarps / kCull;
  // row-sum groups for the combine: the warps that share the rows
  static constexpr int kGroups = kShare;
  static constexpr int kGroupRows = kOwn / kCull;
  static constexpr int kWarpRows = kGroupRows < 32 ? kGroupRows : 32;
  // the warp's parts that take alternate survivors
  static constexpr int kSplit = 32 / kWarpRows;
  static constexpr int kRg = kGroupRows / kWarpRows;
  // candidates of a tile that a warp tests
  static constexpr int kPerWarp = kStageLen / kShare;
  // survivors a lane meets at a time, and a warp's survivors per step
  static constexpr int kUnroll = kRg >= 4 ? 1 : 4 / kRg;
  static constexpr int kStep = kSplit * kUnroll;
  // a list holds a tile's survivors after fewer than kStep carried over
  // from the item's tiles before, and one slot that the dropped
  // candidates are written to
  static constexpr int kListLen = kPerWarp + kStep;
  static constexpr int kDrop = kListLen - 1;
  // the pair work reads the ring: each warp culls and consumes its
  // candidates of a tile, and leaves it when done
  static constexpr int kPlaneBytes = 0;
  using Shared = CullShared<kOwn, kCull, kListLen>;

  // the block's one Shared
  static __device__ __forceinline__ Shared& shared() {
    __shared__ Shared sh;
    return sh;
  }

  Consts k;
  int lane, warp;
  // the chunk of the block's last item: its next item of the same chunk
  // keeps the grouping, the rows and the box
  int row0_last;
  // this warp's survivors over the block's items (each meets the
  // kGroupRows rows of its group): at most the launch's candidates, far
  // below 2^32
  unsigned survivors;
  // survivors carried over to the item's next tile (fewer than kStep, at
  // the head of the warp's list)
  int pending;
  float4 me[kRg];
  float olam[kRg];  // lambda_i + s_corr (kProject)
  float a0[kRg], a1[kRg], a2[kRg];
  // kProject, whose three sums leave the fewest registers, reads its
  // group's box from shared memory once a tile and loops over the tile's
  // rounds of candidates; the others keep the box in registers and
  // unroll the rounds (faster for each on the card, PERF.md, section 6)
  static constexpr bool kLean = kPass == Pass::kProject;
  float lo[3], hi[3];

  // the chunk row at rank q
  __device__ __forceinline__ int row_at(int q) const {
    if constexpr (kCull > 1) {
      return shared().at[q];
    } else {
      return q;
    }
  }

  // the rank of this lane's row s
  __device__ __forceinline__ int rank_of(int s) const {
    return warp / kShare * kGroupRows + 32 * s + lane % kWarpRows;
  }

  // the first of the longest extents of a box (no array indexed at run
  // time)
  static __device__ __forceinline__ int longest_axis(const float (&lo)[3],
                                                     const float (&hi)[3]) {
    const float e0 = hi[0] - lo[0], e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
    int axis = e1 > e0 ? 1 : 0;
    if (e2 > fmaxf(e0, e1)) axis = 2;
    return axis;
  }

  // Chunk row t's ranking key along `axis`: the coordinate's order with
  // the low bits the row (unique, so ties go by the row), rows past n
  // last.
  static __device__ __forceinline__ unsigned rank_key(float4 p, int axis,
                                                      bool valid, int t) {
    constexpr unsigned kLow = unsigned(kOwn - 1);
    const float c = axis == 0 ? p.x : (axis == 1 ? p.y : p.z);
    const unsigned o = valid ? order_key(c) : 0xffffffffu;
    return (o & ~kLow) | unsigned(t);
  }

  // the keys of keys[0, kCount) below `key`
  template <int kCount>
  static __device__ __forceinline__ int keys_below(const unsigned* keys,
                                                   unsigned key) {
    int rank = 0;
    const uint4* k4 = reinterpret_cast<const uint4*>(keys);
#pragma unroll 4
    for (int j = 0; j < kCount / 4; ++j) {
      const uint4 q = k4[j];
      rank += int(q.x < key) + int(q.y < key) + int(q.z < key) +
              int(q.w < key);
    }
    return rank;
  }

  // The grouping's two cuts. First the chunk's rows are ranked along the
  // longest axis of their box; then each half (ranks [0, own / 2) and
  // [own / 2, own)) is ranked along the longest axis of its own box, by
  // the same keys. sh.at[h * own / 2 + rank in half h] = row.
  __device__ __forceinline__ void rank_rows(const float4* __restrict__ pin,
                                            int row0, int n) {
    Shared& sh = shared();
    constexpr int kMine = (kOwn + kThreads - 1) / kThreads;
    constexpr int kHalf = kOwn / 2;
    float4 p[kMine];
    int t[kMine];
    unsigned key[kMine];
    float v[6];
    empty_box(v);
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      t[m] = threadIdx.x + kThreads * m;
      if (t[m] < kOwn) {
        p[m] = pin[row0 + t[m]];
        if (row0 + t[m] < n) grow_box(v, p[m]);
      }
    }
    warp_box(v);
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 6; ++a) sh.part[warp][a] = v[a];
    }
    consumer_sync();
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = sh.part[0][a];
      hi[a] = sh.part[0][3 + a];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        lo[a] = fminf(lo[a], sh.part[w][a]);
        hi[a] = fmaxf(hi[a], sh.part[w][3 + a]);
      }
    }
    const int axis = longest_axis(lo, hi);
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      if (t[m] < kOwn) {
        key[m] = rank_key(p[m], axis, row0 + t[m] < n, t[m]);
        sh.key[t[m]] = key[m];
      }
    }
    consumer_sync();
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      if (t[m] < kOwn) sh.at[keys_below<kOwn>(sh.key, key[m])] = t[m];
    }
    consumer_sync();

    // The second cut. Thread q takes rank q's row; each 32 ranks lie in
    // one half (kHalf >= 32). A half of 32 ranks (own 64) is one warp's,
    // so its box and its ranking stay in the warp; a larger half's box is
    // made of the boxes of its 32 ranks (sh.block[q / 32]).
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int q = threadIdx.x + kThreads * m;
      if (q < kOwn) {
        t[m] = sh.at[q];
        p[m] = pin[row0 + t[m]];
        empty_box(v);
        if (row0 + t[m] < n) grow_box(v, p[m]);
        warp_box(v);
        if constexpr (kHalf == 32) {
          const float vlo[3] = {v[0], v[1], v[2]};
          const float vhi[3] = {v[3], v[4], v[5]};
          key[m] = rank_key(p[m], longest_axis(vlo, vhi), row0 + t[m] < n,
                            t[m]);
          sh.key[q] = key[m];
        } else if (lane == 0) {
#pragma unroll
          for (int a = 0; a < 6; ++a) sh.block[q / 32][a] = v[a];
        }
      }
    }
    if constexpr (kHalf == 32) {
      __syncwarp();
    } else {
      consumer_sync();
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const int q = threadIdx.x + kThreads * m;
        if (q < kOwn) {
          const int b0 = q / kHalf * (kHalf / 32);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            lo[a] = sh.block[b0][a];
            hi[a] = sh.block[b0][3 + a];
#pragma unroll
            for (int b = 1; b < kHalf / 32; ++b) {
              lo[a] = fminf(lo[a], sh.block[b0 + b][a]);
              hi[a] = fmaxf(hi[a], sh.block[b0 + b][3 + a]);
            }
          }
          key[m] = rank_key(p[m], longest_axis(lo, hi), row0 + t[m] < n,
                            t[m]);
          sh.key[q] = key[m];
        }
      }
      consumer_sync();
    }
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int q = threadIdx.x + kThreads * m;
      if (q < kOwn) {
        const int h0 = q / kHalf * kHalf;
        sh.at[h0 + keys_below<kHalf>(sh.key + h0, key[m])] = t[m];
      }
    }
    consumer_sync();
  }

  // The item's own rows into registers, and the group's box.
  __device__ __forceinline__ void begin(const float4* __restrict__ pin,
                                        int row0, int n) {
    pending = 0;
#pragma unroll
    for (int s = 0; s < kRg; ++s) a0[s] = a1[s] = a2[s] = 0.f;
    if (row0 == row0_last) return;
    row0_last = row0;
    if constexpr (kCull > 1) rank_rows(pin, row0, n);
    float v[6];
    empty_box(v);
#pragma unroll
    for (int s = 0; s < kRg; ++s) {
      const int row = row_at(rank_of(s));
      me[s] = pin[row0 + row];
      olam[s] = me[s].w + k.s_corr;
      if (row0 + row < n) grow_box(v, me[s]);
    }
    warp_box(v);
    if constexpr (kLean) {
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) shared().box[warp][a] = v[a];
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = v[a];
        hi[a] = v[3 + a];
      }
    }
  }

  // the squared distance from candidate c to the box, each product and
  // sum rounded apart (cull_survivors repeats it in plain torch)
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

  // kU survivors against this lane's rows as independent chains; kMasked
  // adds those of `ok` alone.
  template <int kU, bool kMasked>
  __device__ __forceinline__ void pairs(const float4 (&c)[kU], unsigned ok) {
#pragma unroll
    for (int s = 0; s < kRg; ++s) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float4 cj = c[u];
        const float dx = me[s].x - cj.x;
        const float dy = me[s].y - cj.y;
        const float dz = me[s].z - cj.z;
        float rd2 = dx * dx + dy * dy + dz * dz;
        rd2 = fmaxf(fminf(rd2, k.h2), k.eps);
        const bool add = !kMasked || ((ok >> u) & 1u);
        // Each output has a pair body of its own. The lambda body keeps
        // this order (u before t2, both sums last): with the rho sum
        // moved above the rsqrt, nvcc gave the one-block-per-chunk
        // kernel 31 registers in place of 34 and it ran ~11 % slower.
        if constexpr (kPass == Pass::kLambda) {
          const float tt = k.h2 - rd2;
          const float uu = k.h - rd2 * rsqrt_normal(rd2);
          const float t2 = tt * tt;
          const float u2 = uu * uu;
          if (add) {
            a0[s] += t2 * tt;
            a1[s] += (u2 * u2) * rd2;
          }
        } else if constexpr (kPass == Pass::kRho) {
          const float tt = k.h2 - rd2;
          if (add) a0[s] += (tt * tt) * tt;
        } else {
          const float uu = k.h - rd2 * rsqrt_normal(rd2);
          const float sc = (uu * uu) * (olam[s] + cj.w);
          if (add) {
            a0[s] += sc * dx;
            a1[s] += sc * dy;
            a2[s] += sc * dz;
          }
        }
      }
    }
  }

  // One step: kU survivors for each of the warp's kSplit parts from list
  // position s, those from `top` on masked.
  template <int kU, bool kMasked>
  __device__ __forceinline__ void step(const float4* list, int s, int top) {
    const int part = lane / kWarpRows;
    float4 c[kU];
    unsigned ok = 0;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = s + kSplit * u + part;
      ok |= unsigned(!kMasked || i < top) << u;
      c[u] = list[!kMasked || i < top ? i : s];
    }
    pairs<kU, kMasked>(c, ok);
  }

  // The pair work of a staged tile. The warp culls its runs of eight
  // candidates (from 8 (w + kShare r), w its place among the warps of its
  // group) against its group's box, one lane a candidate, and appends the
  // survivors to its list in lane order (a ballot and popc prefix; a
  // dropped candidate goes to the list's last slot, which is never read);
  // then it runs the pair body of the list's whole steps of kStep
  // survivors against the group's rows, kUnroll at a time for each of the
  // warp's kSplit parts, and carries the rest to the head of the list for
  // the item's next tile (end takes the last).
  __device__ __forceinline__ void consume(const float4* cand,
                                          const unsigned char*, int cnt) {
    float4* mine = shared().list[warp];
    const float h2c = __fmul_rn(k.h2, kCullMargin);
    const unsigned below = (1u << lane) - 1u;
    int found = pending;
    float blo[3], bhi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      blo[a] = kLean ? shared().box[warp][a] : lo[a];
      bhi[a] = kLean ? shared().box[warp][3 + a] : hi[a];
    }
    // eight lanes read eight neighbouring candidates (no bank conflict);
    // the warps of a group take turns at runs of eight. kLean leaves out
    // the rounds past the tile's last candidate where the warp takes every
    // candidate, in order.
    const int rounds =
        kLean && kShare == 1 ? min(kPerWarp, cnt + 31) : kPerWarp;
#pragma unroll(kLean ? 2 : kPerWarp / 32)
    for (int i0 = 0; i0 < rounds; i0 += 32) {
      const int j = (lane & 7) +
                    8 * (warp % kShare + kShare * ((i0 + lane) >> 3));
      const bool in = j < cnt;
      const float4 c = cand[in ? j : 0];
      const bool keep = in & (box_dist2(blo, bhi, c) < h2c);
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      mine[keep ? found + __popc(m & below) : kDrop] = c;
      found += __popc(m);
    }
    __syncwarp();
    survivors += found - pending;
    const int whole = found - found % kStep;
    for (int s = 0; s < whole; s += kStep) {
      step<kUnroll, false>(mine, s, 0);
    }
    pending = found - whole;
    if (whole > 0) {
      __syncwarp();  // every lane has read the head of the list
      if (lane < pending) mine[lane] = mine[whole + lane];
    }
    __syncwarp();  // the list is read before the next tile's cull writes it
  }

  // The item's last survivors (one masked step), then its row sums into
  // red; with kSplit 2 the two halves' sums of a row first, added by a
  // shuffle (a + b and b + a are the same float).
  __device__ __forceinline__ void end(float4* red) {
    if (pending > 0) step<kUnroll, true>(shared().list[warp], 0, pending);
#pragma unroll
    for (int s = 0; s < kRg; ++s) {
      float4 sum = make_float4(a0[s], a1[s], a2[s], 0.f);
      if constexpr (kSplit == 2) {
        sum.x += __shfl_xor_sync(0xffffffffu, sum.x, 16);
        sum.y += __shfl_xor_sync(0xffffffffu, sum.y, 16);
        sum.z += __shfl_xor_sync(0xffffffffu, sum.z, 16);
      }
      if (lane < kWarpRows) {
        red[warp % kShare * kOwn + row_at(rank_of(s))] = sum;
      }
    }
  }

  __device__ __forceinline__ float4 finish(float4 me_i, float4 s) const {
    return pair_items::finish<kPass>(me_i, s, k);
  }
};

// The blocks an SM that the registers are capped for: seven at own 64, as
// many as the shared memory holds (56 registers a thread); eight, four and
// three at own 32, 128 and 256, near the two-group kernels' occupancy,
// which nvcc left alone gives up for registers (PERF.md, section 6).
template <Pass kPass, int R>
__global__ void __launch_bounds__(kBlockThreads,
                                  R == 1 ? 8 : (R == 2 ? 7 : (R == 4 ? 4 : 3)))
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
