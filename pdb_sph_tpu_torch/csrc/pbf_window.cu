// The FP32 pair kernels of the PBF constraint solve, for Hopper (sm_90a).
//
// What each replaces. window_kernel<kLambda> is K1, the TPU kernel
// `_density_kernel` (pdb_sph_tpu/ops/pallas_pbf.py:424, launched by
// density_pass :608); window_kernel<kRho> serves the diagnostic density of
// diagnostics_fn (core/step.py), which the JAX package computes in plain
// XLA; window_kernel<kProject> is K2, `_project_kernel` (:477, launched by
// project_pass :633). All three stream what `_pair_loop` (:333) streamed.
//
// The work. Every (own row, candidate) pair costs its distance, deltas and
// rd2: 8 flops, an FMA counted as 2. Only a pair within h, whose terms the
// clamp does not zero, needs the rest of the body: ~10 flops (lambda), ~4
// (rho) or ~11 (project), and one rsqrt except for rho. At the 80k dam
// break (own 64, 1,250 chunks) that is ~195 M pairs a launch mid-collapse,
// 13.6 % of them within h, and ~170 M settled, 14.6 % within h
// (chip_smoke.py counts them): ~22-28 us of FP32 work at the H100's 67
// TFLOP/s, more than the rsqrt units need (16 a clock per SM, ~6 us) and
// far more than the bytes (~2.7 MB in and out, < 1 us). The kernels are
// compute-bound. This kernel evaluates every pair's whole body, without a
// branch.
//
// The design. pair_items.cuh schedules the work: items of at most
// `seg_len` candidates of one chunk on a persistent grid of four-warp
// blocks, tiles of kStageLen candidates through a bulk-copy ring, and a
// segment-order combine with no float atomics. The pair body here reads
// each staged tile straight from the ring: each lane holds own/32 own rows
// in registers and the four warps split the tile, so one broadcast shared
// load feeds own/32 independent pair chains; the four warps' sums are the
// combine's groups, added in warp order.
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

namespace {

using namespace pair_items;

// R own rows per lane: lane l holds rows l, l + 32, ..., of the item's
// chunk; warp w takes candidates w, w + 4, ... of each staged tile.
// kLambda's sums are (rho, g2), kRho's (rho), kProject's sum_j (h - r)^2
// (lambda_i + s_corr + lambda_j) (p_i - p_j) with lambda_i carried through
// (the self pair has dx = dy = dz = 0 exactly and adds s * 0).
template <Pass kPass, int R>
struct WindowBody {
  static constexpr int kOwn = 32 * R;
  static constexpr int kGroups = kWarps;
  static constexpr int kPlaneBytes = 0;

  Consts k;
  int lane, warp;
  float4 me[R];
  float olam[R];  // lambda_i + s_corr (kProject)
  float a0[R], a1[R], a2[R];

  __device__ __forceinline__ void begin(const float4* __restrict__ pin,
                                        int row0, int) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      me[r] = pin[row0 + lane + 32 * r];
      olam[r] = me[r].w + k.s_corr;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) a0[r] = a1[r] = a2[r] = 0.f;
  }

  __device__ __forceinline__ void convert(const float4*, int,
                                          unsigned char*) {}

  __device__ __forceinline__ void consume(const float4* cand,
                                          const unsigned char*, int cnt) {
#pragma unroll 2
    for (int j = warp; j < cnt; j += kWarps) {
      const float4 cj = cand[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = me[r].x - cj.x;
        const float dy = me[r].y - cj.y;
        const float dz = me[r].z - cj.z;
        float rd2 = dx * dx + dy * dy + dz * dz;
        rd2 = fmaxf(fminf(rd2, k.h2), k.eps);
        // Each output has a pair body of its own. The lambda body keeps
        // this order (u before t2, both sums last): with the rho sum
        // moved above the rsqrt, nvcc gave the one-block-per-chunk
        // kernel 31 registers in place of 34 and it ran ~11 % slower.
        if constexpr (kPass == Pass::kLambda) {
          const float tt = k.h2 - rd2;
          const float u = k.h - rd2 * rsqrt_normal(rd2);
          const float t2 = tt * tt;
          const float u2 = u * u;
          a0[r] += t2 * tt;
          a1[r] += (u2 * u2) * rd2;
        } else if constexpr (kPass == Pass::kRho) {
          const float tt = k.h2 - rd2;
          a0[r] += (tt * tt) * tt;
        } else {
          const float u = k.h - rd2 * rsqrt_normal(rd2);
          const float sc = (u * u) * (olam[r] + cj.w);
          a0[r] += sc * dx;
          a1[r] += sc * dy;
          a2[r] += sc * dz;
        }
      }
    }
  }

  __device__ __forceinline__ void end(float4* red) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      red[warp * kOwn + lane + 32 * r] = make_float4(a0[r], a1[r], a2[r], 0.f);
    }
  }

  __device__ __forceinline__ float4 finish(float4 me_i, float4 s) const {
    return pair_items::finish<kPass>(me_i, s, k);
  }
};

template <Pass kPass, int R>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const float4* __restrict__ pin, float4* __restrict__ pout,
                  const int* __restrict__ ranges,
                  const int* __restrict__ seg_prefix,
                  const int* __restrict__ seg_len_p,
                  float4* __restrict__ partials, int* __restrict__ counters,
                  int n, int num_chunks, Consts k) {
  WindowBody<kPass, R> body;
  body.k = k;
  body.lane = threadIdx.x & 31;
  body.warp = threadIdx.x >> 5;
  run_items(body, pin, pout, ranges, seg_prefix, seg_len_p, partials,
            counters, n, num_chunks);
}

template <Pass kPass, int R>
int launch_window(const Launch& a, const Consts& k) {
  return launch_items<window_kernel<kPass, R>>(
      smem_bytes<WindowBody<kPass, R>>(), a, k);
}

// own rows per chunk -> rows per lane
template <Pass kPass>
int dispatch(int own, const Launch& a, const Consts& k) {
  switch (own) {
    case 32:
      return launch_window<kPass, 1>(a, k);
    case 64:
      return launch_window<kPass, 2>(a, k);
    case 128:
      return launch_window<kPass, 4>(a, k);
    case 256:
      return launch_window<kPass, 8>(a, k);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The work table's arguments, after (pin, pout, ranges): seg_prefix
// (num_chunks + 1 int32, items before each chunk), seg_len (one int32, the
// plan's segment length), partials (float4 per own row of each item),
// counters (num_chunks + 2 int32, all 0 between launches).
extern "C" int launch_density_lambda(const void* pin, void* pout,
                                     const void* ranges,
                                     const void* seg_prefix,
                                     const void* seg_len, void* partials,
                                     void* counters, int n, int num_chunks,
                                     int own, float h, float h2, float eps,
                                     float poly6, float l2, float inv_rho0,
                                     float relax_eps, void* stream) {
  return dispatch<Pass::kLambda>(
      own,
      {pin, pout, ranges, seg_prefix, seg_len, partials, counters, n,
       num_chunks, stream},
      {h, h2, eps, poly6, l2, inv_rho0, relax_eps, 0.f, 0.f});
}

extern "C" int launch_density_rho(const void* pin, void* pout,
                                  const void* ranges, const void* seg_prefix,
                                  const void* seg_len, void* partials,
                                  void* counters, int n, int num_chunks,
                                  int own, float h2, float eps, float poly6,
                                  void* stream) {
  return dispatch<Pass::kRho>(
      own,
      {pin, pout, ranges, seg_prefix, seg_len, partials, counters, n,
       num_chunks, stream},
      {0.f, h2, eps, poly6, 0.f, 0.f, 0.f, 0.f, 0.f});
}

extern "C" int launch_project(const void* pin, void* pout, const void* ranges,
                              const void* seg_prefix, const void* seg_len,
                              void* partials, void* counters, int n,
                              int num_chunks, int own, float h, float h2,
                              float eps, float k_proj, float s_corr,
                              void* stream) {
  return dispatch<Pass::kProject>(
      own,
      {pin, pout, ranges, seg_prefix, seg_len, partials, counters, n,
       num_chunks, stream},
      {h, h2, eps, 0.f, 0.f, 0.f, 0.f, k_proj, s_corr});
}

// The launchers' interface version: 2 takes the work table (1, without this
// symbol, took one block per own-chunk).
extern "C" int pbf_window_abi() { return 2; }

extern "C" const char* pbf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
