// The FP32 pair kernels of the PBF constraint solve, for Hopper (sm_90a).
//
// What each replaces. window_kernel<kLambda> is K1, the TPU kernel
// `_density_kernel` (pdb_sph_tpu/ops/pallas_pbf.py:424, launched by
// density_pass :608); window_kernel<kRho> serves the diagnostic density of
// diagnostics_fn (core/step.py), which the JAX package computes in plain
// XLA; window_kernel<kProject> is K2, `_project_kernel` (:477, launched by
// project_pass :633). All three stream what `_pair_loop` (:333) streamed.
//
// The work. Each own-chunk of `own` consecutive cell-sorted particles takes
// as candidates nine disjoint [start, end) ranges of the sorted array
// (build_plan in ops/cuda_pbf.py). Every (own row, candidate) pair costs
// its distance, deltas and rd2: 8 flops, an FMA counted as 2. Only a pair
// within h, whose terms the clamp does not zero, needs the rest of the
// body: ~10 flops (lambda), ~4 (rho) or ~11 (project), and one rsqrtf
// except for rho. At the 80k dam break (own 64, 1,250 chunks) that is
// ~195 M pairs a launch mid-collapse, 13.6 % of them within h, and ~170 M
// settled, 14.6 % within h (chip_smoke.py counts them): ~22-28 us of FP32
// work at the H100's 67 TFLOP/s, more than the rsqrt units need (16 a
// clock per SM, ~6 us) and far more than the bytes (~2.7 MB in and out,
// < 1 us). The kernels are compute-bound. This kernel evaluates every
// pair's whole body, without a branch.
//
// The design, against the four limits of one block per own-chunk:
//  1. The heaviest chunk no longer sets the time. The plan cuts each
//     chunk's candidates (the virtual concatenation of its nine ranges)
//     into segments of at most `seg_len` candidates; one work item is one
//     (chunk, segment). A persistent grid of SMs x occupancy blocks takes
//     items from a counter, so no block carries a 13k-candidate chain while
//     the rest of the card idles.
//  2. Occupancy: four-warp blocks, as many as fit on an SM (registers
//     decide), in place of 1,250 blocks of two warps.
//  3. Staging: one thread copies each tile's window pieces with the bulk
//     copy engine (cp.async.bulk, completed on an mbarrier) into a ring of
//     kStages shared-memory tiles of kStageLen candidates (a constant:
//     256 ran 2-4 % faster than 128 on an H100), so the next tiles are in
//     flight while the current one is consumed. A candidate is a 16-byte,
//     16-byte aligned float4 row, which is what the bulk copy takes.
//  4. Reuse: each lane holds own/32 own rows in registers and the four
//     warps split each tile, so one broadcast shared load feeds own/32
//     independent pair chains.
//
// A deterministic combine with no float atomics. The four warps' sums meet
// in shared memory in warp order. A chunk of one segment writes its rows at
// once. A chunk of several writes each item's sums to a scratch slot; the
// block that finishes the chunk's last segment (a per-chunk arrival
// counter after __threadfence, reset by that block) adds the slots in
// segment order and writes the rows. So two launches on one input give
// bitwise-equal output. The wrapper allocates the scratch; the kernel
// allocates nothing, and leaves every counter at 0 for the next launch.
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWindows = 9;
constexpr int kWarps = 4;  // geometry.WARPS
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;  // geometry.STAGES
// candidates per ring stage (geometry.STAGE_LEN)
constexpr int kStageLen = 256;
// mbarrier words at the head of shared memory, padded to 16 bytes
constexpr int kBarBytes = 32;
// a wait that has not seen its tile after this many tries traps, so a
// fault shows as a failed launch and not as a hung card
constexpr uint32_t kSpinLimit = 1u << 24;

enum class Pass { kLambda, kRho, kProject };

struct Consts {
  float h, h2, eps, poly6, l2, inv_rho0, relax_eps, k_proj, s_corr;
};

size_t window_smem_bytes(int own) {
  return kBarBytes +
         sizeof(float4) * (size_t(kStages) * kStageLen + size_t(kWarps) * own);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == kSpinLimit) __trap();
  }
}

// global -> shared bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 1 / sqrt(x) for a normal x: the same MUFU.RSQ value as rsqrtf, without
// the scaling rsqrtf wraps around it for subnormal inputs. rd2 is clamped
// to at least eps = 1e-16, far above FLT_MIN, so every input is normal.
// On an H100 (benchmarks_torch/kernel_ab.py) the output was bitwise equal
// to rsqrtf's and the lambda and project kernels ~16 % faster.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The output row from the row's position (and lambda) and its sums.
template <Pass kPass>
__device__ __forceinline__ float4 finish(float4 me, float4 s,
                                         const Consts& k) {
  if constexpr (kPass == Pass::kLambda) {
    const float rho = k.poly6 * s.x;
    const float g2 = k.l2 * s.y;
    const float c = rho * k.inv_rho0 - 1.f;
    return make_float4(me.x, me.y, me.z, -c / (g2 + k.relax_eps));
  } else if constexpr (kPass == Pass::kRho) {
    return make_float4(me.x, me.y, me.z, k.poly6 * s.x);
  } else {
    return make_float4(me.x + k.k_proj * s.x, me.y + k.k_proj * s.y,
                       me.z + k.k_proj * s.z, me.w);
  }
}

// One block takes items until none is left. R own rows per lane: lane l
// holds rows l, l + 32, ..., of the item's chunk; warp w takes candidates
// w, w + 4, ... of each staged tile. kLambda writes (x, y, z, lambda) into
// pout, so the density -> project hand-over needs no separate lambda
// splice; kRho writes (x, y, z, rho) and skips the gradient sum; kProject
// writes p_i + k * sum_j (h - r)^2 (lambda_i + s_corr + lambda_j)
// (p_i - p_j) with lambda_i carried through (the self pair has
// dx = dy = dz = 0 exactly and adds s * 0).
template <Pass kPass, int R>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const float4* __restrict__ pin, float4* __restrict__ pout,
                  const int* __restrict__ ranges,
                  const int* __restrict__ seg_prefix,
                  const int* __restrict__ seg_len_p,
                  float4* __restrict__ partials, int* __restrict__ counters,
                  int n, int num_chunks, Consts k) {
  constexpr int own = 32 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float4* ring = reinterpret_cast<float4*>(smem + kBarBytes);
  float4* red = ring + kStages * kStageLen;
  __shared__ int s_item;
  __shared__ int s_last;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg_len = *seg_len_p;
  const int items = seg_prefix[num_chunks];
  int* next_item = counters + num_chunks;
  int* blocks_done = counters + num_chunks + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // tiles consumed by this block; thread 0 issues them in the same order
  uint32_t used = 0;

  for (;;) {
    if (threadIdx.x == 0) s_item = atomicAdd(next_item, 1);
    __syncthreads();  // also: the last item's ring and `red` are free
    const int item = s_item;
    if (item >= items) break;

    // the item's chunk: the last c with seg_prefix[c] <= item
    int lo = 0, hi = num_chunks - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (seg_prefix[mid] <= item) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int c = lo;
    const int first = seg_prefix[c];
    const int nseg = seg_prefix[c + 1] - first;
    const int* win = ranges + c * (2 * kWindows);
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWindows; ++w) total += win[2 * w + 1] - win[2 * w];
    const int p0 = (item - first) * seg_len;
    const int count = max(0, min(seg_len, total - p0));
    const int ntiles = (count + kStageLen - 1) / kStageLen;

    // tile t of the item into stage (used + t) % kStages: one bulk copy
    // per window piece, all completing on the stage's barrier
    auto issue = [&](int t) {
      const int s = (used + t) % kStages;
      const int q0 = p0 + t * kStageLen;
      const int q1 = p0 + min((t + 1) * kStageLen, count);
      mbar_arrive_expect_tx(&bars[s], uint32_t(q1 - q0) * sizeof(float4));
      int base = 0;
      for (int w = 0; w < kWindows; ++w) {
        const int start = win[2 * w];
        const int len = win[2 * w + 1] - start;
        const int a = max(q0, base);
        const int b = min(q1, base + len);
        if (a < b) {
          bulk_copy(ring + s * kStageLen + (a - q0), pin + start + (a - base),
                    uint32_t(b - a) * sizeof(float4), &bars[s]);
        }
        base += len;
      }
    };
    if (threadIdx.x == 0) {
      for (int t = 0; t < min(kStages, ntiles); ++t) issue(t);
    }

    float4 me[R];
    float olam[R];  // lambda_i + s_corr (kProject)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      me[r] = pin[c * own + lane + 32 * r];
      olam[r] = me[r].w + k.s_corr;
    }
    float a0[R], a1[R], a2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a0[r] = a1[r] = a2[r] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
      const int s = (used + t) % kStages;
      mbar_wait(&bars[s], ((used + t) / kStages) & 1);
      const int cnt = min(kStageLen, count - t * kStageLen);
      const float4* cand = ring + s * kStageLen;
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
      __syncthreads();  // every warp is done with stage s
      if (threadIdx.x == 0 && t + kStages < ntiles) issue(t + kStages);
    }
    used += ntiles;

    // the four warps' sums, added in warp order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      red[warp * own + lane + 32 * r] = make_float4(a0[r], a1[r], a2[r], 0.f);
    }
    __syncthreads();
    for (int row = threadIdx.x; row < own; row += kThreads) {
      float4 p = red[row];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 q = red[w * own + row];
        p.x += q.x;
        p.y += q.y;
        p.z += q.z;
      }
      const int i = c * own + row;
      if (nseg == 1) {
        if (i < n) pout[i] = finish<kPass>(pin[i], p, k);
      } else {
        partials[size_t(item) * own + row] = p;
      }
    }
    if (nseg == 1) continue;

    // the chunk's last item to finish adds the partials in segment order
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_last = atomicAdd(&counters[c], 1) == nseg - 1;
      if (s_last) counters[c] = 0;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (int row = threadIdx.x; row < own; row += kThreads) {
        const int i = c * own + row;
        if (i >= n) continue;
        float4 p = __ldcg(&partials[size_t(first) * own + row]);
        for (int g = 1; g < nseg; ++g) {
          const float4 q = __ldcg(&partials[size_t(first + g) * own + row]);
          p.x += q.x;
          p.y += q.y;
          p.z += q.z;
        }
        pout[i] = finish<kPass>(pin[i], p, k);
      }
    }
  }

  // the last block out resets the item counters for the next launch
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(blocks_done, 1) == int(gridDim.x) - 1) {
      *next_item = 0;
      *blocks_done = 0;
    }
  }
}

// A launch's pointers and sizes, as the launchers receive them.
struct Launch {
  const void* pin;
  void* pout;
  const void* ranges;
  const void* seg_prefix;
  const void* seg_len;
  void* partials;
  void* counters;
  int n, num_chunks;
  void* stream;
};

// Grid of one instantiation: SMs x resident blocks at this shared memory,
// asked once per shared-memory size.
template <Pass kPass, int R>
int launch_window(const Launch& a, const Consts& k) {
  static size_t cached_smem = 0;
  static int grid = 0;
  const auto kernel = window_kernel<kPass, R>;
  const size_t smem = window_smem_bytes(32 * R);
  if (smem != cached_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = sms * per_sm;
    cached_smem = smem;
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float4*>(a.pin), static_cast<float4*>(a.pout),
      static_cast<const int*>(a.ranges),
      static_cast<const int*>(a.seg_prefix),
      static_cast<const int*>(a.seg_len), static_cast<float4*>(a.partials),
      static_cast<int*>(a.counters), a.n, a.num_chunks, k);
  return static_cast<int>(cudaGetLastError());
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
