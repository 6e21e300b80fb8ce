// The scheduler that every pair kernel of the PBF solve shares, for Hopper
// (sm_90a): work items on a persistent grid, the bulk-copy ring that stages
// their candidates, and the deterministic segment-order combine.
// pbf_window.cu (the FP32 kernels) and pbf_tc.cu (the tensor-core forms)
// include it, each with its pair body as a template functor.
//
// The work. Each own-chunk of `own` consecutive cell-sorted particles takes
// as candidates nine disjoint [start, end) ranges of the sorted array
// (build_plan in ops/cuda_pbf.py). The plan cuts each chunk's candidates
// (the virtual concatenation of its nine ranges) into segments of at most
// `seg_len` candidates; one work item is one (chunk, segment), and
// `seg_prefix[c]` counts the items before chunk c. A persistent grid of
// SMs x occupancy four-warp blocks takes items from a counter, so no block
// carries a heavy chunk's whole chain while the rest of the card idles.
//
// Staging. One thread copies each tile's window pieces with the bulk copy
// engine (cp.async.bulk, completed on an mbarrier) into a ring of kStages
// shared-memory tiles of kStageLen raw float4 candidate rows, so the next
// tiles are in flight while the current one is consumed. A body that needs
// another form of the candidates (the tensor-core fragment planes) converts
// each arrived tile into one of two plane buffers; the tile's ring slot is
// then free at once and the next copy goes out before the pair work starts.
//
// The combine, with no float atomics. The body leaves a float4 of row sums
// per (group, own row) in shared memory, and its groups are added in group
// order. A chunk of one segment writes its rows at once; a chunk of several
// writes each item's sums to a scratch slot, and the block that finishes
// the chunk's last segment (a per-chunk arrival counter after
// __threadfence, reset by that block) adds the slots in segment order and
// writes the rows. Two launches on one input give bitwise-equal output.
// The wrapper allocates the scratch; the kernel allocates nothing and
// leaves every counter at 0 for the next launch.
//
// A body provides:
//   kOwn, kGroups     own rows per item; row-sum groups added in order
//   kPlaneBytes       bytes of one converted tile (0: it reads the ring)
//   begin(pin, row0, n)           the item's own rows into registers
//   convert(tile, cnt, planes)    (kPlaneBytes > 0) a tile into planes
//   consume(tile, planes, cnt)    the pair work of one staged tile
//   end(red)          red[g * kOwn + row] = the item's sums of group g
//   finish(me, s)     an output row from its position and combined sums

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pair_items {

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

struct Consts {
  float h, h2, eps, poly6, l2, inv_rho0, relax_eps, k_proj, s_corr;
};

enum class Pass { kLambda, kRho, kProject };

// Dynamic shared memory of a body: barriers, the ring, the groups' row
// sums, two converted tiles.
template <class Body>
constexpr size_t smem_bytes() {
  return kBarBytes + sizeof(float4) * (size_t(kStages) * kStageLen +
                                       size_t(Body::kGroups) * Body::kOwn) +
         2 * size_t(Body::kPlaneBytes);
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

__device__ __forceinline__ void add4(float4& p, const float4& q) {
  p.x += q.x;
  p.y += q.y;
  p.z += q.z;
  p.w += q.w;
}

// One block takes items until none is left, with `body` doing the pair
// work of each.
template <class Body>
__device__ __forceinline__ void run_items(
    Body& body, const float4* __restrict__ pin, float4* __restrict__ pout,
    const int* __restrict__ ranges, const int* __restrict__ seg_prefix,
    const int* __restrict__ seg_len_p, float4* __restrict__ partials,
    int* __restrict__ counters, int n, int num_chunks) {
  constexpr int own = Body::kOwn;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float4* ring = reinterpret_cast<float4*>(smem + kBarBytes);
  float4* red = ring + kStages * kStageLen;
  unsigned char* planes =
      reinterpret_cast<unsigned char*>(red + Body::kGroups * own);
  __shared__ int s_item;
  __shared__ int s_last;

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

    body.begin(pin, c * own, n);
    for (int t = 0; t < ntiles; ++t) {
      const int s = (used + t) % kStages;
      mbar_wait(&bars[s], ((used + t) / kStages) & 1);
      const int cnt = min(kStageLen, count - t * kStageLen);
      const float4* tile = ring + s * kStageLen;
      if constexpr (Body::kPlaneBytes > 0) {
        // two plane buffers: every thread is past the pair work of tile
        // t - 1, which read the other one, once it passes this barrier
        unsigned char* pl = planes + ((used + t) & 1) * Body::kPlaneBytes;
        body.convert(tile, cnt, pl);
        __syncthreads();  // planes written, stage s read by every warp
        if (threadIdx.x == 0 && t + kStages < ntiles) issue(t + kStages);
        body.consume(tile, pl, cnt);
      } else {
        body.consume(tile, nullptr, cnt);
        __syncthreads();  // every warp is done with stage s
        if (threadIdx.x == 0 && t + kStages < ntiles) issue(t + kStages);
      }
    }
    used += ntiles;

    // the groups' sums, added in group order
    body.end(red);
    __syncthreads();
    for (int row = threadIdx.x; row < own; row += kThreads) {
      float4 p = red[row];
#pragma unroll
      for (int g = 1; g < Body::kGroups; ++g) add4(p, red[g * own + row]);
      const int i = c * own + row;
      if (nseg == 1) {
        if (i < n) pout[i] = body.finish(pin[i], p);
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
          add4(p, __ldcg(&partials[size_t(first + g) * own + row]));
        }
        pout[i] = body.finish(pin[i], p);
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

// Launch `kKernel` (a __global__ taking the Launch's arguments and `Args`)
// on its persistent grid: SMs x resident blocks at `smem` bytes, asked once
// per kernel.
template <auto kKernel, class... Args>
int launch_items(size_t smem, const Launch& a, Args... args) {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kKernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                          kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = sms * per_sm;
  }
  kKernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float4*>(a.pin), static_cast<float4*>(a.pout),
      static_cast<const int*>(a.ranges),
      static_cast<const int*>(a.seg_prefix),
      static_cast<const int*>(a.seg_len), static_cast<float4*>(a.partials),
      static_cast<int*>(a.counters), a.n, a.num_chunks, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pair_items
