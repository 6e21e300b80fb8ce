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
// SMs x occupancy blocks takes items from a counter, kGrab consecutive
// items at a time, so no block carries a heavy chunk's whole chain while
// the rest of the card idles.
//
// Staging. A block is kWarps warps that run the body and one producer
// warp. The producer takes the items, finds each item's chunk (32 probes
// of seg_prefix a round) and window pieces, and copies each tile of
// kStageLen candidates with the bulk copy engine (cp.async.bulk, a lane a
// window piece) into a ring of kStages shared-memory tiles, with a header
// that names the tile's item. Each stage has a full mbarrier (the copy's
// bytes landed) and an empty one (every body warp is done with it), so the
// producer runs ahead of the body across items: an item's tiles are in
// flight while the item before is summed and combined. The body's warps
// synchronise among themselves only (named barrier 1), at an item's
// begin and end. A body that needs another form of the candidates (the
// tensor-core fragment planes) converts each arrived tile into one of two
// plane buffers; the tile's stage is then free at once.
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
// A body provides (its functions run on the kWarps body warps alone):
//   kOwn, kGroups     own rows per item; row-sum groups added in order
//   kPlaneBytes       bytes of one converted tile (0: it reads the ring)
//   begin(pin, row0, n)           the item's own rows into registers (it
//                                 may synchronise the body's warps with
//                                 consumer_sync)
//   convert(tile, cnt, planes)    (kPlaneBytes > 0) a tile into planes
//   consume(tile, planes, cnt)    the pair work of one staged tile (cnt
//                                 > 0); with kPlaneBytes 0 each warp may
//                                 leave it as soon as it is done with the
//                                 tile
//   end(red)          red[g * kOwn + row] = the item's sums of group g
//   finish(me, s)     an output row from its position and combined sums

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pair_items {

constexpr int kWindows = 9;
// the body's warps, which consume the tiles (geometry.WARPS)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// and one producer warp, which takes the items and stages their tiles
constexpr int kBlockThreads = kThreads + 32;
constexpr int kStages = 3;  // geometry.STAGES
// candidates per ring stage (geometry.STAGE_LEN)
constexpr int kStageLen = 256;
// mbarrier words at the head of shared memory: a full and an empty
// barrier per stage
constexpr int kBarBytes = 2 * kStages * 8;
// consecutive items that the producer takes at a time
constexpr int kGrab = 2;
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// A barrier of the body's warps alone (named barrier 1): the producer
// warp never waits on it.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
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

// A staged tile's place in the work, which the producer writes beside it:
// the item, the tile's index in it and the item's tiles (an item with no
// candidates has one tile of none, so that its rows are still written),
// the tile's candidates, the item's chunk, its first item and its items.
// An item of -1 ends the block's stream.
struct TileHead {
  int item, t, ntiles, cnt, c, first, nseg;
};

// The producer warp: takes items until none is left, finds each item's
// chunk (32 probes of seg_prefix a round) and window pieces, and stages
// every tile of it into the ring, one bulk copy per window piece (a lane
// a piece), as soon as the body's warps have freed the tile's stage.
__device__ __forceinline__ void produce(
    const float4* __restrict__ pin, const int* __restrict__ ranges,
    const int* __restrict__ seg_prefix, int seg_len, int items,
    int* __restrict__ next_item, int num_chunks, float4* ring,
    uint64_t* full, uint64_t* empty, TileHead* heads) {
  const int lane = threadIdx.x & 31;
  uint32_t seq = 0;  // tiles staged
  // the stage of tile `seq`, once the body's warps have freed it
  auto stage = [&]() {
    const int s = seq % kStages;
    if (seq >= kStages) mbar_wait(&empty[s], (seq / kStages - 1) & 1);
    return s;
  };
  int c = 0;
  for (int item = 0, last = 0;; ++item) {
    if (item == last) {
      if (lane == 0) item = atomicAdd(next_item, kGrab);
      item = __shfl_sync(0xffffffffu, item, 0);
      last = min(item + kGrab, items);
      if (item >= items) {
        const int s = stage();
        if (lane == 0) {
          heads[s].item = -1;
          mbar_arrive(&full[s]);
        }
        return;
      }
      c = 0;
    }
    // the item's chunk: the last c with seg_prefix[c] <= item
    // (seg_prefix[0] = 0); the item after another of the same chunk keeps
    // its chunk
    if (c == 0 || seg_prefix[c + 1] <= item) {
      c = 0;
      for (int span = num_chunks; span > 1;) {
        const int step = (span + 31) >> 5;
        const int probe = c + lane * step;
        const bool le = probe < c + span && seg_prefix[probe] <= item;
        const int k = 31 - __clz(__ballot_sync(0xffffffffu, le));
        c += k * step;
        span = min(step, span - k * step);
      }
    }
    const int first = seg_prefix[c];
    const int nseg = seg_prefix[c + 1] - first;
    // lane w < 9 holds window w: its start, length, and the candidates of
    // the windows before it
    const int* win = ranges + c * (2 * kWindows);
    const int start = lane < kWindows ? win[2 * lane] : 0;
    const int len = lane < kWindows ? win[2 * lane + 1] - start : 0;
    int base = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, base, d);
      if (lane >= d) base += v;
    }
    const int total = __shfl_sync(0xffffffffu, base, 31);
    base -= len;
    const int p0 = (item - first) * seg_len;
    const int count = max(0, min(seg_len, total - p0));
    const int ntiles = max(1, (count + kStageLen - 1) / kStageLen);
    for (int t = 0; t < ntiles; ++t) {
      const int s = stage();
      const int q0 = p0 + t * kStageLen;
      const int q1 = p0 + min((t + 1) * kStageLen, count);
      if (lane == 0) {
        heads[s] = TileHead{item, t, ntiles, max(0, q1 - q0), c, first, nseg};
        mbar_arrive_expect_tx(&full[s],
                              uint32_t(max(0, q1 - q0)) * sizeof(float4));
      }
      __syncwarp();
      const int a = max(q0, base);
      const int b = min(q1, base + len);
      if (lane < kWindows && a < b) {
        bulk_copy(ring + s * kStageLen + (a - q0), pin + start + (a - base),
                  uint32_t(b - a) * sizeof(float4), &full[s]);
      }
      ++seq;
    }
  }
}

// One block takes items until none is left, with `body` doing the pair
// work of each on the first kWarps warps, and the last warp producing
// their tiles.
template <class Body>
__device__ __forceinline__ void run_items(
    Body& body, const float4* __restrict__ pin, float4* __restrict__ pout,
    const int* __restrict__ ranges, const int* __restrict__ seg_prefix,
    const int* __restrict__ seg_len_p, float4* __restrict__ partials,
    int* __restrict__ counters, int n, int num_chunks) {
  constexpr int own = Body::kOwn;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float4* ring = reinterpret_cast<float4*>(smem + kBarBytes);
  float4* red = ring + kStages * kStageLen;
  unsigned char* planes =
      reinterpret_cast<unsigned char*>(red + Body::kGroups * own);
  __shared__ TileHead heads[kStages];
  __shared__ int s_last;

  // Every index below fits an int with room to spare at the largest scene
  // the port runs (the 2M dam break: n_pad 2,000,000, 31,250 chunks): the
  // nine ranges of a chunk are disjoint ranges of the sorted array, so its
  // candidates, and each item's first candidate p0, stay under n_pad; a
  // row c * own + row is under n_pad; the items are at most
  // ITEMS_PER_CHUNK * chunks (500,000 there). Only the partials' row,
  // item * own (up to 16 * n_pad), is taken in size_t.
  const int seg_len = *seg_len_p;
  const int items = seg_prefix[num_chunks];
  int* next_item = counters + num_chunks;
  int* blocks_done = counters + num_chunks + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    produce(pin, ranges, seg_prefix, seg_len, items, next_item, num_chunks,
            ring, full, empty, heads);
  } else {
    const int lane = threadIdx.x & 31;
    for (uint32_t seq = 0;; ++seq) {
      const int s = seq % kStages;
      mbar_wait(&full[s], (seq / kStages) & 1);
      const TileHead h = heads[s];
      if (h.item < 0) break;
      if (h.t == 0) body.begin(pin, h.c * own, n);
      const float4* tile = ring + s * kStageLen;
      if (h.cnt == 0) {
        if (lane == 0) mbar_arrive(&empty[s]);
      } else if constexpr (Body::kPlaneBytes > 0) {
        // two plane buffers: every warp is past the pair work of the tile
        // before, which read the other one, once it passes this barrier
        unsigned char* pl = planes + (seq & 1) * Body::kPlaneBytes;
        body.convert(tile, h.cnt, pl);
        consumer_sync();  // planes written, stage s read by every warp
        if (lane == 0) mbar_arrive(&empty[s]);
        body.consume(tile, pl, h.cnt);
      } else {
        body.consume(tile, nullptr, h.cnt);
        __syncwarp();  // this warp is done with stage s
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (h.t < h.ntiles - 1) continue;

      // the item's groups' sums, added in group order, once every warp is
      // past the last item's reads of `red`
      consumer_sync();
      body.end(red);
      consumer_sync();
      for (int row = threadIdx.x; row < own; row += kThreads) {
        float4 p = red[row];
#pragma unroll
        for (int g = 1; g < Body::kGroups; ++g) add4(p, red[g * own + row]);
        const int i = h.c * own + row;
        if (h.nseg == 1) {
          if (i < n) pout[i] = body.finish(pin[i], p);
        } else {
          partials[size_t(h.item) * own + row] = p;
        }
      }
      if (h.nseg == 1) continue;

      // the chunk's last item to finish adds the partials in segment order
      __threadfence();
      consumer_sync();
      if (threadIdx.x == 0) {
        s_last = atomicAdd(&counters[h.c], 1) == h.nseg - 1;
        if (s_last) counters[h.c] = 0;
      }
      consumer_sync();
      if (s_last) {
        __threadfence();
        for (int row = threadIdx.x; row < own; row += kThreads) {
          const int i = h.c * own + row;
          if (i >= n) continue;
          float4 p = __ldcg(&partials[size_t(h.first) * own + row]);
          for (int g = 1; g < h.nseg; ++g) {
            add4(p, __ldcg(&partials[size_t(h.first + g) * own + row]));
          }
          pout[i] = body.finish(pin[i], p);
        }
      }
    }
  }

  // the last block out resets the item counters for the next launch
  __syncthreads();
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
// per kernel. The grid depends on the card and the kernel, never on n: the
// blocks take items until none is left, at any scene size.
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
                                                          kBlockThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = sms * per_sm;
  }
  kKernel<<<grid, kBlockThreads, smem,
            static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float4*>(a.pin), static_cast<float4*>(a.pout),
      static_cast<const int*>(a.ranges),
      static_cast<const int*>(a.seg_prefix),
      static_cast<const int*>(a.seg_len), static_cast<float4*>(a.partials),
      static_cast<int*>(a.counters), a.n, a.num_chunks, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pair_items
