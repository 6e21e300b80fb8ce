// The window plan on Hopper (sm_90a): each own-chunk's nine disjoint
// candidate windows, then the pair kernels' work table.
//
// What it replaces. No TPU kernel: the JAX package's `build_plan` and
// `restrict_plan` (pdb_sph_tpu/ops/pallas_pbf.py:101-263) are plain XLA.
// The port ran them as a chain of PyTorch ops (ops/cuda_pbf.py
// `build_plan_ref`, `work_table_ref`): the chunk spans, a searchsorted
// over every cell and two gathers of it, the cummax that makes the windows
// disjoint, the pad masks, the candidate sums and the work table's scan,
// some 44 small kernels a step.
//
// What bounds it. Latency: the plan reads the sorted cell ids (4 B a
// particle) and writes 72 B of ranges a chunk, microseconds of bytes even
// at 2M particles. Each window bound is a binary search over the sorted
// ids, ~20 dependent loads that stay in L2 (their first levels, which
// every search of a block shares, in L1); the work table's one block is
// bound by its rounds of shuffles.
//
// plan_windows_kernel: one half-warp a chunk. The chunk's span is
// [c_first, c_last], c_last the largest id below ncells (a mixed chunk's
// padding never stretches it), -1 if none. Lane w of 0-8 takes window w's
// first cell lo = clamp(c_first + off_w - 1, 0, ncells) and last cell hi
// = clamp(c_last + off_w + 1, -1, ncells - 1), off_w = dz W^2 + dy W in
// the order of `window_offsets`, and finds lower_bound(ids, lo) and
// lower_bound(ids, hi + 1) by two binary searches in step: the plain
// version's cell-starts table at those cells, since searchsorted's left
// side is the count of smaller ids. Two chunks a warp keep 16,000 chunks
// (1M particles) within one wave of resident warps. The nine windows are
// then made disjoint by one shuffle scan over lanes 0-8:
// reach = the inclusive max of max(start, end), carry = its exclusive max
// (0 for w = 0), start = max(start, carry), end = max(end, start), the
// plain version's cummax. An all-pad chunk (c_first >= ncells) gets nine
// empty (0, 0) windows. Integers only, so the ranges are the plain
// version's exactly.
//
// work_table_kernel: one block. total = sum(cand) in int64, seg_len =
// max(seg, ceil(total / spare)), items = max(1, ceil(cand / seg_len)) a
// chunk, and seg_prefix, their exclusive prefix: each warp scans a run of
// consecutive chunks in coalesced rounds, from the items of the runs
// before it. C's division truncates where torch's floors; the two differ
// only at cand = 0, where (cand - 1) / seg_len is 0 here and -1 there,
// and the clamp to one item makes both 1. With its counters given, the
// last warp, which holds the fewest chunks (often none), adds the
// table's items (seg_prefix's last entry) into `items` and the most items
// of one chunk into `items_max` while the others scan: items() rises with
// cand, so that is the items of the largest cand, whose block max rides
// beside the sum. One block, one writing thread: a plain add in the
// stream's order.
//
// The launchers take raw pointers and the stream, never synchronise, and
// return cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindows = 9;
constexpr int kPlanWarps = 8;        // warps a block of plan_windows_kernel
constexpr int kTableThreads = 1024;  // work_table_kernel's one block
constexpr int kTableWarps = kTableThreads / 32;

// The first indices of `ids` (n >= 1 sorted ints) whose values are not
// below key_a and key_b: the counts of ids below each. Two binary
// searches in step, so that their loads are in flight together; a search
// that has ended reads a valid index and keeps its result.
__device__ __forceinline__ void lower_bounds(const int* __restrict__ ids,
                                             int n, int key_a, int key_b,
                                             int& a, int& b) {
  int lo_a = 0, n_a = n, lo_b = 0, n_b = n;
  while (n_a > 0 || n_b > 0) {
    const int h_a = n_a >> 1, h_b = n_b >> 1;
    const int v_a = __ldg(ids + min(lo_a + h_a, n - 1));
    const int v_b = __ldg(ids + min(lo_b + h_b, n - 1));
    if (n_a > 0) {
      if (v_a < key_a) {
        lo_a += h_a + 1;
        n_a -= h_a + 1;
      } else {
        n_a = h_a;
      }
    }
    if (n_b > 0) {
      if (v_b < key_b) {
        lo_b += h_b + 1;
        n_b -= h_b + 1;
      } else {
        n_b = h_b;
      }
    }
  }
  a = lo_a;
  b = lo_b;
}

// One half-warp a chunk, two chunks a warp: lanes 0-8 of a half each take
// one window's start and end.
__global__ void __launch_bounds__(kPlanWarps * 32)
    plan_windows_kernel(const int* __restrict__ ids, int n_pad, int chunks,
                        int own, int ncells, int width,
                        int* __restrict__ ranges,
                        long long* __restrict__ cand) {
  const int lane = threadIdx.x & 15;  // the lane within its half
  const int pair = blockIdx.x * kPlanWarps + (threadIdx.x >> 5);
  if (2 * pair >= chunks) return;  // the whole warp leaves together
  const int c = 2 * pair + ((threadIdx.x >> 4) & 1);
  const bool live = c < chunks;
  const int* chunk = ids + static_cast<long long>(c) * own;

  int c_first = ncells, c_last = -1;
  if (live) {
    c_first = __ldg(chunk);
    for (int k = lane; k < own; k += 16) {
      const int id = __ldg(chunk + k);
      if (id < ncells) c_last = max(c_last, id);
    }
  }
#pragma unroll
  for (int d = 8; d > 0; d >>= 1)
    c_last = max(c_last, __shfl_xor_sync(kFull, c_last, d));

  int start = 0, end = 0;
  if (live && lane < kWindows) {
    const int off = (lane / 3 - 1) * width * width + (lane % 3 - 1) * width;
    const int lo = min(max(c_first + off - 1, 0), ncells);
    const int hi = min(max(c_last + off + 1, -1), ncells - 1);
    lower_bounds(ids, n_pad, lo, hi + 1, start, end);
  }

  // the inclusive running max of the reach over lanes 0-8 of each half: a
  // shuffle up of width 16 reads only lower lanes of the same half
  int reach = lane < kWindows ? max(start, end) : 0;
#pragma unroll
  for (int d = 1; d < 16; d <<= 1) {
    const int up = __shfl_up_sync(kFull, reach, d, 16);
    if (lane >= d) reach = max(reach, up);
  }
  int carry = __shfl_up_sync(kFull, reach, 1, 16);
  if (lane == 0) carry = 0;
  start = max(start, carry);
  end = max(end, start);
  if (c_first >= ncells || lane >= kWindows) start = end = 0;

  if (live && lane < kWindows) {
    int* out = ranges + (static_cast<long long>(c) * kWindows + lane) * 2;
    out[0] = start;
    out[1] = end;
  }
  int n_cand = end - start;
#pragma unroll
  for (int d = 8; d > 0; d >>= 1)
    n_cand += __shfl_xor_sync(kFull, n_cand, d);
  if (live && lane == 0) cand[c] = n_cand;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// The inclusive prefix sum of one value a lane, in lane order.
__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// ceil(cand / seg_len), and one item for a chunk without candidates. cand
// <= n_pad fits an int, so the division is 32-bit: C truncates where
// torch floors, which differ only at cand = 0 (0 here, -1 there), where
// the clamp makes both 1.
__device__ __forceinline__ int items(long long cand, int seg_len) {
  return max((static_cast<int>(cand) - 1) / seg_len + 1, 1);
}

// Each warp takes a run of consecutive chunks, a multiple of 32 long, and
// reads it in coalesced rounds of 32: first the sum and the run's items at
// the geometry's seg, then, after one block sum of the runs, the prefix,
// carried from round to round. Only where the candidates stretch the
// segments (seg_len > seg, the same in every thread) does a pass between
// count the run's items again at seg_len.
__global__ void __launch_bounds__(kTableThreads)
    work_table_kernel(const long long* __restrict__ cand, int chunks,
                      int seg, int spare, int* __restrict__ seg_len_out,
                      int* __restrict__ seg_prefix,
                      long long* __restrict__ total_out,
                      int* __restrict__ overflow,
                      long long* __restrict__ items_out,
                      long long* __restrict__ items_max_out) {
  __shared__ long long warp_total[kTableWarps];
  __shared__ long long warp_largest[kTableWarps];
  __shared__ int warp_items[kTableWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (chunks + kTableThreads - 1) / kTableThreads * 32;
  const int first = min(warp * per, chunks);
  const int last = min(first + per, chunks);

  long long t = 0, largest = 0;
  int run = 0;
#pragma unroll 4
  for (int c = first + lane; c < last; c += 32) {
    const long long v = __ldg(cand + c);
    t += v;
    largest = max(largest, v);
    run += items(v, seg);
  }
  t = warp_sum(t);
  largest = warp_max(largest);
  run = warp_sum(run);
  if (lane == 0) {
    warp_total[warp] = t;
    warp_largest[warp] = largest;
    warp_items[warp] = run;
  }
  __syncthreads();
  const long long total = warp_sum(lane < kTableWarps ? warp_total[lane]
                                                      : 0LL);
  const long long wide = (total + (spare - 1)) / spare;
  const int seg_len = static_cast<int>(wide > seg ? wide : seg);
  if (seg_len != seg) {
    run = 0;
#pragma unroll 4
    for (int c = first + lane; c < last; c += 32)
      run += items(__ldg(cand + c), seg_len);
    run = warp_sum(run);
    if (lane == 0) warp_items[warp] = run;  // no warp has read it yet
    __syncthreads();
  }
  if (items_out != nullptr && warp == kTableWarps - 1) {
    const int all = warp_sum(lane < kTableWarps ? warp_items[lane] : 0);
    largest = warp_max(lane < kTableWarps ? warp_largest[lane] : 0LL);
    if (lane == 0) {
      *items_out += all;
      *items_max_out += items(largest, seg_len);
    }
  }
  // the items of the runs before this warp's
  int carry = warp_sum(lane < warp ? warp_items[lane] : 0);
#pragma unroll 4
  for (int base = first; base < last; base += 32) {
    const int c = base + lane;
    const int incl = warp_inclusive_scan(
        c < last ? items(__ldg(cand + c), seg_len) : 0);
    if (c < last) seg_prefix[c + 1] = carry + incl;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (threadIdx.x == 0) {
    seg_prefix[0] = 0;
    *seg_len_out = seg_len;
    *total_out = total;
    if (overflow != nullptr) *overflow = 0;
  }
}

}  // namespace

// (sorted_cid, n_pad, chunks, own, ncells, width, ranges, cand, stream):
// sorted_cid is n_pad ascending int32 cell ids, padding = ncells; ranges
// (chunks, 9, 2) int32 and cand (chunks,) int64 are written whole.
extern "C" int launch_plan_windows(const void* sorted_cid, int n_pad,
                                   int chunks, int own, int ncells, int width,
                                   void* ranges, void* cand, void* stream) {
  if (chunks > 0) {
    const dim3 grid((chunks + 2 * kPlanWarps - 1) / (2 * kPlanWarps));
    plan_windows_kernel<<<grid, kPlanWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(sorted_cid), n_pad, chunks, own, ncells,
        width, static_cast<int*>(ranges), static_cast<long long*>(cand));
  }
  return static_cast<int>(cudaGetLastError());
}

// (cand, chunks, seg, spare, seg_len, seg_prefix, total, overflow, items,
// items_max, stream): cand (chunks,) int64; writes seg_len () int32,
// seg_prefix (chunks + 1,) int32, total () int64 and, unless overflow is
// NULL, a 0 into overflow () int32; unless items is NULL, adds the table's
// items into items () int64 and the most items of one chunk into
// items_max () int64 (both NULL or neither). spare = items beyond one a
// chunk, > 0.
extern "C" int launch_work_table(const void* cand, int chunks, int seg,
                                 int spare, void* seg_len,
                                 void* seg_prefix, void* total,
                                 void* overflow, void* items,
                                 void* items_max, void* stream) {
  if ((items == nullptr) != (items_max == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  work_table_kernel<<<1, kTableThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cand), chunks, seg, spare,
      static_cast<int*>(seg_len), static_cast<int*>(seg_prefix),
      static_cast<long long*>(total), static_cast<int*>(overflow),
      static_cast<long long*>(items), static_cast<long long*>(items_max));
  return static_cast<int>(cudaGetLastError());
}

// The launchers' interface: 2 since launch_work_table takes the work-item
// counters.
extern "C" int pbf_plan_abi() { return 2; }
