// The two pair kernels of the PBF constraint solve, for Hopper (sm_90a).
//
// density_lambda_kernel replaces the TPU kernel `_density_kernel`
// (pdb_sph_tpu/ops/pallas_pbf.py:424, launched by density_pass :608); its
// kRho instantiation serves the diagnostic density of diagnostics_fn
// (core/step.py), which the JAX package computes in plain XLA;
// project_kernel replaces `_project_kernel` (:477, launched by
// project_pass :633). Both stream what `_pair_loop` (:333) streamed.
//
// Work split. One block per own-chunk of `own` consecutive cell-sorted
// particles, one thread per own particle. The chunk's candidates are nine
// disjoint [start, end) ranges of the sorted array (build_plan in
// ops/cuda_pbf.py): cell ids run x-fastest, so the 27-cell stencil of the
// chunk's cell span is one contiguous run per (dy, dz). The ranges are exact
// and never reach a padding row, so no candidate needs a mask; only own rows
// past n are guarded.
//
// What bounds it. FP32 pair math: ~20 flops and one rsqrt per pair, with no
// reuse of a pair's work, over the ~2-3k candidates of each own particle.
// The tiling keeps memory out of the way: each candidate (x, y, z, lambda)
// is read from device memory once per block as a coalesced 16-byte float4,
// staged in shared memory `tile` at a time, and read back by every thread
// of the block as a broadcast (one conflict-free 16-byte shared load per
// pair). The sums stay in registers; each thread writes one float4.
//
// Numerics follow the JAX kernels: rd2 is clamped to [eps, h^2], which
// zeroes every pair at or beyond h without a branch; r = rd2 * rsqrtf(rd2);
// the constant factors are applied once after the stream. Build without
// --use_fast_math: reduced-precision pair math kept the fluid from settling
// on the TPU although the CPU parity tests passed.
//
// Launchers take raw pointers and the stream, never synchronise, and
// return cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>

namespace {

constexpr int kWindows = 9;

// What a density pass writes into column 3 of each own row: lambda_i for
// the solve, or rho_i alone for the diagnostics.
enum class DensityOut { kLambda, kRho };

// The density pass over the chunk's windows. kLambda writes
// (x, y, z, lambda) into pout, so the density -> project hand-over needs no
// separate lambda splice. kRho writes (x, y, z, rho) with
// rho = poly6 * sum (h^2 - rd2)^3 and skips the gradient sum: the
// diagnostic density of the current state, through the same stream as the
// solve, with no capacity that could drop a particle.
template <DensityOut kOut>
__global__ void density_lambda_kernel(const float4* __restrict__ pin,
                                      float4* __restrict__ pout,
                                      const int* __restrict__ ranges, int n,
                                      int tile, float h, float h2, float eps,
                                      float poly6, float l2, float inv_rho0,
                                      float relax_eps) {
  extern __shared__ float4 cand[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const float4 me = active ? pin[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const int* win = ranges + blockIdx.x * (2 * kWindows);

  float s_rho = 0.f;  // sum (h^2 - rd2)^3
  float s_g2 = 0.f;   // sum (h - r)^4 rd2 (kLambda only)
  for (int w = 0; w < kWindows; ++w) {
    const int start = win[2 * w];
    const int end = win[2 * w + 1];
    for (int base = start; base < end; base += tile) {
      const int cnt = min(tile, end - base);
      for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
        cand[k] = pin[base + k];
      }
      __syncthreads();
      if (active) {
#pragma unroll 4
        for (int k = 0; k < cnt; ++k) {
          const float4 c = cand[k];
          const float dx = me.x - c.x;
          const float dy = me.y - c.y;
          const float dz = me.z - c.z;
          float rd2 = dx * dx + dy * dy + dz * dz;
          rd2 = fmaxf(fminf(rd2, h2), eps);
          // Each output has a pair body of its own. The lambda body keeps
          // this order (u before t2, both sums last): with the rho sum
          // moved above the rsqrt, nvcc gave the kernel 31 registers in
          // place of 34 and it ran ~11 % slower on an H100.
          if constexpr (kOut == DensityOut::kLambda) {
            const float t = h2 - rd2;
            const float u = h - rd2 * rsqrtf(rd2);
            const float t2 = t * t;
            const float u2 = u * u;
            s_rho += t2 * t;
            s_g2 += (u2 * u2) * rd2;
          } else {
            const float t = h2 - rd2;
            s_rho += (t * t) * t;
          }
        }
      }
      __syncthreads();
    }
  }
  if (active) {
    const float rho = poly6 * s_rho;
    float out;
    if constexpr (kOut == DensityOut::kLambda) {
      const float g2 = l2 * s_g2;
      const float c = rho * inv_rho0 - 1.f;
      out = -c / (g2 + relax_eps);
    } else {
      out = rho;
    }
    pout[i] = make_float4(me.x, me.y, me.z, out);
  }
}

// p_i + k * sum_j (h - r)^2 (lambda_i + s_corr + lambda_j) (p_i - p_j);
// lambda_i is carried through in the fourth column. The self pair has
// dx = dy = dz = 0 exactly and adds s * 0.
__global__ void project_kernel(const float4* __restrict__ pin,
                               float4* __restrict__ pout,
                               const int* __restrict__ ranges, int n,
                               int tile, float h, float h2, float eps,
                               float k_proj, float s_corr) {
  extern __shared__ float4 cand[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const float4 me = active ? pin[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float olam = me.w + s_corr;
  const int* win = ranges + blockIdx.x * (2 * kWindows);

  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int w = 0; w < kWindows; ++w) {
    const int start = win[2 * w];
    const int end = win[2 * w + 1];
    for (int base = start; base < end; base += tile) {
      const int cnt = min(tile, end - base);
      for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
        cand[k] = pin[base + k];
      }
      __syncthreads();
      if (active) {
#pragma unroll 4
        for (int k = 0; k < cnt; ++k) {
          const float4 c = cand[k];
          const float dx = me.x - c.x;
          const float dy = me.y - c.y;
          const float dz = me.z - c.z;
          float rd2 = dx * dx + dy * dy + dz * dz;
          rd2 = fmaxf(fminf(rd2, h2), eps);
          const float u = h - rd2 * rsqrtf(rd2);
          const float s = (u * u) * (olam + c.w);
          ax += s * dx;
          ay += s * dy;
          az += s * dz;
        }
      }
      __syncthreads();
    }
  }
  if (active) {
    pout[i] = make_float4(me.x + k_proj * ax, me.y + k_proj * ay,
                          me.z + k_proj * az, me.w);
  }
}

}  // namespace

extern "C" int launch_density_lambda(const void* pin, void* pout,
                                     const void* ranges, int n,
                                     int num_chunks, int own, int tile,
                                     float h, float h2, float eps, float poly6,
                                     float l2, float inv_rho0,
                                     float relax_eps, void* stream) {
  density_lambda_kernel<DensityOut::kLambda>
      <<<num_chunks, own, tile * sizeof(float4),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float4*>(pin), static_cast<float4*>(pout),
          static_cast<const int*>(ranges), n, tile, h, h2, eps, poly6, l2,
          inv_rho0, relax_eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_density_rho(const void* pin, void* pout,
                                  const void* ranges, int n, int num_chunks,
                                  int own, int tile, float h2, float eps,
                                  float poly6, void* stream) {
  density_lambda_kernel<DensityOut::kRho>
      <<<num_chunks, own, tile * sizeof(float4),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float4*>(pin), static_cast<float4*>(pout),
          static_cast<const int*>(ranges), n, tile, 0.f, h2, eps, poly6, 0.f,
          0.f, 0.f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_project(const void* pin, void* pout, const void* ranges,
                              int n, int num_chunks, int own, int tile,
                              float h, float h2, float eps, float k_proj,
                              float s_corr, void* stream) {
  project_kernel<<<num_chunks, own, tile * sizeof(float4),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pin), static_cast<float4*>(pout),
      static_cast<const int*>(ranges), n, tile, h, h2, eps, k_proj, s_corr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pbf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
