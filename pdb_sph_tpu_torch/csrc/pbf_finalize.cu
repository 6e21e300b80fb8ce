// Finalize on Hopper (sm_90a): the velocity, the six ordered walls, the
// final clamp and the non-finite flag, one thread a particle.
//
// What it replaces. No TPU kernel: the JAX package's finalize is plain XLA
// (pdb_sph_tpu/ops/collide.py `finalize`, which XLA fuses). The port ran it
// as a chain of PyTorch ops (ops/collide.py `finalize_ref`, ~18 kernels a
// wall) followed by the step's finite check (isfinite, all, cast, cat):
// ~117 small kernels a step, each re-reading and re-writing the arrays.
//
// What bounds it. Bytes: per particle it reads p (its 12 B sit in the
// 16 B row of the solve's buffer, a sector's share) and the last position
// (12 B) and writes x and v (24 B), 52 B in all; 80k particles are 4.2 MB (1.2 us at 3.35 TB/s), 1M
// 52 MB (15.5 us). The arithmetic, a few dozen flops a particle, is far
// below the bytes.
//
// Same bits as the chain. Every operation that the chain runs as a kernel
// of its own is one rounded operation here: __fsub_rn, __fmul_rn and
// __fdiv_rn, which are never contracted into an FMA. The constants arrive
// as the wrapper computes them for the chain (f32(1 - cd), f32(cd),
// f32(wall)); PyTorch's CUDA division by a host scalar multiplies by the
// float32 reciprocal, so the velocity is (p - last) * fl(1 / dt) with the
// reciprocal from the host. -1 (the reflection) comes as an argument so
// that the compiler cannot turn the multiplication into a sign flip, which
// would treat a NaN otherwise. The clamp passes a NaN through unchanged,
// as torch.clamp does, and the walls select with the chain's tests, so a
// NaN velocity at a wall bounces in the strict mode exactly where the
// chain's `va != 0` does. Where a wall hits, its velocity is never 0, so
// the chain's `where(va == 0, 1, va)` divisor is the velocity itself.
//
// The flag. A warp that holds a non-finite coordinate of the final x or v
// raises the flag once (__any_sync, then one atomic); the caller zeroes it.
//
// The launcher takes raw pointers and the stream, never synchronises, and
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Consts {
  float inv_dt;    // fl(1 / f32(dt)), the host's float32 reciprocal
  float wall;      // f32(wall)
  float two_wall;  // 2 * f32(wall), exact
  float keep;      // f32(1 - collision_damp)
  float damp;      // f32(collision_damp)
  float flip;      // -1
};

// One wall of the chain's `_bounce`: past the wall and moving (out, or in
// the strict mode at all), rewind all three coordinates by the impact
// time, mirror the wall's coordinate, reflect and damp the velocity.
template <int kAxis, bool kUpper, bool kStrict>
__device__ __forceinline__ void bounce(float (&pos)[3], float (&vel)[3],
                                       const Consts& c) {
  const float w = kUpper ? c.wall : 0.0f;
  const float pa = pos[kAxis];
  const float va = vel[kAxis];
  bool hit;
  if (kStrict) {
    hit = (kUpper ? pa > w : pa < w) && va != 0.0f;
  } else {
    hit = kUpper ? (pa > w && va > 0.0f) : (pa < w && va < 0.0f);
  }
  if (!hit) return;
  const float t = __fdiv_rn(__fsub_rn(pa, w), va);
  const float s = __fmul_rn(c.keep, t);
  float rw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) rw[k] = __fsub_rn(pos[k], __fmul_rn(vel[k], s));
  rw[kAxis] = __fsub_rn(kUpper ? c.two_wall : 0.0f, rw[kAxis]);
  vel[kAxis] = __fmul_rn(vel[kAxis], c.flip);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[k] = rw[k];
    vel[k] = __fmul_rn(vel[k], c.damp);
  }
}

// torch.clamp(v, 0, wall) on the card: a NaN passes unchanged
__device__ __forceinline__ float clamp_box(float v, float wall) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), wall);
}

template <bool kStrict>
__global__ void __launch_bounds__(kThreads)
    finalize_kernel(const float* __restrict__ p, int p_stride,
                    const float* __restrict__ last, int last_stride,
                    float* __restrict__ x_out, float* __restrict__ v_out,
                    int* __restrict__ nonfinite, int n, Consts c) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool bad = false;
  if (i < n) {
    float pos[3], vel[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos[k] = p[static_cast<long long>(i) * p_stride + k];
      const float l = last[static_cast<long long>(i) * last_stride + k];
      vel[k] = __fmul_rn(__fsub_rn(pos[k], l), c.inv_dt);
    }
    // the reference's order (src/FluidSimulator.cu:362-439)
    bounce<1, false, kStrict>(pos, vel, c);
    bounce<1, true, kStrict>(pos, vel, c);
    bounce<0, false, kStrict>(pos, vel, c);
    bounce<2, false, kStrict>(pos, vel, c);
    bounce<0, true, kStrict>(pos, vel, c);
    bounce<2, true, kStrict>(pos, vel, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (!kStrict) pos[k] = clamp_box(pos[k], c.wall);
      x_out[3 * static_cast<long long>(i) + k] = pos[k];
      v_out[3 * static_cast<long long>(i) + k] = vel[k];
      bad |= !isfinite(pos[k]) || !isfinite(vel[k]);
    }
  }
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0)
    atomicOr(nonfinite, 1);
}

}  // namespace

// (p, p_stride, last, last_stride, x, v, nonfinite, n, inv_dt, wall, keep,
// damp, strict, stream): p and last are n rows of 3 floats, `*_stride`
// floats apart; x and v are n contiguous rows of 3; nonfinite one int,
// zero before the launch, set to 1 if any coordinate of x or v is not
// finite.
extern "C" int launch_finalize(const void* p, int p_stride, const void* last,
                               int last_stride, void* x, void* v,
                               void* nonfinite, int n, float inv_dt,
                               float wall, float keep, float damp, int strict,
                               void* stream) {
  if (n > 0) {
    const Consts c{inv_dt, wall, 2.0f * wall, keep, damp, -1.0f};
    const dim3 grid((n + kThreads - 1) / kThreads);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* pf = static_cast<const float*>(p);
    const auto* lf = static_cast<const float*>(last);
    auto* xf = static_cast<float*>(x);
    auto* vf = static_cast<float*>(v);
    auto* flag = static_cast<int*>(nonfinite);
    if (strict) {
      finalize_kernel<true><<<grid, kThreads, 0, s>>>(
          pf, p_stride, lf, last_stride, xf, vf, flag, n, c);
    } else {
      finalize_kernel<false><<<grid, kThreads, 0, s>>>(
          pf, p_stride, lf, last_stride, xf, vf, flag, n, c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
