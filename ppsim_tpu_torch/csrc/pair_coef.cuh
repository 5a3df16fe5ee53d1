// The force-law seam of the Hopper step kernels (K1 grid_step.cu, K3
// grid3_step.cu): the pair coefficient of an in-cutoff pair, so that the
// acceleration contribution is coef * (neighbour - self) componentwise.
//
// Replaces: ppsim_tpu/ops/pallas_grid.py:_pair_coef (the Pallas kernels'
// law seam). The law is a template parameter, so each law compiles to its
// own straight-line code. Callers test r2 <= c2 first; out-of-cutoff pairs
// (and BIG-sentinel slots) never reach these bodies.
//
// - Repulsive: grid_ops.pair_coef's op order (rsqrt, then
//   (inv2 - cutoff*rinv*inv2) * inv_mass), each product and difference
//   explicitly rounded as the plain twin rounds it (FMA contraction here
//   moved K1's velocities 1.7e-6 off the twin on a late main-path slab,
//   where close pairs' terms of ~1e6 cancel).
// - Lennard-Jones: physics.lj_coef_from_r2's op order with IEEE division,
//   explicitly rounded (no FMA contraction):
//     s2 = sig2 / r2c;  s6 = s2*s2*s2;
//     coef = (lj_k * ((2*s6)*s6 - s6)) / r2c / mass,  lj_k = f32(-24 eps).
//
// Every constant arrives as the float32 value the plain twin rounds.

#pragma once

#include <cuda_runtime.h>

namespace ppsim {

enum class Law : int { kRepulsive = 0, kLJ = 1 };

struct PairParams {
  float c2;        // cutoff^2 as the law's plain twin rounds it
  float cutoff;    // f32(cutoff)
  float mr2;       // f32(min_r^2)
  float inv_mass;  // f32(1 / mass)   (repulsive)
  float sig2;      // f32(sigma^2)    (LJ)
  float lj_k;      // f32(-24 eps)    (LJ)
  float mass;      // f32(mass)       (LJ)
};

template <Law L>
__device__ __forceinline__ float pair_coef(float r2, const PairParams& p);

template <>
__device__ __forceinline__ float pair_coef<Law::kRepulsive>(
    float r2, const PairParams& p) {
  const float rinv = rsqrtf(fmaxf(r2, p.mr2));
  const float inv2 = __fmul_rn(rinv, rinv);
  return __fmul_rn(__fsub_rn(inv2, __fmul_rn(__fmul_rn(p.cutoff, rinv), inv2)),
                   p.inv_mass);
}

template <>
__device__ __forceinline__ float pair_coef<Law::kLJ>(float r2,
                                                     const PairParams& p) {
  const float r2c = fmaxf(r2, p.mr2);
  const float s2 = __fdiv_rn(p.sig2, r2c);
  const float s6 = __fmul_rn(__fmul_rn(s2, s2), s2);
  const float t = __fsub_rn(__fmul_rn(__fmul_rn(2.0f, s6), s6), s6);
  return __fdiv_rn(__fdiv_rn(__fmul_rn(p.lj_k, t), r2c), p.mass);
}

}  // namespace ppsim
