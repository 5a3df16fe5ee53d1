// The wall fold of the Hopper step kernels (K1 grid_step.cu, K3
// grid3_step.cu): reflect a slot's global coordinate local + off into [0, L]
// and flip its velocity on odd reflections (the closed form of iterated
// mirroring, part1/serial.cpp:53-61; grid_ops._reflect / grid3d_ops._reflect).
//
// The floored modulo is fmodf (exact) with the sign fix, which is
// bit-identical to jnp.mod and torch.remainder for the multi-bounce fold (the
// x - 2L*floorf(x/2L) form is not). Every op is explicitly rounded so FMA
// contraction cannot move the result.

#pragma once

#include <cuda_runtime.h>

namespace ppsim {

__device__ __forceinline__ float floored_mod(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.0f && r < 0.0f) r += m;
  return r;
}

// Fold the global coordinate local+off into [0, L] (out-of-box slots only),
// flipping v on odd reflections.
__device__ __forceinline__ void wall_fold(float& local, float& v, float off,
                                          float L, float twoL) {
  const float g = __fadd_rn(local, off);
  if (g < 0.0f || g > L) {
    const float m = floored_mod(g, twoL);
    local = __fsub_rn(__fsub_rn(L, fabsf(__fsub_rn(m, L))), off);
    if (m > L) v = -v;
  }
}

}  // namespace ppsim
