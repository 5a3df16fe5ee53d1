// Shared pieces of the 2D slab rebin kernels (K2 rebin_axes.cu, K7 + K8
// rebin_dirs9.cu): the slab field pointers, grid_ops.slab_dirs per slot, and
// the 32-bit slot-mask helpers (cap <= 32, one bit per slot).
//
// Directions are floor(x * inv) with inv = f32(1.0 / bin_size) from the host,
// as the JAX package rounds it, clamped to one hop and then to the physical
// grid: the op order of grid_ops.slab_dirs, so every decision built on them
// equals the plain twins'.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppsim {

constexpr float kSlabBig = 1.0e9f;  // the empty-slot position sentinel

struct Slab {
  float* x;
  float* y;
  float* vx;
  float* vy;
  int* pid;
};

struct SlabC {
  const float* x;
  const float* y;
  const float* vx;
  const float* vy;
  const int* pid;
};

// The unclamped bin offset of a bin-local coordinate.
__device__ __forceinline__ int raw_dir(float coord, float inv) {
  return (int)floorf(__fmul_rn(coord, inv));
}

// grid_ops.slab_dirs along one axis from the raw offset: the one-hop clamp,
// then the physical-grid clamp at index gi of n_phys (live slots only).
__device__ __forceinline__ int clamp_dir(int raw, int gi, int n_phys) {
  const int d = max(-1, min(1, raw));
  const int lo = -min(gi, 1);
  const int hi = min(n_phys - 1 - gi, 1);
  return min(max(d, lo), hi);
}

__device__ __forceinline__ int dir1(float coord, int gi, int n_phys, float inv) {
  return clamp_dir(raw_dir(coord, inv), gi, n_phys);
}

// The first k set bits of m.
__device__ __forceinline__ uint32_t first_bits(uint32_t m, int k) {
  uint32_t out = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t low = m & (~m + 1u);
    out |= low;
    m ^= low;
  }
  return out;
}

// Index of the n-th (0-based) set bit of m (the caller guarantees it exists).
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1u;
  return __ffs(m) - 1;
}

// Movers accepted from a group of `movers` (in slot order) under the
// acceptance contract: rank < evac and off + rank < F, i.e. budget = F - off.
__device__ __forceinline__ int accepted_count(int movers, int evac, int budget) {
  return max(0, min(movers, min(evac, budget)));
}

__device__ __forceinline__ uint32_t cap_mask(int cap) {
  return cap == 32 ? 0xffffffffu : ((1u << cap) - 1u);
}

}  // namespace ppsim
