// Shared pieces of the slab rebin kernels (K2 rebin_axes.cu, K4 + K5
// rebin3.cu, K7 + K8 rebin_dirs9.cu): the 2D slab field pointers,
// grid_ops.slab_dirs per slot, the 32-bit slot-mask helpers (cap <= 32, one
// bit per slot), the aliveness and mover masks of a bin along one axis, and
// the acceptance decisions of one axis pass.
//
// Directions are floor(x * inv) with inv = f32(1.0 / bin_size) from the host,
// as the JAX package rounds it, clamped to one hop and then to the physical
// grid: the op order of grid_ops.slab_dirs (grid3d_ops.slab3_dirs per axis),
// so every decision built on them equals the plain twins'.

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

// Movers accepted from a group of `movers` (in slot order) under the
// acceptance contract: rank < evac and off + rank < F, i.e. budget = F - off.
__device__ __forceinline__ int accepted_count(int movers, int evac, int budget) {
  return max(0, min(movers, min(evac, budget)));
}

__device__ __forceinline__ uint32_t cap_mask(int cap) {
  return cap == 32 ? 0xffffffffu : ((1u << cap) - 1u);
}

// An entrant stream: the e-th accepted mover (the e-th set bit of `src`)
// lands in the e-th set bit of `dst`; put(to, from) for each, in slot order.
template <typename Put>
__device__ __forceinline__ void stream(uint32_t src, uint32_t dst, Put put) {
  while (src) {
    const int from = __ffs(src) - 1;
    const int to = __ffs(dst) - 1;
    src &= src - 1u;
    dst &= dst - 1u;
    put(to, from);
  }
}

// A bin's live slots and its -1 / +1 movers along one axis.
struct Masks {
  uint32_t alive = 0, neg = 0, pos = 0;
};

// The masks of the bin at flat index nb, which sits at index gi (of n_phys
// physical) along the pass axis; `coord` is the plane of the coordinate
// along that axis, slot s at s * plane + nb.
__device__ __forceinline__ Masks masks_of(const float* coord, const int* pid,
                                          int64_t plane, int64_t nb, int cap,
                                          int gi, int n_phys, float inv) {
  Masks m;
  for (int s = 0; s < cap; ++s) {
    if (pid[s * plane + nb] < 0) continue;
    m.alive |= 1u << s;
    const int d = dir1(coord[s * plane + nb], gi, n_phys, inv);
    if (d < 0) m.neg |= 1u << s;
    if (d > 0) m.pos |= 1u << s;
  }
  return m;
}

// The decisions of one axis pass at a bin (grid_ops._axis_pass2): the mover
// of rank k toward d is accepted iff k < evac and off + k < F at its
// destination, F the destination's pre-pass free slots, off = 0 for d = -1
// and the -1 movers at destination + 1 for d = +1. Both sides of a transfer
// evaluate it from the same pre-pass state, so no thread waits for another.
struct PassMoves {
  uint32_t leave;   // own slots whose movers leave
  uint32_t in_hi;   // slots of the bin after (+1) whose -1 movers enter
  uint32_t in_lo;   // slots of the bin before (-1) whose +1 movers enter
  int off_lo;       // empty-rank at which the +1 stream starts
};

// mm, m0, mp: the masks at offsets -1, 0, +1 along the axis; Fm, F0, Fp
// their pre-pass free slots; cnt_m_p2 the -1 movers at offset +2.
__device__ __forceinline__ PassMoves pass_moves(const Masks& mm,
                                                const Masks& m0,
                                                const Masks& mp, int Fm,
                                                int F0, int Fp, int cnt_m_p2,
                                                int evac) {
  PassMoves p;
  const int cnt_m_p1 = __popc(mp.neg);
  p.leave =
      first_bits(m0.neg, accepted_count(__popc(m0.neg), evac, Fm)) |
      first_bits(m0.pos, accepted_count(__popc(m0.pos), evac, Fp - cnt_m_p2));
  p.in_hi = first_bits(mp.neg, accepted_count(cnt_m_p1, evac, F0));
  p.in_lo = first_bits(mm.pos, accepted_count(__popc(mm.pos), evac,
                                              F0 - cnt_m_p1));
  p.off_lo = cnt_m_p1;
  return p;
}

}  // namespace ppsim
