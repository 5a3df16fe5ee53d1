// K1: fused slab-grid step for Hopper (sm_90a) — stencil force, Verlet move,
// wall fold and the per-bin max|v|^2 plane in one pass. K6: the force-only
// kernel, K1 without the move tail.
//
// Replaces: ppsim_tpu/ops/pallas_grid.py:_step_kernel (through
// grid_step_pallas) and its two-sided A/B twin _step_kernel_asym
// (grid_step_pallas(symmetric=False), which is K1's own design: every pair
// evaluated from both sides, then _move_tail); K6 replaces _force_kernel
// (through grid_force_pallas). Plain twins: ppsim_tpu_torch/ops/cuda_grid.py
// grid_step_plain (grid_force_xla + the move planes) and grid_force_plain.
//
// Design. One thread per bin (r, c), c fastest, so each slot-plane load of a
// warp is 32 consecutive floats. Owner-computes and two-sided: the thread
// sums, for each of its own slots, the force from all 9 neighbour bins x cap
// slots, then integrates its own slots. The TPU kernel evaluates each pair
// once (Newton 3) and scatters the reaction through a row spill that the next
// grid block reads; that relies on the TPU running grid blocks in order, and
// CUDA blocks run concurrently in no order. Owner-computes does about twice
// the pair math (9*cap^2 vs cap(cap-1)/2 + 4*cap^2 pair evaluations per bin)
// but needs no atomics and no ordering, is deterministic, and sums in the
// same order as the plain twin (directions in DIRS order, neighbour slots
// ascending). Bins outside [0,R)x[0,C) read as BIG (the block_ext fill and the
// lane masks of the TPU kernel); dead neighbour slots hold exactly BIG and
// contribute exact zeros, so both are skipped.
//
// Bound. Pair math: ~9*cap^2 candidate pairs per bin (1764 at cap 14), of
// which the in-cutoff ones (a few per slot) reach the rsqrt. Memory traffic
// is small (each slot plane read by 9 threads, mostly from L1/L2). So the
// kernel is bound by issue of the candidate-pair loop; skipping dead
// neighbour slots (about half at the main path's occupancy 7.6 of 14) is the
// one saving taken here. Newton-3 halving and per-bin occupancy bounds are
// later work. K6 does the same pair loop and writes 2 planes instead of 4 +
// the speed plane, so it is bound the same way. Both call one device
// function for the pair loop (accum_pairs), so they cannot drift apart.
//
// Force law. The pair coefficient comes from pair_coef.cuh, a template
// parameter: the repulsive law (the default) or truncated Lennard-Jones.
//
// Numerics. Constants arrive as the float32 values the JAX package rounds
// (c2 = f32(cutoff^2), mr2 = f32(min_r^2), inv_mass = f32(1/mass)). The
// repulsive coefficient uses grid_ops.pair_coef's op order, LJ
// physics.lj_coef_from_r2's. rsqrtf differs from the CPU rsqrt by an ulp or
// two and FMA contraction changes the last bit of the pair sums, so parity
// with the plain twin is allclose. Under LJ the in-cutoff test rounds r2 as
// the twin does: the truncated law jumps at the cutoff, and a contracted r2
// put pairs within an ulp of it on the other side. The move tail uses
// explicitly rounded ops (no contraction) and the floored modulo of jnp.mod:
// fmodf (exact) with the sign fix, which is bit-identical to jnp.mod and
// torch.remainder for the multi-bounce fold.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pair_coef.cuh"
#include "wall_fold.cuh"

namespace {

using ppsim::Law;
using ppsim::PairParams;
using ppsim::wall_fold;

constexpr float kBig = 1.0e9f;

// Sum into (ax, ay) the force on the bin's own slots (sx, sy) from all 9
// neighbour bins x cap slots, directions in grid_ops.DIRS order (dr outer, dc
// inner), neighbour slots ascending.
template <int MAXC, Law LAW>
__device__ __forceinline__ void accum_pairs(
    const float* __restrict__ xl, const float* __restrict__ yl,
    const float (&sx)[MAXC], const float (&sy)[MAXC], float (&ax)[MAXC],
    float (&ay)[MAXC], int r, int c, int cap, int R, int C, int64_t plane,
    float bs, const PairParams& pp) {
  for (int dr = -1; dr <= 1; ++dr) {
    const int rn = r + dr;
    if (rn < 0 || rn >= R) continue;
    const float offx = dr * bs;  // exactly -bs, 0 or bs
    for (int dc = -1; dc <= 1; ++dc) {
      const int cn = c + dc;
      if (cn < 0 || cn >= C) continue;
      const float offy = dc * bs;
      const int64_t nb = (int64_t)rn * C + cn;
      for (int j = 0; j < cap; ++j) {
        const float xn = xl[j * plane + nb];
        if (!(xn < 0.5f * kBig)) continue;  // dead slot: exact zero force
        const float xno = __fadd_rn(xn, offx);
        const float yno = __fadd_rn(yl[j * plane + nb], offy);
#pragma unroll
        for (int s = 0; s < MAXC; ++s) {
          if (s < cap) {
            const float dx = __fsub_rn(xno, sx[s]);
            const float dy = __fsub_rn(yno, sy[s]);
            // Truncated LJ jumps at the cutoff, so its in-cutoff test takes
            // r2 rounded as the twin rounds it (no FMA); the repulsive
            // coefficient is 0 at the cutoff and keeps the contracted form.
            float r2;
            if constexpr (LAW == Law::kLJ)
              r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            else
              r2 = dx * dx + dy * dy;
            if (r2 <= pp.c2) {
              const float coef = ppsim::pair_coef<LAW>(r2, pp);
              ax[s] += coef * dx;
              ay[s] += coef * dy;
            }
          }
        }
      }
    }
  }
}

// The bin's own slots into registers (BIG past cap) and zeroed sums.
template <int MAXC>
__device__ __forceinline__ void load_own(const float* __restrict__ xl,
                                         const float* __restrict__ yl,
                                         float (&sx)[MAXC], float (&sy)[MAXC],
                                         float (&ax)[MAXC], float (&ay)[MAXC],
                                         int cap, int64_t plane, int64_t b) {
#pragma unroll
  for (int s = 0; s < MAXC; ++s) {
    sx[s] = s < cap ? xl[s * plane + b] : kBig;
    sy[s] = s < cap ? yl[s * plane + b] : kBig;
    ax[s] = 0.0f;
    ay[s] = 0.0f;
  }
}

template <int MAXC, Law LAW>
__global__ void __launch_bounds__(128)
grid_step_kernel(const float* __restrict__ xl, const float* __restrict__ yl,
                 const float* __restrict__ vx, const float* __restrict__ vy,
                 float* __restrict__ xo, float* __restrict__ yo,
                 float* __restrict__ vxo, float* __restrict__ vyo,
                 float* __restrict__ sp, int cap, int R, int C, float bs,
                 PairParams pp, float dt, float L) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const int64_t plane = (int64_t)R * C;
  const int64_t b = (int64_t)r * C + c;

  float sx[MAXC], sy[MAXC], ax[MAXC], ay[MAXC];
  load_own<MAXC>(xl, yl, sx, sy, ax, ay, cap, plane, b);
  accum_pairs<MAXC, LAW>(xl, yl, sx, sy, ax, ay, r, c, cap, R, C, plane, bs,
                         pp);

  // Move tail (pallas_grid._move_tail): Verlet, wall fold, speed plane.
  const float row_off = __fmul_rn((float)r, bs);
  const float col_off = __fmul_rn((float)c, bs);
  const float twoL = 2.0f * L;
  float spmax = 0.0f;
#pragma unroll
  for (int s = 0; s < MAXC; ++s) {
    if (s < cap) {
      const int64_t i = s * plane + b;
      const bool alive = sx[s] < 0.5f * kBig;
      float vxs = alive ? __fadd_rn(vx[i], __fmul_rn(ax[s], dt)) : 0.0f;
      float vys = alive ? __fadd_rn(vy[i], __fmul_rn(ay[s], dt)) : 0.0f;
      float x = __fadd_rn(sx[s], __fmul_rn(vxs, dt));
      float y = __fadd_rn(sy[s], __fmul_rn(vys, dt));
      wall_fold(x, vxs, row_off, L, twoL);
      wall_fold(y, vys, col_off, L, twoL);
      xo[i] = alive ? x : kBig;
      yo[i] = alive ? y : kBig;
      vxo[i] = vxs;
      vyo[i] = vys;
      // dead slots hold v = 0, matching the plain twin's alive-masked speed2
      spmax = fmaxf(spmax, __fadd_rn(__fmul_rn(vxs, vxs), __fmul_rn(vys, vys)));
    }
  }
  sp[b] = spmax;
}

// K6: the accelerations of every slot, the move left out.
template <int MAXC, Law LAW>
__global__ void __launch_bounds__(128)
grid_force_kernel(const float* __restrict__ xl, const float* __restrict__ yl,
                  float* __restrict__ axo, float* __restrict__ ayo, int cap,
                  int R, int C, float bs, PairParams pp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const int64_t plane = (int64_t)R * C;
  const int64_t b = (int64_t)r * C + c;

  float sx[MAXC], sy[MAXC], ax[MAXC], ay[MAXC];
  load_own<MAXC>(xl, yl, sx, sy, ax, ay, cap, plane, b);
  accum_pairs<MAXC, LAW>(xl, yl, sx, sy, ax, ay, r, c, cap, R, C, plane, bs,
                         pp);
#pragma unroll
  for (int s = 0; s < MAXC; ++s) {
    if (s < cap) {
      axo[s * plane + b] = ax[s];
      ayo[s * plane + b] = ay[s];
    }
  }
}

// Calls launch(MAXC, LAW) with the instantiation covering cap (8, 16 or 32
// slots) and law; returns cudaGetLastError() after it (0 = launched).
template <typename F>
int dispatch(int cap, int law, F&& launch) {
  auto by_cap = [&](auto lawc) {
    if (cap <= 8)
      launch(std::integral_constant<int, 8>{}, lawc);
    else if (cap <= 16)
      launch(std::integral_constant<int, 16>{}, lawc);
    else if (cap <= 32)
      launch(std::integral_constant<int, 32>{}, lawc);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  };
  if (law == (int)Law::kRepulsive)
    return by_cap(std::integral_constant<Law, Law::kRepulsive>{});
  if (law == (int)Law::kLJ)
    return by_cap(std::integral_constant<Law, Law::kLJ>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// law 0 = repulsive, 1 = Lennard-Jones (pair_coef.cuh). Returns
// cudaGetLastError() after the launch (0 = launched). cap <= 32.
int ppsim_grid_step(const float* xl, const float* yl, const float* vx,
                    const float* vy, float* xo, float* yo, float* vxo,
                    float* vyo, float* sp, int device, int cap, int R, int C,
                    int law, float bs, float c2, float cutoff, float mr2,
                    float inv_mass, float sig2, float lj_k, float mass,
                    float dt, float L, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const PairParams pp{c2, cutoff, mr2, inv_mass, sig2, lj_k, mass};
  const dim3 block(128);
  const dim3 grid((C + block.x - 1) / block.x, R);
  return dispatch(cap, law, [&](auto maxc, auto lawc) {
    grid_step_kernel<decltype(maxc)::value, decltype(lawc)::value>
        <<<grid, block, 0, s>>>(xl, yl, vx, vy, xo, yo, vxo, vyo, sp, cap, R,
                                C, bs, pp, dt, L);
  });
}

// K6: accelerations (ax, ay) of the slab positions (xl, yl); arguments as
// ppsim_grid_step's.
int ppsim_grid_force(const float* xl, const float* yl, float* ax, float* ay,
                     int device, int cap, int R, int C, int law, float bs,
                     float c2, float cutoff, float mr2, float inv_mass,
                     float sig2, float lj_k, float mass, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const PairParams pp{c2, cutoff, mr2, inv_mass, sig2, lj_k, mass};
  const dim3 block(128);
  const dim3 grid((C + block.x - 1) / block.x, R);
  return dispatch(cap, law, [&](auto maxc, auto lawc) {
    grid_force_kernel<decltype(maxc)::value, decltype(lawc)::value>
        <<<grid, block, 0, s>>>(xl, yl, ax, ay, cap, R, C, bs, pp);
  });
}

const char* ppsim_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
