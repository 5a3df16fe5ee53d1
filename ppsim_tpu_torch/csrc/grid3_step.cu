// K3: fused 3D slab-grid step for Hopper (sm_90a) — 27-bin stencil force,
// Verlet move, 3-axis wall fold and the per-bin max|v|^2 plane in one pass.
//
// Replaces: ppsim_tpu/ops/pallas_grid3d.py:_step3_kernel and
// _step3_kernel_nospeed (through grid3_step_pallas). Plain twin:
// ppsim_tpu_torch/ops/cuda_grid3.py grid3_step_plain (grid3_force_xla with
// the kernels' pair arithmetic + move3_planes).
//
// Layout. Fields are (cap, Y, X, Z) float32 planes, z fastest; bin
// b = (y*X + x)*Z + z, slot s at s*plane + b. Dead slots hold exactly BIG.
//
// Design. Owner-computes and two-sided, like K1: every slot's force is the sum
// over the 27 neighbour bins (DIRS3 order: dy, dx, dz ascending) and their
// slots (ascending) of the pair term, the plain twin's order, with each
// product and sum rounded as the twin's (no FMA contraction). The TPU kernel
// evaluates each pair once and carries the y+1 reactions to the next y-slab
// through a whole-plane VMEM spill that relies on Pallas running grid steps
// in order; CUDA blocks run concurrently, so that would race. Owner-computes
// needs no atomics and is deterministic. Neighbours are masked
// at the physical edges (xs, zs; y at the array edge), not at the padded
// extents; dead neighbour slots contribute exact zeros and are skipped.
//
// Thread mapping: one thread per bin, z fastest (a warp reads 32
// consecutive floats of a slot plane), holding its slots' coordinates and
// accumulators in registers (cap templated to 8/12/16/32). It loads each
// neighbour slot once and tests it against its own live slots up to the last
// live one. Register pressure grows as 6 x MAXC: 128 registers at MAXC 16
// with a few bytes of spill for LJ (ptxas). One thread per (slot, bin) needs
// 64-80 registers but loads every neighbour slot once per live own slot; it
// measured 2x slower at the stretch geometry (PERF.md), so it is not kept.
//
// Bound. Memory: 6 planes read and 6 written once plus the speed plane,
// 12 x cap x plane x 4 B (3.4 GB at the 20.97M stretch geometry, ~1 ms at
// 3.35 TB/s). Operations: ~10 flops per candidate pair (live own slot x live
// neighbour slot in the 27 bins), ~2.2G candidate pairs per step there,
// owner-computes doing each pair from both sides; the candidate loop's issue
// rate, not the bytes, is what this design pays for.
//
// Numerics. Constants arrive as the float32 values the plain twin rounds.
// The repulsive coefficient's rsqrtf may differ from torch.rsqrt by an ulp,
// so parity with the plain twin is allclose (rtol 1e-5, atol 1e-6); everything
// else, the move tail included, repeats the twin's rounding step for step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_coef.cuh"
#include "wall_fold.cuh"

namespace {

using ppsim::Law;
using ppsim::PairParams;
using ppsim::wall_fold;

constexpr float kBig = 1.0e9f;

struct Fields {
  const float* x;
  const float* y;
  const float* z;
  const float* vx;
  const float* vy;
  const float* vz;
};

struct Outs {
  float* x;
  float* y;
  float* z;
  float* vx;
  float* vy;
  float* vz;
};

struct Geo3 {
  int cap, Y, X, Z;  // array extents (Y, X, Z padded)
  int xs, zs;        // physical x and z bins
  float bsx, bsy, bsz;
};

__device__ __forceinline__ float r2_of(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Verlet + wall fold of one live-or-dead slot (grid3d_ops.move3_planes);
// returns |v|^2 (0 for a dead slot, whose velocity is 0).
__device__ __forceinline__ float move_slot(const Fields& in, const Outs& out,
                                           int64_t i, float x, float y,
                                           float z, float ax, float ay,
                                           float az, float xo, float yo,
                                           float zo, float dt, float L) {
  const bool alive = x < 0.5f * kBig;
  float vx = alive ? __fadd_rn(in.vx[i], __fmul_rn(ax, dt)) : 0.0f;
  float vy = alive ? __fadd_rn(in.vy[i], __fmul_rn(ay, dt)) : 0.0f;
  float vz = alive ? __fadd_rn(in.vz[i], __fmul_rn(az, dt)) : 0.0f;
  x = __fadd_rn(x, __fmul_rn(vx, dt));
  y = __fadd_rn(y, __fmul_rn(vy, dt));
  z = __fadd_rn(z, __fmul_rn(vz, dt));
  const float twoL = 2.0f * L;
  wall_fold(x, vx, xo, L, twoL);
  wall_fold(y, vy, yo, L, twoL);
  wall_fold(z, vz, zo, L, twoL);
  out.x[i] = alive ? x : kBig;
  out.y[i] = alive ? y : kBig;
  out.z[i] = alive ? z : kBig;
  out.vx[i] = vx;
  out.vy[i] = vy;
  out.vz[i] = vz;
  return alive ? r2_of(vx, vy, vz) : 0.0f;
}

template <int MAXC, Law LAW>
__global__ void __launch_bounds__(128)
grid3_step_kernel(Fields in, Outs out, float* __restrict__ sp, Geo3 g,
                  PairParams pp, float dt, float L) {
  const int64_t plane = (int64_t)g.Y * g.X * g.Z;
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= plane) return;
  const int z = (int)(b % g.Z);
  const int x = (int)((b / g.Z) % g.X);
  const int y = (int)(b / ((int64_t)g.X * g.Z));

  float sx[MAXC], sy[MAXC], sz[MAXC], ax[MAXC], ay[MAXC], az[MAXC];
  int own_end = 0;  // one past the last live own slot
#pragma unroll
  for (int s = 0; s < MAXC; ++s) {
    sx[s] = s < g.cap ? in.x[s * plane + b] : kBig;
    sy[s] = s < g.cap ? in.y[s * plane + b] : kBig;
    sz[s] = s < g.cap ? in.z[s * plane + b] : kBig;
    ax[s] = 0.0f;
    ay[s] = 0.0f;
    az[s] = 0.0f;
    if (sx[s] < 0.5f * kBig) own_end = s + 1;
  }

  if (own_end > 0) {
    for (int dy = -1; dy <= 1; ++dy) {
      const int yn = y + dy;
      if (yn < 0 || yn >= g.Y) continue;
      const float offy = (float)dy * g.bsy;  // exactly -bsy, 0 or bsy
      for (int dx = -1; dx <= 1; ++dx) {
        const int xn = x + dx;
        if (xn < 0 || xn >= g.xs) continue;
        const float offx = (float)dx * g.bsx;
        for (int dz = -1; dz <= 1; ++dz) {
          const int zn = z + dz;
          if (zn < 0 || zn >= g.zs) continue;
          const float offz = (float)dz * g.bsz;
          const int64_t nb = ((int64_t)yn * g.X + xn) * g.Z + zn;
          for (int j = 0; j < g.cap; ++j) {
            const float xv = in.x[j * plane + nb];
            if (!(xv < 0.5f * kBig)) continue;  // dead slot: exact zero
            const float xno = __fadd_rn(xv, offx);
            const float yno = __fadd_rn(in.y[j * plane + nb], offy);
            const float zno = __fadd_rn(in.z[j * plane + nb], offz);
#pragma unroll
            for (int s = 0; s < MAXC; ++s) {
              if (s < own_end) {
                const float ddx = __fsub_rn(xno, sx[s]);
                const float ddy = __fsub_rn(yno, sy[s]);
                const float ddz = __fsub_rn(zno, sz[s]);
                const float r2 = r2_of(ddx, ddy, ddz);
                if (r2 <= pp.c2) {
                  const float coef = ppsim::pair_coef<LAW>(r2, pp);
                  ax[s] = __fadd_rn(ax[s], __fmul_rn(coef, ddx));
                  ay[s] = __fadd_rn(ay[s], __fmul_rn(coef, ddy));
                  az[s] = __fadd_rn(az[s], __fmul_rn(coef, ddz));
                }
              }
            }
          }
        }
      }
    }
  }

  const float xo = __fmul_rn((float)x, g.bsx);
  const float yo = __fmul_rn((float)y, g.bsy);
  const float zo = __fmul_rn((float)z, g.bsz);
  float spmax = 0.0f;
#pragma unroll
  for (int s = 0; s < MAXC; ++s) {
    if (s < g.cap) {
      spmax = fmaxf(spmax, move_slot(in, out, s * plane + b, sx[s], sy[s],
                                     sz[s], ax[s], ay[s], az[s], xo, yo, zo,
                                     dt, L));
    }
  }
  sp[b] = spmax;
}

template <int MAXC, Law LAW>
int launch(const Fields& in, const Outs& out, float* sp, const Geo3& g,
           const PairParams& pp, float dt, float L, cudaStream_t s) {
  const int64_t plane = (int64_t)g.Y * g.X * g.Z;
  const int block = 128;
  const int64_t grid = (plane + block - 1) / block;
  grid3_step_kernel<MAXC, LAW><<<(unsigned)grid, block, 0, s>>>(
      in, out, sp, g, pp, dt, L);
  return (int)cudaGetLastError();
}

template <Law LAW>
int launch_law(const Fields& in, const Outs& out, float* sp, const Geo3& g,
               const PairParams& pp, float dt, float L, cudaStream_t s) {
  if (g.cap <= 8) return launch<8, LAW>(in, out, sp, g, pp, dt, L, s);
  if (g.cap <= 12) return launch<12, LAW>(in, out, sp, g, pp, dt, L, s);
  if (g.cap <= 16) return launch<16, LAW>(in, out, sp, g, pp, dt, L, s);
  if (g.cap <= 32) return launch<32, LAW>(in, out, sp, g, pp, dt, L, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Inputs x, y, z, vx, vy, vz; outputs likewise; sp the (Y, X, Z) speed
// plane. law 0 = repulsive, 1 = Lennard-Jones. Returns cudaGetLastError()
// after the launch (0 = launched). cap <= 32.
int ppsim_grid3_step(const float* x, const float* y, const float* z,
                     const float* vx, const float* vy, const float* vz,
                     float* xo, float* yo, float* zo, float* vxo, float* vyo,
                     float* vzo, float* sp, int device, int cap,
                     int Y, int X, int Z, int xs, int zs, int law, float bsx,
                     float bsy, float bsz, float c2, float cutoff, float mr2,
                     float inv_mass, float sig2, float lj_k, float mass,
                     float dt, float L, void* stream) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Fields in{x, y, z, vx, vy, vz};
  const Outs out{xo, yo, zo, vxo, vyo, vzo};
  const Geo3 g{cap, Y, X, Z, xs, zs, bsx, bsy, bsz};
  const PairParams pp{c2, cutoff, mr2, inv_mass, sig2, lj_k, mass};
  if (law == (int)Law::kRepulsive)
    return launch_law<Law::kRepulsive>(in, out, sp, g, pp, dt, L, s);
  if (law == (int)Law::kLJ)
    return launch_law<Law::kLJ>(in, out, sp, g, pp, dt, L, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
