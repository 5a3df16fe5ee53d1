// K1: fused slab-grid step for Hopper (sm_90a) — stencil force, Verlet move,
// wall fold and the per-bin max|v|^2 plane in one pass.
//
// Replaces: ppsim_tpu/ops/pallas_grid.py:_step_kernel (through
// grid_step_pallas). Plain twin: ppsim_tpu_torch/ops/cuda_grid.py
// grid_step_plain (grid_force_xla + the move planes).
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
// later work.
//
// Numerics. Constants arrive as the float32 values the JAX package rounds
// (c2 = f32(cutoff^2), mr2 = f32(min_r^2), inv_mass = f32(1/mass)). The pair
// coefficient uses grid_ops.pair_coef's op order. rsqrtf differs from the CPU
// rsqrt by an ulp or two and FMA contraction changes the last bit of the pair
// sums, so parity with the plain twin is allclose. The move tail uses
// explicitly rounded ops (no contraction) and the floored modulo of jnp.mod:
// fmodf (exact) with the sign fix, which is bit-identical to jnp.mod and
// torch.remainder for the multi-bounce fold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1.0e9f;

__device__ __forceinline__ float floored_mod(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.0f && r < 0.0f) r += m;
  return r;
}

// Fold the global coordinate local+off into [0, L] (out-of-box slots only),
// flipping v on odd reflections; grid_ops._reflect.
__device__ __forceinline__ void wall_fold(float& local, float& v, float off,
                                          float L, float twoL) {
  const float g = __fadd_rn(local, off);
  if (g < 0.0f || g > L) {
    const float m = floored_mod(g, twoL);
    local = __fsub_rn(__fsub_rn(L, fabsf(__fsub_rn(m, L))), off);
    if (m > L) v = -v;
  }
}

template <int MAXC>
__global__ void __launch_bounds__(128)
grid_step_kernel(const float* __restrict__ xl, const float* __restrict__ yl,
                 const float* __restrict__ vx, const float* __restrict__ vy,
                 float* __restrict__ xo, float* __restrict__ yo,
                 float* __restrict__ vxo, float* __restrict__ vyo,
                 float* __restrict__ sp, int cap, int R, int C, float bs,
                 float c2, float cutoff, float mr2, float inv_mass, float dt,
                 float L) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const int64_t plane = (int64_t)R * C;
  const int64_t b = (int64_t)r * C + c;

  float sx[MAXC], sy[MAXC], ax[MAXC], ay[MAXC];
#pragma unroll
  for (int s = 0; s < MAXC; ++s) {
    sx[s] = s < cap ? xl[s * plane + b] : kBig;
    sy[s] = s < cap ? yl[s * plane + b] : kBig;
    ax[s] = 0.0f;
    ay[s] = 0.0f;
  }

  // Directions in grid_ops.DIRS order: dr outer, dc inner.
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
            const float r2 = dx * dx + dy * dy;
            if (r2 <= c2) {
              const float rinv = rsqrtf(fmaxf(r2, mr2));
              const float inv2 = rinv * rinv;
              const float coef = (inv2 - cutoff * rinv * inv2) * inv_mass;
              ax[s] += coef * dx;
              ay[s] += coef * dy;
            }
          }
        }
      }
    }
  }

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

template <int MAXC>
void launch(const float* xl, const float* yl, const float* vx, const float* vy,
            float* xo, float* yo, float* vxo, float* vyo, float* sp, int cap,
            int R, int C, float bs, float c2, float cutoff, float mr2,
            float inv_mass, float dt, float L, cudaStream_t stream) {
  const dim3 block(128);
  const dim3 grid((C + block.x - 1) / block.x, R);
  grid_step_kernel<MAXC><<<grid, block, 0, stream>>>(
      xl, yl, vx, vy, xo, yo, vxo, vyo, sp, cap, R, C, bs, c2, cutoff, mr2,
      inv_mass, dt, L);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). cap <= 32.
int ppsim_grid_step(const float* xl, const float* yl, const float* vx,
                    const float* vy, float* xo, float* yo, float* vxo,
                    float* vyo, float* sp, int device, int cap, int R, int C,
                    float bs, float c2, float cutoff, float mr2,
                    float inv_mass, float dt, float L, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (cap <= 8)
    launch<8>(xl, yl, vx, vy, xo, yo, vxo, vyo, sp, cap, R, C, bs, c2, cutoff,
              mr2, inv_mass, dt, L, s);
  else if (cap <= 16)
    launch<16>(xl, yl, vx, vy, xo, yo, vxo, vyo, sp, cap, R, C, bs, c2, cutoff,
               mr2, inv_mass, dt, L, s);
  else if (cap <= 32)
    launch<32>(xl, yl, vx, vy, xo, yo, vxo, vyo, sp, cap, R, C, bs, c2, cutoff,
               mr2, inv_mass, dt, L, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* ppsim_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
