// K2: loss-free axis-factorized slab rebin for Hopper (sm_90a).
//
// Replaces: ppsim_tpu/ops/pallas_rebin.py:_axes_kernel (through
// rebin_axes_call_pallas / grid_rebin_axes_pallas). Plain twin:
// ppsim_tpu_torch/ops/grid_ops.py _axis_pass2 (x pass, then y pass), with the
// monitor planes of ppsim_tpu_torch/ops/cuda_rebin.py rebin_axes_call_plain.
//
// Design. Two launches of one thread per bin (r, c), c fastest:
//   1. x pass: reads the pre-rebin state at rows r-1..r+2 of column c and
//      writes the x-settled slab (scratch the wrapper allocates) plus the
//      far_pre and alive_pre monitor planes;
//   2. y pass: reads the x-settled slab at columns c-1..c+2 of row r and
//      writes the final slab plus the alive_post and resid planes.
// The TPU kernel fused both passes because a whole row block sat in VMEM;
// one 1664-bin row x 14 slots x 5 fields is ~466 KB here, beyond a block's
// shared memory, so the passes meet in device memory instead.
//
// Each thread evaluates the acceptance predicate of the JAX twin for its own
// movers (as source) and for its neighbours' movers into it (as destination):
// the mover of rank k toward d is accepted iff k < evac and off + k < F at the
// destination (F = its pre-pass free slots; off = 0 for d = -1 and the count
// of -1 movers at destination+1 for d = +1). Both sides of a transfer compute
// the same predicate from the same pre-pass state, so the kernel needs no
// atomics and no ordering between threads, and its decisions equal the
// twin's exactly. Per-slot flags live in 32-bit masks (cap <= 32): "the e-th
// accepted mover" is the e-th set bit of the mover mask and "the empty slot
// of empty-rank k" the k-th set bit of the empty mask. Ranks and counts are
// int32 (the TPU kernel carried them in f32 only to please Mosaic).
//
// Exactness. Values are only moved; the one arithmetic op is the recentering
// x - d*bs with d in {-1, 1}, exact in float32. Directions are
// floor(x * inv) with inv = f32(1.0 / bin_size) from the host, as in JAX. So
// the output is bitwise equal to the plain twin on all five planes and the
// count planes.
//
// Bound. Memory: each pass reads ~4 rows x cap slots of 2 fields per bin for
// the direction masks (mostly L1/L2 hits across neighbouring threads) and
// writes 5 planes once; the per-bin control flow is short. It runs every
// rebin_every-th step, so its cost is amortized over the cadence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1.0e9f;

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

// grid_ops.slab_dirs along one axis: one-hop clamp, then the physical-grid
// clamp at index gi of n_phys (live slots only).
__device__ __forceinline__ int dir1(float coord, int gi, int n_phys, float inv) {
  int d = (int)floorf(__fmul_rn(coord, inv));
  d = max(-1, min(1, d));
  const int lo = -min(gi, 1);
  const int hi = min(n_phys - 1 - gi, 1);
  return min(max(d, lo), hi);
}

__device__ __forceinline__ int raw_dir(float coord, float inv) {
  return (int)floorf(__fmul_rn(coord, inv));
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

struct Masks {
  uint32_t alive = 0, neg = 0, pos = 0;
};

// Aliveness and -1/+1 mover masks of the bin at flat index nb, which sits at
// index gi (of n_phys physical) along the pass axis; `coord` is the plane of
// the coordinate along that axis.
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

__device__ __forceinline__ int accepted_count(int movers, int evac, int budget) {
  return max(0, min(movers, min(evac, budget)));
}

// One axis pass for the bin at (r, c). axis 0 moves along rows (x), 1 along
// cols (y). Writes the bin's output slots; returns nothing (monitor planes
// are written by the callers).
__device__ __forceinline__ void axis_pass(const SlabC in, Slab out, int axis,
                                          int r, int c, int cap, int R, int C,
                                          int rows, int cols, int evac,
                                          float bs, float inv) {
  const int64_t plane = (int64_t)R * C;
  const int64_t b = (int64_t)r * C + c;
  const int g = axis == 0 ? r : c;          // index along the pass axis
  const int n_arr = axis == 0 ? R : C;      // array extent along it
  const int n_phys = axis == 0 ? rows : cols;
  const int64_t step = axis == 0 ? (int64_t)C : 1;
  const float* coord = axis == 0 ? in.x : in.y;

  Masks mv[4];  // views at offsets -1, 0, +1, +2 along the axis
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int gv = g + v - 1;
    if (gv >= 0 && gv < n_arr)
      mv[v] = masks_of(coord, in.pid, plane, b + (v - 1) * step, cap, gv,
                       n_phys, inv);
  }
  const Masks& mm = mv[0];
  const Masks& m0 = mv[1];
  const Masks& mp = mv[2];
  const int F0 = cap - __popc(m0.alive);
  const int Fm = cap - __popc(mm.alive);
  const int Fp = cap - __popc(mp.alive);
  const int cnt_m_p1 = __popc(mp.neg);
  const int cnt_m_p2 = __popc(mv[3].neg);

  // Source side: my accepted leavers (-1 into bin-1 with off 0; +1 into bin+1
  // with off = the -1 movers at bin+2).
  const uint32_t leave =
      first_bits(m0.neg, accepted_count(__popc(m0.neg), evac, Fm)) |
      first_bits(m0.pos, accepted_count(__popc(m0.pos), evac, Fp - cnt_m_p2));
  for (int s = 0; s < cap; ++s) {
    const int64_t i = s * plane + b;
    const bool gone = (leave >> s) & 1u;
    out.x[i] = gone ? kBig : in.x[i];
    out.y[i] = gone ? kBig : in.y[i];
    out.vx[i] = gone ? 0.0f : in.vx[i];
    out.vy[i] = gone ? 0.0f : in.vy[i];
    out.pid[i] = gone ? -1 : in.pid[i];
  }

  // Destination side: entrants fill my pre-pass empty slots in empty-rank
  // order, the -1 stream (from bin+1) first, the +1 stream (from bin-1) at
  // offset cnt_m_p1.
  const uint32_t capmask = cap == 32 ? 0xffffffffu : ((1u << cap) - 1u);
  const uint32_t empty = ~m0.alive & capmask;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int d = k == 0 ? -1 : 1;
    const Masks& src = d < 0 ? mp : mm;
    const uint32_t movers = d < 0 ? src.neg : src.pos;
    const int off = d < 0 ? 0 : cnt_m_p1;
    const int n_in = accepted_count(__popc(movers), evac, F0 - off);
    const int64_t sb = b - d * step;  // the source bin
    for (int e = 0; e < n_in; ++e) {
      const int64_t si = nth_bit(movers, e) * plane + sb;
      const int64_t ti = nth_bit(empty, off + e) * plane + b;
      const float dbs = d * bs;  // exactly -bs or bs
      out.x[ti] = axis == 0 ? __fsub_rn(in.x[si], dbs) : in.x[si];
      out.y[ti] = axis == 1 ? __fsub_rn(in.y[si], dbs) : in.y[si];
      out.vx[ti] = in.vx[si];
      out.vy[ti] = in.vy[si];
      out.pid[ti] = in.pid[si];
    }
  }
}

__global__ void __launch_bounds__(128)
rebin_x_kernel(SlabC in, Slab mid, int* __restrict__ cnt, int cap, int R,
               int C, int rows, int cols, int evac, float bs, float inv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const int64_t plane = (int64_t)R * C;
  const int64_t b = (int64_t)r * C + c;
  int far = 0, alive = 0;
  for (int s = 0; s < cap; ++s) {
    if (in.pid[s * plane + b] < 0) continue;
    ++alive;
    const int rx = raw_dir(in.x[s * plane + b], inv);
    const int ry = raw_dir(in.y[s * plane + b], inv);
    far += (abs(rx) > 1 || abs(ry) > 1) ? 1 : 0;
  }
  cnt[0 * plane + b] = far;
  cnt[1 * plane + b] = alive;
  axis_pass(in, mid, 0, r, c, cap, R, C, rows, cols, evac, bs, inv);
}

__global__ void __launch_bounds__(128)
rebin_y_kernel(SlabC mid, Slab out, int* __restrict__ cnt, int cap, int R,
               int C, int rows, int cols, int evac, float bs, float inv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  axis_pass(mid, out, 1, r, c, cap, R, C, rows, cols, evac, bs, inv);
  // Post-rebin monitor planes, read back from this thread's own writes.
  const int64_t plane = (int64_t)R * C;
  const int64_t b = (int64_t)r * C + c;
  int alive = 0, resid = 0;
  for (int s = 0; s < cap; ++s) {
    const int64_t i = s * plane + b;
    if (out.pid[i] < 0) continue;
    ++alive;
    const int dx = dir1(out.x[i], r, rows, inv);
    const int dy = dir1(out.y[i], c, cols, inv);
    resid += (dx != 0 || dy != 0) ? 1 : 0;
  }
  cnt[2 * plane + b] = alive;
  cnt[3 * plane + b] = resid;
}

}  // namespace

extern "C" {

// Pre-rebin slab in (x, y, vx, vy, pid), x-settled scratch mid, final slab
// out, count planes cnt (4, R, C) = [far_pre, alive_pre, alive_post, resid].
// Returns cudaGetLastError() after both launches (0 = launched). cap <= 32.
int ppsim_rebin_axes(const float* x, const float* y, const float* vx,
                     const float* vy, const int* pid, float* mx, float* my,
                     float* mvx, float* mvy, int* mpid, float* ox, float* oy,
                     float* ovx, float* ovy, int* opid, int* cnt, int device,
                     int cap, int R, int C, int rows, int cols, int evac,
                     float bs, float inv, void* stream) {
  if (cap < 1 || cap > 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(128);
  const dim3 grid((C + block.x - 1) / block.x, R);
  const SlabC in{x, y, vx, vy, pid};
  const Slab mid{mx, my, mvx, mvy, mpid};
  const SlabC midc{mx, my, mvx, mvy, mpid};
  const Slab out{ox, oy, ovx, ovy, opid};
  rebin_x_kernel<<<grid, block, 0, s>>>(in, mid, cnt, cap, R, C, rows, cols,
                                        evac, bs, inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rebin_y_kernel<<<grid, block, 0, s>>>(midc, out, cnt, cap, R, C, rows, cols,
                                        evac, bs, inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
