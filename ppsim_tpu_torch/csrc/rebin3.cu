// K4 and K5: the loss-free axis-factorized 3D rebin for Hopper (sm_90a).
//
// Replaces: ppsim_tpu/ops/pallas_rebin3.py — K4 = _inplane_kernel (fused)
// and _xpass_kernel + _zpass_kernel (split) through rebin3_inplane_pallas;
// K5 = _ypass_kernel through rebin3_ypass_pallas. Plain twins:
// ppsim_tpu_torch/ops/cuda_rebin3.py rebin3_inplane_plain and
// rebin3_ypass_plain (grid3d_ops._axis_pass: x, z, then y).
//
// Layout. Fields (cap, Y, X, Z), z fastest, bin b = (y*X + x)*Z + z; six
// float32 fields (xl yl zl vx vy vz) and int32 pid, -1 where empty.
//
// Design. One thread per bin, three launches, each one axis pass:
//   K4a x pass: pre-rebin state -> x-settled scratch, plus the pre-rebin
//       monitor planes far_pre (a raw drift > 1 bin on any axis, read before
//       any clamp) and alive_pre;
//   K4b z pass: x-settled -> xz-settled slab, plus the y pass's acceptance
//       inputs [m-, alive, m+] (y movers and occupancy of the result);
//   K5  y pass: xz-settled -> final slab, reading fields at y-1..y+1 and the
//       count planes at y-1..y+2, plus [alive_post, resid] monitor planes.
// The TPU kernels kept a whole (X, Z) plane (or a chunk) of every slot in
// VMEM; here a bin's neighbours along the pass axis are read from device
// memory (L1/L2 hits across neighbouring threads) and the passes meet in
// device memory, as in K2.
//
// Each thread evaluates the acceptance predicate of grid3d_ops._axis_pass for
// its own movers (as source) and for its neighbours' movers into it (as
// destination): the mover of rank k toward d is accepted iff k < evac and
// off + k < F at the destination (F = its pre-pass free slots; off = 0 for
// d = -1 and the count of -1 movers at destination+1 for d = +1). Both sides
// compute it from the same pre-pass state, so there are no atomics and no
// ordering between threads, and the decisions equal the twin's. Per-slot
// flags are 32-bit masks (cap <= 32): the e-th accepted mover is the e-th set
// bit of the mover mask, the empty slot of empty-rank k the k-th set bit of
// the empty mask. Counts are int32 (the TPU kernels used float32 only for
// Mosaic's sake).
//
// Exactness. Values are only moved; the one arithmetic op is the recentering
// c - d*bs with d in {-1, 1}, exact in float32. Directions are
// floor(c * inv) with inv = float32(1.0 / bs) from the host, as the twin
// rounds it. So the outputs equal the twin's bitwise on all seven planes and
// the count planes.
//
// Bound. Memory: each launch reads the seven planes once and writes them
// once (7 x cap x plane x 4 B each way, 2.0 GB at the 20.97M stretch
// geometry) plus int32 count planes; the per-bin control flow is short. The
// rebin runs every 8th step at the stretch config.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1.0e9f;

// Fill of field k (xl yl zl vx vy vz) in an empty slot.
__device__ __forceinline__ float fill_of(int k) { return k < 3 ? kBig : 0.0f; }

struct Slab {
  float* f[6];  // xl yl zl vx vy vz
  int* pid;
};

struct SlabC {
  const float* f[6];
  const int* pid;
};

struct Geo3 {
  int cap, Y, X, Z;  // array extents
  int ys, xs, zs;    // physical bins
};

// grid3d_ops.slab3_dirs along one axis: one-hop clamp, then the
// physical-grid clamp at index gi of n_phys (live slots only).
__device__ __forceinline__ int dir1(float coord, int gi, int n_phys,
                                    float inv) {
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

__device__ __forceinline__ int accepted_count(int movers, int evac,
                                              int budget) {
  return max(0, min(movers, min(evac, budget)));
}

// What one axis pass needs to know about a bin's neighbours along the axis.
struct Around {
  Masks mm, m0, mp;  // masks at offsets -1, 0, +1
  int Fm, F0, Fp;    // free slots at -1, 0, +1 (pre-pass)
  int cnt_m_p1;      // -1 movers at +1
  int cnt_m_p2;      // -1 movers at +2
};

// One axis pass for bin b at index g along the axis (array extent n_arr,
// step `step` between neighbours): clear my accepted leavers, pull in my
// neighbours' accepted entrants (the -1 stream from b+1 first, then the +1
// stream from b-1), recentering the axis coordinate field `ci`.
__device__ __forceinline__ void shuffle(const SlabC in, Slab out,
                                        const Around& a, int64_t plane,
                                        int64_t b, int64_t step, int ci,
                                        int cap, int evac, float bs) {
  const uint32_t leave =
      first_bits(a.m0.neg, accepted_count(__popc(a.m0.neg), evac, a.Fm)) |
      first_bits(a.m0.pos,
                 accepted_count(__popc(a.m0.pos), evac, a.Fp - a.cnt_m_p2));
  for (int s = 0; s < cap; ++s) {
    const int64_t i = s * plane + b;
    const bool gone = (leave >> s) & 1u;
#pragma unroll
    for (int k = 0; k < 6; ++k) out.f[k][i] = gone ? fill_of(k) : in.f[k][i];
    out.pid[i] = gone ? -1 : in.pid[i];
  }
  const uint32_t capmask = cap == 32 ? 0xffffffffu : ((1u << cap) - 1u);
  const uint32_t empty = ~a.m0.alive & capmask;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int d = t == 0 ? -1 : 1;
    const uint32_t movers = d < 0 ? a.mp.neg : a.mm.pos;
    const int off = d < 0 ? 0 : a.cnt_m_p1;
    const int n_in = accepted_count(__popc(movers), evac, a.F0 - off);
    const int64_t sb = b - d * step;  // the source bin
    const float dbs = d * bs;         // exactly -bs or bs
    for (int e = 0; e < n_in; ++e) {
      const int64_t si = nth_bit(movers, e) * plane + sb;
      const int64_t ti = nth_bit(empty, off + e) * plane + b;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        out.f[k][ti] = k == ci ? __fsub_rn(in.f[k][si], dbs) : in.f[k][si];
      out.pid[ti] = in.pid[si];
    }
  }
}

// Masks at offsets -1..+2 along an in-plane axis, all from the fields.
__device__ __forceinline__ Around around_of(const SlabC in, int ci,
                                            int64_t plane, int64_t b,
                                            int64_t step, int g, int n_arr,
                                            int n_phys, int cap, float inv) {
  Masks mv[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int gv = g + v - 1;
    if (gv >= 0 && gv < n_arr)
      mv[v] = masks_of(in.f[ci], in.pid, plane, b + (v - 1) * step, cap, gv,
                       n_phys, inv);
  }
  Around a;
  a.mm = mv[0];
  a.m0 = mv[1];
  a.mp = mv[2];
  a.Fm = cap - __popc(mv[0].alive);
  a.F0 = cap - __popc(mv[1].alive);
  a.Fp = cap - __popc(mv[2].alive);
  a.cnt_m_p1 = __popc(mv[2].neg);
  a.cnt_m_p2 = __popc(mv[3].neg);
  return a;
}

__device__ __forceinline__ void bin_coords(int64_t b, const Geo3& g, int& y,
                                           int& x, int& z) {
  z = (int)(b % g.Z);
  x = (int)((b / g.Z) % g.X);
  y = (int)(b / ((int64_t)g.X * g.Z));
}

// K4a: x pass + pre-rebin monitor planes cnt[3] = far_pre, cnt[4] = alive_pre.
__global__ void __launch_bounds__(128)
rebin3_x_kernel(SlabC in, Slab mid, int* __restrict__ cnt, Geo3 g, int evac,
                float bsx, float invx, float invy, float invz) {
  const int64_t plane = (int64_t)g.Y * g.X * g.Z;
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= plane) return;
  int y, x, z;
  bin_coords(b, g, y, x, z);
  int far = 0, alive = 0;
  for (int s = 0; s < g.cap; ++s) {
    const int64_t i = s * plane + b;
    if (in.pid[i] < 0) continue;
    ++alive;
    const int rx = raw_dir(in.f[0][i], invx);
    const int ry = raw_dir(in.f[1][i], invy);
    const int rz = raw_dir(in.f[2][i], invz);
    far += (abs(rx) > 1 || abs(ry) > 1 || abs(rz) > 1) ? 1 : 0;
  }
  cnt[3 * plane + b] = far;
  cnt[4 * plane + b] = alive;
  const Around a =
      around_of(in, 0, plane, b, g.Z, x, g.X, g.xs, g.cap, invx);
  shuffle(in, mid, a, plane, b, g.Z, 0, g.cap, evac, bsx);
}

// K4b: z pass + the y pass's inputs cnt[0..2] = [m-, alive, m+] of the result.
__global__ void __launch_bounds__(128)
rebin3_z_kernel(SlabC mid, Slab out, int* __restrict__ cnt, Geo3 g, int evac,
                float bsz, float invy, float invz) {
  const int64_t plane = (int64_t)g.Y * g.X * g.Z;
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= plane) return;
  int y, x, z;
  bin_coords(b, g, y, x, z);
  const Around a = around_of(mid, 2, plane, b, 1, z, g.Z, g.zs, g.cap, invz);
  shuffle(mid, out, a, plane, b, 1, 2, g.cap, evac, bsz);
  // y counts of this thread's own writes
  int cm = 0, ca = 0, cp = 0;
  for (int s = 0; s < g.cap; ++s) {
    const int64_t i = s * plane + b;
    if (out.pid[i] < 0) continue;
    ++ca;
    const int dy = dir1(out.f[1][i], y, g.ys, invy);
    cm += dy < 0 ? 1 : 0;
    cp += dy > 0 ? 1 : 0;
  }
  cnt[0 * plane + b] = cm;
  cnt[1 * plane + b] = ca;
  cnt[2 * plane + b] = cp;
}

// K5: y pass from the xz-settled slab and its count planes, plus the
// post-rebin monitor planes post = [alive_post, resid].
__global__ void __launch_bounds__(128)
rebin3_y_kernel(SlabC in, const int* __restrict__ cnt, Slab out,
                int* __restrict__ post, Geo3 g, int evac, float bsy,
                float invx, float invy, float invz) {
  const int64_t plane = (int64_t)g.Y * g.X * g.Z;
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= plane) return;
  int y, x, z;
  bin_coords(b, g, y, x, z);
  const int64_t step = (int64_t)g.X * g.Z;
  Around a;
  a.m0 = masks_of(in.f[1], in.pid, plane, b, g.cap, y, g.ys, invy);
  if (y > 0)
    a.mm = masks_of(in.f[1], in.pid, plane, b - step, g.cap, y - 1, g.ys,
                    invy);
  if (y + 1 < g.Y)
    a.mp = masks_of(in.f[1], in.pid, plane, b + step, g.cap, y + 1, g.ys,
                    invy);
  // budgets and offsets from the count planes (0 off the array)
  auto at = [&](int which, int dy) {
    const int yv = y + dy;
    return (yv >= 0 && yv < g.Y) ? cnt[which * plane + b + dy * step] : 0;
  };
  a.Fm = g.cap - at(1, -1);
  a.F0 = g.cap - at(1, 0);
  a.Fp = g.cap - at(1, 1);
  a.cnt_m_p1 = at(0, 1);
  a.cnt_m_p2 = at(0, 2);
  shuffle(in, out, a, plane, b, step, 1, g.cap, evac, bsy);
  int alive = 0, resid = 0;
  for (int s = 0; s < g.cap; ++s) {
    const int64_t i = s * plane + b;
    if (out.pid[i] < 0) continue;
    ++alive;
    const int dx = dir1(out.f[0][i], x, g.xs, invx);
    const int dy = dir1(out.f[1][i], y, g.ys, invy);
    const int dz = dir1(out.f[2][i], z, g.zs, invz);
    resid += (dx != 0 || dy != 0 || dz != 0) ? 1 : 0;
  }
  post[0 * plane + b] = alive;
  post[1 * plane + b] = resid;
}

unsigned blocks_of(const Geo3& g) {
  return (unsigned)(((int64_t)g.Y * g.X * g.Z + 127) / 128);
}

}  // namespace

extern "C" {

// K4: slab in (xl yl zl vx vy vz pid), x-settled scratch mid, xz-settled out,
// counts cnt (5, Y, X, Z) = [m-, alive, m+, far_pre, alive_pre]. bs* are the
// float32 bin sides, inv* = float32(1.0 / bs*). Returns cudaGetLastError()
// after both launches (0 = launched). cap <= 32.
int ppsim_rebin3_inplane(const float* x, const float* y, const float* z,
                         const float* vx, const float* vy, const float* vz,
                         const int* pid, float* mx, float* my, float* mz,
                         float* mvx, float* mvy, float* mvz, int* mpid,
                         float* ox, float* oy, float* oz, float* ovx,
                         float* ovy, float* ovz, int* opid, int* cnt,
                         int device, int cap, int Y, int X, int Z, int ys,
                         int xs, int zs, int evac, float bsx, float bsz,
                         float invx, float invy, float invz, void* stream) {
  if (cap < 1 || cap > 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Geo3 g{cap, Y, X, Z, ys, xs, zs};
  const SlabC in{{x, y, z, vx, vy, vz}, pid};
  const Slab mid{{mx, my, mz, mvx, mvy, mvz}, mpid};
  const SlabC midc{{mx, my, mz, mvx, mvy, mvz}, mpid};
  const Slab out{{ox, oy, oz, ovx, ovy, ovz}, opid};
  rebin3_x_kernel<<<blocks_of(g), 128, 0, s>>>(in, mid, cnt, g, evac, bsx,
                                               invx, invy, invz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rebin3_z_kernel<<<blocks_of(g), 128, 0, s>>>(midc, out, cnt, g, evac, bsz,
                                               invy, invz);
  return (int)cudaGetLastError();
}

// K5: xz-settled slab in and its counts cnt (first two planes [m-, alive]
// read), final slab out, post (2, Y, X, Z) = [alive_post, resid].
int ppsim_rebin3_ypass(const float* x, const float* y, const float* z,
                       const float* vx, const float* vy, const float* vz,
                       const int* pid, const int* cnt, float* ox, float* oy,
                       float* oz, float* ovx, float* ovy, float* ovz,
                       int* opid, int* post, int device, int cap, int Y,
                       int X, int Z, int ys, int xs, int zs, int evac,
                       float bsy, float invx, float invy, float invz,
                       void* stream) {
  if (cap < 1 || cap > 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Geo3 g{cap, Y, X, Z, ys, xs, zs};
  const SlabC in{{x, y, z, vx, vy, vz}, pid};
  const Slab out{{ox, oy, oz, ovx, ovy, ovz}, opid};
  rebin3_y_kernel<<<blocks_of(g), 128, 0, s>>>(in, cnt, out, post, g, evac,
                                               bsy, invx, invy, invz);
  return (int)cudaGetLastError();
}

}  // extern "C"
