// K7 + K8: the loss-free 9-direction ("dirs9") slab rebin for Hopper
// (sm_90a), the ablation against the axis-factorized K2.
//
// Replaces: ppsim_tpu/ops/pallas_rebin.py:_counts_kernel (K7, through
// rebin_counts_pallas) and _shuffle_kernel (K8, through rebin_shuffle_pallas /
// grid_rebin_pallas). Plain twins: ppsim_tpu_torch/ops/cuda_rebin.py
// rebin_counts_plain and rebin_shuffle_plain (grid_ops.rebin_counts and
// grid_ops.rebin_shuffle, plus the monitor planes).
//
// Design. As K2, one thread per bin (r, c), c fastest, one launch per pass,
// and the input slab is never written:
//   K7 reads xl, yl, pid and writes the int32 (9, R, C) count stack: [d] =
//      live slots whose direction is DIRS[d], [4] = the live count. (The TPU
//      carried counts in f32 only because Mosaic narrowed i1.)
//   K8 reads the 5 fields and the counts and writes the 5 fields into fresh
//      buffers, plus the (4, R, C) monitor stack [far_pre, alive_pre,
//      alive_post, resid] of K2 (the TPU reduced the same quantities with XLA
//      after the kernel).
// No atomics: each thread writes only its own bin's slots. As source it
// clears its accepted leavers; as destination it pulls group d from the bin
// at -d into its own pre-rebin empty slots, evaluating that source's
// acceptance predicate in its own frame. Group d is accepted up to rank <
// evac and off[d] + rank < F at the destination, where F = cap - live count
// and off[d] = the entrants queued there by the groups before d in DIRS order
// (off[d](b) = sum over d' < d of counts[d'](b - d')). So the source reads
// counts up to 2 bins away (offsets d - d') and fields 1 bin away; bins
// outside the array read count 0 and no particles. Every decision reads the
// input slab, never the output.
//
// Slot choice. The e-th accepted entrant of group d lands in the empty slot of
// pre-rebin empty-rank off[d] + e (grid_ops.grid_rebin's placement). The TPU
// kernel found it with a cap x cap select loop because vector lanes cannot
// index; a thread takes the (off[d] + e)-th set bit of its empty mask.
//
// Exactness. Values are only moved; the one arithmetic op is the re-basing
// x - dr*bs with dr in {-1, 0, 1}, explicitly rounded (__fsub_rn) so no FMA
// contraction can move it. Directions come from slab_rebin.cuh (the op order
// of grid_ops.slab_dirs). So the output equals the plain twin bitwise on all
// planes.
//
// Bound. Memory: K7 reads 3 planes and writes 9 count planes; K8 reads 5
// planes + the count stack and writes 5 planes + 4 monitor planes. The
// neighbour reads (8 bins x cap slots of x, y, pid per thread; a 5 x 5 window
// of counts) are shared by adjacent threads and mostly hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_rebin.cuh"

namespace {

using ppsim::accepted_count;
using ppsim::cap_mask;
using ppsim::clamp_dir;
using ppsim::dir1;
using ppsim::first_bits;
using ppsim::nth_bit;
using ppsim::raw_dir;
using ppsim::Slab;
using ppsim::SlabC;

constexpr float kBig = ppsim::kSlabBig;

// Direction code of grid_ops.DIRS: d = (dr + 1) * 3 + (dc + 1); 4 = stay.
__device__ __forceinline__ int dcode(int dr, int dc) { return (dr + 1) * 3 + (dc + 1); }

__global__ void __launch_bounds__(128)
rebin_counts_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const int* __restrict__ pid, int* __restrict__ counts,
                    int cap, int R, int C, int rows, int cols, float inv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const int64_t plane = (int64_t)R * C;
  const int64_t b = (int64_t)r * C + c;
  int n[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) n[k] = 0;
  for (int s = 0; s < cap; ++s) {
    const int64_t i = s * plane + b;
    if (pid[i] < 0) continue;
    const int d = dcode(dir1(x[i], r, rows, inv), dir1(y[i], c, cols, inv));
#pragma unroll
    for (int k = 0; k < 9; ++k) n[k] += (k == 4 || k == d) ? 1 : 0;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) counts[k * plane + b] = n[k];
}

__global__ void __launch_bounds__(128)
rebin_shuffle_kernel(SlabC in, const int* __restrict__ counts, Slab out,
                     int* __restrict__ mon, int cap, int R, int C, int rows,
                     int cols, int evac, float bs, float inv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const int64_t plane = (int64_t)R * C;
  const int64_t b = (int64_t)r * C + c;

  // Count plane k of the bin at (r + dr, c + dc); 0 outside the array.
  auto cnt = [&](int k, int dr, int dc) -> int {
    const int rr = r + dr, cc = c + dc;
    if (rr < 0 || rr >= R || cc < 0 || cc >= C) return 0;
    return counts[k * plane + (int64_t)rr * C + cc];
  };

  // Own slots: aliveness, per-direction mover masks, far movers.
  uint32_t alive = 0, moving = 0;
  uint32_t movers[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) movers[k] = 0;
  int far = 0;
  for (int s = 0; s < cap; ++s) {
    const int64_t i = s * plane + b;
    if (in.pid[i] < 0) continue;
    alive |= 1u << s;
    const int rx = raw_dir(in.x[i], inv);
    const int ry = raw_dir(in.y[i], inv);
    far += (abs(rx) > 1 || abs(ry) > 1) ? 1 : 0;
    const int d = dcode(clamp_dir(rx, r, rows), clamp_dir(ry, c, cols));
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (k == d && k != 4) movers[k] |= 1u << s;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) moving |= movers[k];

  const int F0 = cap - cnt(4, 0, 0);
  const uint32_t empty = ~alive & cap_mask(cap);  // pre-rebin empty slots
  uint32_t leave = 0, filled = 0;
  int resid_in = 0;
  int off = 0;  // my off[d]: entrants queued here before group d
#pragma unroll
  for (int d = 0; d < 9; ++d) {
    if (d == 4) continue;
    const int dr = d / 3 - 1, dc = d % 3 - 1;

    // Source side: my group d into the bin at +d, whose off[d] sums the
    // counts of the groups d' < d at offsets d - d' from me.
    int off_dest = 0;
#pragma unroll
    for (int dp = 0; dp < d; ++dp)
      if (dp != 4) off_dest += cnt(dp, dr - (dp / 3 - 1), dc - (dp % 3 - 1));
    const int F_dest = cap - cnt(4, dr, dc);
    leave |= first_bits(movers[d], accepted_count(__popc(movers[d]), evac,
                                                  F_dest - off_dest));

    // Destination side: group d of the source bin at -d, into my empty
    // slots from empty-rank off[d] on.
    const int sr = r - dr, sc = c - dc;
    if (sr >= 0 && sr < R && sc >= 0 && sc < C) {
      const int64_t sb = (int64_t)sr * C + sc;
      uint32_t src = 0;
      for (int s = 0; s < cap; ++s) {
        const int64_t i = s * plane + sb;
        if (in.pid[i] < 0) continue;
        if (dir1(in.x[i], sr, rows, inv) == dr && dir1(in.y[i], sc, cols, inv) == dc)
          src |= 1u << s;
      }
      const int n_in = accepted_count(__popc(src), evac, F0 - off);
      const float dxs = dr * bs, dys = dc * bs;  // exactly -bs, 0 or bs
      for (int e = 0; e < n_in; ++e) {
        const int64_t si = nth_bit(src, e) * plane + sb;
        const int t = nth_bit(empty, off + e);
        if (t < 0) break;  // counts not of this slab: no such empty slot
        const int64_t ti = t * plane + b;
        const float xn = __fsub_rn(in.x[si], dxs);
        const float yn = __fsub_rn(in.y[si], dys);
        out.x[ti] = xn;
        out.y[ti] = yn;
        out.vx[ti] = in.vx[si];
        out.vy[ti] = in.vy[si];
        out.pid[ti] = in.pid[si];
        filled |= 1u << t;
        resid_in += (dir1(xn, r, rows, inv) != 0 || dir1(yn, c, cols, inv) != 0) ? 1 : 0;
      }
    }
    off += cnt(d, -dr, -dc);
  }

  // Own slots not taken by an entrant: accepted leavers clear, the rest keep
  // their input values.
  for (int s = 0; s < cap; ++s) {
    if ((filled >> s) & 1u) continue;
    const int64_t i = s * plane + b;
    const bool gone = (leave >> s) & 1u;
    out.x[i] = gone ? kBig : in.x[i];
    out.y[i] = gone ? kBig : in.y[i];
    out.vx[i] = gone ? 0.0f : in.vx[i];
    out.vy[i] = gone ? 0.0f : in.vy[i];
    out.pid[i] = gone ? -1 : in.pid[i];
  }

  const uint32_t stay = alive & ~leave;
  mon[0 * plane + b] = far;
  mon[1 * plane + b] = __popc(alive);
  mon[2 * plane + b] = __popc(stay) + __popc(filled);
  mon[3 * plane + b] = __popc(stay & moving) + resid_in;
}

}  // namespace

extern "C" {

// K7: counts (9, R, C) int32 of the slab (x, y, pid). Returns
// cudaGetLastError() after the launch (0 = launched). cap <= 32.
int ppsim_rebin_counts(const float* x, const float* y, const int* pid,
                       int* counts, int device, int cap, int R, int C,
                       int rows, int cols, float inv, void* stream) {
  if (cap < 1 || cap > 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(128);
  const dim3 grid((C + block.x - 1) / block.x, R);
  rebin_counts_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, y, pid, counts, cap, R, C, rows, cols, inv);
  return (int)cudaGetLastError();
}

// K8: the pre-rebin slab in (x, y, vx, vy, pid) and its K7 counts -> the
// rebinned slab out and the monitor planes mon (4, R, C) = [far_pre,
// alive_pre, alive_post, resid]. Returns cudaGetLastError() after the launch.
int ppsim_rebin_shuffle(const float* x, const float* y, const float* vx,
                        const float* vy, const int* pid, const int* counts,
                        float* ox, float* oy, float* ovx, float* ovy,
                        int* opid, int* mon, int device, int cap, int R, int C,
                        int rows, int cols, int evac, float bs, float inv,
                        void* stream) {
  if (cap < 1 || cap > 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(128);
  const dim3 grid((C + block.x - 1) / block.x, R);
  rebin_shuffle_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      SlabC{x, y, vx, vy, pid}, counts, Slab{ox, oy, ovx, ovy, opid}, mon,
      cap, R, C, rows, cols, evac, bs, inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
