// K2: loss-free axis-factorized slab rebin for Hopper (sm_90a), both passes
// in one launch.
//
// Replaces: ppsim_tpu/ops/pallas_rebin.py:_axes_kernel (through
// rebin_axes_call_pallas / grid_rebin_axes_pallas). Plain twin:
// ppsim_tpu_torch/ops/grid_ops.py _axis_pass2 (x pass, then y pass), with the
// monitor planes of ppsim_tpu_torch/ops/cuda_rebin.py rebin_axes_call_plain.
//
// Design: rebin_tile.cuh with 5 planes. A block owns a strip of T columns
// over a segment of rows and walks it with a ring of input rows in shared
// memory; it settles the x pass (rows) over the strip and its halo, then the
// y pass (cols) over its own bins, and writes the final slab and the count
// planes [far_pre, alive_pre, alive_post, resid] once. The TPU kernel fused
// both passes over a whole row block in VMEM ("one HBM round trip for the
// whole rebin"); the strip's halo of 1 column before and 2 after gives each
// block what the y pass needs, so here too the x-settled slab never reaches
// device memory.
//
// Exactness. Values are only moved; the one arithmetic op is the recentering
// x - d*bs with d in {-1, 1}, exact in float32. Directions are
// floor(x * inv) with inv = f32(1.0 / bin_size) from the host, as in JAX, and
// every decision is the twin's acceptance predicate. So the output is bitwise
// equal to the plain twin on all five planes and the count planes.
//
// Shards: the kernel takes a shard's global row offset and its ghost rows,
// and a tile also its global column offset and its ghost columns
// (rebin_tile.cuh); the single-device call passes row0 = 0 and no ghosts.
// The TPU kernel takes a tile on column-extended arrays with 2 real ghost
// columns a side in 64-lane blocks (sharded_tile.py:291-317) and its ghost
// lanes' counts are sliced off before the mesh sum; here the walk takes the
// columns it reads, 1 west and 2 east, and writes own bins only.
//
// Bound. Memory: it reads the 5 planes once (plus the halo rows and columns,
// mostly from L2) and writes 5 planes and 4 count planes once. It runs every
// rebin_every-th step, so its cost is amortized over the cadence.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rebin_tile.cuh"

namespace {

// ptxas fits K2 in 80 registers without spilling, 3 blocks an SM, so its
// launch bounds ask for no minimum of blocks (K4's do: rebin3.cu).
// SHARD: the instance with a row offset and ghost rows; COLS: a tile's,
// with a column offset and ghost columns too; the single-device call
// launches the one without them.
template <bool SHARD, bool COLS = false>
__global__ void __launch_bounds__(ppsim::kTileThreads)
rebin_axes_kernel(const ppsim::PlanesC<5> in, const ppsim::Planes<5> out,
                  int* __restrict__ cnt, const ppsim::RebinGeo g,
                  const int T, const int seg,
                  const ppsim::RowGhosts<5> gh, const ppsim::ColGhosts<5> gc) {
  ppsim::rebin_tile<5, SHARD, COLS>(in, out, cnt, g, T, seg, gh, gc);
}

}  // namespace

extern "C" {

// Pre-rebin slab in (x, y, vx, vy, pid), final slab out, count planes cnt
// (4, R, C) = [far_pre, alive_pre, alive_post, resid]. A shard passes its
// global row offset row0 and its ghost rows: t* row -1 of each plane
// [cap][C]; b* rows R and R+1, [cap][2][C] for bx and bpid, [cap][C] (row
// R) for by, bvx, bvy. Null tpid / bpid: no ghosts. A tile also passes its
// global column offset col0 and its ghost columns: w* column -1, e* columns
// C and C+1, rows -1..R+1 for wx, wpid, ex, epid ([cap][R + 3][1] and
// [cap][R + 3][2]) and rows -1..R for the others ([cap][R + 2][1], [2]);
// they need the ghost rows. Null wpid / epid: no ghost column that side.
// The launch plan (tile
// width, segment, threads, blocks, shared bytes) must be the one
// cuda_rebin.rebin_plan gives for this shape; anything else returns
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch
// (0 = launched). cap <= 32.
int ppsim_rebin_axes(const float* x, const float* y, const float* vx,
                     const float* vy, const int* pid, const float* tx,
                     const float* ty, const float* tvx, const float* tvy,
                     const int* tpid, const float* bx, const float* by,
                     const float* bvx, const float* bvy, const int* bpid,
                     const float* wx, const float* wy, const float* wvx,
                     const float* wvy, const int* wpid, const float* ex,
                     const float* ey, const float* evx, const float* evy,
                     const int* epid, float* ox, float* oy, float* ovx,
                     float* ovy, int* opid, int* cnt, int device, int cap,
                     int R, int C, int row0, int col0, int rows, int cols,
                     int evac, int tile, int seg,
                     int threads, int blocks, int smem, float bs, float inv,
                     void* stream) {
  const ppsim::RebinGeo g{cap, 1, R, C, 1, rows, cols, evac, bs, bs,
                          {inv, inv, 0.0f}, row0};
  if (!ppsim::rebin_plan_ok(5, g, tile, seg, threads, blocks, smem))
    return (int)cudaErrorInvalidValue;
  if ((tpid == nullptr) != (bpid == nullptr)) return (int)cudaErrorInvalidValue;
  const bool cols_in = col0 != 0 || wpid || epid;
  if (cols_in && !tpid) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = cols_in ? rebin_axes_kernel<true, true>
                : (row0 != 0 || tpid) ? rebin_axes_kernel<true>
                                      : rebin_axes_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      ppsim::PlanesC<5>{{x, y, vx, vy}, pid},
      ppsim::Planes<5>{{ox, oy, ovx, ovy}, opid}, cnt, g, tile, seg,
      ppsim::RowGhosts<5>{{{tx, ty, tvx, tvy}, tpid}, {{bx, by, bvx, bvy}, bpid}},
      ppsim::ColGhosts<5>{{{wx, wy, wvx, wvy}, wpid}, {{ex, ey, evx, evy}, epid}, col0});
  return (int)cudaGetLastError();
}

}  // extern "C"
