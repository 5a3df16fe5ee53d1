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
// Design.
//   K4 x and z pass in one launch: rebin_tile.cuh with 7 planes. A block
//      owns a strip of T z-bins of one y-slab over a segment of x rows and
//      walks it with a ring of input rows in shared memory; it settles the x
//      pass over the strip and its halo, then the z pass over its own bins,
//      and writes the xz-settled slab and the counts [m-, alive, m+,
//      far_pre, alive_pre] once: the y pass's acceptance inputs of the
//      result (its y movers and occupancy), then the pre-rebin monitors
//      (far_pre: a raw drift > 1 bin on any axis, read before any clamp).
//      The TPU kernel kept a whole (X, Z) plane in VMEM to fuse the passes;
//      the halo (1 z-bin before the strip, 2 after) is all a block needs.
//   K5 y pass, one thread per bin: xz-settled -> final slab, reading fields
//      at y-1..y+1 and the count planes at y-1..y+2, plus the [alive_post,
//      resid] monitor planes. Neighbours along y are read from device memory
//      (L1/L2 hits across neighbouring threads).
// Shards (the sharded engine, ops/cuda_rebin3.py). A shard's planes are
// y-slabs y0 .. y0 + Y - 1 of the global slab. K4's passes are slab-local,
// so it takes y0 alone (the y direction of its count planes). K5 reads
// fields at y-1..y+1 and the count planes at y-1..y+2; a shard passes the
// xz-settled fields of slabs -1 and Y and the count planes [m-, alive] of
// slab -1 and of slabs Y and Y+1, which take the place of the empty slabs
// and zero counts outside the planes. This equals the JAX package's shard
// route (both kernels on the strip extended by two ghost slabs a side,
// sharded_grid3d.py:208-230) without running K4 on a neighbour's slabs.
// The shard inputs are a template parameter (SHARD): the single-device call
// launches the instance without them.
//
// Both evaluate the acceptance predicate of grid3d_ops._axis_pass
// (slab_rebin.cuh pass_moves) from the pre-pass state on both sides of each
// transfer, so there are no atomics and no ordering between threads on the
// slab, and the decisions equal the twin's.
//
// Exactness. Values are only moved; the one arithmetic op is the recentering
// c - d*bs with d in {-1, 1}, exact in float32. Directions are
// floor(c * inv) with inv = float32(1.0 / bs) from the host, as the twin
// rounds it. So the outputs equal the twin's bitwise on all seven planes and
// the count planes.
//
// Bound. Memory: K4 reads the seven planes once (plus its halo) and writes
// them once with 5 count planes (7 x cap x plane x 4 B each way, 1.98 GB at
// the 20.97M stretch geometry); K5 the same with 2 count planes read and 2
// written. The rebin runs every 8th step at the stretch config.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rebin_tile.cuh"

namespace {

using ppsim::cap_mask;
using ppsim::dir1;
using ppsim::first_bits;
using ppsim::Masks;
using ppsim::masks_of;
using ppsim::PassMoves;
using ppsim::Planes;
using ppsim::PlanesC;

struct Geo3 {
  int cap, Y, X, Z;  // array extents
  int ys, xs, zs;    // physical bins
};

// K4, held to 2 blocks an SM: ptxas then keeps its values in registers;
// left to fit the 3 blocks its shared memory allows, it spilled and ran
// ~15% slower on the H100's stretch slab (PERF.md). SHARD: the instance
// with a y offset.
template <bool SHARD>
__global__ void __launch_bounds__(ppsim::kTileThreads, 2)
rebin3_xz_kernel(const PlanesC<7> in, const Planes<7> out,
                 int* __restrict__ cnt, const ppsim::RebinGeo g, const int T,
                 const int seg) {
  ppsim::rebin_tile<7, SHARD>(in, out, cnt, g, T, seg);
}

// A shard's ghost slabs for K5: the xz-settled fields of slab -1 (top) and
// slab Y (bottom), [cap][X][Z] each; the count planes [m-, alive] of slab
// -1, [2][X][Z], and of slabs Y and Y+1, [2][2][X][Z]. Null pids and
// counts: no ghosts.
struct SlabGhosts {
  PlanesC<7> top, bot;
  const int *ctop, *cbot;
  int y0;  // global index of the planes' slab 0
};

// K5: y pass from the xz-settled slab and its count planes, plus the
// post-rebin monitor planes post = [alive_post, resid]. SHARD: the instance
// with a y offset and ghost slabs.
template <bool SHARD>
__global__ void __launch_bounds__(128)
rebin3_y_kernel(PlanesC<7> in, const int* __restrict__ cnt, Planes<7> out,
                int* __restrict__ post, Geo3 g, int evac, float bsy,
                float invx, float invy, float invz, SlabGhosts gh) {
  const int64_t plane = (int64_t)g.Y * g.X * g.Z;
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= plane) return;
  const int z = (int)(b % g.Z);
  const int x = (int)((b / g.Z) % g.X);
  const int y = (int)(b / ((int64_t)g.X * g.Z));
  const int64_t step = (int64_t)g.X * g.Z;
  const int64_t bxz = b - y * step;  // the bin's index in a ghost slab
  const int gy = (SHARD ? gh.y0 : 0) + y;
  Masks mm, mp;
  const Masks m0 = masks_of(in.f[1], in.pid, plane, b, g.cap, gy, g.ys, invy);
  if (y > 0)
    mm = masks_of(in.f[1], in.pid, plane, b - step, g.cap, gy - 1, g.ys, invy);
  else if (SHARD && gh.top.pid)
    mm = masks_of(gh.top.f[1], gh.top.pid, step, bxz, g.cap, gy - 1, g.ys, invy);
  if (y + 1 < g.Y)
    mp = masks_of(in.f[1], in.pid, plane, b + step, g.cap, gy + 1, g.ys, invy);
  else if (SHARD && gh.bot.pid)
    mp = masks_of(gh.bot.f[1], gh.bot.pid, step, bxz, g.cap, gy + 1, g.ys, invy);
  // budgets and offsets from the count planes (0 off the array, the ghost
  // slabs' planes outside a shard)
  auto at = [&](int which, int dy) {
    const int yv = y + dy;
    if (yv >= 0 && yv < g.Y) return cnt[which * plane + b + dy * step];
    if constexpr (SHARD) {
      if (yv < 0) return gh.ctop ? gh.ctop[which * step + bxz] : 0;
      return gh.cbot ? gh.cbot[(which * 2 + yv - g.Y) * step + bxz] : 0;
    }
    return 0;
  };
  const PassMoves pm =
      ppsim::pass_moves(mm, m0, mp, g.cap - at(1, -1), g.cap - at(1, 0),
                        g.cap - at(1, 1), at(0, 2), evac);
  for (int s = 0; s < g.cap; ++s) {
    const int64_t i = s * plane + b;
    const bool gone = (pm.leave >> s) & 1u;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      out.f[k][i] = gone ? (k < 3 ? ppsim::kSlabBig : 0.0f) : in.f[k][i];
    out.pid[i] = gone ? -1 : in.pid[i];
  }
  // entrants into my pre-pass empty slots: the -1 stream (from y+1) first,
  // the +1 stream (from y-1) from empty-rank off_lo on
  auto enter = [&](int to, int from, int64_t sb, float dbs) {
    const int64_t ti = to * plane + b, si = from * plane + sb;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      out.f[k][ti] = k == 1 ? __fsub_rn(in.f[k][si], dbs) : in.f[k][si];
    out.pid[ti] = in.pid[si];
  };
  // an entrant from a ghost slab, slot stride X * Z (pointers picked one by
  // one: a struct picked by reference would be copied to local memory)
  auto enter_ghost = [&](int to, int from, bool top, float dbs) {
    const int64_t ti = to * plane + b, si = from * step + bxz;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float* f = top ? gh.top.f[k] : gh.bot.f[k];
      out.f[k][ti] = k == 1 ? __fsub_rn(f[si], dbs) : f[si];
    }
    out.pid[ti] = (top ? gh.top.pid : gh.bot.pid)[si];
  };
  const bool ghost_hi = SHARD && y + 1 == g.Y, ghost_lo = SHARD && y == 0;
  const uint32_t empty = ~m0.alive & cap_mask(g.cap);
  ppsim::stream(pm.in_hi, empty, [&](int to, int from) {
    if (ghost_hi) enter_ghost(to, from, false, -bsy);
    else enter(to, from, b + step, -bsy);
  });
  ppsim::stream(pm.in_lo, empty & ~first_bits(empty, pm.off_lo),
                [&](int to, int from) {
                  if (ghost_lo) enter_ghost(to, from, true, bsy);
                  else enter(to, from, b - step, bsy);
                });
  int alive = 0, resid = 0;
  for (int s = 0; s < g.cap; ++s) {
    const int64_t i = s * plane + b;
    if (out.pid[i] < 0) continue;
    ++alive;
    const int dx = dir1(out.f[0][i], x, g.xs, invx);
    const int dy = dir1(out.f[1][i], gy, g.ys, invy);
    const int dz = dir1(out.f[2][i], z, g.zs, invz);
    resid += (dx != 0 || dy != 0 || dz != 0) ? 1 : 0;
  }
  post[0 * plane + b] = alive;
  post[1 * plane + b] = resid;
}

}  // namespace

extern "C" {

// K4: slab in (xl yl zl vx vy vz pid), xz-settled out, counts cnt (5, Y, X,
// Z) = [m-, alive, m+, far_pre, alive_pre]; y0 the global index of slab 0
// (a shard's offset, 0 on one device). bs* are the float32 bin sides,
// inv* = float32(1.0 / bs*). The launch plan (tile width along z, segment
// along x, threads, blocks, shared bytes) must be the one
// cuda_rebin3.rebin3_plan gives for this shape; anything else returns
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch
// (0 = launched). cap <= 32.
int ppsim_rebin3_inplane(const float* x, const float* y, const float* z,
                         const float* vx, const float* vy, const float* vz,
                         const int* pid, float* ox, float* oy, float* oz,
                         float* ovx, float* ovy, float* ovz, int* opid,
                         int* cnt, int device, int cap, int Y, int X, int Z,
                         int y0, int ys, int xs, int zs, int evac, int tile, int seg,
                         int threads, int blocks, int smem, float bsx,
                         float bsz, float invx, float invy, float invz,
                         void* stream) {
  const ppsim::RebinGeo g{cap, Y, X, Z, ys, xs, zs, evac, bsx, bsz,
                          {invx, invy, invz}, 0, y0};
  if (!ppsim::rebin_plan_ok(7, g, tile, seg, threads, blocks, smem))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return ppsim::launch_rebin_tile<7>(
      y0 != 0 ? rebin3_xz_kernel<true> : rebin3_xz_kernel<false>, PlanesC<7>{{x, y, z, vx, vy, vz}, pid},
      Planes<7>{{ox, oy, oz, ovx, ovy, ovz}, opid}, cnt, g, tile, seg,
      threads, blocks, smem, (cudaStream_t)stream);
}

// K5: xz-settled slab in and its counts cnt (first two planes [m-, alive]
// read), final slab out, post (2, Y, X, Z) = [alive_post, resid]. A shard
// passes y0 and its ghost slabs: t* the fields of slab -1 and b* of slab Y
// ([cap][X][Z] each), ctop the counts [m-, alive] of slab -1 ([2][X][Z]),
// cbot of slabs Y and Y+1 ([2][2][X][Z]); all four of tpid, bpid, ctop and
// cbot null (no ghosts) or none.
int ppsim_rebin3_ypass(const float* x, const float* y, const float* z,
                       const float* vx, const float* vy, const float* vz,
                       const int* pid, const int* cnt, const float* tx,
                       const float* ty, const float* tz, const float* tvx,
                       const float* tvy, const float* tvz, const int* tpid,
                       const float* bx, const float* by, const float* bz,
                       const float* bvx, const float* bvy, const float* bvz,
                       const int* bpid, const int* ctop, const int* cbot,
                       float* ox, float* oy, float* oz, float* ovx,
                       float* ovy, float* ovz, int* opid, int* post,
                       int device, int cap, int Y, int X, int Z, int y0,
                       int ys, int xs, int zs, int evac, float bsy,
                       float invx, float invy, float invz, void* stream) {
  if (cap < 1 || cap > 32) return (int)cudaErrorInvalidValue;
  if (!tpid != !bpid || !tpid != !ctop || !tpid != !cbot)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Geo3 g{cap, Y, X, Z, ys, xs, zs};
  const SlabGhosts gh{PlanesC<7>{{tx, ty, tz, tvx, tvy, tvz}, tpid},
                      PlanesC<7>{{bx, by, bz, bvx, bvy, bvz}, bpid}, ctop,
                      cbot, y0};
  const unsigned blocks = (unsigned)(((int64_t)Y * X * Z + 127) / 128);
  auto kernel = (y0 != 0 || tpid) ? rebin3_y_kernel<true> : rebin3_y_kernel<false>;
  kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      PlanesC<7>{{x, y, z, vx, vy, vz}, pid}, cnt,
      Planes<7>{{ox, oy, oz, ovx, ovy, ovz}, opid}, post, g, evac, bsy, invx,
      invy, invz, gh);
  return (int)cudaGetLastError();
}

}  // extern "C"
