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
// Layout. Fields are (cap, R, C) float32 planes, c fastest; bin b = r*C + c,
// slot s at s*plane + b. Dead slots hold exactly BIG.
//
// Bound. Memory: K1 reads 4 planes and writes 4 + the speed plane (~0.37 ms
// at 1664^2 x 14 on 3.35 TB/s); K6 reads 2 and writes 2. Operations: each
// live particle must meet every live slot of its 9 neighbour bins (~1.4G
// ordered candidate pairs per step on the main path), of which about 1% lie
// inside the cutoff (bins are ~6 cutoffs wide). So what bounds both kernels
// on this card is the issue rate of distance tests that fail, with their
// addressing and warp divergence; not the force law and not the bytes.
// Tensor cores have no part: each test is an elementwise float32 distance
// held to the plain twin's rounding.
//
// Design. One block owns a strip of W columns over a segment of rows and
// walks it row by row. It keeps a ring of four row buffers in shared memory,
// each the strip plus one halo column on each side: rows r-1, r, r+1 for the
// row it computes, and row r+2, whose copies (cp.async, 4 bytes a slot) are
// in flight meanwhile. When a row arrives, each bin's live slots are
// compacted in place, ascending, with a count and the bounds of the live
// coordinates per bin, so empty slots, holes left by rebins and empty bins
// cost nothing. Bins outside [0,R)x[0,C) count as empty (the block_ext fill
// and the lane masks of the TPU kernel); a block never relies on the
// contents of a bin it did not copy.
//
// Most candidate tests fail, so the kernels cut them without changing a
// sum: per own bin they record which neighbour bins hold live slots and,
// for each of its four faces, the nearest live coordinate beyond it; a
// particle drops the neighbour bins beyond a face whose gap exceeds the
// cutoff. The gap is computed with the pair loop's own rounded ops and
// rounding is monotone, so every dropped pair would have failed r2 <= c2
// and added an exact zero; the kept pairs are summed in the same order.
//
// Thread mapping: one thread per live own particle of the row (a block-wide
// prefix sum lists them). Each thread walks the compacted lists of its kept
// neighbour bins in shared memory (threads of one bin read the same
// addresses, which broadcast). Owner-computes and two-sided: the TPU kernel
// evaluates each pair once (Newton 3) and scatters the reaction through a
// row spill that the next grid block reads, which relies on the TPU running
// grid blocks in order; CUDA blocks run in no order. Each particle sums its
// own force in the twin's order (directions in DIRS order, dr outer;
// neighbour slots ascending), so no atomics touch the sums and the kernel
// is deterministic. The bin's max |v|^2 is an atomicMax of the float bits
// in shared memory (order-free). Dead own slots get their outputs (K1: BIG
// and 0; K6: 0) when their row is compacted. K1 and K6 are one template
// (MOVE), so their pair loops cannot drift apart. One thread per own bin
// with its slots in registers, reading the same shared-memory rows, lost
// 1.4-8x to this mapping on the card, and the one-thread-per-bin kernels
// reading global memory that this design replaces lost 2.5-3.5x (PERF.md).
// The strip width, segment length, block size and shared-memory bytes come
// from the Python plan (cuda_grid.step_plan), which the entry points check.
//
// Shards (the sharded engine, ops/cuda_grid.py). A shard's planes are rows
// row0 .. row0 + R - 1 of the global slab; row0 enters the wall fold, and
// the neighbouring shards' boundary rows arrive as ghost planes (cap, 1, C):
// the ring takes row -1 and row R from them instead of the BIG fill, and
// compacts them as it compacts its own rows. The TPU kernel evaluates the
// ghost row's pairs self-side only because of its Newton-3 row spill
// (pallas_grid.py:488-511); here every particle sums its own force, so a
// ghost row is only read, like any neighbour row. The shard inputs are a
// template parameter (SHARD): the single-device call launches the instance
// without them, which compiles to the kernel as it was before them.
//
// Tiles (the 2-D tile engine, engines/sharded_tile.py). A tile's planes are
// also columns col0 .. col0 + C - 1 of the global slab; col0 enters the y
// wall fold, and the neighbouring tiles' boundary columns arrive as ghost
// planes (cap, R + 2, 1) each side, rows -1..R, so their first and last
// rows are the corner bins of the diagonal tiles (the mesh sends the rows
// first, then the columns of the row-extended blocks). The ring takes
// columns -1 and C from them where the single-device kernel has the fill.
// The TPU kernel carries a tile's ghost columns as 64-lane blocks on
// column-extended arrays (a 128-lane alignment device, sharded_tile.py:
// 183-193) and scatters reactions through them; here they are two bins a
// row of the ring, only read, so no output is sliced off and a tile's sums
// equal the single-device kernel's bitwise. The column inputs are a second
// template parameter (COLS) beside SHARD.
//
// Force law. The pair coefficient comes from pair_coef.cuh, a template
// parameter: the repulsive law (the default) or truncated Lennard-Jones.
//
// Numerics. Constants arrive as the float32 values the JAX package rounds
// (c2 = f32(cutoff^2), mr2 = f32(min_r^2), inv_mass = f32(1/mass)). The
// repulsive coefficient uses grid_ops.pair_coef's op order, LJ
// physics.lj_coef_from_r2's. Every product and sum of the pair loop is
// rounded as the plain twin rounds it (no FMA contraction), as in K3: on a
// late main-path slab close pairs' terms of ~1e6 cancel, and a contracted
// sum put velocities 1.7e-6 off the twin. The repulsive rsqrtf may differ
// from the CPU rsqrt by an ulp, so parity with the plain twin is allclose.
// The move tail uses explicitly rounded ops and the floored modulo of
// jnp.mod: fmodf (exact) with the sign fix, which is bit-identical to
// jnp.mod and torch.remainder for the multi-bounce fold.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_coef.cuh"
#include "step_tile.cuh"
#include "wall_fold.cuh"

namespace {

using ppsim::Law;
using ppsim::PairParams;
using ppsim::TileLayout;
using ppsim::wall_fold;

constexpr float kBig = 1.0e9f;

// Direction bits (d = (dr+1)*3 + dc+1) with dr = -1 and with dc = -1;
// shifted by 6 and 2 they are the +1 sides.
constexpr uint32_t kDRM = 0x7u;
constexpr uint32_t kDCM = 0x49u;

struct Geo2 {
  int cap, R, C;
  float bs;
};

struct Tile2 {
  int w, seg;  // own columns of a strip; rows a block walks
};

// A shard's ghost rows: x and y of row -1 (top) and of row R (bottom), each
// [cap][C]; a tile's ghost columns: x and y of column -1 (west) and of
// column C (east), rows -1..R, each [cap][R + 2]. Null pointers where the
// fill applies.
struct Ghost2 {
  const float *tx, *ty, *bx, *by;
  int row0;  // global row of the planes' row 0
  const float *wx, *wy, *ex, *ey;
  int col0;  // global column of the planes' column 0
};

// MOVE: K1 (outputs x, y, vx, vy and the speed plane); else K6 (outputs
// ax, ay in o0, o1). SHARD: K1 with a row offset and ghost rows. COLS: a
// tile, SHARD with a column offset and ghost columns.
template <Law LAW, bool MOVE, bool SHARD, bool COLS = false>
__global__ void __launch_bounds__(ppsim::kTileThreads)
grid_tile_kernel(const float* __restrict__ xl, const float* __restrict__ yl,
                 const float* __restrict__ vx, const float* __restrict__ vy,
                 float* __restrict__ o0, float* __restrict__ o1,
                 float* __restrict__ o2, float* __restrict__ o3,
                 float* __restrict__ sp, Geo2 g, Tile2 t, Ghost2 gh,
                 PairParams pp, float dt, float L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HB = t.w + 2, OB = t.w;
  const TileLayout lay = ppsim::tile_layout(2, g.cap, HB, OB);
  const int cap = g.cap;
  const int tid = threadIdx.x;
  const int64_t plane = (int64_t)g.R * g.C;

  // block -> (segment, strip), strips fastest
  const int nstrip = (g.C + t.w - 1) / t.w;
  const int c0 = (blockIdx.x % nstrip) * t.w;
  const int ra = blockIdx.x / nstrip * t.seg;
  const int rb = min(g.R, ra + t.seg);

  auto buf = [&](int rr) { return smem + ((rr - ra + 1) & 3) * lay.buf; };
  uint16_t* plist = reinterpret_cast<uint16_t*>(smem + lay.plist);
  unsigned* spmax = reinterpret_cast<unsigned*>(smem + lay.spmax);
  uint32_t* omask = reinterpret_cast<uint32_t*>(smem + lay.omask);
  float* face = reinterpret_cast<float*>(smem + lay.face);
  int* wsum = reinterpret_cast<int*>(smem + lay.wsum);

  // This thread's halo bin for copies and compaction: h = tid % HB, and
  // the copies of a bin's cap slots split over `parts` threads.
  const int parts = blockDim.x / HB;
  const int h = tid % HB, part = tid / HB;
  const int gc = c0 - 1 + h;
  const bool interior = h >= 1 && h <= t.w;
  const bool in_array = gc >= 0 && gc < g.C;
  // a tile's ghost column -1 or C, where given
  const bool west = COLS && gc == -1 && gh.wx;
  const bool east = COLS && gc == g.C && gh.ex;
  const bool colg = west || east;

  // rows held: the planes' own, and the ghost rows -1 and R where given
  auto held = [&](int rr) {
    return (rr >= 0 && rr < g.R) ||
           (SHARD && ((rr == -1 && gh.tx) || (rr == g.R && gh.bx)));
  };
  auto issue = [&](int rr) {
    if (!held(rr) || part >= parts || !(in_array || colg)) return;
    float* c = reinterpret_cast<float*>(buf(rr));
    const bool own_row = !SHARD || (rr >= 0 && rr < g.R);
    // (pointers picked one by one: a struct picked by reference would be
    // copied to local memory)
    const float* px = west ? gh.wx : east ? gh.ex : own_row ? xl : (rr < 0 ? gh.tx : gh.bx);
    const float* py = west ? gh.wy : east ? gh.ey : own_row ? yl : (rr < 0 ? gh.ty : gh.by);
    const int64_t stride = colg ? (int64_t)g.R + 2 : own_row ? plane : g.C;
    const int64_t gb = colg ? (int64_t)rr + 1 : own_row ? (int64_t)rr * g.C + gc : gc;
    for (int s = part; s < cap; s += parts) {
      ppsim::cp_async4(c + s * HB + h, px + s * stride + gb);
      ppsim::cp_async4(c + (cap + s) * HB + h, py + s * stride + gb);
    }
  };
  auto compact = [&](int rr) {
    if (tid >= HB) return;
    unsigned char* b = buf(rr);
    const bool loaded = held(rr) && (in_array || colg);
    int k = 0;
    uint32_t dead = 0;
    if (loaded)
      k = ppsim::compact_bin<2>(reinterpret_cast<float*>(b),
                                reinterpret_cast<float*>(b + lay.bnd), cap,
                                HB, h, interior ? b + lay.slot : nullptr, OB,
                                h - 1, &dead);
    b[lay.ncnt + h] = (uint8_t)k;
    if (interior && loaded && !colg && rr >= ra && rr < rb) {
      const int64_t gb = (int64_t)rr * g.C + gc;
      for (int s = 0; s < cap; ++s) {
        if (dead >> s & 1u) {
          const int64_t i = s * plane + gb;
          if constexpr (MOVE) {
            o0[i] = kBig;
            o1[i] = kBig;
            o2[i] = 0.0f;
            o3[i] = 0.0f;
          } else {
            o0[i] = 0.0f;
            o1[i] = 0.0f;
          }
        }
      }
    }
  };

  issue(ra - 1);
  issue(ra);
  issue(ra + 1);
  ppsim::cp_async_commit();
  ppsim::cp_async_wait_all();
  __syncthreads();
  compact(ra - 1);
  compact(ra);
  compact(ra + 1);
  __syncthreads();

  const float twoL = 2.0f * L;
  const float cutm = pp.cutoff * 1.000001f;
  for (int r = ra; r < rb; ++r) {
    // row r+2 streams in while row r computes
    if (r + 1 < rb) issue(r + 2);
    ppsim::cp_async_commit();

    // the live own particles of row r, one list entry each (own bin o sits
    // at halo bin o + 1; a ragged strip's bins past C are not its own)
    const unsigned char* cur = buf(r);
    const int v = tid < OB && (!COLS || c0 + tid < g.C) ? cur[lay.ncnt + tid + 1] : 0;
    int total;
    const int first = ppsim::block_exclusive_scan(v, wsum, &total);
    for (int k = 0; k < v; ++k) plist[first + k] = (uint16_t)(tid << 5 | k);
    if (tid < OB) {
      if (MOVE) spmax[tid] = 0u;
      // The bin's non-empty neighbours (bit d, DIRS order) and, per face,
      // the nearest live coordinate beyond it: the largest x of the dr=-1
      // bins, the smallest x of the dr=+1 bins, and so on.
      uint32_t m = 0;
      float f[4] = {-kBig, kBig, -kBig, kBig};
#pragma unroll
      for (int d = 0; d < 9; ++d) {
        const int dr = d / 3 - 1, dc = d % 3 - 1;
        const unsigned char* nb = buf(r + dr);
        const int hn = tid + 1 + dc;
        if (nb[lay.ncnt + hn] == 0) continue;
        m |= 1u << d;
        const float* bn = reinterpret_cast<const float*>(nb + lay.bnd);
        if (dr) f[dr < 0 ? 0 : 1] = dr < 0 ? fmaxf(f[0], bn[1 * HB + hn])
                                           : fminf(f[1], bn[0 * HB + hn]);
        if (dc) f[dc < 0 ? 2 : 3] = dc < 0 ? fmaxf(f[2], bn[3 * HB + hn])
                                           : fminf(f[3], bn[2 * HB + hn]);
      }
      omask[tid] = m;
#pragma unroll
      for (int q = 0; q < 4; ++q) face[q * OB + tid] = f[q];
    }
    __syncthreads();
    const float* cc = reinterpret_cast<const float*>(cur);

    const float row_off = __fmul_rn((float)((SHARD ? gh.row0 : 0) + r), g.bs);
    for (int p = tid; p < total; p += blockDim.x) {
      const int e = plist[p];
      const int ob = e >> 5, k = e & 31;
      const float sx = cc[k * HB + ob + 1];
      const float sy = cc[(cap + k) * HB + ob + 1];
      const int s = cur[lay.slot + k * OB + ob];
      const int64_t i = s * plane + (int64_t)r * g.C + c0 + ob;
      float ax = 0.0f, ay = 0.0f;
      // Cut the neighbour bins beyond a face whose nearest live coordinate
      // lies more than a cutoff away: the gap is computed with the pair
      // loop's own rounded ops (neighbour + offset, minus own), rounding is
      // monotone, so every pair there would fail r2 <= c2 (cutm carries a
      // 1e-6 margin over the cutoff). Cut pairs would add exact zeros.
      uint32_t m = omask[ob];
      const float* fc = face + ob;
      if (__fsub_rn(__fadd_rn(fc[0], -g.bs), sx) < -cutm) m &= ~kDRM;
      if (__fsub_rn(__fadd_rn(fc[OB], g.bs), sx) > cutm) m &= ~(kDRM << 6);
      if (__fsub_rn(__fadd_rn(fc[2 * OB], -g.bs), sy) < -cutm) m &= ~kDCM;
      if (__fsub_rn(__fadd_rn(fc[3 * OB], g.bs), sy) > cutm)
        m &= ~(kDCM << 2);
      // the remaining bins in DIRS order (dr outer, dc inner)
      while (m) {
        const int d = __ffs(m) - 1;
        m &= m - 1;
        const int dr = d / 3 - 1, dc = d % 3 - 1;
        const unsigned char* nb = buf(r + dr);
        const float offx = dr * g.bs;  // exactly -bs, 0 or bs
        const float offy = dc * g.bs;
        const int hn = ob + 1 + dc;
        const int n = nb[lay.ncnt + hn];
        const float* px = reinterpret_cast<const float*>(nb) + hn;
        const float* py = px + cap * HB;
        for (int j = 0; j < n; ++j) {
          const float xno = __fadd_rn(px[j * HB], offx);
          const float yno = __fadd_rn(py[j * HB], offy);
          const float dx = __fsub_rn(xno, sx);
          const float dy = __fsub_rn(yno, sy);
          const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          if (r2 <= pp.c2) {
            const float coef = ppsim::pair_coef<LAW>(r2, pp);
            ax = __fadd_rn(ax, __fmul_rn(coef, dx));
            ay = __fadd_rn(ay, __fmul_rn(coef, dy));
          }
        }
      }
      if constexpr (MOVE) {
        // Move tail (pallas_grid._move_tail) of a live slot: Verlet, wall
        // fold, speed plane.
        float vxs = __fadd_rn(vx[i], __fmul_rn(ax, dt));
        float vys = __fadd_rn(vy[i], __fmul_rn(ay, dt));
        float x = __fadd_rn(sx, __fmul_rn(vxs, dt));
        float y = __fadd_rn(sy, __fmul_rn(vys, dt));
        wall_fold(x, vxs, row_off, L, twoL);
        wall_fold(y, vys, __fmul_rn((float)((COLS ? gh.col0 : 0) + c0 + ob), g.bs), L,
                  twoL);
        o0[i] = x;
        o1[i] = y;
        o2[i] = vxs;
        o3[i] = vys;
        atomicMax(&spmax[ob], __float_as_uint(__fadd_rn(
                                  __fmul_rn(vxs, vxs), __fmul_rn(vys, vys))));
      } else {
        o0[i] = ax;
        o1[i] = ay;
      }
    }
    __syncthreads();
    if (MOVE && tid < OB && c0 + tid < g.C)
      sp[(int64_t)r * g.C + c0 + tid] = __uint_as_float(spmax[tid]);
    ppsim::cp_async_wait_all();
    __syncthreads();
    if (r + 1 < rb) compact(r + 2);
    __syncthreads();
  }
}

// The plan's shape checks: the launch must be the one cuda_grid.step_plan
// gives for (cap, R, C).
bool plan_ok(int cap, int R, int C, int w, int seg, int threads, int blocks,
             int smem) {
  if (cap < 1 || cap > 32 || w < 1 || seg < 1) return false;
  const int hb = w + 2;
  const int nblocks = ((C + w - 1) / w) * ((R + seg - 1) / seg);
  return threads % 32 == 0 && threads <= ppsim::kTileThreads &&
         hb <= threads && blocks == nblocks &&
         smem == ppsim::tile_layout(2, cap, hb, w).bytes;
}

template <bool MOVE>
int launch(int law, const float* xl, const float* yl, const float* vx,
           const float* vy, float* o0, float* o1, float* o2, float* o3,
           float* sp, const Geo2& g, const Tile2& t, const Ghost2& gh,
           int threads, int blocks, int smem, const PairParams& pp, float dt,
           float L, cudaStream_t s) {
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<blocks, threads, smem, s>>>(xl, yl, vx, vy, o0, o1, o2, o3, sp,
                                         g, t, gh, pp, dt, L);
    return (int)cudaGetLastError();
  };
  const bool cols = gh.col0 != 0 || gh.wx || gh.ex;
  const bool shard = cols || gh.row0 != 0 || gh.tx || gh.bx;
  if constexpr (MOVE) {
    if (cols) {
      if (law == (int)Law::kRepulsive)
        return go(grid_tile_kernel<Law::kRepulsive, true, true, true>);
      if (law == (int)Law::kLJ) return go(grid_tile_kernel<Law::kLJ, true, true, true>);
      return (int)cudaErrorInvalidValue;
    }
    if (shard) {
      if (law == (int)Law::kRepulsive)
        return go(grid_tile_kernel<Law::kRepulsive, true, true>);
      if (law == (int)Law::kLJ) return go(grid_tile_kernel<Law::kLJ, true, true>);
      return (int)cudaErrorInvalidValue;
    }
  }
  if (law == (int)Law::kRepulsive)
    return go(grid_tile_kernel<Law::kRepulsive, MOVE, false>);
  if (law == (int)Law::kLJ) return go(grid_tile_kernel<Law::kLJ, MOVE, false>);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// law 0 = repulsive, 1 = Lennard-Jones (pair_coef.cuh). A shard passes its
// global row offset row0 and its ghost rows (gtx, gty: row -1; gbx, gby:
// row R; each [cap][C]); a tile also its global column offset col0 and its
// ghost columns (gwx, gwy: column -1; gex, gey: column C; each [cap][R + 2],
// rows -1..R), which need the ghost rows; null ghosts take the BIG fill.
// The launch plan
// (strip width w, segment length, threads, blocks, shared bytes) must be
// the one cuda_grid.step_plan gives for this shape; anything else returns
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch
// (0 = launched). cap <= 32.
int ppsim_grid_step(const float* xl, const float* yl, const float* vx,
                    const float* vy, const float* gtx, const float* gty,
                    const float* gbx, const float* gby, const float* gwx,
                    const float* gwy, const float* gex, const float* gey,
                    float* xo, float* yo, float* vxo, float* vyo, float* sp,
                    int device, int cap, int R, int C, int row0, int col0,
                    int law, int w, int seg,
                    int threads, int blocks,
                    int smem, float bs, float c2, float cutoff, float mr2,
                    float inv_mass, float sig2, float lj_k, float mass,
                    float dt, float L, void* stream) {
  if (!plan_ok(cap, R, C, w, seg, threads, blocks, smem))
    return (int)cudaErrorInvalidValue;
  if ((gtx == nullptr) != (gty == nullptr) || (gbx == nullptr) != (gby == nullptr) ||
      (gwx == nullptr) != (gwy == nullptr) || (gex == nullptr) != (gey == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((gwx || gex) && !(gtx && gbx)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const PairParams pp{c2, cutoff, mr2, inv_mass, sig2, lj_k, mass};
  return launch<true>(law, xl, yl, vx, vy, xo, yo, vxo, vyo, sp,
                      Geo2{cap, R, C, bs}, Tile2{w, seg},
                      Ghost2{gtx, gty, gbx, gby, row0, gwx, gwy, gex, gey, col0},
                      threads, blocks, smem,
                      pp, dt, L, (cudaStream_t)stream);
}

// K6: accelerations (ax, ay) of the slab positions (xl, yl); arguments as
// ppsim_grid_step's.
int ppsim_grid_force(const float* xl, const float* yl, float* ax, float* ay,
                     int device, int cap, int R, int C, int law, int w,
                     int seg, int threads, int blocks, int smem, float bs,
                     float c2, float cutoff, float mr2, float inv_mass,
                     float sig2, float lj_k, float mass, void* stream) {
  if (!plan_ok(cap, R, C, w, seg, threads, blocks, smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const PairParams pp{c2, cutoff, mr2, inv_mass, sig2, lj_k, mass};
  return launch<false>(law, xl, yl, nullptr, nullptr, ax, ay, nullptr,
                       nullptr, nullptr, Geo2{cap, R, C, bs}, Tile2{w, seg},
                       Ghost2{nullptr, nullptr, nullptr, nullptr, 0, nullptr,
                              nullptr, nullptr, nullptr, 0},
                       threads,
                       blocks, smem, pp, 0.0f, 0.0f,
                       (cudaStream_t)stream);
}

const char* ppsim_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
