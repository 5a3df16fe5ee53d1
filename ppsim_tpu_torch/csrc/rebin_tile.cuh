// The fused axis rebin of the Hopper kernels K2 (rebin_axes.cu: the 2D x
// pass, then the y pass) and K4 (rebin3.cu: the 3D x pass, then the z pass,
// per y-slab) as one pass through shared-memory tiles. One template serves
// both: NF = 5 planes (x y vx vy pid) in 2D, 7 (x y z vx vy vz pid) in 3D.
//
// Axes. The first pass moves along the walked axis (2D rows, 3D x), the
// second along the strip axis (2D cols, 3D z; the fastest in memory, so a
// warp's bins are neighbours in memory). Field 0 is the walked coordinate,
// field FS (2D y, 3D z) the strip one.
//
// Dependencies. The walked pass of bin (w, c) reads column c at rows
// w-1..w+2 (masks at all four, fields at w-1..w+1); the strip pass of that
// bin reads the walk-settled row w at columns c-1..c+2. So a block owns a
// strip of T columns over a segment of rows, with a halo of 1 column before
// and 2 after, and walks the segment row by row. Its ring in shared memory
// holds the input rows w-1..w+2 and row w+3 in flight (cp.async, 4 bytes a
// slot): every plane of the input slab is read from device memory once,
// plus the halo, and nothing goes back to device memory between the passes.
//
// Per row:
//   A. when a row arrives, one thread per halo bin reads its slots once and
//      keeps their masks: alive, -1 and +1 movers along the walked axis and
//      along the strip axis (a slot's strip direction depends only on its
//      strip coordinate and column, which the walked pass leaves alone),
//      and the bin's far movers;
//   B. one thread per halo bin settles the walked pass in shared memory from
//      masks alone: a source map, one byte a slot (own slot, a slot of row
//      w-1 or w+1, or the fill of a leaver), and the strip-axis masks of the
//      settled bin (its stayers' bits plus each entrant's bit from its
//      source row). Halo bins are settled redundantly by the blocks beside:
//      each derives the same decisions from the same input, so no block
//      needs another's.
//   C. one thread per own bin settles the strip pass into a final source map
//      (two bytes a slot: the input slot, its row and its column) and writes
//      the bin's count planes that need no values;
//   D. one thread per (slot, own bin), bins fastest, writes the output planes
//      coalesced from the ring through the final map, recentering a moved
//      coordinate with __fsub_rn(c, +-bs), and counts the per-slot monitors
//      (2D resid; 3D the y movers) in shared memory.
// Decisions follow grid_ops._axis_pass2 (slab_rebin.cuh pass_moves):
// entrants fill the pre-pass empty slots in empty-rank order, the -1 stream
// first, the +1 stream from the -1 movers' count on. A slot nobody touches
// keeps its input values, as in the twins.
//
// Shards (K2 and K4 in the sharded engines). 3D: the passes are slab-local,
// so a shard of y-slabs y0 .. y0 + NY - 1 needs no ghosts; y0 enters the y
// direction of the count planes [m-, alive, m+] (the clamp at the physical
// edge), and far_pre, a raw drift, reads no index. 2D: a shard's rows are
// global rows w0 .. w0 + W - 1: w0 enters every use of a row index as a
// global one (the clamp at the physical edge, the count planes). The walk of row w reads
// masks at rows w-1..w+2 and fields at w-1..w+1, so at a shard's first and
// last segment the ring takes row -1 from the top ghosts (every plane) and
// rows W and W+1 from the bottom ghosts (row W of every plane; row W+1 of
// the walked coordinate and pid only, the masks its -1 movers need): the
// exchange of the JAX package's sharded engine (sharded_grid.py:230-253).
// Without ghosts the rows outside [0, W) hold no particles, as before. The
// shard inputs are a template parameter (SHARD): an instance without them
// compiles to the walk as it was before them.
//
// Tiles (K2 in the 2-D tile engine). A tile's columns are global columns
// s0g .. s0g + S - 1: s0g enters every use of a strip index as a global one
// (the clamp at the physical edge, in the masks and in resid). The strip
// pass of column c reads the walk-settled columns c-1..c+2, so at a tile's
// west and east edges the strip's halo takes column -1 and columns S and
// S+1 from ghost columns of every plane (instead of treating them as
// empty), over the rows the walk reads there: -1..W+1, row W+1 of the
// walked coordinate and pid only, as for the ghost rows. The walked pass of
// a ghost column is settled redundantly, like any halo bin: it derives the
// owner's decisions from the same input, so a transfer across a column
// boundary needs no handshake (the JAX argument, sharded_tile.py:31-35).
// The count planes cover own bins only. The column inputs are a second
// template parameter (COLS) beside SHARD; only the 2D walk takes them.
//
// Count planes. 2D: [far_pre, alive_pre, alive_post, resid]; 3D: [m-, alive,
// m+, far_pre, alive_pre], the y pass's inputs of the xz-settled slab (K5
// reads them) and the pre-rebin monitors.
//
// The tile, segment, block size and shared bytes come from the Python plan
// (cuda_rebin.rebin_plan, cuda_rebin3.rebin3_plan), whose rebin_smem repeats
// rebin_layout; the entry points refuse any other plan. rebin_tile is the
// kernels' body: K2 and K4 are __global__ wrappers in their own sources,
// each with the launch bounds that measured fastest for it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_rebin.cuh"
#include "step_tile.cuh"

namespace ppsim {

// Buffers in the rebin ring: rows w-1, w, w+1, w+2 and the one in flight.
constexpr int kRebinRing = 5;

// Where a settled slot's value comes from, along one axis: the own bin, the
// bin before (-1), the bin after (+1), or the fill of an accepted leaver.
constexpr int kOwn = 0, kLo = 1, kHi = 2, kFill = 3;

struct RebinLayout {
  int hb;     // halo bins of a row: the T own bins, 1 before, 2 after
  int ob;     // own bins of a row
  int mask;   // offset of a buffer's masks, uint32[6][hb]: alive, walked-axis
              // -1 / +1 movers, strip-axis -1 / +1 movers, far movers
  int buf;    // bytes of one buffer (planes [nf][cap][hb] at offset 0)
  int xmap;   // offset of the walked pass's source map, uint8[cap][hb]
  int smask;  // offset of the walk-settled strip-axis masks, uint32[3][hb]
  int fmap;   // offset of the final source map, uint16[cap][ob]
  int mon;    // offset of the per-own-bin monitor counters, int[2][ob]
  int bytes;  // dynamic shared memory of the block
};

__host__ __device__ inline RebinLayout rebin_layout(int nf, int cap, int ob) {
  RebinLayout t;
  t.ob = ob;
  t.hb = ob + 3;
  t.mask = align16(nf * cap * t.hb * 4);
  t.buf = t.mask + align16(6 * t.hb * 4);
  t.xmap = kRebinRing * t.buf;
  t.smask = t.xmap + align16(cap * t.hb);
  t.fmap = t.smask + align16(3 * t.hb * 4);
  t.mon = t.fmap + align16(2 * cap * ob);
  t.bytes = t.mon + 2 * ob * 4;
  return t;
}

template <int NF>
struct Planes {
  float* f[NF - 1];
  int* pid;
};

template <int NF>
struct PlanesC {
  const float* f[NF - 1];
  const int* pid;
};

struct RebinGeo {
  int cap;       // slots
  int NY, W, S;  // array extents: y-slabs (2D: 1), walked axis, strip axis
  int ny, nw, ns;  // physical bins along them
  int evac;
  float bsw, bss;  // bin sides along the walked and the strip axis
  float inv[3];    // float32(1 / bin side) of coordinate fields 0..NC-1
  int w0;          // global index of walked row 0 (a 2D shard's row offset)
  int y0;          // global index of y-slab 0 (a 3D shard's slab offset)
};

// A shard's ghost rows (2D): top, row -1 of every plane, [cap][S] each;
// bot, rows W and W+1: [cap][2][S] for the walked coordinate (plane 0) and
// pid, [cap][S] (row W only) for the others. Null pids: no ghosts.
template <int NF>
struct RowGhosts {
  PlanesC<NF> top, bot;
};

// A tile's ghost columns (2D): west, column -1, [cap][W + 3][1]; east,
// columns S and S+1, [cap][W + 3][2]; rows -1..W+1, for the walked
// coordinate (plane 0) and pid; rows -1..W, [cap][W + 2][ncols], for the
// others. Null pids: no ghost column that side. s0g: the global column of
// strip index 0.
template <int NF>
struct ColGhosts {
  PlanesC<NF> west, east;
  int s0g;
};

// Offset, along its axis, of a source code's bin.
__device__ __forceinline__ int src_off(int code) {
  return code == kLo ? -1 : (code == kHi ? 1 : 0);
}

// Recentering of a coordinate that came from the bin at src_off(code):
// x - d*bs for its move d = -src_off, exactly -bs or bs.
__device__ __forceinline__ float recenter(float v, int code, float bs) {
  return code == kLo ? __fsub_rn(v, bs) : (code == kHi ? __fsub_rn(v, -bs) : v);
}

__device__ __forceinline__ Masks mask_at(const uint32_t* m, int hb, int h) {
  Masks r;
  r.alive = m[h];
  r.neg = m[hb + h];
  r.pos = m[2 * hb + h];
  return r;
}

__device__ __forceinline__ void mask_put(uint32_t* m, int hb, int h,
                                         const Masks& v) {
  m[h] = v.alive;
  m[hb + h] = v.neg;
  m[2 * hb + h] = v.pos;
}

__device__ __forceinline__ PassMoves moves_of(const Masks& mm, const Masks& m0,
                                              const Masks& mp, const Masks& m2,
                                              int cap, int evac) {
  return pass_moves(mm, m0, mp, cap - __popc(mm.alive), cap - __popc(m0.alive),
                    cap - __popc(mp.alive), __popc(m2.neg), evac);
}

template <int NF, bool SHARD = false, bool COLS = false>
__device__ __forceinline__ void rebin_tile(const PlanesC<NF> in,
                                           const Planes<NF> out,
                                           int* __restrict__ cnt,
                                           const RebinGeo g, const int T,
                                           const int seg,
                                           const RowGhosts<NF>& gh = {},
                                           const ColGhosts<NF>& gc = {}) {
  constexpr int NC = (NF - 1) / 2;  // coordinate fields
  constexpr int FS = NC - 1;        // the strip axis's coordinate field
  constexpr bool THREE = NF == 7;
  constexpr bool ROWS = SHARD && !THREE;  // ghost rows of the walked axis
  constexpr bool TILE = COLS && ROWS;     // and ghost columns of the strip axis
  extern __shared__ __align__(16) unsigned char smem[];
  const RebinLayout lay = rebin_layout(NF, g.cap, T);
  const int cap = g.cap, HB = lay.hb, tid = threadIdx.x;
  const int64_t plane = (int64_t)g.NY * g.W * g.S;

  // block -> (y-slab, segment, strip), strips fastest
  const int nstrip = (g.S + T - 1) / T;
  const int nseg = (g.W + seg - 1) / seg;
  const int s0 = (blockIdx.x % nstrip) * T;
  const int rest = blockIdx.x / nstrip;
  const int wa = rest % nseg * seg;
  const int wb = min(g.W, wa + seg);
  const int yi = rest / nseg;
  const int64_t ybase = (int64_t)yi * g.W * g.S;

  auto buf = [&](int w) { return smem + (w - wa + 1) % kRebinRing * lay.buf; };
  auto plane_of = [&](unsigned char* b, int k) {
    return reinterpret_cast<float*>(b) + k * cap * HB;
  };
  auto pid_of = [&](unsigned char* b) {
    return reinterpret_cast<int*>(b) + (NF - 1) * cap * HB;
  };
  auto masks = [&](unsigned char* b) {
    return reinterpret_cast<uint32_t*>(b + lay.mask);
  };
  uint8_t* xmap = smem + lay.xmap;
  uint32_t* smask = reinterpret_cast<uint32_t*>(smem + lay.smask);
  uint16_t* fmap = reinterpret_cast<uint16_t*>(smem + lay.fmap);
  int* mon = reinterpret_cast<int*>(smem + lay.mon);

  // This thread's halo bin for copies and masks: h = tid % HB, the copies of
  // a bin's cap slots split over `parts` threads.
  const int parts = blockDim.x / HB;
  const int h = tid % HB, part = tid / HB;
  const int gs = s0 - 1 + h;
  const bool in_array = gs >= 0 && gs < g.S;
  // a tile's ghost column -1, S or S+1, where given
  const bool west = TILE && gs == -1 && gc.west.pid;
  const bool east = TILE && (gs == g.S || gs == g.S + 1) && gc.east.pid;
  const bool colg = west || east;
  // the strip axis's global index of this halo bin
  const int gsg = (TILE ? gc.s0g : 0) + gs;

  // rows held: the array's own, and the ghost rows -1, W and W+1 if given
  auto held = [&](int w) {
    return (w >= 0 && w < g.W) ||
           (ROWS && ((w == -1 && gh.top.pid) ||
                      ((w == g.W || w == g.W + 1) && gh.bot.pid)));
  };
  // the walked axis's global index of local row w
  auto gw = [&](int w) { return (ROWS ? g.w0 : 0) + w; };
  auto issue = [&](int w) {
    if (!held(w) || part >= parts || !(in_array || colg)) return;
    unsigned char* b = buf(w);
    if (TILE && colg) {
      // a ghost column; as for the ghost rows, row W+1 carries the walked
      // coordinate and pid only (pointers picked one by one)
      const int nc = west ? 1 : 2, j = west ? 0 : gs - g.S;
      for (int s = part; s < cap; s += parts) {
        const int64_t i3 = ((int64_t)s * (g.W + 3) + w + 1) * nc + j;
        const int64_t i2 = ((int64_t)s * (g.W + 2) + w + 1) * nc + j;
        cp_async4(plane_of(b, 0) + s * HB + h, (west ? gc.west.f[0] : gc.east.f[0]) + i3);
#pragma unroll
        for (int k = 1; k < NF - 1; ++k) {
          if (w <= g.W)
            cp_async4(plane_of(b, k) + s * HB + h, (west ? gc.west.f[k] : gc.east.f[k]) + i2);
          else
            plane_of(b, k)[s * HB + h] = 0.0f;
        }
        cp_async4(pid_of(b) + s * HB + h, (west ? gc.west.pid : gc.east.pid) + i3);
      }
      return;
    }
    if (!ROWS || (w >= 0 && w < g.W)) {
      const int64_t gb = ybase + (int64_t)w * g.S + gs;
      for (int s = part; s < cap; s += parts) {
        const int64_t i = s * plane + gb;
#pragma unroll
        for (int k = 0; k < NF - 1; ++k)
          cp_async4(plane_of(b, k) + s * HB + h, in.f[k] + i);
        cp_async4(pid_of(b) + s * HB + h, in.pid + i);
      }
      return;
    }
    // a ghost row; row W+1 carries no plane but the walked coordinate and
    // pid, and its other planes read 0 (only its -1 movers are counted)
    // (pointers picked one by one: a struct picked by reference would be
    // copied to local memory)
    const bool top = w < 0;
    const int j = top ? 0 : w - g.W;
    for (int s = part; s < cap; s += parts) {
      const int64_t i1 = (int64_t)s * g.S + gs;
      const int64_t i2 = ((int64_t)s * (top ? 1 : 2) + j) * g.S + gs;
      cp_async4(plane_of(b, 0) + s * HB + h, (top ? gh.top.f[0] : gh.bot.f[0]) + i2);
#pragma unroll
      for (int k = 1; k < NF - 1; ++k) {
        if (j == 0)
          cp_async4(plane_of(b, k) + s * HB + h, (top ? gh.top.f[k] : gh.bot.f[k]) + i1);
        else
          plane_of(b, k)[s * HB + h] = 0.0f;
      }
      cp_async4(pid_of(b) + s * HB + h, (top ? gh.top.pid : gh.bot.pid) + i2);
    }
  };
  // the masks of a row that has arrived (threads tid < HB)
  auto take_masks = [&](int w) {
    unsigned char* b = buf(w);
    Masks mw, ms;
    uint32_t far = 0;
    if (held(w) && (in_array || colg)) {
      const int* pid = pid_of(b);
#pragma unroll 4
      for (int s = 0; s < cap; ++s) {
        const int j = s * HB + h;
        float c[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) c[k] = plane_of(b, k)[j];
        if (pid[j] < 0) continue;
        int raw[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) raw[k] = raw_dir(c[k], g.inv[k]);
        const uint32_t bit = 1u << s;
        mw.alive |= bit;
        const int dw = clamp_dir(raw[0], gw(w), g.nw);
        const int ds = clamp_dir(raw[FS], gsg, g.ns);
        if (dw < 0) mw.neg |= bit;
        if (dw > 0) mw.pos |= bit;
        if (ds < 0) ms.neg |= bit;
        if (ds > 0) ms.pos |= bit;
        bool f = false;
#pragma unroll
        for (int k = 0; k < NC; ++k) f |= abs(raw[k]) > 1;
        far += f ? 1u : 0u;
      }
    }
    uint32_t* m = masks(b);
    mask_put(m, HB, h, mw);
    m[3 * HB + h] = ms.neg;
    m[4 * HB + h] = ms.pos;
    m[5 * HB + h] = far;
  };

  for (int w = wa - 1; w <= wa + 2; ++w) issue(w);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (tid < HB)
    for (int w = wa - 1; w <= wa + 2; ++w) take_masks(w);
  __syncthreads();

  const uint32_t cmask = cap_mask(cap);
  for (int w = wa; w < wb; ++w) {
    // row w+3 streams in while row w settles
    if (w + 1 < wb) issue(w + 3);
    cp_async_commit();

    // B: the walked pass at every halo bin, and the settled bin's masks
    // along the strip axis
    if (tid < HB) {
      Masks sm;
      if (in_array || colg) {
        const uint32_t* M0 = masks(buf(w));
        const Masks m0 = mask_at(M0, HB, h);
        const PassMoves pm = moves_of(mask_at(masks(buf(w - 1)), HB, h), m0,
                                      mask_at(masks(buf(w + 1)), HB, h),
                                      mask_at(masks(buf(w + 2)), HB, h), cap,
                                      g.evac);
        for (int s = 0; s < cap; ++s)
          xmap[s * HB + h] = (uint8_t)(((pm.leave >> s & 1u) ? kFill : kOwn) << 5 | s);
        const uint32_t stay = m0.alive & ~pm.leave;
        sm.alive = stay;
        sm.neg = M0[3 * HB + h] & stay;
        sm.pos = M0[4 * HB + h] & stay;
        // an entrant from row w+1 (src kHi) or w-1 (kLo) keeps its strip
        // direction: its bits come from its source row's masks
        auto enter = [&](int src) {
          const uint32_t* Ms = masks(buf(w + src_off(src)));
          const uint32_t sn = Ms[3 * HB + h], sp = Ms[4 * HB + h];
          return [&, src, sn, sp](int to, int from) {
            xmap[to * HB + h] = (uint8_t)(src << 5 | from);
            sm.alive |= 1u << to;
            sm.neg |= (sn >> from & 1u) << to;
            sm.pos |= (sp >> from & 1u) << to;
          };
        };
        const uint32_t empty = ~m0.alive & cmask;
        stream(pm.in_hi, empty, enter(kHi));
        stream(pm.in_lo, empty & ~first_bits(empty, pm.off_lo), enter(kLo));
      }
      mask_put(smask, HB, h, sm);
    }
    __syncthreads();

    // C: the strip pass at every own bin into the final map, and the count
    // planes that need no values
    const int64_t row = ybase + (int64_t)w * g.S;
    if (tid < T && s0 + tid < g.S) {
      const int o = tid, ho = tid + 1;
      const Masks m0 = mask_at(smask, HB, ho);
      const PassMoves pm = moves_of(mask_at(smask, HB, ho - 1), m0,
                                    mask_at(smask, HB, ho + 1),
                                    mask_at(smask, HB, ho + 2), cap, g.evac);
#pragma unroll 4
      for (int s = 0; s < cap; ++s)
        fmap[s * T + o] = (pm.leave >> s & 1u) ? (uint16_t)(kFill << 5)
                                               : (uint16_t)xmap[s * HB + ho];
      const uint32_t empty = ~m0.alive & cmask;
      auto put_hi = [&](int to, int from) {
        fmap[to * T + o] = (uint16_t)(xmap[from * HB + ho + 1] | kHi << 7);
      };
      auto put_lo = [&](int to, int from) {
        fmap[to * T + o] = (uint16_t)(xmap[from * HB + ho - 1] | kLo << 7);
      };
      stream(pm.in_hi, empty, put_hi);
      stream(pm.in_lo, empty & ~first_bits(empty, pm.off_lo), put_lo);
      // pre-rebin monitors from the input row's masks
      const uint32_t* M0 = masks(buf(w));
      const int alive = __popc(M0[ho]), far = (int)M0[5 * HB + ho];
      const int post = __popc(m0.alive & ~pm.leave) + __popc(pm.in_hi) +
                       __popc(pm.in_lo);
      const int64_t i = row + s0 + o;
      if constexpr (THREE) {
        cnt[1 * plane + i] = post;
        cnt[3 * plane + i] = far;
        cnt[4 * plane + i] = alive;
      } else {
        cnt[0 * plane + i] = far;
        cnt[1 * plane + i] = alive;
        cnt[2 * plane + i] = post;
      }
      mon[o] = 0;
      mon[T + o] = 0;
    }
    __syncthreads();

    // D: the output planes, one thread per (slot, own bin), bins fastest
    for (int e = tid; e < cap * T; e += blockDim.x) {
      const int s = e / T, o = e - s * T;
      if (s0 + o >= g.S) continue;
      const int64_t i = s * plane + row + s0 + o;
      const int code = fmap[s * T + o];
      const int ws = code >> 5 & 3, cs = code >> 7;
      if (ws == kFill) {
#pragma unroll
        for (int k = 0; k < NF - 1; ++k) out.f[k][i] = k < NC ? kSlabBig : 0.0f;
        out.pid[i] = -1;
        continue;
      }
      unsigned char* b = buf(w + src_off(ws));
      const int j = (code & 31) * HB + o + 1 + src_off(cs);
      float v[NF - 1];
#pragma unroll
      for (int k = 0; k < NF - 1; ++k) {
        v[k] = plane_of(b, k)[j];
        if (k == 0) v[k] = recenter(v[k], ws, g.bsw);
        if (k == FS) v[k] = recenter(v[k], cs, g.bss);
        out.f[k][i] = v[k];
      }
      const int pid = pid_of(b)[j];
      out.pid[i] = pid;
      if (pid < 0) continue;
      if constexpr (THREE) {
        const int dy = dir1(v[1], (SHARD ? g.y0 : 0) + yi, g.ny, g.inv[1]);
        if (dy < 0) atomicAdd(&mon[o], 1);
        if (dy > 0) atomicAdd(&mon[T + o], 1);
      } else {
        if (dir1(v[0], gw(w), g.nw, g.inv[0]) != 0 ||
            dir1(v[FS], (TILE ? gc.s0g : 0) + s0 + o, g.ns, g.inv[FS]) != 0)
          atomicAdd(&mon[o], 1);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (tid < HB && w + 1 < wb) take_masks(w + 3);
    if (tid < T && s0 + tid < g.S) {
      const int64_t i = row + s0 + tid;
      if constexpr (THREE) {
        cnt[0 * plane + i] = mon[tid];
        cnt[2 * plane + i] = mon[T + tid];
      } else {
        cnt[3 * plane + i] = mon[tid];
      }
    }
    __syncthreads();
  }
}

// The plan's shape checks: the launch must be the one the Python plan gives
// (tile T, segment, threads, blocks, shared bytes) for this geometry.
inline bool rebin_plan_ok(int nf, const RebinGeo& g, int T, int seg,
                          int threads, int blocks, int smem) {
  if (g.cap < 1 || g.cap > 32 || T < 1 || seg < 1) return false;
  const int64_t nblocks =
      (int64_t)((g.S + T - 1) / T) * ((g.W + seg - 1) / seg) * g.NY;
  return threads % 32 == 0 && threads <= kTileThreads && T + 3 <= threads &&
         blocks == nblocks && smem == rebin_layout(nf, g.cap, T).bytes;
}

// Launches `kernel` (a wrapper of rebin_tile<NF>) on a plan that
// rebin_plan_ok accepted; returns cudaGetLastError().
template <int NF>
int launch_rebin_tile(void (*kernel)(PlanesC<NF>, Planes<NF>, int*, RebinGeo,
                                     int, int),
                      const PlanesC<NF>& in, const Planes<NF>& out, int* cnt,
                      const RebinGeo& g, int T, int seg, int threads,
                      int blocks, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem, s>>>(in, out, cnt, g, T, seg);
  return (int)cudaGetLastError();
}

}  // namespace ppsim
