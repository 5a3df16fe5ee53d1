// K3: fused 3D slab-grid step for Hopper (sm_90a) — 27-bin stencil force,
// Verlet move, 3-axis wall fold and the per-bin max|v|^2 plane in one pass.
//
// Replaces: ppsim_tpu/ops/pallas_grid3d.py:_step3_kernel and
// _step3_kernel_nospeed (through grid3_step_pallas; with y0 and ghosts, its
// shard form, pallas_grid3d.py:275-322). Plain twin:
// ppsim_tpu_torch/ops/cuda_grid3.py grid3_step_plain (grid3_force_xla with
// the kernels' pair arithmetic + move3_planes).
//
// Layout. Fields are (cap, Y, X, Z) float32 planes, z fastest; bin
// b = (y*X + x)*Z + z, slot s at s*plane + b. Dead slots hold exactly BIG.
//
// Bound. Memory: 6 planes read and 6 written once plus the speed plane,
// 12 x cap x plane x 4 B (3.4 GB at the 20.97M stretch geometry, ~1 ms at
// 3.35 TB/s). Operations: each live particle must meet every live slot of
// its 27 neighbour bins, ~2.2G ordered candidate pairs per step there, of
// which under 1% lie inside the cutoff (the bins are 2-4 cutoffs wide). So
// the kernel is bound by instruction issue, not by the bytes: the distance
// tests, most of which fail, with their addressing and the warp divergence
// over the neighbour bins' counts, and the pair coefficients of the few
// that pass (the LJ law's three IEEE divisions). Tensor cores have no part:
// each test is an elementwise float32 distance held to the plain twin's
// rounding.
//
// Design. One block owns an (x, z) tile of tx x tz bins over a segment of
// y-slabs and walks it in y. It keeps a ring of four slab buffers in shared
// memory, each the tile plus a one-bin halo in x and z: slabs y-1, y, y+1
// for the slab it computes, and slab y+2, whose copies (cp.async, 4 bytes a
// slot) are in flight meanwhile. When a slab arrives, each bin's live slots
// are compacted in place, ascending, with a count and the bounds of the live
// coordinates per bin, so empty slots, holes left by rebins and empty bins
// cost nothing. Neighbour bins outside the physical grid (x >= xs, z >= zs,
// y off the array) count as empty, as the twin masks them; a block never
// relies on the contents of a bin it did not copy.
//
// Most candidate tests fail, so the kernel cuts them without changing a
// sum: per own bin it records which neighbour bins hold live slots and, for
// each of its six faces, the nearest live coordinate beyond it; a particle
// drops the neighbour bins beyond a face whose gap exceeds the cutoff. The
// gap is computed with the pair loop's own rounded ops and rounding is
// monotone, so every dropped pair would have failed r2 <= c2 and added an
// exact zero; the kept pairs are summed in the same order as before.
//
// Thread mapping: one thread per live own particle of the slab (a block-wide
// prefix sum lists them), so work follows the particles, not the slots.
// Each thread walks the compacted lists of its kept neighbour bins in shared
// memory (threads of one bin read the same addresses, which broadcast).
// Owner-computes and two-sided: each particle sums its own force in the
// twin's order (DIRS3: dy, dx, dz ascending; neighbour slots ascending),
// with every product and sum rounded as the twin's (no FMA contraction), so
// no atomics touch the sums and the kernel is deterministic. The bin's max
// |v|^2 is an atomicMax of the float bits in shared memory (order-free).
// Dead own slots get their outputs (BIG, 0) when their slab is compacted.
// One thread per own bin with its slots in registers, reading the same
// shared-memory tiles, lost 2-15x to this mapping on the card (divergence
// over the bins' counts), and the one-thread-per-bin kernel reading global
// memory that this design replaces lost 3.7-5.2x (PERF.md). The tile, the segment
// length, the block size and the shared-memory bytes come from the Python
// plan (cuda_grid3.step3_plan), which this entry point checks.
//
// Flat walk. A warp runs a test as long as one of its lanes has one left.
// Nested loops over the kept bins and their slots ran, for each kept bin,
// the slots of the lane with the most there, summed over the bins. Here
// each particle's tests are one flat run: a cursor (the kept bin's
// direction bit, its first slot's address, the slot and the bin's count)
// steps to the next kept bin when the bin's slots run out, through a table
// of the 27 directions built once a slab (each direction's coordinate
// offsets and the byte offsets of its bin's slots and count), so a step
// costs two shared loads and no division; and a pass tests kSlots = 2 slots
// of the bin at once, their loads and arithmetic independent, so a lane's
// run of tests takes about half the passes, each little longer. A slot past
// the bin's count is computed and dropped.
// Ordering the list by each particle's count of tests (a counting sort
// before the walk, so that a warp's lanes hold about as many tests each)
// raised the share of busy lanes in a test pass from 30% to 84% on the
// final lj3d_20m slab, and cut its test passes 2.85x, but took 0.40-0.63
// ms a call in its count pass and two more barriers against 0.26 ms saved
// in the walk (PERF.md): a block-slab waits for its slowest warp, which
// holds the heaviest particle whatever the order, and sorted lanes lose
// the broadcasts of lanes that share an own bin.
//
// Deferred pairs. The walk over the kept bins only tests r2 <= c2: a pair
// that passes is queued as its (direction, compacted slot), 10 bits in a
// 64-bit register, up to kQueue of them. When the walk ends, or stops at a
// queue without room for a pass's hits (to resume after), the thread drains
// the queue oldest first: it recomputes each pair's offsets and r2 with the
// walk's rounded ops (the same bits), evaluates the coefficient and adds the
// force. Each particle adds the same terms in the same order, so the outputs
// are bitwise those of evaluating each hit where the walk meets it. The
// coefficient is a branch that a warp runs whenever one of its lanes needs
// it: evaluated in place, a warp ran it at most kept bins that held a lane's
// own particle (each particle meets itself) or a neighbour in range, with
// one or two lanes busy; drained, it runs as many times as the lane with the
// most hits has pairs. Given four counters, the kernel counts the pairs
// inside the cutoff (self pairs included), the warp passes of the
// coefficient, the distance tests and the warp passes of the test (kSlots a
// pass of the walk): a register each per thread, an atomic add each per warp
// at the end. It counts in an instance of its own (COUNT), since counting
// costs time; a call without counters launches the one that does not
// count.
//
// Shards (the sharded engine, ops/cuda_grid3.py). A shard's planes are y
// slabs y0 .. y0 + Y - 1 of the global slab; y0 enters the wall fold, and
// the neighbouring shards' boundary slabs arrive as ghost planes (cap, 1,
// X, Z) of x, y and z: the ring takes slab -1 and slab Y from them instead
// of treating them as empty, and compacts them as it compacts its own
// slabs. The TPU kernel evaluates the top ghost slab's pairs self-side only
// because of its Newton-3 slab spill (pallas_grid3d.py:178-202); here every
// particle sums its own force, so a ghost slab is only read, like any
// neighbour slab, and a shard's sums equal the single-device kernel's. The
// shard inputs are a template parameter (SHARD): the single-device call
// launches the instance without them, which compiles to the kernel as it
// was before them.
//
// Numerics. Constants arrive as the float32 values the plain twin rounds.
// The repulsive coefficient's rsqrtf may differ from torch.rsqrt by an ulp,
// so parity with the plain twin is allclose (rtol 1e-5, atol 1e-6); everything
// else, the move tail included, repeats the twin's rounding step for step.

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

// Direction bits (d = (dy+1)*9 + (dx+1)*3 + dz+1) with dx = -1, dy = -1,
// dz = -1; shifted by 6, 18 and 2 they are the +1 sides.
constexpr uint32_t kDXM = 0x1C0E07u;
constexpr uint32_t kDYM = 0x1FFu;
constexpr uint32_t kDZM = 0x1249249u;

// Hits a thread queues before it drains them: 10 bits each (direction << 5
// | compacted slot) in a 64-bit register. A particle of the stretch config's
// late gas has ~1.6 (itself and a Poisson(0.6) count of neighbours).
constexpr int kQueue = 6;

// Slots of one neighbour bin a lane tests in a pass of its walk (bins hold
// ~3.9 live slots in the stretch config's gas). Two beat three and four on
// the card: within the 80 registers of 3 blocks an SM, more slots spilled.
constexpr int kSlots = 2;

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

struct Tile3 {
  int tx, tz, seg;  // own bins in x and z; y-slabs a block walks
};

// A shard's ghost slabs: x, y and z of slab -1 (top) and of slab Y
// (bottom), each [cap][X][Z]; null pointers where the slab is empty.
struct Ghost3 {
  const float *tx, *ty, *tz, *bx, *by, *bz;
  int y0;  // global index of the planes' slab 0
};

__device__ __forceinline__ float r2_of(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Count one drain's warp passes of the coefficient: the most pairs that a
// lane among those draining together holds, added by the lowest of them.
__device__ __forceinline__ void note_passes(unsigned& passes, int nq) {
  const unsigned act = __activemask();
  const unsigned most = __reduce_max_sync(act, (unsigned)nq);
  if ((int)(threadIdx.x & 31) == __ffs(act) - 1) passes += most;
}

// Count a pass of the walk: this lane's distance tests in it, and the
// kSlots test slots of each lane that the warp runs (added by the lowest
// lane running the pass).
__device__ __forceinline__ void note_tests(unsigned& tests, unsigned& passes,
                                           int k) {
  tests += k;
  if ((int)(threadIdx.x & 31) == __ffs(__activemask()) - 1) passes += kSlots;
}

// Blocks an SM an instance is built for (__launch_bounds__). The ring's
// shared memory leaves room for 3 blocks an SM up to capacity 11 at the
// 4 x 16 tile (the 3D repulsive config) and for 2 above it (the stretch
// config's 13), so the instances that step are held to the 80 registers
// that 3 blocks allow; both laws' bodies fit in them without spilling. The
// counting instances, launched only to measure, are held to 2: with its
// counters the repulsive body would spill at 80. ptxas -v (sm_90a, CUDA
// 12.8): stepping instances LJ 79, LJ shard 80, repulsive 80 and 80
// registers, no spill; counting instances 94 (LJ) and 105 (repulsive).
constexpr int min_blocks(bool count) { return count ? 2 : 3; }

// SHARD: K3 with a y offset and ghost slabs. COUNT: K3 adding its pairs
// inside the cutoff, its warp passes of the coefficient, its distance tests
// and its warp passes of the test to counts.
template <Law LAW, bool SHARD, bool COUNT>
__global__ void __launch_bounds__(ppsim::kTileThreads, min_blocks(COUNT))
grid3_step_kernel(Fields in, Outs out, float* __restrict__ sp,
                  unsigned long long* __restrict__ counts, Geo3 g, Tile3 t,
                  Ghost3 gh, PairParams pp, float dt, float L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HX = t.tx + 2, HZ = t.tz + 2, HB = HX * HZ, OB = t.tx * t.tz;
  const TileLayout lay = ppsim::tile_layout(3, g.cap, HB, OB);
  const int cap = g.cap;
  const int tid = threadIdx.x;
  const int64_t plane = (int64_t)g.Y * g.X * g.Z;

  // block -> (segment, x tile, z tile), z tiles fastest
  const int ntz = (g.Z + t.tz - 1) / t.tz, ntx = (g.X + t.tx - 1) / t.tx;
  const int iz = blockIdx.x % ntz;
  const int ix = (blockIdx.x / ntz) % ntx;
  const int ya = blockIdx.x / (ntz * ntx) * t.seg;
  const int yb = min(g.Y, ya + t.seg);
  const int x0 = ix * t.tx, z0 = iz * t.tz;

  auto buf = [&](int yy) { return smem + ((yy - ya + 1) & 3) * lay.buf; };
  uint16_t* plist = reinterpret_cast<uint16_t*>(smem + lay.plist);
  unsigned* spmax = reinterpret_cast<unsigned*>(smem + lay.spmax);
  uint32_t* omask = reinterpret_cast<uint32_t*>(smem + lay.omask);
  float* face = reinterpret_cast<float*>(smem + lay.face);
  int* wsum = reinterpret_cast<int*>(smem + lay.wsum);
  float4* dofs = reinterpret_cast<float4*>(smem + lay.dofs);
  int* dcnt = reinterpret_cast<int*>(smem + lay.dcnt);

  // This thread's halo bin for copies and compaction: h = tid % HB, and
  // the copies of a bin's cap slots split over `parts` threads.
  const int parts = blockDim.x / HB;
  const int h = tid % HB, part = tid / HB;
  const int hx = h / HZ, hz = h - hx * HZ;
  const int gx = x0 - 1 + hx, gz = z0 - 1 + hz;
  const bool interior = hx >= 1 && hx <= t.tx && hz >= 1 && hz <= t.tz;
  const int o = (hx - 1) * t.tz + (hz - 1);  // own bin index if interior
  const bool in_array = gx >= 0 && gx < g.X && gz >= 0 && gz < g.Z;
  const bool phys = gx >= 0 && gx < g.xs && gz >= 0 && gz < g.zs;
  // a bin is copied if it can be a neighbour, or is an own bin
  const bool wanted = in_array && (phys || interior);

  // slabs held: the planes' own, and the ghost slabs -1 and Y where given
  auto held = [&](int yy) {
    return (yy >= 0 && yy < g.Y) ||
           (SHARD && ((yy == -1 && gh.tx) || (yy == g.Y && gh.bx)));
  };
  const float* fin[3] = {in.x, in.y, in.z};
  auto issue = [&](int yy) {
    if (!held(yy) || part >= parts || !wanted) return;
    float* c = reinterpret_cast<float*>(buf(yy));
    if (!SHARD || (yy >= 0 && yy < g.Y)) {
      const int64_t gb = ((int64_t)yy * g.X + gx) * g.Z + gz;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        for (int s = part; s < cap; s += parts)
          ppsim::cp_async4(c + (q * cap + s) * HB + h, fin[q] + s * plane + gb);
      return;
    }
    // a ghost slab, slot stride X * Z (pointers picked one by one: a struct
    // picked by reference would be copied to local memory)
    const bool top = yy < 0;
    const int64_t xz = (int64_t)g.X * g.Z, gb = (int64_t)gx * g.Z + gz;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* src = q == 0 ? (top ? gh.tx : gh.bx)
                                : (q == 1 ? (top ? gh.ty : gh.by)
                                          : (top ? gh.tz : gh.bz));
      for (int s = part; s < cap; s += parts)
        ppsim::cp_async4(c + (q * cap + s) * HB + h, src + s * xz + gb);
    }
  };
  auto compact = [&](int yy) {
    if (tid >= HB) return;
    unsigned char* b = buf(yy);
    const bool loaded = held(yy) && wanted;
    int k = 0;
    uint32_t dead = 0;
    if (loaded)
      k = ppsim::compact_bin<3>(reinterpret_cast<float*>(b),
                                reinterpret_cast<float*>(b + lay.bnd), cap,
                                HB, h, interior ? b + lay.slot : nullptr, OB,
                                o, &dead);
    b[lay.ncnt + h] = (uint8_t)(loaded && phys ? k : 0);
    if (interior) b[lay.ocnt + o] = (uint8_t)k;
    if (interior && loaded && yy >= ya && yy < yb) {
      const int64_t gb = ((int64_t)yy * g.X + gx) * g.Z + gz;
      for (int s = 0; s < cap; ++s) {
        if (dead >> s & 1u) {
          const int64_t i = s * plane + gb;
          out.x[i] = kBig;
          out.y[i] = kBig;
          out.z[i] = kBig;
          out.vx[i] = 0.0f;
          out.vy[i] = 0.0f;
          out.vz[i] = 0.0f;
        }
      }
    }
  };

  issue(ya - 1);
  issue(ya);
  issue(ya + 1);
  ppsim::cp_async_commit();
  ppsim::cp_async_wait_all();
  __syncthreads();
  compact(ya - 1);
  compact(ya);
  compact(ya + 1);
  __syncthreads();

  const float twoL = 2.0f * L;
  const float cutm = pp.cutoff * 1.000001f;
  // COUNT: this thread's pairs in range, coefficient passes, distance tests
  // and test passes
  unsigned hits = 0, passes = 0, tests = 0, tpasses = 0;
  for (int y = ya; y < yb; ++y) {
    // slab y+2 streams in while slab y computes
    if (y + 1 < yb) issue(y + 2);
    ppsim::cp_async_commit();

    // the live own particles of slab y, one list entry each
    const unsigned char* cur = buf(y);
    const int v = tid < OB ? cur[lay.ocnt + tid] : 0;
    int total;
    const int first = ppsim::block_exclusive_scan(v, wsum, &total);
    for (int k = 0; k < v; ++k) plist[first + k] = (uint16_t)(tid << 5 | k);
    if (tid < OB) {
      spmax[tid] = 0u;
      // The bin's non-empty neighbours (bit d, DIRS3 order) and, per face,
      // the nearest live coordinate beyond it: the largest x of the dx=-1
      // bins, the smallest x of the dx=+1 bins, and so on.
      const int ox = tid / t.tz, h0 = (ox + 1) * HZ + tid - ox * t.tz + 1;
      uint32_t m = 0;
      float f[6] = {-kBig, kBig, -kBig, kBig, -kBig, kBig};
#pragma unroll
      for (int d = 0; d < 27; ++d) {
        const int dy = d / 9 - 1, dx = d / 3 % 3 - 1, dz = d % 3 - 1;
        const unsigned char* nb = buf(y + dy);
        const int hn = h0 + dx * HZ + dz;
        if (nb[lay.ncnt + hn] == 0) continue;
        m |= 1u << d;
        const float* bn = reinterpret_cast<const float*>(nb + lay.bnd);
        if (dx) f[dx < 0 ? 0 : 1] = dx < 0 ? fmaxf(f[0], bn[1 * HB + hn])
                                           : fminf(f[1], bn[0 * HB + hn]);
        if (dy) f[dy < 0 ? 2 : 3] = dy < 0 ? fmaxf(f[2], bn[3 * HB + hn])
                                           : fminf(f[3], bn[2 * HB + hn]);
        if (dz) f[dz < 0 ? 4 : 5] = dz < 0 ? fmaxf(f[4], bn[5 * HB + hn])
                                           : fminf(f[5], bn[4 * HB + hn]);
      }
      omask[tid] = m;
#pragma unroll
      for (int q = 0; q < 6; ++q) face[q * OB + tid] = f[q];
    }
    // The slab's direction table: for neighbour direction d, the offsets
    // of the walk's coordinates (dx * bsx, dy * bsy, dz * bsz: exactly
    // -bs, 0 or bs) and the byte offsets, from an own bin's halo index h0,
    // of the neighbour's first x (from smem + 4 * h0) and of its count
    // (from smem + h0), in the buffer of slab y + dy.
    if (tid < 27) {
      const int dy = tid / 9 - 1, dx = tid / 3 % 3 - 1, dz = tid % 3 - 1;
      const int b = (int)(buf(y + dy) - smem), cell = dx * HZ + dz;
      dofs[tid] = make_float4((float)dx * g.bsx, (float)dy * g.bsy,
                              (float)dz * g.bsz, __int_as_float(b + 4 * cell));
      dcnt[tid] = b + lay.ncnt + cell;
    }
    __syncthreads();
    const float* c0 = reinterpret_cast<const float*>(cur);
    const int capHB = cap * HB;

    const float yo = __fmul_rn((float)((SHARD ? gh.y0 : 0) + y), g.bsy);
    for (int p = tid; p < total; p += blockDim.x) {
      const int e = plist[p];
      const int ob = e >> 5, k = e & 31;
      const int ox = ob / t.tz, oz = ob - ox * t.tz;
      const int h0 = (ox + 1) * HZ + oz + 1;
      const float sx = c0[k * HB + h0];
      const float sy = c0[(cap + k) * HB + h0];
      const float sz = c0[(2 * cap + k) * HB + h0];
      float ax = 0.0f, ay = 0.0f, az = 0.0f;
      // Cut the neighbour bins beyond a face whose nearest live coordinate
      // lies more than a cutoff away: the gap is computed with the pair
      // loop's own rounded ops (neighbour + offset, minus own), rounding is
      // monotone, so every pair there would fail r2 <= c2 (cutm carries a
      // 1e-6 margin over the cutoff). Cut pairs would add exact zeros.
      uint32_t m = omask[ob];
      const float* fc = face + ob;
      if (__fsub_rn(__fadd_rn(fc[0], -g.bsx), sx) < -cutm) m &= ~kDXM;
      if (__fsub_rn(__fadd_rn(fc[OB], g.bsx), sx) > cutm) m &= ~(kDXM << 6);
      if (__fsub_rn(__fadd_rn(fc[2 * OB], -g.bsy), sy) < -cutm) m &= ~kDYM;
      if (__fsub_rn(__fadd_rn(fc[3 * OB], g.bsy), sy) > cutm)
        m &= ~(kDYM << 18);
      if (__fsub_rn(__fadd_rn(fc[4 * OB], -g.bsz), sz) < -cutm) m &= ~kDZM;
      if (__fsub_rn(__fadd_rn(fc[5 * OB], g.bsz), sz) > cutm)
        m &= ~(kDZM << 2);
      // One flat run of tests over the remaining bins in DIRS3 order (dy,
      // dx, dz ascending), each bin's slots ascending, kSlots slots a pass:
      // a cursor (bin bit d, its first x px, slot j of its n) steps to the
      // next kept bin when the slots run out; a pass reads the bin's
      // offsets from the table again rather than hold them in registers.
      // Hits are queued (newest in the low bits); a queue without room for
      // a pass's hits stops the walk at the cursor, the drain empties it
      // oldest first and the walk resumes there, so the pairs drain in the
      // order met.
      const unsigned char* cb = smem + 4 * h0;
      const unsigned char* nbs = smem + h0;
      const float* px = c0;
      int d = 0, j = 0, n = 0;
      bool more = true;
      while (more) {
        uint64_t q = 0;
        int nq = 0;
        for (;;) {
          if (j == n) {  // every kept bin holds a live slot
            if (!m) {
              more = false;
              break;
            }
            d = __ffs(m) - 1;
            m &= m - 1;
            const float4 o = dofs[d];
            px = reinterpret_cast<const float*>(cb + __float_as_int(o.w));
            n = nbs[dcnt[d]];
            j = 0;
          }
          // slots j .. j + kSlots - 1, those past the bin's count computed
          // and dropped (their loads stay inside the buffer: its bounds
          // follow the coordinates)
          const float* pj = px + j * HB;
          const float4 od = dofs[d];
          const float offx = od.x, offy = od.y, offz = od.z;
          const int left = min(n - j, kSlots);
          float r2[kSlots];
#pragma unroll
          for (int u = 0; u < kSlots; ++u)
            r2[u] = r2_of(__fsub_rn(__fadd_rn(pj[u * HB], offx), sx),
                          __fsub_rn(__fadd_rn(pj[capHB + u * HB], offy), sy),
                          __fsub_rn(__fadd_rn(pj[2 * capHB + u * HB], offz),
                                    sz));
          if constexpr (COUNT) note_tests(tests, tpasses, left);
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            if (u < left && r2[u] <= pp.c2) {
              q = q << 10 | (uint64_t)(d << 5 | (j + u));
              ++nq;
            }
          }
          j += left;
          if (nq > kQueue - kSlots) break;
        }
        // the drain: each queued pair's offsets and r2 recomputed with the
        // walk's own rounded ops, then its coefficient and force
        if constexpr (COUNT) note_passes(passes, nq);
        for (int e = nq - 1; e >= 0; --e) {
          const int r = (int)(q >> (10 * e)) & 1023;
          const float4 o = dofs[r >> 5];
          const float* pj = reinterpret_cast<const float*>(
                                cb + __float_as_int(o.w)) + (r & 31) * HB;
          const float ddx = __fsub_rn(__fadd_rn(pj[0], o.x), sx);
          const float ddy = __fsub_rn(__fadd_rn(pj[capHB], o.y), sy);
          const float ddz = __fsub_rn(__fadd_rn(pj[2 * capHB], o.z), sz);
          const float coef = ppsim::pair_coef<LAW>(r2_of(ddx, ddy, ddz), pp);
          ax = __fadd_rn(ax, __fmul_rn(coef, ddx));
          ay = __fadd_rn(ay, __fmul_rn(coef, ddy));
          az = __fadd_rn(az, __fmul_rn(coef, ddz));
        }
        if constexpr (COUNT) hits += nq;
      }
      // Verlet + wall fold (grid3d_ops.move3_planes) of a live slot, whose
      // index is taken here so that no register holds it through the walk
      const int s = cur[lay.slot + k * OB + ob];
      const int64_t i =
          s * plane + ((int64_t)y * g.X + x0 + ox) * g.Z + z0 + oz;
      float vx = __fadd_rn(in.vx[i], __fmul_rn(ax, dt));
      float vy = __fadd_rn(in.vy[i], __fmul_rn(ay, dt));
      float vz = __fadd_rn(in.vz[i], __fmul_rn(az, dt));
      float x = __fadd_rn(sx, __fmul_rn(vx, dt));
      float yv = __fadd_rn(sy, __fmul_rn(vy, dt));
      float z = __fadd_rn(sz, __fmul_rn(vz, dt));
      wall_fold(x, vx, __fmul_rn((float)(x0 + ox), g.bsx), L, twoL);
      wall_fold(yv, vy, yo, L, twoL);
      wall_fold(z, vz, __fmul_rn((float)(z0 + oz), g.bsz), L, twoL);
      out.x[i] = x;
      out.y[i] = yv;
      out.z[i] = z;
      out.vx[i] = vx;
      out.vy[i] = vy;
      out.vz[i] = vz;
      atomicMax(&spmax[ob], __float_as_uint(r2_of(vx, vy, vz)));
    }
    __syncthreads();
    if (tid < OB) {
      const int ox = tid / t.tz, oz = tid - ox * t.tz;
      if (x0 + ox < g.X && z0 + oz < g.Z)
        sp[((int64_t)y * g.X + x0 + ox) * g.Z + z0 + oz] =
            __uint_as_float(spmax[tid]);
    }
    ppsim::cp_async_wait_all();
    __syncthreads();
    if (y + 1 < yb) compact(y + 2);
    __syncthreads();
  }
  if constexpr (COUNT) {
    const unsigned c[4] = {hits, passes, tests, tpasses};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned w = __reduce_add_sync(0xffffffffu, c[q]);
      if ((tid & 31) == 0) atomicAdd(counts + q, (unsigned long long)w);
    }
  }
}

template <Law LAW>
int launch(const Fields& in, const Outs& out, float* sp,
           unsigned long long* counts, const Geo3& g,
           const Tile3& t, const Ghost3& gh, int threads, int blocks,
           int smem, const PairParams& pp, float dt, float L,
           cudaStream_t s) {
  const bool shard = gh.y0 != 0 || gh.tx || gh.bx;
  auto kernel = shard ? (counts ? grid3_step_kernel<LAW, true, true>
                                : grid3_step_kernel<LAW, true, false>)
                      : (counts ? grid3_step_kernel<LAW, false, true>
                                : grid3_step_kernel<LAW, false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem, s>>>(in, out, sp, counts, g, t, gh, pp, dt,
                                       L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Inputs x, y, z, vx, vy, vz; outputs likewise; sp the (Y, X, Z) speed
// plane; counts null, or four int64 counters to which the launch adds its
// pairs inside the cutoff (self pairs included), its warp passes of the
// pair coefficient, its distance tests and its warp passes of the test.
// law 0 = repulsive, 1 = Lennard-Jones. A shard passes the
// global index y0 of its slab 0 and its ghost slabs (gtx, gty, gtz: slab -1;
// gbx, gby, gbz: slab Y; each [cap][X][Z]); null ghosts count as empty slabs,
// and the three of one side come together or not at all. The launch plan (tile tx x
// tz, segment length, threads, blocks, shared bytes) must be the one
// cuda_grid3.step3_plan gives for this shape; anything else returns
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch
// (0 = launched). cap <= 32.
int ppsim_grid3_step(const float* x, const float* y, const float* z,
                     const float* vx, const float* vy, const float* vz,
                     const float* gtx, const float* gty, const float* gtz,
                     const float* gbx, const float* gby, const float* gbz,
                     float* xo, float* yo, float* zo, float* vxo, float* vyo,
                     float* vzo, float* sp, long long* counts, int device,
                     int cap, int Y, int X, int Z, int y0, int xs, int zs,
                     int law, int tx, int tz, int seg, int threads, int blocks,
                     int smem,
                     float bsx, float bsy, float bsz, float c2, float cutoff,
                     float mr2, float inv_mass, float sig2, float lj_k,
                     float mass, float dt, float L, void* stream) {
  if (cap < 1 || cap > 32 || tx < 1 || tz < 1 || seg < 1)
    return (int)cudaErrorInvalidValue;
  const int hb = (tx + 2) * (tz + 2), ob = tx * tz;
  const int nblocks = ((X + tx - 1) / tx) * ((Z + tz - 1) / tz) *
                      ((Y + seg - 1) / seg);
  if (threads % 32 || threads > ppsim::kTileThreads || hb > threads ||
      ob > 2048 || blocks != nblocks ||
      smem != ppsim::tile_layout(3, cap, hb, ob).bytes)
    return (int)cudaErrorInvalidValue;
  if (!gtx != !gty || !gtx != !gtz || !gbx != !gby || !gbx != !gbz)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Fields in{x, y, z, vx, vy, vz};
  const Outs out{xo, yo, zo, vxo, vyo, vzo};
  const Geo3 g{cap, Y, X, Z, xs, zs, bsx, bsy, bsz};
  const Tile3 t{tx, tz, seg};
  const Ghost3 gh{gtx, gty, gtz, gbx, gby, gbz, y0};
  const PairParams pp{c2, cutoff, mr2, inv_mass, sig2, lj_k, mass};
  unsigned long long* cnt = reinterpret_cast<unsigned long long*>(counts);
  if (law == (int)Law::kRepulsive)
    return launch<Law::kRepulsive>(in, out, sp, cnt, g, t, gh, threads,
                                   blocks, smem, pp, dt, L, s);
  if (law == (int)Law::kLJ)
    return launch<Law::kLJ>(in, out, sp, cnt, g, t, gh, threads, blocks, smem,
                            pp, dt, L, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
