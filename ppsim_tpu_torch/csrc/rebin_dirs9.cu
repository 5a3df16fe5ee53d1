// K7 + K8: the loss-free 9-direction ("dirs9") slab rebin for Hopper
// (sm_90a), the ablation against the axis-factorized K2.
//
// Replaces: ppsim_tpu/ops/pallas_rebin.py:_counts_kernel (K7, through
// rebin_counts_pallas) and _shuffle_kernel (K8, through rebin_shuffle_pallas /
// grid_rebin_pallas). Plain twins: ppsim_tpu_torch/ops/cuda_rebin.py
// rebin_counts_plain and rebin_shuffle_plain (grid_ops.rebin_counts and
// grid_ops.rebin_shuffle, plus the monitor planes).
//
// K7, one thread per bin (r, c), c fastest, reads xl, yl, pid and writes the
// int32 (9, R, C) count stack: [d] = live slots whose direction is DIRS[d],
// [4] = the live count. (The TPU carried counts in f32 only because Mosaic
// narrowed i1.)
//
// K8 reads the 5 fields and the counts and writes the 5 fields into fresh
// buffers, plus the (4, R, C) monitor stack [far_pre, alive_pre, alive_post,
// resid] of K2 (the TPU reduced the same quantities with XLA after the
// kernel). The input slab is never written.
//
// Decisions (grid_ops.rebin_shuffle). Group d of a bin (its live slots
// moving toward DIRS[d]) is accepted up to rank < evac and off[d] + rank < F
// at the destination, F = cap - its live count and off[d] = the entrants
// queued there by the groups before d in DIRS order (off[d](b) = sum over
// d' < d of counts[d'](b - d')). The e-th accepted entrant of group d lands
// in the destination's empty slot of pre-rebin empty-rank off[d] + e. The
// source side (which leavers go) and the destination side (which entrants
// come, into which slots) evaluate the same predicate from the input's
// counts, so no thread waits for another and there are no atomics on the
// slab. So a bin's decisions read fields and masks 1 bin away (its sources)
// and counts 2 bins away (its destinations' off); bins outside the array
// read count 0 and no particles.
//
// Design of K8: a strip walk through shared memory, as K2's
// (rebin_tile.cuh). A block owns a strip of T columns over a segment of
// rows and walks it row by row. Its rings hold the field rows r-1..r+1 (the
// strip and 1 bin each side: 5 planes, 4 bytes a slot) and the count rows
// r-2..r+2 (2 bins each side, 9 planes), with one more row of each in
// flight (cp.async; a count row travels with the field row one before it),
// and the off tables of rows r-1..r+1. Every plane of the input is read
// from device memory once, plus the halo. Per row:
//   A. when a field row arrives, four threads per halo bin read its slots
//      once (a quarter each, pooled by warp shuffles) and keep alive, the
//      eight per-direction mover masks and the far count: a source bin's
//      mask for d is the one its destination at +d needs, so each slot's
//      direction is computed once, not once per neighbour; eight threads
//      per halo bin scan its counts into its off table (off[d] for the
//      eight directions), so no decision sums counts;
//   B. one thread per (own bin, direction d) settles group d on both sides:
//      its own leavers toward d (off at the destination from its table) and
//      the entrants from the bin at -d into its empty slots, writing those
//      slots of a final source map (two bytes a slot: direction << 5 |
//      source slot); the bin's eight threads pool their leave and fill masks
//      with warp shuffles and mark the other slots keep or clear;
//   C. one thread per (slot, own bin), bins fastest, writes the five output
//      planes coalesced from the ring through the map, recentering an
//      entrant with __fsub_rn(v, d * bs), and counts resid (live slots still
//      pointing out of their bin) in shared memory; the monitor planes are
//      written once per bin.
//
// Exactness. Values are only moved; the one arithmetic op is the re-basing
// x - dr*bs with dr in {-1, 0, 1}, explicitly rounded (__fsub_rn) so no FMA
// contraction can move it. Directions come from slab_rebin.cuh (the op order
// of grid_ops.slab_dirs). So the output equals the plain twin bitwise on all
// planes.
//
// The strip width, segment, block size and shared bytes come from the Python
// plan (cuda_rebin.shuffle_plan, whose shuffle_smem repeats shuffle_layout);
// the entry point refuses any other plan.
//
// Bound. Memory: K7 reads 3 planes and writes 9 count planes; K8 reads 5
// planes + the count stack and writes 5 planes + 4 monitor planes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "slab_rebin.cuh"
#include "step_tile.cuh"

namespace {

using ppsim::accepted_count;
using ppsim::align16;
using ppsim::cap_mask;
using ppsim::clamp_dir;
using ppsim::cp_async4;
using ppsim::dir1;
using ppsim::first_bits;
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

// K8's final source map: a kept slot is (4 << 5 | slot), an entrant
// (d << 5 | source slot), a cleared leaver kClear.
constexpr uint16_t kClear = 0xffff;
// Words of masks a field-buffer bin keeps: alive, then [1 + d] the movers
// toward DIRS[d], whose stay entry [1 + 4] holds the far count.
constexpr int kMaskWords = 10;
// Buffers of the rings: field rows r-1..r+1 and count rows r-2..r+2, each
// with one more in flight; the off tables of rows r-1..r+1.
constexpr int kFieldRing = 4, kCountRing = 6, kOffRing = 3;

struct ShuffleLayout {
  int hf;     // field halo bins of a row: the T own bins and 1 each side
  int hc;     // count halo bins of a row: the T own bins and 2 each side
  int fmask;  // offset of a field buffer's masks, uint32[kMaskWords][hf]
  int fbuf;   // bytes of one field buffer (planes [5][cap][hf] at offset 0)
  int cring;  // offset of the count ring
  int cbuf;   // bytes of one count buffer, int[9][hc]
  int offt;   // offset of the off tables, int[kOffRing][8][hf]
  int fmap;   // offset of the final source map, uint16[cap][T]
  int mon;    // offset of the monitor counters, int[4][T]
  int bytes;  // dynamic shared memory of the block
};

__host__ __device__ inline ShuffleLayout shuffle_layout(int cap, int T) {
  ShuffleLayout t;
  t.hf = T + 2;
  t.hc = T + 4;
  t.fmask = align16(5 * cap * t.hf * 4);
  t.fbuf = t.fmask + align16(kMaskWords * t.hf * 4);
  t.cring = kFieldRing * t.fbuf;
  t.cbuf = align16(9 * t.hc * 4);
  t.offt = t.cring + kCountRing * t.cbuf;
  t.fmap = t.offt + align16(kOffRing * 8 * t.hf * 4);
  t.mon = t.fmap + align16(2 * cap * T);
  t.bytes = t.mon + 4 * T * 4;
  return t;
}

struct Geo9 {
  int cap, R, C;    // slots, array extents
  int rows, cols;   // physical bins
  int evac;
  float bs, inv;    // bin side, float32(1 / bin side)
};

// Threads that take a halo bin's masks, its slots split among them.
constexpr int kMaskThreads = 4;

// Blocks K8 runs on an SM at most. Where 4 fit (at 64 registers or fewer
// and capacity 14, 4 x 56 KB of shared memory), K8 ran 13-15% slower on the
// H100 than with 3 (PERF.md), whether a launch bound or ptxas's own choice
// brought it there: the entry point asks for a shared-memory carveout that
// holds 3 blocks and not 4, which leaves the rest of the SM's 256 KB to L1.
constexpr int kShuffleBlocksPerSM = 3;
// Shared memory an H100 SM can hand to blocks, and what each block reserves.
constexpr int kSmemPerSM = 228 * 1024, kSmemPerBlock = 1024;

__global__ void __launch_bounds__(ppsim::kTileThreads)
rebin_shuffle_kernel(const SlabC in, const int* __restrict__ counts,
                     const Slab out, int* __restrict__ mon_out, const Geo9 g,
                     const int T, const int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ShuffleLayout lay = shuffle_layout(g.cap, T);
  const int cap = g.cap, HF = lay.hf, HC = lay.hc, tid = threadIdx.x;
  const int64_t plane = (int64_t)g.R * g.C;

  // block -> (segment, strip), strips fastest
  const int nstrip = (g.C + T - 1) / T;
  const int s0 = (blockIdx.x % nstrip) * T;
  const int ra = blockIdx.x / nstrip * seg;
  const int rb = min(g.R, ra + seg);

  // ring buffers of row r (r >= ra - 1 for fields and tables, ra - 2 for
  // counts)
  auto fbuf = [&](int r) { return smem + (r - ra + 1) % kFieldRing * lay.fbuf; };
  auto fplane = [&](unsigned char* b, int k) {
    return reinterpret_cast<float*>(b) + k * cap * HF;
  };
  auto fpid = [&](unsigned char* b) {
    return reinterpret_cast<int*>(b) + 4 * cap * HF;
  };
  auto masks = [&](int r) {
    return reinterpret_cast<uint32_t*>(fbuf(r) + lay.fmask);
  };
  auto cbuf = [&](int r) {
    return reinterpret_cast<int*>(smem + lay.cring + (r - ra + 2) % kCountRing * lay.cbuf);
  };
  auto offt = [&](int r) {
    return reinterpret_cast<int*>(smem + lay.offt) + (r - ra + 1) % kOffRing * 8 * HF;
  };
  uint16_t* fmap = reinterpret_cast<uint16_t*>(smem + lay.fmap);
  int* mon = reinterpret_cast<int*>(smem + lay.mon);

  // This thread's field halo bin for copies: h = tid % HF, the copies of a
  // bin's cap slots split over `parts` threads.
  const int parts = blockDim.x / HF;
  const int h = tid % HF, part = tid / HF;
  const int gc = s0 - 1 + h;
  const bool col_in = gc >= 0 && gc < g.C;
  // Lanes of eight: own bin (or halo bin) tid >> 3, direction DIRS[d]
  // (without the stay) for lane k8 = tid & 7
  const int k8 = tid & 7;
  const int d = k8 + (k8 >= 4 ? 1 : 0);
  const int dr = d / 3 - 1, dc = d % 3 - 1;

  auto issue_fields = [&](int r) {
    if (r < 0 || r >= g.R || part >= parts || !col_in) return;
    unsigned char* b = fbuf(r);
    const int64_t gb = (int64_t)r * g.C + gc;
    for (int s = part; s < cap; s += parts) {
      const int64_t i = s * plane + gb;
      const int j = s * HF + h;
      cp_async4(fplane(b, 0) + j, in.x + i);
      cp_async4(fplane(b, 1) + j, in.y + i);
      cp_async4(fplane(b, 2) + j, in.vx + i);
      cp_async4(fplane(b, 3) + j, in.vy + i);
      cp_async4(fpid(b) + j, in.pid + i);
    }
  };
  // count row r over the strip and 2 bins each side; 0 outside the array
  auto issue_counts = [&](int r) {
    int* b = cbuf(r);
    const bool row_in = r >= 0 && r < g.R;
    for (int e = tid; e < 9 * HC; e += blockDim.x) {
      const int k = e / HC, hh = e - k * HC;
      const int cc = s0 - 2 + hh;
      if (row_in && cc >= 0 && cc < g.C)
        cp_async4(b + e, counts + k * plane + (int64_t)r * g.C + cc);
      else
        b[e] = 0;
    }
  };
  // A: the masks of a field row that has arrived, kMaskThreads threads a
  // halo bin pooled by warp shuffles (threads tid < n_mask_threads, whole
  // warps)
  const int n_mask_threads = (kMaskThreads * HF + 31) & ~31;
  auto take_masks = [&](int r) {
    const int hb = tid / kMaskThreads, p = tid % kMaskThreads;
    const int cb = s0 - 1 + hb;
    unsigned char* b = fbuf(r);
    uint32_t alive = 0, far = 0;
    uint32_t mv[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) mv[k] = 0;
    if (hb < HF && r >= 0 && r < g.R && cb >= 0 && cb < g.C) {
      const float* xs = fplane(b, 0);
      const float* ys = fplane(b, 1);
      const int* pid = fpid(b);
#pragma unroll 2
      for (int s = p; s < cap; s += kMaskThreads) {
        const int j = s * HF + hb;
        const float x = xs[j], y = ys[j];
        if (pid[j] < 0) continue;
        const uint32_t bit = 1u << s;
        alive |= bit;
        const int rx = raw_dir(x, g.inv), ry = raw_dir(y, g.inv);
        far += (abs(rx) > 1 || abs(ry) > 1) ? 1u : 0u;
        const int dd = dcode(clamp_dir(rx, r, g.rows), clamp_dir(ry, cb, g.cols));
#pragma unroll
        for (int k = 0; k < 9; ++k)
          if (k == dd && k != 4) mv[k] |= bit;
      }
    }
#pragma unroll
    for (int m = 1; m < kMaskThreads; m <<= 1) {
      alive |= __shfl_xor_sync(0xffffffffu, alive, m);
      far += __shfl_xor_sync(0xffffffffu, far, m);
#pragma unroll
      for (int k = 0; k < 9; ++k)
        if (k != 4) mv[k] |= __shfl_xor_sync(0xffffffffu, mv[k], m);
    }
    if (hb < HF && p == 0) {
      uint32_t* m = masks(r);
      m[hb] = alive;
#pragma unroll
      for (int k = 0; k < 9; ++k) m[(1 + k) * HF + hb] = k == 4 ? far : mv[k];
    }
  };
  // off table of row r (all threads): [k][hb] = off[DIRS k] at halo bin hb,
  // the entrants queued there by the groups before it, an exclusive scan
  // over the eight lanes of counts[d] at (r - dr, hb - dc)
  auto take_offs = [&](int r) {
    int* t = offt(r);
    for (int e = tid; e < ((8 * HF + 31) & ~31); e += blockDim.x) {
      const int hb = e >> 3;
      const int v = hb < HF ? cbuf(r - dr)[d * HC + hb + 1 - dc] : 0;
      int x = v;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o, 8);
        if (k8 >= o) x += y;
      }
      if (hb < HF) t[k8 * HF + hb] = x - v;
    }
  };
  auto take_row = [&](int r) {
    if (tid < n_mask_threads) take_masks(r);
    take_offs(r);
  };

  // the rows that settle the segment's first row, then one more in flight
  for (int r = ra - 2; r <= ra + 2; ++r) issue_counts(r);
  for (int r = ra - 1; r <= ra + 1; ++r) issue_fields(r);
  ppsim::cp_async_commit();
  ppsim::cp_async_wait_all();
  __syncthreads();
  for (int r = ra - 1; r <= ra + 1; ++r) take_row(r);
  __syncthreads();

  const uint32_t cmask = cap_mask(cap);
  const int o = tid >> 3;  // B's own bin
  const bool own = o < T && s0 + o < g.C;
  for (int r = ra; r < rb; ++r) {
    // field row r + 2 (and count row r + 3) streams in
    if (r + 2 <= rb) {
      issue_fields(r + 2);
      issue_counts(r + 3);
    }
    ppsim::cp_async_commit();

    // B: group d of the own bin, as source and as destination
    uint32_t leave = 0, filled = 0, alive = 0;
    if (own) {
      const int hf = o + 1, hc = o + 2;  // the bin in field / count buffers
      auto cnt = [&](int k, int ddr, int ddc) {
        return cbuf(r + ddr)[k * HC + hc + ddc];
      };
      // off: entrants queued here before group d; off_dest: at the bin at
      // +d before my group d
      const int off = offt(r)[k8 * HF + hf];
      const int off_dest = offt(r + dr)[k8 * HF + hf + dc];
      const uint32_t* M0 = masks(r);
      alive = M0[hf];
      const uint32_t mine = M0[(1 + d) * HF + hf];
      leave = first_bits(mine, accepted_count(__popc(mine), g.evac,
                                              cap - cnt(4, dr, dc) - off_dest));
      // entrants: group d of the bin at -d, into my pre-rebin empty slots
      // from empty-rank off on (none left: counts not of this slab)
      uint32_t src = masks(r - dr)[(1 + d) * HF + hf - dc];
      int n_in = accepted_count(__popc(src), g.evac, cap - cnt(4, 0, 0) - off);
      uint32_t dst = ~alive & cmask;
      for (int i = 0; i < off && dst; ++i) dst &= dst - 1u;
      for (; n_in > 0 && dst; --n_in) {
        const int t = __ffs(dst) - 1;
        fmap[t * T + o] = (uint16_t)(d << 5 | (__ffs(src) - 1));
        filled |= 1u << t;
        dst &= dst - 1u;
        src &= src - 1u;
      }
    }
    // the bin's eight threads pool their masks
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
      leave |= __shfl_xor_sync(0xffffffffu, leave, m);
      filled |= __shfl_xor_sync(0xffffffffu, filled, m);
    }
    if (own) {
      // slots no entrant took: accepted leavers clear, the rest keep
      for (int s = k8; s < cap; s += 8)
        if (!(filled >> s & 1u))
          fmap[s * T + o] = (leave >> s & 1u) ? kClear : (uint16_t)(4 << 5 | s);
      if (k8 == 0) {
        mon[o] = (int)masks(r)[5 * HF + o + 1];
        mon[T + o] = __popc(alive);
        mon[2 * T + o] = __popc(alive & ~leave) + __popc(filled);
        mon[3 * T + o] = 0;
      }
    }
    __syncthreads();

    // C: the output planes, one thread per (slot, own bin), bins fastest
    const int64_t row = (int64_t)r * g.C + s0;
    for (int e = tid; e < cap * T; e += blockDim.x) {
      const int s = e / T, oo = e - s * T;
      if (s0 + oo >= g.C) continue;
      const int64_t i = s * plane + row + oo;
      const int code = fmap[e];
      if (code == kClear) {
        out.x[i] = kBig;
        out.y[i] = kBig;
        out.vx[i] = 0.0f;
        out.vy[i] = 0.0f;
        out.pid[i] = -1;
        continue;
      }
      const int ds = code >> 5, sr = ds / 3 - 1, sc = ds % 3 - 1;
      unsigned char* b = fbuf(r - sr);
      const int j = (code & 31) * HF + oo + 1 - sc;
      float x = fplane(b, 0)[j], y = fplane(b, 1)[j];
      if (ds != 4) {
        x = __fsub_rn(x, sr * g.bs);
        y = __fsub_rn(y, sc * g.bs);
      }
      const int pid = fpid(b)[j];
      out.x[i] = x;
      out.y[i] = y;
      out.vx[i] = fplane(b, 2)[j];
      out.vy[i] = fplane(b, 3)[j];
      out.pid[i] = pid;
      if (pid >= 0 && (dir1(x, r, g.rows, g.inv) != 0 ||
                       dir1(y, s0 + oo, g.cols, g.inv) != 0))
        atomicAdd(&mon[3 * T + oo], 1);
    }
    ppsim::cp_async_wait_all();
    __syncthreads();
    if (r + 2 <= rb) take_row(r + 2);
    if (tid < T && s0 + tid < g.C) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mon_out[k * plane + row + tid] = mon[k * T + tid];
    }
    __syncthreads();
  }
}

// The plan's shape checks: the launch must be the one the Python plan gives
// (strip T, segment, threads, blocks, shared bytes) for this geometry.
bool shuffle_plan_ok(const Geo9& g, int T, int seg, int threads, int blocks,
                     int smem) {
  if (g.cap < 1 || g.cap > 32 || T < 1 || seg < 1) return false;
  const int64_t nblocks = (int64_t)((g.C + T - 1) / T) * ((g.R + seg - 1) / seg);
  return threads % 32 == 0 && threads <= ppsim::kTileThreads && 8 * T <= threads &&
         blocks == nblocks && smem == shuffle_layout(g.cap, T).bytes;
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
// alive_pre, alive_post, resid]. The launch plan (strip width, segment,
// threads, blocks, shared bytes) must be the one cuda_rebin.shuffle_plan
// gives for this shape; anything else returns cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch (0 = launched). cap <= 32.
int ppsim_rebin_shuffle(const float* x, const float* y, const float* vx,
                        const float* vy, const int* pid, const int* counts,
                        float* ox, float* oy, float* ovx, float* ovy,
                        int* opid, int* mon, int device, int cap, int R, int C,
                        int rows, int cols, int evac, int tile, int seg,
                        int threads, int blocks, int smem, float bs, float inv,
                        void* stream) {
  const Geo9 g{cap, R, C, rows, cols, evac, bs, inv};
  if (!shuffle_plan_ok(g, tile, seg, threads, blocks, smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rebin_shuffle_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  // the carveout, in percent, rounded up to a size the SM supports
  const int64_t want = (int64_t)kShuffleBlocksPerSM * (smem + kSmemPerBlock);
  err = cudaFuncSetAttribute(
      rebin_shuffle_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)std::min<int64_t>(100, (want * 100 + kSmemPerSM - 1) / kSmemPerSM));
  if (err != cudaSuccess) return (int)err;
  rebin_shuffle_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      SlabC{x, y, vx, vy, pid}, counts, Slab{ox, oy, ovx, ovy, opid}, mon, g,
      tile, seg);
  return (int)cudaGetLastError();
}

}  // extern "C"
