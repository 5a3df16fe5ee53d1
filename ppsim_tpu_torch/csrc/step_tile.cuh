// The shared-memory tile machinery of the Hopper step kernels (K1 + K6
// grid_step.cu, K3 grid3_step.cu): the layout of a block's ring of four
// row (2D) or y-slab (3D) buffers, the cp.async copies that fill a buffer
// while the block computes on the other three, the in-place compaction of a
// bin's live slots, and the block-wide prefix sum that lists a row's live
// own particles, one thread each.
//
// A buffer holds, for each halo bin h of the block's tile, NC coordinate
// planes [NC][cap][hb] float (raw as loaded, then compacted: slot k is the
// k-th live slot, ascending), the bounds of the bin's live coordinates, the
// bin's live count as a neighbour (0 outside the mask), its live count as an
// own bin, and each compacted own slot's original slot index. After the four
// buffers come the row's particle list (own bin << 5 | compacted slot,
// uint16), and per own bin the max |v|^2, the mask of non-empty neighbour
// bins and the bound of the live coordinates beyond each face; then the
// scan's warp sums, and in 3D (nc == 3) last the slab's table of the 27
// neighbour directions. ppsim_tpu_torch/ops/cuda_grid.py tile_smem repeats
// this layout to plan the launch; the entry points check that both agree.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppsim {

// Largest block of a tiled step kernel (its __launch_bounds__).
constexpr int kTileThreads = 256;
// Buffers in the ring: the rows (slabs) y-1, y, y+1 and the one in flight.
constexpr int kRing = 4;

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

struct TileLayout {
  int hb;     // halo bins of one buffer
  int ob;     // own bins of one row (slab)
  int bnd;    // offset of the live-slot bounds, float[NC][2][hb] (min, max)
  int ncnt;   // offset of the neighbour counts, uint8[hb]
  int ocnt;   // offset of the own counts, uint8[ob]
  int slot;   // offset of the own slot map, uint8[cap][ob]
  int buf;    // bytes of one buffer (coordinates at offset 0)
  int plist;  // offset of the particle list, uint16[cap * ob]
  int spmax;  // offset of the per-own-bin max |v|^2 bits, uint32[ob]
  int omask;  // offset of the per-own-bin neighbour masks, uint32[ob]
  int face;   // offset of the per-own-bin face bounds, float[2 * NC][ob]
  int wsum;   // offset of the scan's warp sums, int[32]
  int dofs;   // 3D: offset of the directions' offsets, float4[27]
  int dcnt;   // 3D: offset of the directions' count offsets, int[27]
  int bytes;  // dynamic shared memory of the block
};

__host__ __device__ inline TileLayout tile_layout(int nc, int cap, int hb,
                                                  int ob) {
  TileLayout t;
  t.hb = hb;
  t.ob = ob;
  t.bnd = align16(nc * cap * hb * 4);
  t.ncnt = t.bnd + align16(2 * nc * hb * 4);
  t.ocnt = t.ncnt + align16(hb);
  t.slot = t.ocnt + align16(ob);
  t.buf = t.slot + align16(cap * ob);
  t.plist = kRing * t.buf;
  t.spmax = t.plist + align16(2 * cap * ob);
  t.omask = t.spmax + align16(4 * ob);
  t.face = t.omask + align16(4 * ob);
  t.wsum = t.face + align16(2 * nc * 4 * ob);
  t.dofs = t.wsum + 4 * 32;
  t.dcnt = t.dofs + (nc == 3 ? 16 * 27 : 0);
  t.bytes = t.dcnt + (nc == 3 ? align16(4 * 27) : 0);
  return t;
}

// One 4-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies; a __syncthreads must follow before other
// threads read them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the sum. wsum is 32 ints of shared memory. Holds two
// __syncthreads: every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  *total = wsum[nwarps - 1];
  return (warp ? wsum[warp - 1] : 0) + x - v;
}

// Compact halo bin h of a buffer in place: its live slots (x < BIG/2, the
// dead-slot sentinel) move down in ascending order, so compacted slot k is
// the k-th live one, which keeps the plain twin's summation order. bnd gets
// the bin's live-coordinate bounds ([q][min, max][hb]; BIG and -BIG when
// empty). With a slot map (own bins), slot[k * ob + o] records the original
// slot. Returns the live count; *dead gets the mask of dead slots.
template <int NC>
__device__ __forceinline__ int compact_bin(float* c, float* bnd, int cap,
                                           int hb, int h, uint8_t* slot,
                                           int ob, int o, uint32_t* dead) {
  float lo[NC], hi[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    lo[q] = 1.0e9f;
    hi[q] = -1.0e9f;
  }
  int k = 0;
  uint32_t d = 0;
  for (int s = 0; s < cap; ++s) {
    if (c[s * hb + h] < 0.5f * 1.0e9f) {
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float v = c[(q * cap + s) * hb + h];
        c[(q * cap + k) * hb + h] = v;
        lo[q] = fminf(lo[q], v);
        hi[q] = fmaxf(hi[q], v);
      }
      if (slot) slot[k * ob + o] = (uint8_t)s;
      ++k;
    } else {
      d |= 1u << s;
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    bnd[(2 * q) * hb + h] = lo[q];
    bnd[(2 * q + 1) * hb + h] = hi[q];
  }
  *dead = d;
  return k;
}

}  // namespace ppsim
