// The roofline probes for Hopper (sm_90a): the card's own float32 FMA rate
// and its device-memory stream rate, which ppsim_tpu_torch/roofline.py
// places the step kernel against.
//
// Replaces: bench/mfu.py vpu_peak_flops (its FMA-chain Pallas kernel) and
// hbm_stream_bw (its Pallas stream copy). Plain twins:
// ppsim_tpu_torch/ops/cuda_roofline.py fma_chain_plain and stream_add_plain.
//
// fma_chain<CHAINS>: y = sum over k of the chain acc_k after `iters` steps,
// elementwise on a = x[i], with b = a * 1.0000001 + 0.5, acc_k = a + k at the
// start and acc_k = acc_k * b + a each step (the TPU kernel's op mix, the
// pair loop's hot body). Bound by operations: 2 * iters * CHAINS flop an
// element against 16 bytes of traffic. Design: one thread per element over
// a grid-stride loop with the grid at full occupancy; the CHAINS accumulators
// are registers (CHAINS is a template parameter, instances 1, 2, 4, 8), so
// each step is CHAINS independent FFMAs (fmaf: one rounding, where the twin
// rounds the product and the sum) and the latency of one chain is hidden by
// the others and by the SM's other warps. `iters` is a run-time argument, so
// the compiler cannot fold or hoist the chain; the loop is unrolled 8 deep
// to keep the loop's own instructions a small share of the issue slots. b
// and the chains' starts use __fmul_rn / __fadd_rn, rounded as the twin
// rounds them (no FMA contraction), and the chains are summed left to right
// as the twin sums them. The output is stored, so no step is dead code. At
// the probe's size (iters 256, b ~1.5) every value overflows to inf within
// the first call, in the TPU kernel too; an FFMA on inf costs what it costs
// on a finite value, so the timing holds.
//
// stream_add: y = x + 1 (a stream copy: each element read once and written
// once). Bound by bytes: 8 bytes an element. Design: one 16-byte float4
// load and store a thread, one thread per float4, in a one-shot grid of
// blocks that each move 4 KB and retire (the first threads of the grid
// also take the last n mod 4 elements): on the H100 a persistent grid (8
// blocks an SM striding through the whole array) read 6% slower, with one
// or four loads in flight a thread. Both pointers must be 16-byte aligned
// (the wrapper checks).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int CHAINS>
__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long n, int iters) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = x[i];
    const float b = __fadd_rn(__fmul_rn(a, 1.0000001f), 0.5f);
    float acc[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc[k] = __fadd_rn(a, (float)k);
#pragma unroll 8
    for (int t = 0; t < iters; ++t) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) acc[k] = fmaf(acc[k], b, a);
    }
    float out = acc[0];
#pragma unroll
    for (int k = 1; k < CHAINS; ++k) out = __fadd_rn(out, acc[k]);
    y[i] = out;
  }
}

__global__ void __launch_bounds__(kThreads)
stream_add_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  if (i < n4) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<float4*>(y)[i] =
        make_float4(__fadd_rn(v.x, 1.0f), __fadd_rn(v.y, 1.0f),
                    __fadd_rn(v.z, 1.0f), __fadd_rn(v.w, 1.0f));
  }
  if (i < n - 4 * n4) y[4 * n4 + i] = __fadd_rn(x[4 * n4 + i], 1.0f);
}

// One thread an element, in as many blocks as fill every SM at the kernel's
// occupancy (and no more than the elements need).
template <int CHAINS>
int launch_fma_chain(const float* x, float* y, long long n, int iters,
                     int device, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fma_chain_kernel<CHAINS>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  fma_chain_kernel<CHAINS><<<(unsigned)(need < full ? need : full), kThreads,
                             0, stream>>>(x, y, n, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fma_chain: y[i] from x[i], n float32 elements, `chains` in {1, 2, 4, 8},
// iters >= 0. Returns cudaGetLastError() after the launch (0 = launched).
int ppsim_fma_chain(const float* x, float* y, long long n, int iters,
                    int chains, int device, void* stream) {
  if (n < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (chains) {
    case 1: return launch_fma_chain<1>(x, y, n, iters, device, s);
    case 2: return launch_fma_chain<2>(x, y, n, iters, device, s);
    case 4: return launch_fma_chain<4>(x, y, n, iters, device, s);
    case 8: return launch_fma_chain<8>(x, y, n, iters, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// stream_add: y = x + 1 over n float32 elements; x and y 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = launched).
int ppsim_stream_add(const float* x, float* y, long long n, int device,
                     void* stream) {
  if (n < 0 || ((unsigned long long)x | (unsigned long long)y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stream_add_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), kThreads, 0,
                      (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
