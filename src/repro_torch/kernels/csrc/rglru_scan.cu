// RG-LRU linear recurrence, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::_rglru_kernel
// (pallas_call at rglru_scan.py:57):
//
//     h_t = a_t * h_{t-1} + b_t  per channel, h_{-1} = h0 (or 0),
//
// a, b (B, S, W) float32 -> h (B, S, W) float32 and h_last (B, W) float32,
// the function of the oracle src/repro/kernels/ref.py::rglru_ref, at every
// S and W (the TPU kernel's divisibility asserts were its tiling).
//
// What bounds it on the H100.  Two float32 operations per element against
// 12 bytes moved (a and b read, h written): bytes, by far.  At the serving
// shape of recurrentgemma-9b (B 8, S 512, W 4096) the function moves
// 201,588,736 bytes, h0 and h_last included: 0.0602 ms at 3.35 TB/s.
//
// What the design does about it.  The TPU kernel tiles (B, W / bw, S /
// chunk) with the chunk innermost and carries h in VMEM across its
// sequential grid steps.  Here one thread owns one (b, w) channel and loops
// over S with h in a register; neighbouring threads own neighbouring
// channels, so every load and store of a step is coalesced across w.  The
// loads of a_t and b_t do not depend on h, so a thread issues U steps' loads
// before the U dependent updates, which keeps 2 U loads per thread in
// flight against the memory's latency.  Each step rounds the product and
// the sum separately (no fused multiply-add), as the plain version's
// `a * h + b` does, so the two agree bit for bit on the card.
//
// At the serving shape that is B * W = 32,768 threads, 256 blocks of 128:
// about two blocks per SM.  A long sequence at batch 1 leaves most of the
// card idle; a two-pass chunked scan over S is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;  // steps whose loads are issued together

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long row = (long long)blockIdx.y * W + w;  // (b, w)
  const long long base = (long long)blockIdx.y * S * W + w;
  float hv = h0 ? h0[row] : 0.f;
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      av[i] = a[base + (long long)(t + i) * W];
      bv[i] = b[base + (long long)(t + i) * W];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      hv = __fadd_rn(__fmul_rn(av[i], hv), bv[i]);
      h[base + (long long)(t + i) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const long long off = base + (long long)t * W;
    hv = __fadd_rn(__fmul_rn(a[off], hv), b[off]);
    h[off] = hv;
  }
  h_last[row] = hv;
}

}  // namespace

// Plain C entry point, bound with ctypes.  a, b and h are contiguous
// (B, S, W) float32, h0 (B, W) float32 or null for zeros, h_last (B, W)
// float32; B, S, W >= 1, B <= 65535.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int rglru_scan_fwd(const float* a, const float* b,
                              const float* h0, float* h, float* h_last, int B,
                              int S, int W, void* stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, h_last, S, W);
  return (int)cudaGetLastError();
}
