// Sentinel gather, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/relational.py::_gather_kernel
// (pallas_call at relational.py:252, launched by _sentinel_gather), the
// shared core of filter_join_gather and gather_payload:
//     out[i] = idx[i] >= 0 ? src[idx[i]] : fill
// with int64 indices and any fixed-width src.  The reference semantics are
// repro's core/vkernels.py::filter_join_gather (src = the selection, fill =
// -1) and kdispatch.gather_payload.
//
// The element is copied as raw bits of its width (1, 2, 4 or 8 bytes), so
// floats keep their NaN payloads and -0.0; `fill` arrives as the bit
// pattern of the fill value in src's dtype, cut to the width.  The caller
// validates that every index lies in [-1, nsrc) and launches nothing for
// zero indices or an empty src (all misses), as _sentinel_gather does.
//
// What bounds it on the H100.  One thread per output, a grid-stride loop:
// each output reads its 8-byte index and writes w bytes, coalesced, and
// reads one element of src at a data-dependent address.  With the join's
// sorted probe indices those reads are mostly in order and src is read
// about once; with random indices each read costs a 32-byte sector, so the
// gather runs below the byte bound that counts each byte once.  The TPU
// kernel keeps the whole of src in VMEM for every block; here src stays in
// device memory and the 50 MB L2 serves the repeats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 32;

template <typename T>
__global__ void sentinel_gather_kernel(const T* __restrict__ src,
                                       const long long* __restrict__ idx,
                                       long long m, T fill,
                                       T* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    long long j = idx[i];
    out[i] = j >= 0 ? src[j] : fill;
  }
}

template <typename T>
cudaError_t launch(const void* src, const void* idx, long long m,
                   unsigned long long fill_bits, void* out, cudaStream_t st) {
  long long b = (m + NTHREADS - 1) / NTHREADS;
  int blocks = (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
  sentinel_gather_kernel<T><<<blocks, NTHREADS, 0, st>>>(
      static_cast<const T*>(src), static_cast<const long long*>(idx), m,
      (T)fill_bits, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// src: elements of `width` bytes; idx: m int64 in [-1, len(src)); out: m
// elements of `width` bytes.  m >= 1.  Returns the cudaError_t of the
// launch; cudaErrorInvalidValue for another width.
extern "C" int sentinel_gather(const void* src, const void* idx, long long m,
                               int width, unsigned long long fill_bits,
                               void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return (int)launch<uint8_t>(src, idx, m, fill_bits, out, st);
    case 2: return (int)launch<uint16_t>(src, idx, m, fill_bits, out, st);
    case 4: return (int)launch<uint32_t>(src, idx, m, fill_bits, out, st);
    case 8: return (int)launch<uint64_t>(src, idx, m, fill_bits, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
