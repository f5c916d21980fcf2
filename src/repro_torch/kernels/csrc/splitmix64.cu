// splitmix64 key hashing, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/relational.py:
//   * hash_fixed (_hash_fixed_kernel, pallas_call at relational.py:146):
//     out[i] = mix64(bits(v[i]) ^ GOLDEN) over any fixed-width array;
//   * the ordered fold of combine_hashes / hash_keys (_combine_kernel and
//     _hash_keys_kernel, pallas_call at relational.py:180, launched by
//     _run_combine): h = GOLDEN, then for every column j in order
//     h = mix64(h * GOLDEN ^ c_j), where c_j is the column's hash, or with
//     mix_first its raw bits, hashed here first (c_j = mix64(c_j ^ GOLDEN)).
// The reference semantics are repro's core/vkernels.py (hash_fixed,
// combine_hashes, hash_keys); the results are bit-identical to it.
//
// Bit preparation.  The TPU wrapper prepares the bits on the host
// (_prep_bits: float -0.0 -> +0.0, narrow widths zero-extended to 64 bits).
// Here hash_fixed does it in the kernel, templated on the element width and
// a float flag: the input is read at its own width (1, 2, 4 or 8 bytes), a
// float whose bits are the sign bit alone (-0.0) becomes 0, every other
// pattern, NaN payloads included, is kept as it is and zero-extended.  The
// fold takes already prepared 64-bit words (ncols x n, column-major by
// column), as the TPU kernel does.
//
// What bounds it on the H100.  One thread per element, a grid-stride loop.
// Per element hash_fixed reads w bytes and writes 8; the fold reads 8 *
// ncols and writes 8.  The mix is 2 64-bit multiplies and 3 xor-shifts, a
// few dozen integer instructions, far below the card's integer rate at
// 3.35 TB/s, so bytes set the least time.  Loads and stores are coalesced
// (neighbouring threads on neighbouring elements); there is nothing to
// reuse, so no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t GOLDEN = 0x9E3779B97F4A7C15ull;
constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 32;  // 32 blocks per SM, then stride

__device__ __forceinline__ uint64_t mix64(uint64_t h) {
  h ^= h >> 30;
  h *= 0xBF58476D1CE4E5B9ull;
  h ^= h >> 27;
  h *= 0x94D049BB133111EBull;
  return h ^ (h >> 31);
}

template <typename U, bool IS_FLOAT>
__global__ void hash_fixed_kernel(const U* __restrict__ bits,
                                  uint64_t* __restrict__ out, long long n) {
  constexpr U SIGN = (U)((U)1 << (8 * sizeof(U) - 1));
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    U b = bits[i];
    if (IS_FLOAT && b == SIGN) b = 0;  // -0.0 hashes as +0.0
    out[i] = mix64((uint64_t)b ^ GOLDEN);
  }
}

template <bool MIX_FIRST>
__global__ void combine_kernel(const uint64_t* __restrict__ cols, int ncols,
                               long long n, uint64_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint64_t h = GOLDEN;
    for (int j = 0; j < ncols; ++j) {
      uint64_t c = cols[(long long)j * n + i];
      if (MIX_FIRST) c = mix64(c ^ GOLDEN);
      h = mix64((h * GOLDEN) ^ c);
    }
    out[i] = h;
  }
}

int blocks_for(long long n) {
  long long b = (n + NTHREADS - 1) / NTHREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename U, bool IS_FLOAT>
cudaError_t launch_hash(const void* bits, void* out, long long n,
                        cudaStream_t st) {
  hash_fixed_kernel<U, IS_FLOAT><<<blocks_for(n), NTHREADS, 0, st>>>(
      static_cast<const U*>(bits), static_cast<uint64_t*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// bits: n elements of `width` bytes; out: n uint64.  n >= 1.  Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue for a
// width/float combination the kernel does not take.
extern "C" int splitmix64_hash_fixed(const void* bits, void* out, long long n,
                                     int width, int is_float, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width * 2 + (is_float ? 1 : 0)) {
    case 2: return (int)launch_hash<uint8_t, false>(bits, out, n, st);
    case 4: return (int)launch_hash<uint16_t, false>(bits, out, n, st);
    case 5: return (int)launch_hash<uint16_t, true>(bits, out, n, st);
    case 8: return (int)launch_hash<uint32_t, false>(bits, out, n, st);
    case 9: return (int)launch_hash<uint32_t, true>(bits, out, n, st);
    case 16: return (int)launch_hash<uint64_t, false>(bits, out, n, st);
    case 17: return (int)launch_hash<uint64_t, true>(bits, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cols: ncols x n uint64 (row j = column j's words), ncols >= 0; out: n
// uint64.  n >= 1.  mix_first = 1 hashes each column's raw bits first.
extern "C" int splitmix64_combine(const void* cols, int ncols, long long n,
                                  int mix_first, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* c = static_cast<const uint64_t*>(cols);
  uint64_t* o = static_cast<uint64_t*>(out);
  if (mix_first)
    combine_kernel<true><<<blocks_for(n), NTHREADS, 0, st>>>(c, ncols, n, o);
  else
    combine_kernel<false><<<blocks_for(n), NTHREADS, 0, st>>>(c, ncols, n, o);
  return (int)cudaGetLastError();
}
