// Row gather and dictionary decode, hand-written CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/take_gather.py:
//   take_rows   (_take_kernel, pallas_call at take_gather.py:51)
//       out[i, :] = values[indices[i], :]
//   dict_decode (_dict_kernel, pallas_call at take_gather.py:88)
//       out[i, :] = dictionary[codes[i], :]
// The reference semantics are the oracles take_rows_ref / dict_decode_ref
// of src/repro/kernels/ref.py: a row gather.  The TPU's dict_decode selects
// rows with a one-hot (bm, R) @ (R, W) matmul on the MXU, which turns
// 0 x inf into NaN across a whole block; this kernel gathers, so both
// entry points copy bits and agree with the oracle on every value.
//
// Bits, not values.  A row is copied as raw words, so NaN payloads, -0.0
// and infinities survive, and any element width works.  The word is the
// widest of 16, 8, 4, 2 or 1 bytes that divides the row's byte count and
// both base pointers: every row then starts on a word boundary, and a row
// of W = 7 bfloat16 (14 bytes) goes in 2-byte words.
//
// Work split.  A warp takes 32 output rows at a time.  Lane j reads the
// index of row j once (one coalesced load per 32 rows); the rows are then
// copied in steps of 32 / G rows, G lanes to a row (G the power of two at
// or above the row's word count, at most 32), and each row's index reaches
// its G lanes by a shuffle.  Any M and any width W >= 1; the grid is sized
// to the card (resident blocks) and loops over the rows.
//
// Narrow rows (take_rows, and dict_decode past the shared memory, in rows
// of 1, 2, 4 or 8 words, with the indices' base aligned to a vector of
// SLOTS / units of them): a warp takes chunks of 32 * SLOTS output words,
// whole rows.  Lane l loads the chunk's indices as one vector (16 bytes of
// int32 at 32-byte rows) and the lanes trade them by shuffles; each lane
// then issues the SLOTS table loads of its words before any store, and the
// next chunk's index vector before it stores this one, so that every store
// writes 32 consecutive words.  The grid is persistent: the blocks that
// fit the card at once walk all the chunks.
//
// dict_decode stages the dictionary in shared memory, once per block, when
// it fits the per-block opt-in limit (227 KB on the H100; the wrapper asks
// the device for it), the counterpart of the TPU's dictionary pinned in
// VMEM.  A larger dictionary is read from device memory through the 50 MB
// L2, as take_rows reads its values.
//
// What bounds it on the H100.  Both are bound by memory bytes: each output
// row is written once, each index read once, each distinct source row read
// at least once (3.35 TB/s); there is no arithmetic.  Output writes are
// coalesced 16-byte stores where the row's bytes allow; the source reads
// land at data-dependent rows.  The indices and the output pass through
// with the streaming hints (__ldcs, __stcs), which leave L2 to the table.
// The timed variants (take_sweep.py; PERF.md section 6) suggest, without
// a counter of L2 hits to confirm it, that a table which L2 does not keep
// is read again from device memory each time a row is named: SF10's 32 B
// rows and 15 M indices reach 0.78 of the bound from a 3.2 MB table, 0.52
// from 24 MB, 0.37 from 48 MB and 0.33 from 96 MB.  The narrow kernel
// gains about 1 % there over the row groups; a flat walk of the output's
// words at every width, more blocks an SM, L2 evict_last policies on the
// table and Hopper's bulk copies through a ring in shared memory
// (cp.async.bulk, mbarriers) were each timed against this design and
// gained nothing.
//
// The caller validates every index in [0, R) before the launch and
// launches nothing for zero rows or zero row bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / 32;
constexpr int MAX_DEVICES = 64;
// narrow rows: words a lane keeps in flight, and whether the path is taken
constexpr int SLOTS = 8;
constexpr bool NARROW = true;

template <int V> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<1> { using T = uint8_t; };

// src: R rows of `units` words; idx: m row indices of type I; out: m rows.
// STAGE copies all of src (src_words words) into shared memory first.
template <typename W, typename I, bool STAGE>
__global__ void __launch_bounds__(NTHREADS)
gather_rows_kernel(const W* __restrict__ src, long long src_words,
                   long long units, int lanes_per_row,
                   const I* __restrict__ idx, long long m,
                   W* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const W* table = src;
  if (STAGE) {
    W* staged = reinterpret_cast<W*>(smem);
    for (long long t = threadIdx.x; t < src_words; t += NTHREADS)
      staged[t] = src[t];
    __syncthreads();
    table = staged;
  }
  const int lane = threadIdx.x & 31;
  const int G = lanes_per_row;
  const int step_rows = 32 / G;
  const int sub = lane / G;          // the row of a step this lane copies
  const int part = lane % G;         // its first word in that row
  const long long warp = blockIdx.x * (long long)WARPS + threadIdx.x / 32;
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long r0 = warp * 32; r0 < m; r0 += nwarps * 32) {
    const long long mine =
        r0 + lane < m ? (long long)__ldcs(idx + r0 + lane) : 0;
    for (int s = 0; s < G; ++s) {
      if (r0 + (long long)s * step_rows >= m) break;     // warp-uniform
      const int k = s * step_rows + sub;
      const long long j = __shfl_sync(0xffffffffu, mine, k);
      const long long row = r0 + k;
      if (row < m) {
        const W* from = table + j * units;
        W* to = out + row * units;
        for (long long u = part; u < units; u += G) __stcs(to + u, from[u]);
      }
    }
  }
}

// the N indices at p (p aligned to them, up to 16 bytes) by 8- or 16-byte
// vector loads, with the streaming hint
template <typename I, int N>
__device__ __forceinline__ void load_indices(const I* p, I (&v)[N]) {
  constexpr int BYTES = N * (int)sizeof(I);
  if constexpr (BYTES % 16 == 0) {
    union { uint4 q[BYTES / 16]; I i[N]; } u;
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      u.q[k] = __ldcs(reinterpret_cast<const uint4*>(p) + k);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = u.i[k];
  } else if constexpr (BYTES == 8) {
    union { uint2 q; I i[N]; } u;
    u.q = __ldcs(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = u.i[k];
  } else {
    v[0] = __ldcs(p);
  }
}

// src: rows of UNITS words; idx: m row indices of type I; out: m rows.  A
// chunk is 32 * RPL rows; lane l holds the indices of its rows RPL * l to
// RPL * l + RPL - 1.  Word 32 s + l of the chunk (slot s of lane l) is
// column l % UNITS of the chunk's row (32 s + l) / UNITS, whose index lane
// (32 s + l) / SLOTS holds as its component (l / UNITS) % RPL.
template <typename W, typename I, int UNITS>
__global__ void __launch_bounds__(NTHREADS)
gather_narrow_kernel(const W* __restrict__ src, const I* __restrict__ idx,
                     long long m, W* __restrict__ out) {
  constexpr int RPL = SLOTS / UNITS;
  static_assert(RPL * UNITS == SLOTS, "rows of 1, 2, 4 or 8 words");
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)NTHREADS + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * WARPS * 32 * RPL;
  const long long n = m * UNITS;
  const int comp = (lane / UNITS) % RPL;
  I v[RPL];
  auto indices = [&](long long r0) {
    const long long mine = r0 + (long long)RPL * lane;
    if (mine + RPL <= m) {
      load_indices<I, RPL>(idx + mine, v);
    } else {
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        v[k] = mine + k < m ? __ldcs(idx + mine + k) : I(0);
    }
  };
  long long r0 = warp * 32 * RPL;
  if (r0 >= m) return;
  indices(r0);
  for (;;) {                         // r0 is the warp's: no lane leaves
    I ix[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int from = (32 * s + lane) / SLOTS;
      ix[s] = I(0);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const I x = __shfl_sync(0xffffffffu, v[k], from);
        if (k == comp) ix[s] = x;
      }
    }
    // every table load of the chunk before any store
    const long long w0 = r0 * UNITS + lane;
    W val[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (w0 + 32 * s < n)
        val[s] = __ldg(src + (long long)ix[s] * UNITS + lane % UNITS);
    // the next chunk's indices, in flight while this one is stored
    const long long next = r0 + step;
    indices(next);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (w0 + 32 * s < n) __stcs(out + w0 + 32 * s, val[s]);
    r0 = next;
    if (r0 >= m) break;
  }
}

struct DeviceInfo {
  int sms = 0, smem_optin = 0, smem_sm = 0, smem_reserved = 0;
};

cudaError_t device_info(DeviceInfo* info) {
  static DeviceInfo cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& c = cache[dev];
  if (c.sms == 0) {
    DeviceInfo d;
    if ((err = cudaDeviceGetAttribute(&d.smem_optin,
             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaDeviceGetAttribute(&d.smem_sm,
             cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) ||
        (err = cudaDeviceGetAttribute(&d.smem_reserved,
             cudaDevAttrReservedSharedMemoryPerBlock, dev)) ||
        (err = cudaDeviceGetAttribute(&d.sms,
             cudaDevAttrMultiProcessorCount, dev)))
      return err;
    c = d;
  }
  *info = c;
  return cudaSuccess;
}

template <typename W, typename I, bool STAGE>
cudaError_t launch(const void* src, long long R, long long units,
                   const void* idx, long long m, void* out, cudaStream_t st) {
  DeviceInfo dev;
  cudaError_t err = device_info(&dev);
  if (err != cudaSuccess) return err;
  auto kernel = gather_rows_kernel<W, I, STAGE>;
  const long long src_words = R * units;
  size_t smem = 0;
  int per_sm = 2048 / NTHREADS;
  if (STAGE) {
    smem = (size_t)src_words * sizeof(W);
    if (smem > (size_t)dev.smem_optin) return cudaErrorInvalidValue;
    static bool opted_in = false;    // once, before any graph capture
    if (!opted_in) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dev.smem_optin);
      if (err != cudaSuccess) return err;
      opted_in = true;
    }
    int fit = (int)(dev.smem_sm / (smem + dev.smem_reserved));
    per_sm = fit < per_sm ? (fit < 1 ? 1 : fit) : per_sm;
  }
  int G = 1;
  while (G < units && G < 32) G <<= 1;
  const long long need = (m + 32LL * WARPS - 1) / (32LL * WARPS);
  const long long cap = (long long)dev.sms * per_sm;
  const int blocks = (int)(need < cap ? need : cap);
  kernel<<<blocks, NTHREADS, smem, st>>>(
      static_cast<const W*>(src), src_words, units, G,
      static_cast<const I*>(idx), m, static_cast<W*>(out));
  return cudaGetLastError();
}

template <typename W, typename I, int UNITS>
cudaError_t launch_narrow(const void* src, const void* idx, long long m,
                          void* out, cudaStream_t st) {
  DeviceInfo dev;
  cudaError_t err = device_info(&dev);
  if (err != cudaSuccess) return err;
  auto kernel = gather_narrow_kernel<W, I, UNITS>;
  static int fit = 0;                // once, before any graph capture
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        NTHREADS, 0);
    if (err != cudaSuccess) return err;
    if (fit < 1) fit = 1;
  }
  const long long rows = 32LL * WARPS * (SLOTS / UNITS);   // a block's
  const long long need = (m + rows - 1) / rows;
  const long long cap = (long long)dev.sms * fit;
  kernel<<<(int)(need < cap ? need : cap), NTHREADS, 0, st>>>(
      static_cast<const W*>(src), static_cast<const I*>(idx), m,
      static_cast<W*>(out));
  return cudaGetLastError();
}

// the narrow path where rows are 1, 2, 4 or 8 words and the indices' base
// is aligned to a vector of SLOTS / units of them (up to 16 bytes), else
// the row-group path
template <typename W, typename I, bool STAGE>
cudaError_t by_path(const void* src, long long R, long long units,
                    const void* idx, long long m, void* out,
                    cudaStream_t st) {
  const long long vec = units <= SLOTS && SLOTS % units == 0
                            ? SLOTS / units * (long long)sizeof(I) : 0;
  if (NARROW && !STAGE && vec && (uintptr_t)idx % (vec < 16 ? vec : 16) == 0)
    switch (units) {
      case 1: return launch_narrow<W, I, 1>(src, idx, m, out, st);
      case 2: return launch_narrow<W, I, 2>(src, idx, m, out, st);
      case 4: return launch_narrow<W, I, 4>(src, idx, m, out, st);
      case 8: return launch_narrow<W, I, 8>(src, idx, m, out, st);
    }
  return launch<W, I, STAGE>(src, R, units, idx, m, out, st);
}

template <int V>
cudaError_t by_index(const void* src, long long R, long long row_bytes,
                     const void* idx, int idx_bytes, long long m, void* out,
                     int stage, cudaStream_t st) {
  using W = typename Word<V>::T;
  const long long units = row_bytes / V;
  if (idx_bytes == 4)
    return stage ? by_path<W, int32_t, true>(src, R, units, idx, m, out, st)
                 : by_path<W, int32_t, false>(src, R, units, idx, m, out, st);
  if (idx_bytes == 8)
    return stage ? by_path<W, int64_t, true>(src, R, units, idx, m, out, st)
                 : by_path<W, int64_t, false>(src, R, units, idx, m, out, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The shared memory one block may opt in to on the current device, in
// bytes (the largest dictionary dict_decode stages).
extern "C" int take_gather_smem_limit(int* bytes) {
  DeviceInfo dev;
  cudaError_t err = device_info(&dev);
  if (err == cudaSuccess) *bytes = dev.smem_optin;
  return (int)err;
}

// out[i] = src[idx[i]] for m >= 1 rows of row_bytes >= 1 bytes; src holds
// R rows; idx holds m int32 (idx_bytes 4) or int64 (8) indices, all in
// [0, R).  stage != 0 stages src in shared memory (its R * row_bytes must
// fit take_gather_smem_limit).  Returns the cudaError_t of the launch.
extern "C" int gather_rows(const void* src, long long R, long long row_bytes,
                           const void* idx, int idx_bytes, long long m,
                           void* out, int stage, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || row_bytes < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const unsigned long long align =
      (unsigned long long)row_bytes | (uintptr_t)src | (uintptr_t)out;
  if (align % 16 == 0)
    return (int)by_index<16>(src, R, row_bytes, idx, idx_bytes, m, out,
                             stage, st);
  if (align % 8 == 0)
    return (int)by_index<8>(src, R, row_bytes, idx, idx_bytes, m, out,
                            stage, st);
  if (align % 4 == 0)
    return (int)by_index<4>(src, R, row_bytes, idx, idx_bytes, m, out,
                            stage, st);
  if (align % 2 == 0)
    return (int)by_index<2>(src, R, row_bytes, idx, idx_bytes, m, out,
                            stage, st);
  return (int)by_index<1>(src, R, row_bytes, idx, idx_bytes, m, out, stage,
                          st);
}
