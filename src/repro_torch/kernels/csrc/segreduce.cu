// Segment reductions over sorted group ranges, hand-written CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/relational.py::_segreduce_kernel
// (pallas_call at relational.py:333, launched by _segreduce), behind
// grouped_count / grouped_sum / grouped_min / grouped_max.  The reference
// semantics are repro's core/vkernels.py (grouped_*): rows are visited in
// the sorted order `order`, group g spans sorted positions
// [starts[g], starts[g + 1]) (the last one ends at n), null rows (valid[r]
// == 0) are left out, and for every group
//   cnt[g]  = its number of non-null rows (int64);
//   sum     = the wrapping 64-bit sum of its values, sign-extended from a
//             signed type, zero-extended from an unsigned one or bool
//             (so an int64 or uint64 total that overflows wraps, as numpy's
//             reduceat does);
//   min/max = its extreme value, compared as signed 64-bit words, or as
//             unsigned ones for uint64; bool is read as uint8; a group with
//             no non-null row keeps the sentinel (the type's max for min,
//             its min for max).
// Integer addition and integer extremes do not depend on the order of the
// reduction, so the atomics below give the reference's bits exactly.  Float
// values never come here: the dispatch registry keeps them on the host.
//
// Design.  The TPU kernel builds a (row block x group block) one-hot mask
// and revisits each group block's accumulator across the whole row sweep,
// which costs n x G work.  Here the sorted domain makes every group a
// contiguous run of positions, so no mask is needed:
//   * each block owns a tile of TILE consecutive sorted positions; the
//     groups it touches are a contiguous range of at most TILE ids (every
//     group has a row), with one slot each in shared memory;
//   * each thread takes ITEMS consecutive positions, issues all their
//     gathers vals[order[p]] and valid[order[p]] into registers first,
//     finds its first group by binary search in `starts` and folds each
//     run in registers, flushing a run to its shared slot with one
//     shared-memory atomic;
//   * the block then commits one 64-bit global atomic per (tile, group) for
//     the count and one for the value (atomicAdd on unsigned long long for
//     wrapping sums, atomicMin/atomicMax on long long or unsigned long
//     long).
// A first small kernel sets the outputs to the identity (0 or the sentinel).
// A count with no validity mask reads no row at all: one small kernel
// takes each group's size from `starts`.
//
// What bounds it on the H100.  Apart from that count, per row it reads the 8-byte order entry, the
// value (w bytes) and the validity byte; per group it writes 16 bytes.  The
// value and validity reads are gathers through `order` (a sort permutation,
// so random), each costing a 32-byte sector, so the kernel runs below the
// byte bound that counts each byte once.  The group search is log2(G) reads
// of `starts` per thread, served by L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = NTHREADS * ITEMS;  // sorted positions per block
constexpr int OP_COUNT = 0, OP_SUM = 1, OP_MIN = 2, OP_MAX = 3;

template <typename T> struct Lim;
template <> struct Lim<int8_t> {
  static constexpr long long lo = -128LL, hi = 127LL;
};
template <> struct Lim<int16_t> {
  static constexpr long long lo = -32768LL, hi = 32767LL;
};
template <> struct Lim<int32_t> {
  static constexpr long long lo = -2147483648LL, hi = 2147483647LL;
};
template <> struct Lim<int64_t> {
  static constexpr long long lo = (-9223372036854775807LL - 1),
                             hi = 9223372036854775807LL;
};
template <> struct Lim<uint8_t> {
  static constexpr long long lo = 0, hi = 255LL;
};
template <> struct Lim<uint16_t> {
  static constexpr long long lo = 0, hi = 65535LL;
};
template <> struct Lim<uint32_t> {
  static constexpr long long lo = 0, hi = 4294967295LL;
};
template <> struct Lim<uint64_t> {
  static constexpr unsigned long long lo = 0, hi = 0xFFFFFFFFFFFFFFFFull;
};

// The 64-bit word a group's value is kept in: wrapping sums in unsigned
// long long; extremes in long long, or unsigned long long for uint64.
template <typename T, int OP> struct Acc { using type = long long; };
template <typename T> struct Acc<T, OP_SUM> {
  using type = unsigned long long;
};
template <> struct Acc<uint64_t, OP_MIN> { using type = unsigned long long; };
template <> struct Acc<uint64_t, OP_MAX> { using type = unsigned long long; };

template <typename T, int OP>
__device__ __forceinline__ typename Acc<T, OP>::type identity() {
  using A = typename Acc<T, OP>::type;
  if constexpr (OP == OP_MIN) return (A)Lim<T>::hi;
  else if constexpr (OP == OP_MAX) return (A)Lim<T>::lo;
  else return (A)0;
}

template <typename T, int OP>
__device__ __forceinline__ typename Acc<T, OP>::type widen(T x) {
  using A = typename Acc<T, OP>::type;
  // a signed T sign-extends through long long, an unsigned one zero-extends
  return (A)(typename Acc<T, OP_MIN>::type)x;
}

template <int OP, typename A>
__device__ __forceinline__ A fold(A a, A b) {
  if constexpr (OP == OP_SUM) return a + b;
  else if constexpr (OP == OP_MIN) return b < a ? b : a;
  else return b > a ? b : a;
}

template <int OP, typename A>
__device__ __forceinline__ void atomic_fold(A* p, A v) {
  if constexpr (OP == OP_SUM) atomicAdd(p, v);
  else if constexpr (OP == OP_MIN) atomicMin(p, v);
  else atomicMax(p, v);
}

// largest g with starts[g] <= p (starts[0] == 0 <= p)
__device__ __forceinline__ long long find_group(const long long* starts,
                                                long long G, long long p) {
  long long lo = 0, hi = G - 1;
  while (lo < hi) {
    long long mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= p) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <typename T, int OP>
__global__ void init_kernel(typename Acc<T, OP>::type* __restrict__ acc,
                            unsigned long long* __restrict__ cnt, long long G) {
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < G;
       g += (long long)gridDim.x * blockDim.x) {
    if constexpr (OP != OP_COUNT) acc[g] = identity<T, OP>();
    cnt[g] = 0;
  }
}

// A count with no validity needs no row: group g has
// starts[g + 1] - starts[g] rows (the last one n - starts[g]).
__global__ void count_runs_kernel(const long long* __restrict__ starts,
                                  long long n, long long G,
                                  unsigned long long* __restrict__ cnt) {
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < G;
       g += (long long)gridDim.x * blockDim.x)
    cnt[g] = (unsigned long long)((g + 1 < G ? starts[g + 1] : n) - starts[g]);
}

template <typename T, int OP>
__global__ void __launch_bounds__(NTHREADS)
segreduce_kernel(const T* __restrict__ vals, const long long* __restrict__ order,
                 const uint8_t* __restrict__ valid,
                 const long long* __restrict__ starts, long long n, long long G,
                 typename Acc<T, OP>::type* __restrict__ acc,
                 unsigned long long* __restrict__ cnt) {
  using A = typename Acc<T, OP>::type;
  __shared__ A s_acc[TILE];
  __shared__ unsigned long long s_cnt[TILE];
  __shared__ long long s_g0, s_span;

  const long long t0 = blockIdx.x * (long long)TILE;
  const long long t1 = t0 + TILE < n ? t0 + TILE : n;
  if (threadIdx.x == 0) {
    s_g0 = find_group(starts, G, t0);
    s_span = find_group(starts, G, t1 - 1) - s_g0 + 1;
  }
  __syncthreads();
  const long long g0 = s_g0, span = s_span;
  for (long long k = threadIdx.x; k < span; k += NTHREADS) {
    if constexpr (OP != OP_COUNT) s_acc[k] = identity<T, OP>();
    s_cnt[k] = 0;
  }
  __syncthreads();

  const long long p0 = t0 + (long long)threadIdx.x * ITEMS;
  const long long pend = p0 + ITEMS < t1 ? p0 + ITEMS : t1;
  if (p0 < pend) {
    // issue all of this thread's gathers before folding any of them, so
    // that ITEMS loads are in flight at once and not one after another
    const int k = (int)(pend - p0);
    long long rows[ITEMS];
    A x[ITEMS];
    bool ok[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) rows[i] = i < k ? order[p0 + i] : 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      ok[i] = i < k && (valid == nullptr || valid[rows[i]]);
      if constexpr (OP != OP_COUNT)
        x[i] = i < k ? widen<T, OP>(vals[rows[i]]) : identity<T, OP>();
    }
    long long g = find_group(starts, G, p0);
    long long next = g + 1 < G ? starts[g + 1] : n;
    A run = identity<T, OP>();
    unsigned long long rc = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (i >= k) break;
      const long long p = p0 + i;
      if (p >= next) {  // a run ends: flush it to its shared slot
        if (rc) {
          atomicAdd(&s_cnt[g - g0], rc);
          if constexpr (OP != OP_COUNT) atomic_fold<OP>(&s_acc[g - g0], run);
        }
        do {
          ++g;
          next = g + 1 < G ? starts[g + 1] : n;
        } while (p >= next);
        run = identity<T, OP>();
        rc = 0;
      }
      if (ok[i]) {
        ++rc;
        if constexpr (OP != OP_COUNT) run = fold<OP>(run, x[i]);
      }
    }
    if (rc) {
      atomicAdd(&s_cnt[g - g0], rc);
      if constexpr (OP != OP_COUNT) atomic_fold<OP>(&s_acc[g - g0], run);
    }
  }
  __syncthreads();

  for (long long k = threadIdx.x; k < span; k += NTHREADS) {
    if (s_cnt[k] == 0) continue;  // nothing of this group is in the tile
    atomicAdd(&cnt[g0 + k], s_cnt[k]);
    if constexpr (OP != OP_COUNT) atomic_fold<OP>(&acc[g0 + k], s_acc[k]);
  }
}

template <typename T, int OP>
cudaError_t launch(const void* vals, const void* order, const void* valid,
                   const void* starts, long long n, long long G, void* acc,
                   void* cnt, cudaStream_t st) {
  using A = typename Acc<T, OP>::type;
  long long ib = (G + NTHREADS - 1) / NTHREADS;
  if (ib > 4096) ib = 4096;
  if (OP == OP_COUNT && valid == nullptr) {
    count_runs_kernel<<<(int)ib, NTHREADS, 0, st>>>(
        static_cast<const long long*>(starts), n, G,
        static_cast<unsigned long long*>(cnt));
    return cudaGetLastError();
  }
  init_kernel<T, OP><<<(int)ib, NTHREADS, 0, st>>>(
      static_cast<A*>(acc), static_cast<unsigned long long*>(cnt), G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long long blocks = (n + TILE - 1) / TILE;
  segreduce_kernel<T, OP><<<(unsigned)blocks, NTHREADS, 0, st>>>(
      static_cast<const T*>(vals), static_cast<const long long*>(order),
      static_cast<const uint8_t*>(valid), static_cast<const long long*>(starts),
      n, G, static_cast<A*>(acc), static_cast<unsigned long long*>(cnt));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* vals, const void* order,
                      const void* valid, const void* starts, long long n,
                      long long G, void* acc, void* cnt, cudaStream_t st) {
  switch (op) {
    case OP_SUM:
      return launch<T, OP_SUM>(vals, order, valid, starts, n, G, acc, cnt, st);
    case OP_MIN:
      return launch<T, OP_MIN>(vals, order, valid, starts, n, G, acc, cnt, st);
    case OP_MAX:
      return launch<T, OP_MAX>(vals, order, valid, starts, n, G, acc, cnt, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// op: 0 count, 1 sum, 2 min, 3 max.  vals: n values of `width` bytes
// (`is_signed` says how they widen; unused for count, may be null); order:
// n int64, a permutation of [0, n); valid: n bytes (0 = null) or null;
// starts: G int64, starts[0] == 0, strictly increasing, < n; n >= 1,
// G >= 1.  acc: G 64-bit words (int64, or uint64 bits for a uint64 min/max
// and for every sum), unused for count; cnt: G int64.  Returns the
// cudaError_t of the launches; cudaErrorInvalidValue for an op or width the
// kernel does not take.
extern "C" int segreduce(int op, const void* vals, int width, int is_signed,
                         const void* order, const void* valid,
                         const void* starts, long long n, long long G,
                         void* acc, void* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == OP_COUNT)
    return (int)launch<uint8_t, OP_COUNT>(nullptr, order, valid, starts, n, G,
                                          acc, cnt, st);
  switch (width * 2 + (is_signed ? 1 : 0)) {
    case 2: return (int)launch_op<uint8_t>(op, vals, order, valid, starts, n, G, acc, cnt, st);
    case 3: return (int)launch_op<int8_t>(op, vals, order, valid, starts, n, G, acc, cnt, st);
    case 4: return (int)launch_op<uint16_t>(op, vals, order, valid, starts, n, G, acc, cnt, st);
    case 5: return (int)launch_op<int16_t>(op, vals, order, valid, starts, n, G, acc, cnt, st);
    case 8: return (int)launch_op<uint32_t>(op, vals, order, valid, starts, n, G, acc, cnt, st);
    case 9: return (int)launch_op<int32_t>(op, vals, order, valid, starts, n, G, acc, cnt, st);
    case 16: return (int)launch_op<uint64_t>(op, vals, order, valid, starts, n, G, acc, cnt, st);
    case 17: return (int)launch_op<int64_t>(op, vals, order, valid, starts, n, G, acc, cnt, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
