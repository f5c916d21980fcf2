// Segment reductions over sorted group ranges, hand-written CUDA C++ for
// Hopper (sm_90a): every requested aggregate of one column in one launch.
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
// The TPU kernel's n x G one-hot reduction is not carried over.
//
// What bounds it on the H100, and what the design does about it.  A
// group-by asks for several aggregates of one column (the star query: count,
// sum, min and max of `amount`), and the least it must move is `order` and
// the values read once (16 bytes a row for int64) and each result written
// once.  Four costs stood above that in the kernel this file replaces:
//   1. one launch per aggregate, so sum, min and max each made a full pass;
//   2. each pass gathered vals[order[p]] and valid[order[p]]: within a group
//      the rows of a stable sort rise with gaps of about G rows, so every
//      8-byte value cost its own 32-byte sector, fetched again by each
//      group's sweep once the values outgrew the 50 MB L2;
//   3. the host copied `order` and the values to the card for each pass
//      (the wrappers in kdispatch now copy them once per column);
//   4. its bound added up the passes.
// Here one launch computes every requested op (count always, sum, and min
// with max together), on a path the caller picks (the C entry's `path`):
//   * few groups (G <= PRIVATE_MAX = 32): rows in their own order.  Pass
//     one reads `order` coalesced and scatters one byte per row,
//     map[order[p]] = g (15 MB at 15 M rows, into L2 after a memset to
//     0xFF); pass two streams the values, validity and map in row order, so
//     no permutation gather is left and the values cross HBM once, with
//     every sector used in full (a warp reads 32 consecutive elements an
//     instruction, evict-first; every load of a thread is issued before any
//     is used).  Group ids stop at 31, so a byte still 0xFF in pass two
//     marks a row that no position names: `order` is not a permutation,
//     pass two raises a flag and the wrapper raises.  In pass two each
//     thread keeps its own count, sum, min and max for every group in shared
//     memory, laid out [group][thread] so that a warp's 32 accesses hit 32
//     banks whatever groups its rows fall in; a row costs its thread a few
//     shared loads and stores and no atomic.  28 bytes a group and thread
//     fill 224 KB at G = 32, one block of 8 warps an SM, on a persistent
//     grid (one block on each of the 132 SMs); the next chunk's loads go
//     out before a chunk is folded.  The threads of a block combine in
//     shared memory, then one global atomic per (block, group, op) commits
//     each result.  At the star query's shape the scatter of pass one is
//     the larger half: about 12 M partial-sector writes into L2.  A warp
//     that kept its groups in registers, lane g % 32 owning group g and
//     every row broadcast to its owner by __shfl_sync, was bound by
//     instruction issue (all 32 lanes run every row's shuffles) and lost
//     to this form up to 32 groups and to the sorted-run pass from 33 to
//     255 on the H100 (PERF.md, Findings), so it is not kept;
//   * many groups (any G; the wrapper's pick above 32): the sorted-run pass.
//     Each block owns a tile of RUN_TILE consecutive sorted positions,
//     gathers their rows' values and validity into registers first, folds
//     each run of one group in registers, flushes it to the group's shared
//     slot, and commits one global atomic per (tile, group, op).  It still
//     pays the gather of point 2, but once for all ops.  It reads the
//     rows through `order` as the plain version does, so an `order` that
//     is not a permutation gives the plain version's result and needs no
//     flag.
// A count with no validity mask reads no row: one small kernel takes each
// group's size from `starts`.  A small kernel first sets the outputs to 0
// or the type's sentinel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads a block (map, private)
constexpr int PRIVATE_MAX = 32;     // groups of the few-groups path
constexpr int MAP_ITEMS = 8;        // sorted positions a thread, pass one
constexpr int PRIVATE_ITEMS = 16;   // rows a thread loads before folding
constexpr int RUN_NT = 128;         // threads a block, sorted-run pass
constexpr int RUN_ITEMS = 8;        // sorted positions a thread
constexpr int RUN_TILE = RUN_NT * RUN_ITEMS;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SKIP = 0xffffu;  // a null or padding row
constexpr uint8_t UNWRITTEN = 0xff;
constexpr long long BIG = 9223372036854775807LL, SMALL = -BIG - 1;
enum Path { PATH_RUNS = 0, PATH_PRIVATE = 1 };
enum Want { WANT_SUM = 1, WANT_MIN = 2, WANT_MAX = 4 };

struct Args {
  const void* vals;            // n values of W bytes; null for a count
  const long long* order;      // n rows in sorted order
  const uint8_t* valid;        // n bytes, 0 = null; or null
  const long long* starts;     // G group starts
  long long n, G;
  bool sext;                   // sign-extend narrow values
  long long flip;              // INT64_MIN for uint64 extremes, else 0
  unsigned long long* sum;     // G results each, or null when not asked
  long long* mn;
  long long* mx;
  unsigned long long* cnt;     // G counts
  uint8_t* map;                // n group ids by row (few-groups path)
  int* bad;                    // set when a row has no group id
};

template <int W> struct Word;
template <> struct Word<1> { using type = uint8_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<8> { using type = unsigned long long; };

// element i as a 64-bit word: sign-extended when `sext`, else zero-extended
template <int W>
__device__ __forceinline__ unsigned long long extend(unsigned long long x,
                                                     bool sext) {
  if constexpr (W < 8) {
    constexpr int s = 64 - 8 * W;
    if (sext) x = (unsigned long long)((long long)(x << s) >> s);
  }
  return x;
}

template <int W>   // streamed once: evict-first
__device__ __forceinline__ unsigned long long stream_word(const void* v,
                                                          long long i,
                                                          bool sext) {
  using U = typename Word<W>::type;
  return extend<W>(__ldcs(static_cast<const U*>(v) + i), sext);
}

template <int W>   // gathered through `order`: other groups may reuse it
__device__ __forceinline__ unsigned long long gather_word(const void* v,
                                                          long long i,
                                                          bool sext) {
  using U = typename Word<W>::type;
  return extend<W>(__ldg(static_cast<const U*>(v) + i), sext);
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

// One block's results for group g into the outputs: min and max arrive as
// signed words (uint64 ones with the sign bit flipped) and leave in the
// output's order.
__device__ __forceinline__ void commit(const Args& a, long long g,
                                       unsigned long long c,
                                       unsigned long long s, long long lo,
                                       long long hi) {
  if (c == 0) return;
  atomicAdd(&a.cnt[g], c);
  if (a.sum) atomicAdd(&a.sum[g], s);
  if (a.flip) {
    if (a.mn)
      atomicMin(reinterpret_cast<unsigned long long*>(&a.mn[g]),
                (unsigned long long)(lo ^ a.flip));
    if (a.mx)
      atomicMax(reinterpret_cast<unsigned long long*>(&a.mx[g]),
                (unsigned long long)(hi ^ a.flip));
  } else {
    if (a.mn) atomicMin(&a.mn[g], lo);
    if (a.mx) atomicMax(&a.mx[g], hi);
  }
}

__global__ void init_kernel(Args a, long long mn0, long long mx0) {
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < a.G; g += (long long)gridDim.x * blockDim.x) {
    a.cnt[g] = 0;
    if (a.sum) a.sum[g] = 0;
    if (a.mn) a.mn[g] = mn0;
    if (a.mx) a.mx[g] = mx0;
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

// ---------------------------------------------------------------- many groups

// A run of one group into the group's shared slot k (nothing if it had no
// non-null row).
template <bool SUM, bool EXT>
__device__ __forceinline__ void flush_run(unsigned long long* s_cnt,
                                          unsigned long long* s_sum,
                                          long long* s_lo, long long* s_hi,
                                          long long k, unsigned long long rc,
                                          unsigned long long rs, long long rlo,
                                          long long rhi) {
  if (rc == 0) return;
  atomicAdd(&s_cnt[k], rc);
  if constexpr (SUM) atomicAdd(&s_sum[k], rs);
  if constexpr (EXT) {
    atomicMin(&s_lo[k], rlo);
    atomicMax(&s_hi[k], rhi);
  }
}

template <int W, bool SUM, bool EXT>
__global__ void __launch_bounds__(RUN_NT) runs_kernel(Args a) {
  __shared__ unsigned long long s_cnt[RUN_TILE];
  __shared__ unsigned long long s_sum[SUM ? RUN_TILE : 1];
  __shared__ long long s_lo[EXT ? RUN_TILE : 1], s_hi[EXT ? RUN_TILE : 1];
  __shared__ long long s_g0, s_span;

  const long long t0 = blockIdx.x * (long long)RUN_TILE;
  const long long t1 = t0 + RUN_TILE < a.n ? t0 + RUN_TILE : a.n;
  if (threadIdx.x == 0) {
    s_g0 = find_group(a.starts, a.G, t0);
    s_span = find_group(a.starts, a.G, t1 - 1) - s_g0 + 1;
  }
  __syncthreads();
  const long long g0 = s_g0, span = s_span;
  for (long long k = threadIdx.x; k < span; k += RUN_NT) {
    s_cnt[k] = 0;
    if constexpr (SUM) s_sum[k] = 0;
    if constexpr (EXT) { s_lo[k] = BIG; s_hi[k] = SMALL; }
  }
  __syncthreads();

  const long long p0 = t0 + (long long)threadIdx.x * RUN_ITEMS;
  const long long pend = p0 + RUN_ITEMS < t1 ? p0 + RUN_ITEMS : t1;
  if (p0 < pend) {
    // issue all of this thread's gathers before folding any of them, so
    // that RUN_ITEMS loads are in flight at once and not one after another
    const int k = (int)(pend - p0);
    long long rows[RUN_ITEMS];
    unsigned long long x[RUN_ITEMS];
    bool ok[RUN_ITEMS];
#pragma unroll
    for (int i = 0; i < RUN_ITEMS; ++i) rows[i] = i < k ? a.order[p0 + i] : 0;
#pragma unroll
    for (int i = 0; i < RUN_ITEMS; ++i) {
      ok[i] = i < k && (a.valid == nullptr || __ldg(a.valid + rows[i]));
      x[i] = 0;
      if constexpr (SUM || EXT)
        if (i < k) x[i] = gather_word<W>(a.vals, rows[i], a.sext);
    }
    long long g = find_group(a.starts, a.G, p0);
    long long next = g + 1 < a.G ? a.starts[g + 1] : a.n;
    unsigned long long rc = 0, rs = 0;
    long long rlo = BIG, rhi = SMALL;
#pragma unroll
    for (int i = 0; i < RUN_ITEMS; ++i) {
      if (i >= k) break;
      const long long p = p0 + i;
      if (p >= next) {   // a run ends: into its group's shared slot
        flush_run<SUM, EXT>(s_cnt, s_sum, s_lo, s_hi, g - g0, rc, rs, rlo,
                            rhi);
        do {
          ++g;
          next = g + 1 < a.G ? a.starts[g + 1] : a.n;
        } while (p >= next);
        rc = rs = 0;
        rlo = BIG;
        rhi = SMALL;
      }
      if (ok[i]) {
        ++rc;
        if constexpr (SUM) rs += x[i];
        if constexpr (EXT) {
          const long long c = (long long)(x[i] ^ a.flip);
          rlo = c < rlo ? c : rlo;
          rhi = c > rhi ? c : rhi;
        }
      }
    }
    flush_run<SUM, EXT>(s_cnt, s_sum, s_lo, s_hi, g - g0, rc, rs, rlo, rhi);
  }
  __syncthreads();

  for (long long k = threadIdx.x; k < span; k += RUN_NT)
    commit(a, g0 + k, s_cnt[k], SUM ? s_sum[k] : 0, EXT ? s_lo[k] : 0,
           EXT ? s_hi[k] : 0);
}

// ----------------------------------------------------------------- few groups

// Pass one: map[order[p]] = the group of sorted position p.  `order` is read
// coalesced; a tile inside one group (all but G - 1 tiles) needs no search.
__global__ void __launch_bounds__(NT) map_kernel(Args a) {
  __shared__ long long s_st[PRIVATE_MAX];
  const int G = (int)a.G;
  for (int i = threadIdx.x; i < G; i += NT) s_st[i] = a.starts[i];
  __syncthreads();
  const long long t0 = blockIdx.x * (long long)(NT * MAP_ITEMS);
  const long long t1 = t0 + NT * MAP_ITEMS < a.n ? t0 + NT * MAP_ITEMS : a.n;
  const long long g0 = find_group(s_st, G, t0);
  const long long g1 = find_group(s_st, G, t1 - 1);
  long long r[MAP_ITEMS];
#pragma unroll
  for (int k = 0; k < MAP_ITEMS; ++k) {   // every load out at once
    const long long p = t0 + k * NT + threadIdx.x;
    r[k] = __ldcs(a.order + (p < t1 ? p : t1 - 1));
  }
#pragma unroll
  for (int k = 0; k < MAP_ITEMS; ++k) {
    const long long p = t0 + k * NT + threadIdx.x;
    if (p < t1)
      a.map[r[k]] = (uint8_t)(g0 == g1 ? g0 : find_group(s_st, G, p));
  }
}

// Pass two's loads for ITEMS rows i = base + k * stride: each row's value
// word and its key, the group id or SKIP for a null row or one past n; a
// map byte still UNWRITTEN raises `bad`.  A row past n loads row n - 1, so
// that every load is issued at once, none behind a branch.
template <int W, bool VALS, int ITEMS>
__device__ __forceinline__ void load_rows(const Args& a, long long base,
                                          int stride,
                                          unsigned long long (&x)[ITEMS],
                                          unsigned (&key)[ITEMS], bool& bad) {
  unsigned m[ITEMS];
  bool ok[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (long long)k * stride;
    const long long r = i < a.n ? i : a.n - 1;
    m[k] = a.map[r];
    if constexpr (VALS) x[k] = stream_word<W>(a.vals, r, a.sext);
    else x[k] = 0;
  }
  if (a.valid) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = base + (long long)k * stride;
      ok[k] = __ldcs(a.valid + (i < a.n ? i : a.n - 1));
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) ok[k] = true;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool in = base + (long long)k * stride < a.n;
    bad |= in && m[k] == UNWRITTEN;
    key[k] = in && ok[k] && m[k] != UNWRITTEN ? m[k] : SKIP;
  }
}

// Pass two: thread t keeps group g's accumulators at
// [g * NT + t] of each shared array.
template <int W, bool SUM, bool EXT>
__global__ void __launch_bounds__(NT) private_kernel(Args a) {
  extern __shared__ unsigned long long smem[];
  const int G = (int)a.G, t = threadIdx.x;
  unsigned long long* s_sum = smem;
  long long* s_lo = reinterpret_cast<long long*>(smem + (SUM ? G * NT : 0));
  long long* s_hi = s_lo + (EXT ? G * NT : 0);
  unsigned* s_cnt = reinterpret_cast<unsigned*>(s_hi + (EXT ? G * NT : 0));
  for (int g = 0; g < G; ++g) {
    s_cnt[g * NT + t] = 0;
    if constexpr (SUM) s_sum[g * NT + t] = 0;
    if constexpr (EXT) { s_lo[g * NT + t] = BIG; s_hi[g * NT + t] = SMALL; }
  }
  bool bad = false;
  const long long chunk = (long long)NT * PRIVATE_ITEMS;
  const long long stride = (long long)gridDim.x * chunk;
  long long c0 = blockIdx.x * chunk;
  unsigned long long x[PRIVATE_ITEMS], xn[PRIVATE_ITEMS];
  unsigned key[PRIVATE_ITEMS], kn[PRIVATE_ITEMS];
  if (c0 < a.n) load_rows<W, SUM || EXT>(a, c0 + t, NT, xn, kn, bad);
  for (; c0 < a.n; c0 += stride) {
#pragma unroll
    for (int k = 0; k < PRIVATE_ITEMS; ++k) {
      x[k] = xn[k];
      key[k] = kn[k];
    }
    // the next chunk's loads go out before this one is folded
    if (c0 + stride < a.n)
      load_rows<W, SUM || EXT>(a, c0 + stride + t, NT, xn, kn, bad);
#pragma unroll
    for (int k = 0; k < PRIVATE_ITEMS; ++k) {
      if (key[k] == SKIP) continue;
      const int j = key[k] * NT + t;
      s_cnt[j] += 1;
      if constexpr (SUM) s_sum[j] += x[k];
      if constexpr (EXT) {
        const long long c = (long long)(x[k] ^ a.flip);
        if (c < s_lo[j]) s_lo[j] = c;
        if (c > s_hi[j]) s_hi[j] = c;
      }
    }
  }
  if (bad) *a.bad = 1;
  __syncthreads();
  // warp w folds groups w, w + 8, ...: each lane 8 threads' slots, then the
  // warp by shuffles; lane 0 commits
  const int lane = t & 31;
  for (int g = t >> 5; g < G; g += NT / 32) {
    unsigned long long c = 0, s = 0;
    long long lo = BIG, hi = SMALL;
    for (int j = g * NT + lane; j < (g + 1) * NT; j += 32) {
      c += s_cnt[j];
      if constexpr (SUM) s += s_sum[j];
      if constexpr (EXT) {
        lo = s_lo[j] < lo ? s_lo[j] : lo;
        hi = s_hi[j] > hi ? s_hi[j] : hi;
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      c += __shfl_xor_sync(FULL, c, off);
      if constexpr (SUM) s += __shfl_xor_sync(FULL, s, off);
      if constexpr (EXT) {
        const long long l = __shfl_xor_sync(FULL, lo, off);
        const long long h = __shfl_xor_sync(FULL, hi, off);
        lo = l < lo ? l : lo;
        hi = h > hi ? h : hi;
      }
    }
    if (lane == 0) commit(a, g, c, s, lo, hi);
  }
}

// ------------------------------------------------------------------- launches

// As many blocks of `kernel` as fit on the card at once, but no more than
// `rows` need at `per_block` rows each.
template <typename K>
cudaError_t launch_persistent(K kernel, size_t smem, long long per_block,
                              const Args& a, cudaStream_t st) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (a.n + per_block - 1) / per_block;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  kernel<<<(unsigned)blocks, NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <int W, bool SUM, bool EXT>
cudaError_t launch_path(int path, const Args& a, cudaStream_t st) {
  if (path == PATH_RUNS) {
    const long long blocks = (a.n + RUN_TILE - 1) / RUN_TILE;
    runs_kernel<W, SUM, EXT><<<(unsigned)blocks, RUN_NT, 0, st>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)a.G * NT * (4 + (SUM ? 8 : 0) + (EXT ? 16 : 0));
  return launch_persistent(private_kernel<W, SUM, EXT>, smem,
                           (long long)NT * PRIVATE_ITEMS, a, st);
}

template <int W>
cudaError_t launch_ops(int path, int want, const Args& a, cudaStream_t st) {
  const bool sum = want & WANT_SUM, ext = want & (WANT_MIN | WANT_MAX);
  if (sum && ext) return launch_path<W, true, true>(path, a, st);
  if (sum) return launch_path<W, true, false>(path, a, st);
  return launch_path<W, false, true>(path, a, st);   // want != 0 here
}

}  // namespace

// path: 0 the sorted-run pass (any G), 1 few groups in private slots
// (G <= 32).  want: the ops besides the
// count, bits 1 sum, 2 min, 4 max (0: a count alone).  vals: n values of
// `width` bytes (`is_signed` says how they widen; null for a count alone);
// order: n int64, a permutation of [0, n) (may be null for a count alone
// with no validity); valid: n bytes (0 = null) or null; starts: G int64,
// starts[0] == 0, strictly increasing, < n; n >= 1, G >= 1.  sum, mn, mx:
// G 64-bit words each for the ops in `want` (uint64 bits for every sum and
// for uint64 extremes; the other extremes sign- or zero-extended), else
// null; cnt: G int64.  map: n bytes of scratch and bad: one int32, both on
// the card, for path 1 (null for path 0); after the launches *bad
// is 1 if `order` named some row twice.  Returns the cudaError_t of the
// launches; cudaErrorInvalidValue for a path, width or G they do not take.
extern "C" int segreduce(int path, int want, const void* vals, int width,
                         int is_signed, const void* order, const void* valid,
                         const void* starts, long long n, long long G,
                         void* sum, void* mn, void* mx, void* cnt, void* map,
                         void* bad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || G < 1 || (want & ~7) || path < 0 || path > 1)
    return (int)cudaErrorInvalidValue;
  const long long ib = (G + NT - 1) / NT < 4096 ? (G + NT - 1) / NT : 4096;
  if (want == 0 && valid == nullptr) {
    count_runs_kernel<<<(int)ib, NT, 0, st>>>(
        static_cast<const long long*>(starts), n, G,
        static_cast<unsigned long long*>(cnt));
    return (int)cudaGetLastError();
  }
  if (want && width != 1 && width != 2 && width != 4 && width != 8)
    return (int)cudaErrorInvalidValue;
  if (path == PATH_PRIVATE &&
      (G > PRIVATE_MAX || map == nullptr || bad == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.vals = vals;
  a.order = static_cast<const long long*>(order);
  a.valid = static_cast<const uint8_t*>(valid);
  a.starts = static_cast<const long long*>(starts);
  a.n = n;
  a.G = G;
  a.sext = is_signed && width < 8;
  a.flip = width == 8 && !is_signed ? SMALL : 0;
  a.sum = (want & WANT_SUM) ? static_cast<unsigned long long*>(sum) : nullptr;
  a.mn = (want & WANT_MIN) ? static_cast<long long*>(mn) : nullptr;
  a.mx = (want & WANT_MAX) ? static_cast<long long*>(mx) : nullptr;
  a.cnt = static_cast<unsigned long long*>(cnt);
  a.map = static_cast<uint8_t*>(map);
  a.bad = static_cast<int*>(bad);
  // the sentinels of an all-null group, as the outputs hold them
  long long mn0, mx0;
  if (width == 8) {
    mn0 = is_signed ? BIG : -1;           // uint64: all ones
    mx0 = is_signed ? SMALL : 0;
  } else if (is_signed) {
    mn0 = (1LL << (8 * width - 1)) - 1;
    mx0 = -(1LL << (8 * width - 1));
  } else {
    mn0 = (1LL << (8 * width)) - 1;
    mx0 = 0;
  }
  init_kernel<<<(int)ib, NT, 0, st>>>(a, mn0, mx0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (path == PATH_PRIVATE) {
    if ((err = cudaMemsetAsync(map, UNWRITTEN, (size_t)n, st)) != cudaSuccess)
      return (int)err;
    if ((err = cudaMemsetAsync(bad, 0, sizeof(int), st)) != cudaSuccess)
      return (int)err;
    const long long blocks = (n + NT * MAP_ITEMS - 1) / (NT * MAP_ITEMS);
    map_kernel<<<(unsigned)blocks, NT, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (want == 0) return (int)launch_path<1, false, false>(path, a, st);
  switch (width) {
    case 1: return (int)launch_ops<1>(path, want, a, st);
    case 2: return (int)launch_ops<2>(path, want, a, st);
    case 4: return (int)launch_ops<4>(path, want, a, st);
    default: return (int)launch_ops<8>(path, want, a, st);
  }
}
