// WKV-6 recurrence (RWKV-6 "Finch" time mix), hand-written CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py::_wkv6_kernel
// (pallas_call at wkv6.py:84).  Per (batch, head), with an N x N float32
// state S carried over the sequence:
//
//     o_t[m] = sum_n r_t[n] * (S[n, m] + u[n] * k_t[n] * v_t[m])
//     S[n, m] <- w_t[n] * S[n, m] + k_t[n] * v_t[m]
//
// which is the function of the oracle src/repro/kernels/ref.py::wkv6_ref
// (and of this package's ref.wkv6_ref), at every sequence length, with any
// initial state and any decay w in [0, 1].  One kernel, wkv6_chunk_kernel,
// instantiated for bf16 and for float32 r, k, v and output; the entry point
// picks the instantiation by dtype, and either one runs or the launch
// fails.
//
// What bounds it on the H100.  At the serving shape of rwkv6-3b (B 8, S 512,
// H 40, N 64; w in f32, the state in and out in f32) the function does 5
// N^2 operations per token and head (k v^T 1, the state update 2, the
// output product 2): 3.36 GFLOP, 0.0034 ms at the 989 TFLOP/s of the bf16
// tensor cores (0.0501 ms even at the 67 TFLOP/s of the CUDA cores).  With
// r, k, v and the output in bf16 it must move 136,325,120 bytes (0.040694
// ms at 3.35 TB/s), in float32 220,211,200 bytes (0.065735 ms).  Both
// instantiations run their products on the tensor cores, so bytes bound
// both.
//
// The chunked form.  Within a chunk of C = 16 tokens, with d_in[t] =
// prod_{j<t} w_j, d_tail[s] = prod_{j>s} w_j and d_total = prod_j w_j (per
// n), the output and the state update are four products (the TPU
// kernel's, wkv6.py:8-12):
//
//     out  = (r . d_in) S  +  A v,   A[t, s] = sum_n r_t k_s prod_{s<j<t} w_j
//            for s < t, A[t, t] = sum_n r_t u k_t (the bonus), 0 above
//     S'   = d_total . S  +  (k . d_tail)^T v
//
// A is factorised as (r . d_in)(k / d_in[s + 1])^T, the decays taken from
// the chunk's start, as the TPU kernel does.  That stays inside f32 only
// while a chunk decays by no more than the inverse of what f32 holds, and
// the wrapper takes any w in [0, 1]: a chunk whose every column decays by
// at least THETA = 2^-96 over its 16 tokens (the model's clip keeps w >=
// e^-4, so its chunks decay by at least e^-64 = 2^-92.3) takes the
// factorised form, and any other computes A pair by pair from w in the
// same kernel (r_t k_s times each w_j in turn), so nothing overflows down
// to w = 0.  The branch is uniform across the block, and the rest of the
// chunk is the same for both.
//
// The products run as mma.sync.m16n8k16 (bf16 in, f32 accumulators), with
// fragments from ldmatrix.  The decay-scaled operands (r . d_in, k / d_in,
// k . d_tail), A and the state are f32, and each is split into K = 3 bf16
// parts, each the rounding of what the parts before it leave; r and k
// enter the products only through them, in f32 whatever their dtype.  v
// is exact in bf16 and, in float32, split into three parts too.  The
// product of two split operands takes the six pairs of parts whose orders
// sum to less than three (x y to about 2^-24 of |x| |y|, as an f32
// product), of a split one with bf16 v three products.  Two parts keep 2^-17
// of each term: within the bounds (output 2e-2, state 1e-4), but in a
// served rwkv6-3b prefill, whose states reach |S| ~ 600, the output's
// state term (r . d_in) S then lost enough that ten times as many outputs
// as the plain version's were not the float64 value correctly rounded;
// with three parts fewer than the plain version's (wkv6_sweep.py
// --served), at a quarter more time.  Each chunk's part of the state is
// summed from zero and added to the decayed state by one FMA: the tensor
// cores keep a sum to its accumulator's precision, and summed into the
// state itself (large where w lies near 1) the parts lost enough to miss
// 1e-4 against the plain version (chip_smoke.py phase 8).
//
// Layout and pipeline.  A block owns one (batch, head), 4 warps at N 64
// (320 blocks at the serving shape, up to 3 an SM); warp w owns the state's
// columns 16w .. 16w + 15.  Its part of S^T (16 x N) lives in mma
// accumulators in registers across chunks, split into the B fragments of
// the output product as it stands.  The block stages r, k, w and v by
// 16-byte cp.async into a ring (ChunkTiles::STAGES: three in bf16, two in
// float32, whose inputs take twice the bytes: a third stage's shared
// memory would leave two blocks an SM).  Per chunk ch, behind a barrier:
// the warps form A of chunk ch once for the block (warp w one s tile over
// half the k-steps, the two halves summed in shared memory), and each warp
// takes chunk ch's v at its columns into registers (in float32, split
// there into its parts); with three stages chunk ch + 2's copies are
// issued here, into chunk ch - 1's stage.  Behind a second barrier (with
// two stages chunk ch + 2's copies are issued now, into chunk ch's stage,
// which no warp reads any more) each thread forms chunk ch + 1's operands
// (the running products of w over one pair of columns and four rows: no exp or
// log, so the decays round as the oracle's state does; 1 / d_in by
// MUFU.RCP) into XOR-swizzled tiles that ldmatrix reads without bank
// conflicts, while each warp runs chunk ch's products and writes its
// output rows from the accumulators.  Inputs whose base pointers are not
// 16-byte aligned are staged element by element into the same layout.
//
// What the card shows (wkv6_sweep.py; PERF.md section 6): in bf16 a block
// alone on its SM (B 1) takes 0.58 of the time of the 320 blocks, so each
// block's chain of dependent instructions per chunk sets the time, not the
// bytes.  Measured and dropped: each warp forming the A it needs (7 %
// slower), a split of each head's columns over two blocks (ChunkTiles::NV
// = N / 2; 640 blocks, each chunk's operands formed twice: 1.7x slower), a
// fourth stage (its shared memory leaves two blocks an SM: 1.5x slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int C = 16;  // tokens a chunk

// ---------------------------------------------------------------------------
// the chunked form on the tensor cores (bf16 and float32 r, k, v)
// ---------------------------------------------------------------------------

constexpr float THETA = 0x1p-96f;  // least decay of a chunk it factorises

// In: the type of r, k, v and the output (bf16 or float).  What the card
// reports (chip_smoke.py phase 2; CUDA 12.8, H100 80GB HBM3):
//
//   In     N   shared memory  registers  spills  blocks/SM  HMMA
//   bf16   16   19,264 B      117        0       11          36
//   bf16   32   36,352 B      146        0        6          66
//   bf16   64   70,528 B      161        0        3         126
//   float  16   20,288 B      128        0       10          48
//   float  32   37,888 B      168        0        6          84
//   float  64   73,088 B      168        0        3         156
//
// A third float32 stage (89,728 B at N 64) leaves two blocks an SM and
// took 0.222 ms at the serving shape against two stages' 0.149; two
// parts took 0.103 ms but missed 1e-4 on the state and the output where
// w lies near 1 (wkv6_sweep.py --dtype float32).
template <typename In, int N>
struct ChunkTiles {
  // columns of the state a block owns (N / 2: wkv6_sweep.py's two_blocks)
  static constexpr int NV = N;
  static constexpr int SPLIT = N / NV;     // blocks a (batch, head)
  static constexpr int WARPS = NV / 16;    // each owns 16 columns of S
  static constexpr int NT = 32 * WARPS;
  static constexpr bool F32 = sizeof(In) == 4;
  // chunks of input in the ring (float32: 3 stages' shared memory would
  // leave 2 blocks an SM)
  static constexpr int STAGES = F32 ? 2 : 3;
  // blocks an SM the shared memory leaves (at N 64), so registers for them
  static constexpr int MIN_BLOCKS = 3;
  static constexpr int PARTS = 3;          // bf16 parts of an f32 operand
  static constexpr int VPARTS = F32 ? PARTS : 1;  // parts of v
  static constexpr int TILE = C * N;       // elements of a C x N tile
  static constexpr int EPP = 16 / sizeof(In);     // elements a 16-byte piece
  // v's row stride: float32 v is read element by element, its rows padded
  // so that a warp's reads fall in 32 banks; bf16 v is swizzled
  static constexpr int VS = F32 ? N + 4 : N;
  // bytes: a stage holds r, k (C x N In), w (C x N f32) and v (C x VS
  // In); an operand set PARTS parts each of r . d_in, k / d_in[s + 1] and
  // k . d_tail (C x N bf16), d_total (N f32) and the bonus (C f32); then
  // A in two parts (2 x C x C f32), and u (N f32)
  static constexpr int KOFF = TILE * sizeof(In), WOFF = 2 * KOFF,
                       VOFF = WOFF + 4 * TILE;
  static constexpr int STAGE = VOFF + C * VS * sizeof(In);
  static constexpr int OPS = 3 * PARTS * TILE * 2 + N * 4 + C * 4;
  static constexpr int SMEM =
      STAGES * STAGE + 2 * OPS + 2 * C * C * 4 + N * 4;
  static_assert(N % NV == 0 && NV % 16 == 0, "tiles");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most K of this thread's commit groups are in flight
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: 16 x 16 row-major bf16 A (4 registers), 16 x 8 column-major
// bf16 B (2 registers), 16 x 8 f32 D.  Lane (g = lane / 4, q = lane % 4)
// holds D's rows g and g + 8 at columns 2q and 2q + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 1 / x to within an ulp (MUFU.RCP), subnormals flushed: the factorised
// chunks' decays are at least 2^-96, so nothing they take is subnormal
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x0, x1 as K packed pairs of bf16 parts: each part the rounding of what
// the parts before it leave
template <int K>
__device__ __forceinline__ void split(float x0, float x1, uint32_t* parts) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    parts[p] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// the sum of K accumulators of one product, smallest parts first
template <int K>
__device__ __forceinline__ float sum_parts(const float (*acc)[2][4], int i,
                                           int e) {
  float s = acc[K - 1][i][e];
#pragma unroll
  for (int p = K - 2; p >= 0; --p) s = acc[p][i][e] + s;
  return s;
}

// Element offset of 16-byte chunk c of row r in a tile of W-wide bf16
// rows.  The chunk index is XORed with the row's line position, so the
// eight consecutive rows that one ldmatrix phase reads at one chunk column
// fall in eight different 16-byte bank groups (rows narrower than 128
// bytes share a line, hence RPL).
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = W / 8;                   // chunks per row
  constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR;  // rows per 128-byte line
  constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  return r * W + ((c ^ ((r / RPL) & MASK)) << 3);
}

// 16 bytes global -> shared: with vec by cp.async (zeros where !in),
// else element by element in 2-byte words (every input is 2- or 4-byte
// aligned).  src must be a valid address even where !in.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool in,
                                       bool vec) {
  if (vec) {
    cp_async_16(smem_addr(dst), src, in ? 16 : 0);
  } else {
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (in) {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
      unsigned short* e = reinterpret_cast<unsigned short*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = s16[j];
    }
    *reinterpret_cast<uint4*>(dst) = val;
  }
}

template <typename In, int N>
__global__ void __launch_bounds__(ChunkTiles<In, N>::NT,
                                  ChunkTiles<In, N>::MIN_BLOCKS)
wkv6_chunk_kernel(const In* __restrict__ r, const In* __restrict__ k,
                  const In* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  In* __restrict__ out, float* __restrict__ s_out, int S,
                  int H, int vec) {
  using T = ChunkTiles<In, N>;
  constexpr int NT = T::NT;
  constexpr int K = T::PARTS;
  constexpr int VP = T::VPARTS;
  constexpr int VS = T::VS;
  constexpr int TILE = T::TILE;
  constexpr int NN8 = N / 8;   // 8-wide n tiles of this warp's S^T
  constexpr int KS = N / 16;   // k-steps over n
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // input stages: r, k, w plain row-major, v swizzled (bf16) or padded
  unsigned char* stages = smem_raw;
  // two operand sets: K parts each of r . d_in, k / d_in[s + 1] and
  // k . d_tail, swizzled C x N tiles; d_total; the bonus sum_n r_t u k_t
  unsigned char* opsets = stages + T::STAGES * T::STAGE;
  // A (C x C, rows t) as the sum of two parts
  float* sA = reinterpret_cast<float*>(opsets + 2 * T::OPS);
  float* sU = sA + 2 * C * C;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x / T::SPLIT;  // b * H + h
  // this warp's 16 columns of the state
  const int m0 = (blockIdx.x % T::SPLIT) * T::NV + warp * 16;
  const int b = bh / H, h = bh % H;
  const long long ts = (long long)H * N;  // elements between tokens
  const long long base = (long long)b * S * ts + (long long)h * N;
  const long long sbase = (long long)bh * N * N;
  const int nch = (S + C - 1) / C;

  for (int i = tid; i < N; i += NT) sU[i] = u[h * N + i];
  for (int i = tid; i < C * C; i += NT) sA[C * C + i] = 0.f;

  struct Inputs {  // chunk ch's inputs, in stage ch % STAGES
    In *r, *k, *v;
    float* w;
  };
  const auto in_of = [&](int ch) {
    unsigned char* p = stages + (ch % T::STAGES) * T::STAGE;
    Inputs x;
    x.r = reinterpret_cast<In*>(p);
    x.k = reinterpret_cast<In*>(p + T::KOFF);
    x.w = reinterpret_cast<float*>(p + T::WOFF);
    x.v = reinterpret_cast<In*>(p + T::VOFF);
    return x;
  };
  struct Ops {  // chunk ch's operands, in set ch & 1
    __nv_bfloat16 *q1, *kk, *kd;
    float *dtot, *diag;
  };
  const auto ops_of = [&](int ch) {
    Ops x;
    x.q1 = reinterpret_cast<__nv_bfloat16*>(opsets + (ch & 1) * T::OPS);
    x.kk = x.q1 + K * TILE;
    x.kd = x.kk + K * TILE;
    x.dtot = reinterpret_cast<float*>(x.kd + K * TILE);
    x.diag = x.dtot + N;
    return x;
  };

  // The 16-byte pieces this thread copies for every chunk: RKV each of r,
  // k and v, WP of w.  Their offsets within a chunk stay the same from
  // chunk to chunk.
  constexpr int EPP = T::EPP;
  constexpr int RKV = C * N / EPP / NT, WP = C * N / 4 / NT;
  static_assert(RKV * NT == C * N / EPP && WP * NT == C * N / 4, "pieces");
  int tp[RKV], sp[RKV], sv[RKV], tw[WP], sw[WP];
  long long gp[RKV], gw[WP];
#pragma unroll
  for (int j = 0; j < RKV; ++j) {
    const int i = tid + j * NT, c = i % (N / EPP);
    tp[j] = i / (N / EPP);
    gp[j] = tp[j] * ts + c * EPP;               // elements in the rows
    sp[j] = tp[j] * N * sizeof(In) + c * 16;    // bytes in r's and k's tiles
    sv[j] = T::F32 ? (tp[j] * VS + c * 4) * 4   // bytes in v's tile
                   : swz<N>(tp[j], c) * 2;
  }
#pragma unroll
  for (int j = 0; j < WP; ++j) {
    const int i = tid + j * NT, c = i % (N / 4);
    tw[j] = i / (N / 4);
    gw[j] = tw[j] * ts + c * 4;
    sw[j] = tw[j] * N * 4 + c * 16;
  }

  // issue the copies of chunk ch into its stage: one commit group, empty
  // past the last chunk, so that every wait below counts the same groups;
  // rows past S are zero-filled (from a valid address, row 0)
  const auto stage = [&](int ch) {
    if (ch < nch) {
      const int nc = min(C, S - ch * C);
      const long long g0 = base + (long long)ch * C * ts;
      unsigned char* p = stages + (ch % T::STAGES) * T::STAGE;
#pragma unroll
      for (int j = 0; j < RKV; ++j) {
        const bool in = tp[j] < nc;
        const long long gi = in ? g0 + gp[j] : base;
        copy16(p + sp[j], r + gi, in, vec);
        copy16(p + T::KOFF + sp[j], k + gi, in, vec);
        copy16(p + T::VOFF + sv[j], v + gi, in, vec);
      }
#pragma unroll
      for (int j = 0; j < WP; ++j)
        copy16(p + T::WOFF + sw[j],
               w + (tw[j] < nc ? g0 + gw[j] : base), tw[j] < nc, vec);
    }
    cp_async_commit();
  };

  // Chunk ch's operands from its inputs.  Thread (pair p, group gr) takes
  // columns n = 2p, 2p + 1 and RPG rows from RPG gr: the running products
  // of w before, over and after its rows give d_in, d_tail and d_total;
  // it writes the split operands as bf16 pairs, and sums the bonus of its
  // rows over the pairs with shuffles.  Returns whether this thread's
  // columns let the chunk take the factorised A.
  const auto prework = [&](int ch) {
    constexpr int PAIRS = N / 2;         // lanes of a group, in one warp
    constexpr int RPG = C * PAIRS / NT;  // rows a thread
    static_assert(RPG * NT == C * PAIRS && RPG <= PAIRS && PAIRS <= 32,
                  "prework");
    const int nc = min(C, S - ch * C);
    const Inputs x = in_of(ch);
    const Ops o = ops_of(ch);
    const int n = 2 * (tid % PAIRS), t0 = (tid / PAIRS) * RPG;
    const auto w_at = [&](int t) {  // padding rows decay by nothing
      return t < nc ? *reinterpret_cast<const float2*>(x.w + t * N + n)
                    : make_float2(1.f, 1.f);
    };
    const auto mul = [](float2 a, float2 b) {
      return make_float2(a.x * b.x, a.y * b.y);
    };
    float2 before = make_float2(1.f, 1.f), after = before;
#pragma unroll 4
    for (int t = 0; t < t0; ++t) before = mul(before, w_at(t));
#pragma unroll 4
    for (int t = t0 + RPG; t < C; ++t) after = mul(after, w_at(t));
    float2 wr[RPG], din[RPG + 1], dtail[RPG];
#pragma unroll
    for (int i = 0; i < RPG; ++i) wr[i] = w_at(t0 + i);
    din[0] = before;
#pragma unroll
    for (int i = 0; i < RPG; ++i) din[i + 1] = mul(din[i], wr[i]);
    dtail[RPG - 1] = after;
#pragma unroll
    for (int i = RPG - 1; i > 0; --i) dtail[i - 1] = mul(dtail[i], wr[i]);
    const float2 dtot = mul(din[RPG], after);
    if (t0 == 0) *reinterpret_cast<float2*>(o.dtot + n) = dtot;
    const float2 un = *reinterpret_cast<const float2*>(sU + n);
    float bonus[RPG];
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int t = t0 + i;
      const float2 rt = load2(x.r + t * N + n);
      const float2 kt = load2(x.k + t * N + n);
      bonus[i] = rt.x * (un.x * kt.x) + rt.y * (un.y * kt.y);
      const float2 xs[3] = {
          mul(rt, din[i]),
          make_float2(kt.x * rcp_approx(din[i + 1].x),
                      kt.y * rcp_approx(din[i + 1].y)),
          mul(kt, dtail[i])};
      __nv_bfloat16* tiles[3] = {o.q1, o.kk, o.kd};
      const int at = swz<N>(t, n >> 3) + (n & 7);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        uint32_t parts[K];
        split<K>(xs[j].x, xs[j].y, parts);
#pragma unroll
        for (int p = 0; p < K; ++p)
          *reinterpret_cast<uint32_t*>(tiles[j] + p * TILE + at) = parts[p];
      }
    }
    // the RPG rows' sums over the PAIRS lanes of the group: while a lane
    // carries more than one row, it keeps half of them and sends the other
    // half (a reduce-scatter), then a butterfly over the lanes left
    int row = t0;
#pragma unroll
    for (int cnt = RPG, m = PAIRS / 2; cnt > 1; cnt /= 2, m /= 2) {
      const bool up = tid & m;
#pragma unroll
      for (int i = 0; i < cnt / 2; ++i)
        bonus[i] = (up ? bonus[cnt / 2 + i] : bonus[i]) +
                   __shfl_xor_sync(0xffffffffu,
                                   up ? bonus[i] : bonus[cnt / 2 + i], m);
      row += up ? cnt / 2 : 0;
    }
#pragma unroll
    for (int m = PAIRS / RPG / 2; m > 0; m /= 2)
      bonus[0] += __shfl_xor_sync(0xffffffffu, bonus[0], m);
    if (tid % (PAIRS / RPG) == 0) o.diag[row] = bonus[0];
    return dtot.x >= THETA && dtot.y >= THETA;
  };

  // A of chunk ch pair by pair, into sA's first part (the second zero):
  // for a chunk that decays too fast for the factorised form
  const auto direct_a = [&](int ch) {
    const Inputs x = in_of(ch);
    for (int i = tid; i < C * C; i += NT) {
      const int t = i / C, s = i % C;
      float a = 0.f;
      for (int n = 0; s < t && n < N; ++n) {
        float p = to_f(x.r[t * N + n]) * to_f(x.k[s * N + n]);
        for (int j = s + 1; j < t; ++j) p *= x.w[j * N + n];
        a += p;
      }
      sA[i] = a;
      sA[C * C + i] = 0.f;
    }
  };

  // S^T, rows m (this warp's 16 columns), columns n: st[j] is n tile j;
  // lane (g, q) holds S[8j + 2q + e][m0 + g + 8i] in st[j][2i + e]
  float st[NN8][4];
#pragma unroll
  for (int j = 0; j < NN8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * q + (e & 1);
      const int m = m0 + g + 8 * (e >> 1);
      st[j][e] = s0 ? s0[sbase + (long long)n * N + m] : 0.f;
    }

  // ldmatrix rows and chunks of this lane: A from [row][k] tiles; B (two
  // 8-wide n tiles) from [n][k] tiles, or A^T from [k][m] with .trans; B
  // (two n tiles) from [k][n] tiles with .trans
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chunk = (lane >> 3) & 1;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3), t_chunk = lane >> 4;

  // The factorised A = (r . d_in)(k / d_in[s + 1])^T of chunk ch, once a
  // block: warp w takes n tile w % 2 of s (both where the block has one
  // warp) and half of the k-steps over n (all where it has two or fewer),
  // and writes its part of the sum to sA's part w / 2.  The product of two
  // split f32 operands takes the pairs of parts (i, j) with i + j < K,
  // each order i + j in its own accumulators.
  const auto a_part = [&](int ch) {
    constexpr int JT = T::WARPS >= 2 ? 2 : 1;  // owners of the s tiles
    constexpr int KP = T::WARPS / JT;          // parts of the sum over n
    static_assert(KP <= 2, "A has two parts");
    const Ops o = ops_of(ch);
    const int kp = warp / JT;
    const bool tile0 = JT == 1 || warp % 2 == 0;
    const bool tile1 = JT == 1 || warp % 2 == 1;
    float a[K][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks % KP != kp) continue;
      uint32_t qf[K][4], kf[K][4];
#pragma unroll
      for (int p = 0; p < K; ++p) {
        ldsm_x4(qf[p], o.q1 + p * TILE + swz<N>(a_row, 2 * ks + a_chunk));
        ldsm_x4(kf[p], o.kk + p * TILE + swz<N>(b_row, 2 * ks + b_chunk));
      }
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; i + j < K; ++j) {
          if (tile0) mma_bf16(a[i + j][0], qf[i], kf[j][0], kf[j][1]);
          if (tile1) mma_bf16(a[i + j][1], qf[i], kf[j][2], kf[j][3]);
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!(j == 0 ? tile0 : tile1)) continue;
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(sA + kp * C * C +
                                   (g + 8 * (e >> 1)) * C + 8 * j + 2 * q) =
            make_float2(sum_parts<K>(a, j, e), sum_parts<K>(a, j, e + 1));
    }
  };

  // Chunk ch's v at this warp's columns m as the B fragments of A v (k =
  // the chunk's tokens t, two 8-wide m tiles), in VP parts: lane (g, q)
  // holds v[t][m] at t = 2q, 2q + 1 (e even) or 2q + 8, 2q + 9 (e odd) and m
  // = m0 + g (e < 2) or m0 + 8 + g.  Permuted, the same registers are the A
  // fragment of v^T in the state's update.  bf16 v is exact (one part,
  // by ldmatrix); float32 v is split into PARTS bf16 parts.
  const auto v_frags = [&](int ch, uint32_t (&vf)[VP][4]) {
    const In* cv = in_of(ch).v;
    if constexpr (T::F32) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 2 * q + 8 * (e & 1), m = m0 + g + 8 * (e >> 1);
        uint32_t parts[VP];
        split<VP>(to_f(cv[t * VS + m]), to_f(cv[(t + 1) * VS + m]), parts);
#pragma unroll
        for (int p = 0; p < VP; ++p) vf[p][e] = parts[p];
      }
    } else {
      ldsm_x4_trans(vf[0], cv + swz<N>(t_row, m0 / 8 + t_chunk));
    }
  };

  // Chunk ch's products: its output rows, and the state carried past it.
  const auto products = [&](int ch, const uint32_t (&vf)[VP][4]) {
    const Ops o = ops_of(ch);
    // the state's term (r . d_in) S of the output (rows t, n tiles of this
    // warp's columns m), over the k-steps of n, by order of parts
    float y[K][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qf[K][4];
#pragma unroll
      for (int p = 0; p < K; ++p)
        ldsm_x4(qf[p], o.q1 + p * TILE + swz<N>(a_row, 2 * ks + a_chunk));
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // S^T's rows g + 8c are columns m
        uint32_t s_lo[K], s_hi[K];
        split<K>(st[2 * ks][2 * c], st[2 * ks][2 * c + 1], s_lo);
        split<K>(st[2 * ks + 1][2 * c], st[2 * ks + 1][2 * c + 1], s_hi);
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int j = 0; i + j < K; ++j)
            mma_bf16(y[i + j][c], qf[i], s_lo[j], s_hi[j]);
      }
    }
    // A (its two parts in sA) masked strictly lower, with the bonus on the
    // diagonal, in K parts as the A fragments of A v (rows t, k = s)
    uint32_t af[4][K];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = g + 8 * (e >> 1), s = 8 * j + 2 * q;
        const float d = o.diag[t];
        const float2 p0 = *reinterpret_cast<const float2*>(sA + t * C + s);
        const float2 p1 =
            *reinterpret_cast<const float2*>(sA + C * C + t * C + s);
        float x0 = p0.x + p1.x, x1 = p0.y + p1.y;
        x0 = s < t ? x0 : (s == t ? d : 0.f);
        x1 = s + 1 < t ? x1 : (s + 1 == t ? d : 0.f);
        split<K>(x0, x1, af[2 * j + (e >> 1)]);
      }
    // A v, summed from zero apart from the state's term: the pairs of
    // parts (i of A, j of v) with i + j < K, smallest orders first
    float ya[2][4] = {};
#pragma unroll
    for (int od = K - 1; od >= 0; --od)
#pragma unroll
      for (int j = 0; j < VP && j <= od; ++j) {
        const int i = od - j;
        const uint32_t ap[4] = {af[0][i], af[1][i], af[2][i], af[3][i]};
        mma_bf16(ya[0], ap, vf[j][0], vf[j][1]);
        mma_bf16(ya[1], ap, vf[j][2], vf[j][3]);
      }
    // the output rows t < nc, from the accumulators
    const int nc = min(C, S - ch * C);
    In* orow = out + base + (long long)ch * C * ts + m0 + 2 * q;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = g + 8 * (e >> 1);
        if (t < nc)
          store2(orow + t * ts + 8 * c, ya[c][e] + sum_parts<K>(y, c, e),
                 ya[c][e + 1] + sum_parts<K>(y, c, e + 1));
      }

    // S' = d_total . S + (k . d_tail)^T v, as S'^T = S^T d_total + v^T KT.
    // The chunk's part v^T KT is summed from zero (smallest parts first)
    // and added to the decayed state by one rounded FMA: summed into the
    // state's own accumulators, every mma would round its terms to the
    // state's magnitude, and over 512 tokens that took the served model's
    // large states past 1e-4 of the plain version.
    // v^T's A fragments (rows m, k = t), part by part
    uint32_t va[VP][4];
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      va[j][0] = vf[j][0];
      va[j][1] = vf[j][2];
      va[j][2] = vf[j][1];
      va[j][3] = vf[j][3];
    }
#pragma unroll
    for (int p = 0; p < N / 16; ++p) {
      float d[2][4] = {};
#pragma unroll
      for (int i = K - 1; i >= 0; --i) {
        uint32_t kd[4];
        ldsm_x4_trans(kd, o.kd + i * TILE + swz<N>(t_row, 2 * p + t_chunk));
#pragma unroll
        for (int j = VP - 1; j >= 0; --j) {
          if (i + j >= K) continue;
          mma_bf16(d[0], va[j], kd[0], kd[1]);
          mma_bf16(d[1], va[j], kd[2], kd[3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * p + jj;
        const float2 dt =
            *reinterpret_cast<const float2*>(o.dtot + 8 * j + 2 * q);
        st[j][0] = fmaf(st[j][0], dt.x, d[jj][0]);
        st[j][1] = fmaf(st[j][1], dt.y, d[jj][1]);
        st[j][2] = fmaf(st[j][2], dt.x, d[jj][2]);
        st[j][3] = fmaf(st[j][3], dt.y, d[jj][3]);
      }
    }
  };

  // The pipeline.  Chunk ch + 1's operands are formed while chunk ch's
  // products run, and chunk ch + 2's copies are in flight meanwhile.  Two
  // barriers a chunk: chunk ch's operands and chunk ch + 1's inputs are
  // in; A is in.  Chunk ch's v goes to registers before the second, so
  // from then on its stage is free: with three stages chunk ch + 2's copies
  // are issued after the first barrier (into chunk ch - 1's stage), with
  // two after the second (into chunk ch's).
  stage(0);
  stage(1);
  cp_async_wait<1>();
  __syncthreads();  // chunk 0 is in, and u
  bool fast = prework(0);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    // chunk ch's operands and chunk ch + 1's inputs are in; every warp is
    // done with chunk ch - 1's products
    const bool fast_ch = __syncthreads_and(fast);
    if constexpr (T::STAGES > 2) stage(ch + 2);
    if (fast_ch)  // uniform across the block
      a_part(ch);
    else
      direct_a(ch);
    uint32_t vf[VP][4];
    v_frags(ch, vf);
    __syncthreads();  // A is in; every warp has read chunk ch's inputs
    if constexpr (T::STAGES == 2) stage(ch + 2);
    if (ch + 1 < nch) fast = prework(ch + 1);
    products(ch, vf);
  }

#pragma unroll
  for (int j = 0; j < NN8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * q + (e & 1);
      const int m = m0 + g + 8 * (e >> 1);
      s_out[sbase + (long long)n * N + m] = st[j][e];
    }
}

// the kernel's shared memory, above the 48 KB default at N 64
template <typename In, int N>
cudaError_t prepare() {
  return cudaFuncSetAttribute(wkv6_chunk_kernel<In, N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              ChunkTiles<In, N>::SMEM);
}

// f(std::integral_constant<int, N>) for a supported head size
template <typename F>
cudaError_t with_n(int N, F&& f) {
  switch (N) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// registers, dynamic and static shared memory, local (spill) bytes,
// threads and resident blocks per SM of one instantiation
template <typename K>
cudaError_t attrs_of(K kern, int threads, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem);
  out[0] = a.numRegs;
  out[1] = smem;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)a.localSizeBytes;
  out[4] = threads;
  out[5] = blocks;
  return err;
}

template <typename In, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, void* out,
                   float* s_out, int B, int S, int H, cudaStream_t st) {
  using T = ChunkTiles<In, N>;
  const cudaError_t err = prepare<In, N>();
  if (err != cudaSuccess) return err;
  const int vec = aligned16(r) && aligned16(k) && aligned16(v) &&
                  aligned16(w);
  wkv6_chunk_kernel<In, N><<<B * H * T::SPLIT, T::NT, T::SMEM, st>>>(
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), w, u, s0, static_cast<In*>(out), s_out, S,
      H, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  r, k, v (bf16 when is_bf16, else
// f32), w (f32) and out (r's type) are contiguous (B, S, H, N); u is (H, N)
// f32; s0 is (B, H, N, N) f32 or null for a zero state; s_out is (B, H, N, N)
// f32.  S >= 1, N in {16, 32, 64}.  Both dtypes run the chunked kernel on
// the tensor cores.  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* s0,
                        void* out, float* s_out, int is_bf16, int B, int S,
                        int H, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_n(N, [&](auto n) {
    constexpr int NN = decltype(n)::value;
    return is_bf16 ? launch<__nv_bfloat16, NN>(r, k, v, w, u, s0, out, s_out,
                                               B, S, H, st)
                   : launch<float, NN>(r, k, v, w, u, s0, out, s_out, B, S,
                                       H, st);
  });
}

// The kernel that wkv6_fwd launches for (is_bf16, N), as six ints in out:
// registers a thread, dynamic and static shared memory bytes a block, local
// memory bytes a thread (spills), threads a block, blocks resident on one
// SM.  Returns a cudaError_t.
extern "C" int wkv6_attrs(int is_bf16, int N, int* out) {
  return (int)with_n(N, [&](auto n) {
    constexpr int NN = decltype(n)::value;
    const auto attrs = [&](auto in) {
      using In = decltype(in);
      const cudaError_t err = prepare<In, NN>();
      if (err != cudaSuccess) return err;
      return attrs_of(wkv6_chunk_kernel<In, NN>, ChunkTiles<In, NN>::NT,
                      ChunkTiles<In, NN>::SMEM, out);
    };
    return is_bf16 ? attrs(__nv_bfloat16{}) : attrs(float{});
  });
}
