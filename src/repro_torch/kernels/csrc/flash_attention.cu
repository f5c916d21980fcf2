// Flash attention forward, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:108): GQA attention forward, causal
// and/or local window, online softmax with f32 accumulators, KV tiles that
// the mask fully excludes skipped.  Query head h reads KV head h / G.  One
// block owns one (query tile, head, batch) and loops over the KV tiles
// itself (the TPU grid's sequential KV axis, whose m, l and acc lived in
// VMEM scratch): m, l and acc live in registers, and scores and
// probabilities never leave the SM.  q/k/v are read in the public
// (B, S, H, hd) layout through their strides, with no transpose copy;
// ragged S and T are masked at the edge, not padded.  The entry point
// picks the kernel by dtype; either one runs or the launch fails.
//
// What bounds it on the H100.  At smollm's prefill (B 8, S = T 512, H 9,
// KV 3, hd 64, bf16, causal) the function must move about 12.6 MB (3.8 us
// at 3.35 TB/s) and do about 2.4 GFLOP (2.4 us at 989 TFLOP/s): bytes set
// the least time.  At recurrentgemma's local attention (hd 256, 16 query
// heads on 1 KV head, window 2048) the products dominate: a 3072-token
// prefill does 69 GFLOP (69.5 us).
//
// bf16: tensor cores (flash_fwd_bf16_kernel).  Each warp owns 16 query
// rows.  Q K^T and P V run as mma.sync.m16n8k16 (bf16 in, f32 out); the
// fragments come from shared memory through ldmatrix (V through
// ldmatrix.trans).  S, m, l and O stay f32 in registers.  The accumulator
// layout of one mma is the A-operand layout of the next, so P is rounded
// to bf16 in registers and never touches shared memory.  K and V are
// staged as bf16 by 16-byte cp.async into a two-stage ring (tile j + 1 is
// in flight while tile j is computed; one __syncthreads per tile), in an
// XOR-swizzled layout so that the eight rows one ldmatrix phase reads fall
// in eight different bank groups.  Q is staged once per block; up to hd
// 128 its fragments stay in registers, at hd 256 they are re-read from
// shared memory (O's accumulators alone take 128 registers a thread).
// The KV loop runs only over the tiles that hold a visible key for some
// row of the block (the window's first tile to the causal diagonal), and
// only the diagonal tile, the window's edge tile and the ragged tail are
// masked element by element.  Under a causal mask the heaviest query
// tiles are launched first.  Inputs whose base pointers or strides are
// not 16-byte aligned are staged element by element into the same layout.
// Tiles (Bf16Tiles): see the table there for the choice, the shared
// memory and ptxas's registers and spills.
//
// float32: the first kernel (flash_fwd_kernel), the same code, written for
// float alone now that bf16 has its own kernel: both products as f32 FMAs
// out of shared memory, 4 warps, 64 x 64 tiles; at hd 256 a
// block takes 213,760 bytes of dynamic shared memory (one block per SM)
// and ptxas gives a thread 240 registers with no spills (CUDA 12.8).
//
// Numerics follow the TPU kernel: scores are scaled, masked with the finite
// NEG_INF = -1e30 (with -inf, a row whose first tile is fully masked would
// turn into NaN; with -1e30 the junk it gathers is wiped by the later
// alpha = exp(m_prev - m_new) = 0), and the output is acc / max(l, 1e-30)
// in q's dtype.  Keys past T (the ragged edge) get -inf, so they add
// exactly nothing.  The bf16 kernel works in base 2: log2(e) is folded into
// the scale and exp2f takes the place of exp, which changes nothing but the
// last bits.  It rounds P to bf16 before the P V product, as the JAX
// model's chunked_attention and every tensor-core flash kernel do; l sums
// the unrounded f32 P.  That rounding costs about one bf16 ulp of the
// output (tests/test_torch_flash_numerics.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {


constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int NTHREADS = 128;  // 4 warps; warp w owns query rows 16w..16w+15
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  // sQ (BQ x HD+1), sK (BK x HD+1), sV (BK x HD), sP (BQ x BK+1), all f32
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

// Thread layout: lane = 8 * (row group) + tx.  Thread (ty, tx), ty in 0..15,
// owns query rows 4ty..4ty+3; for the scores it owns keys tx + 8j (j < 8),
// for the output it owns columns tx + 8c (c < HD/8).  The 8 threads of one
// row group sit in one warp, so row max and row sum are three shuffles and
// the probabilities a warp writes to shared memory are read back only by
// that warp.
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int Tk, int H, int G, long long sqb, long long sqs,
                 long long sqh, long long skb, long long sks, long long skh,
                 long long svb, long long svs, long long svh, int causal,
                 int window, float scale) {
  // +1 pads: rows read by different lanes fall in different banks
  constexpr int QS = HD + 1;
  constexpr int KS = HD + 1;
  constexpr int PS = BK + 1;
  constexpr int CPT = HD / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * KS;
  float* sP = sV + BK * HD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 7;
  const int ty = (tid >> 5) * 4 + (lane >> 3);
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + kvh * skh;
  const float* vb = v + b * svb + kvh * svh;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    sQ[r * QS + d] = (q0 + r < S) ? qb[(long long)(q0 + r) * sqs + d] : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Tk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    // whole-tile skips, by the TPU kernel's rule (block-uniform branches)
    if (causal && k0 > q0 + BQ - 1) break;
    if (window && k0 + BK - 1 <= q0 - window) continue;

    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Tk;
      sK[r * KS + d] = in ? kb[(long long)(k0 + r) * sks + d] : 0.f;
      sV[r * HD + d] = in ? vb[(long long)(k0 + r) * svs + d] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * ty + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(tx + 8 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (kpos >= Tk)
          x = -CUDART_INF_F;
        else if ((causal && kpos > qpos) || (window && kpos <= qpos - window))
          x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(4 * ty + i) * PS + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // this warp's probability rows are written

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(4 * ty + i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = sV[c * HD + tx + 8 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((long long)b * S + qpos) * H * HD + (long long)h * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 8 * c] = acc[i][c] / den;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV, long long sqb,
                   long long sqs, long long sqh, long long skb, long long sks,
                   long long skh, long long svb, long long svs, long long svh,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H,
      H / KV, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, causal, window,
      scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 kernel: tensor cores
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// Tiles of the bf16 kernel, by head dim: WARPS warps of 16 query rows
// (BQ = 16 WARPS), BK keys per KV tile.  What the card reports for them
// (cudaFuncGetAttributes and the occupancy calculator, which
// chip_smoke.py phase 2 prints; the registers and spills are ptxas's),
// built by CUDA 12.8 on an H100 80GB HBM3:
//
//   hd    warps  BK  shared memory  registers  spills  blocks per SM
//   16    4      64   10,240 B       92         0       5
//   32    4      64   20,480 B      100         0       4
//   64    4      64   40,960 B      138         0       3
//   128   4      64   81,920 B      245         0       2
//   256   4      32   98,304 B      255         0       2
//
// Chosen on the card among 4 and 8 warps and BK 32 and 64: 8 warps were
// no faster at any head dim, and at hd 256 BK 64 spills registers and is
// slower, while BK 32 keeps two blocks on an SM (PERF.md section 6; that
// sweep's script is not kept, so its times are not recorded).
template <int HD>
struct Bf16Tiles {
  static constexpr int WARPS = 4;
  static constexpr int BK = HD >= 256 ? 32 : 64;
  static constexpr int BQ = 16 * WARPS;
  static constexpr int NT = 32 * WARPS;
  static constexpr bool Q_IN_REGS = HD <= 128;
  // bytes: Q, then two stages of K and of V, all bf16
  static constexpr int SMEM = 2 * HD * (BQ + 4 * BK);
  static_assert(BK % 16 == 0 && HD % 16 == 0, "mma tiles are 16 deep");
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: 16 x 16 row-major bf16 A (4 registers), 16 x 8 column-major
// bf16 B (2 registers), 16 x 8 f32 D.  Lane (g = lane / 4, t = lane % 4)
// holds D's rows g and g + 8 at columns 2t and 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of 16-byte chunk c of row r in a tile of HD-wide bf16
// rows.  The chunk index is XORed with the row's line position, so the
// eight consecutive rows that one ldmatrix phase reads at one chunk column
// fall in eight different 16-byte bank groups (rows narrower than 128
// bytes share a line, hence RPL).
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = HD / 8;                  // chunks per row
  constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR;  // rows per 128-byte line
  constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  return r * HD + ((c ^ ((r / RPL) & MASK)) << 3);
}

// Stage rows r0 .. r0 + R - 1 of one head (row stride rs elements) into a
// swizzled tile; rows at or past n are zero-filled.  With vec (every base
// pointer and stride 16-byte aligned) by cp.async, else element by element.
template <int HD, int R, int NT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s,
                                           const __nv_bfloat16* g,
                                           long long rs, int r0, int n,
                                           bool vec) {
  constexpr int CPR = HD / 8;
  constexpr int CHUNKS = R * CPR;
#pragma unroll
  for (int i0 = 0; i0 < CHUNKS; i0 += NT) {
    const int i = i0 + threadIdx.x;
    if (CHUNKS % NT != 0 && i >= CHUNKS) break;
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < n;
    const __nv_bfloat16* src = g + (in ? r0 + r : 0) * rs + c * 8;
    __nv_bfloat16* dst = s + swz<HD>(r, c);
    if (vec) {
      cp_async_16(smem_addr(dst), src, in ? 16 : 0);
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = src[j];
      }
      *reinterpret_cast<uint4*>(dst) = val;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Bf16Tiles<HD>::NT)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int S, int Tk, int H,
                      int G, long long sqb, long long sqs, long long sqh,
                      long long skb, long long sks, long long skh,
                      long long svb, long long svs, long long svh,
                      int causal, int window, float scale_log2, int vec) {
  using C = Bf16Tiles<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT;
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int NS = BK / 8;       // 8-key column tiles of S
  constexpr int ND = HD / 8;       // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * HD;      // two stages of BK x HD
  __nv_bfloat16* sV = sK + 2 * BK * HD;  // two stages of BK x HD

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // under a causal mask the last query tiles see the most keys: first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + (h / G) * skh;
  const __nv_bfloat16* vb = v + b * svb + (h / G) * svh;

  // the KV tiles that hold a visible key for some row of this block
  const int nk = (Tk + BK - 1) / BK;
  const int kt_lo = window ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = causal ? min(nk, (min(q0 + BQ, S) - 1) / BK + 1) : nk;

  stage_rows<HD, BQ, NT>(sQ, qb, sqs, q0, S, vec);
  stage_rows<HD, BK, NT>(sK, kb, sks, kt_lo * BK, Tk, vec);
  stage_rows<HD, BK, NT>(sV, vb, svs, kt_lo * BK, Tk, vec);
  cp_async_commit();

  // ldmatrix row and chunk of this lane: A (Q, 16 rows x 16), B (K, two
  // 8-key tiles x 16) and B transposed (V, 16 keys x two 8-wide tiles)
  const int a_row = warp * 16 + (lane & 15), a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_chunk = lane >> 4;
  // this lane's rows (g and g + 8 of the warp's 16) and first column
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);

  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  uint32_t qf[C::Q_IN_REGS ? KSTEPS : 1][4];
  if constexpr (C::Q_IN_REGS) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      ldsm_x4(qf[ks], smem_addr(sQ + swz<HD>(a_row, 2 * ks + a_chunk)));
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) {
      stage_rows<HD, BK, NT>(sK + (stage ^ 1) * BK * HD, kb, sks,
                             (kt + 1) * BK, Tk, vec);
      stage_rows<HD, BK, NT>(sV + (stage ^ 1) * BK * HD, vb, svs,
                             (kt + 1) * BK, Tk, vec);
      cp_async_commit();
    }
    const __nv_bfloat16* cK = sK + stage * BK * HD;
    const __nv_bfloat16* cV = sV + stage * BK * HD;

    // S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t a[4];
      if constexpr (C::Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldsm_x4(a, smem_addr(sQ + swz<HD>(a_row, 2 * ks + a_chunk)));
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(cK + swz<HD>(j * 8 + k_row, 2 * ks + k_chunk)));
        mma_bf16(s[j], a, kf[0], kf[1]);
        mma_bf16(s[j + 1], a, kf[2], kf[3]);
      }
    }

    // scale, then mask: only the diagonal tile, the window's edge tile and
    // the ragged tail hold masked keys (block-uniform branch)
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0) ||
                      (window && k0 <= q0 + BQ - 1 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * 8 + col + (e & 1);
          const int qpos = row0 + ((e >> 1) << 3);
          if (kpos >= Tk)
            x = -CUDART_INF_F;
          else if ((causal && kpos > qpos) ||
                   (window && kpos <= qpos - window))
            x = NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // online softmax: a row's four lanes (a quad) share m and alpha; each
    // keeps its own part of l until the end
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        acc[d][2 * i] *= alpha;
        acc[d][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }

    // O += P V: S's accumulators of key tiles 2kk and 2kk + 1, rounded to
    // bf16, are the A fragment of keys 16kk .. 16kk + 15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf,
                      smem_addr(cV + swz<HD>(kk * 16 + v_row, d + v_chunk)));
        mma_bf16(acc[d], a, vf[0], vf[1]);
        mma_bf16(acc[d + 1], a, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait_all();  // nothing in flight at exit, even with no KV tile

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qpos = row0 + 8 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow =
        o + ((long long)b * S + qpos) * H * HD + (long long)h * HD + col;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * i] / den, acc[d][2 * i + 1] / den);
  }
}

template <int HD>
cudaError_t prepare_bf16() {
  auto kern = flash_fwd_bf16_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Bf16Tiles<HD>::SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Tk, int H, int KV, long long sqb,
                        long long sqs, long long sqh, long long skb,
                        long long sks, long long skh, long long svb,
                        long long svs, long long svh, int causal, int window,
                        float scale, cudaStream_t stream) {
  using C = Bf16Tiles<HD>;
  cudaError_t err = prepare_bf16<HD>();
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   (sqb | sqs | sqh | skb | sks | skh | svb | svs | svh) % 8 ==
                       0;
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  flash_fwd_bf16_kernel<HD><<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, Tk, H, H / KV, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, causal,
      window, scale * LOG2E, vec);
  return cudaGetLastError();
}

// f(std::integral_constant<int, hd>) for a supported head dim
template <typename F>
cudaError_t with_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
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

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).  The caller
// has checked shapes, dtypes and strides (stride 1 on hd); `o` is a
// contiguous (B, S, H, hd) tensor of q's dtype.  bf16 runs the
// tensor-core kernel, float32 the FMA kernel.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int S, int Tk, int H, int KV, int hd, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, int causal, int window, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_hd(hd, [&](auto n) {
    constexpr int HD = decltype(n)::value;
    if (is_bf16)
      return launch_bf16<HD>(q, k, v, o, B, S, Tk, H, KV, sqb, sqs, sqh, skb,
                             sks, skh, svb, svs, svh, causal, window, scale,
                             st);
    return launch<HD>(q, k, v, o, B, S, Tk, H, KV, sqb, sqs, sqh, skb, sks,
                      skh, svb, svs, svh, causal, window, scale, st);
  });
}

// The kernel that flash_attention_fwd launches for (is_bf16, hd), as six
// ints in out: registers a thread, dynamic and static shared memory bytes a
// block, local memory bytes a thread (spills), threads a block, blocks
// resident on one SM.  Returns a cudaError_t.
extern "C" int flash_attention_attrs(int is_bf16, int hd, int* out) {
  return (int)with_hd(hd, [&](auto n) {
    constexpr int HD = decltype(n)::value;
    if (is_bf16) {
      cudaError_t err = prepare_bf16<HD>();
      if (err != cudaSuccess) return err;
      return attrs_of(flash_fwd_bf16_kernel<HD>, Bf16Tiles<HD>::NT,
                      Bf16Tiles<HD>::SMEM, out);
    }
    auto kern = flash_fwd_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<HD>());
    if (err != cudaSuccess) return err;
    return attrs_of(kern, NTHREADS, (int)smem_bytes<HD>(), out);
  });
}
