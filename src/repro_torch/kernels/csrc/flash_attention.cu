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
// 128 its fragments stay in registers, at hd 192 and 256 they are re-read
// from shared memory (O's accumulators alone take 96 registers a thread
// at hd 192, 128 at hd 256).
// The KV loop runs only over the tiles that hold a visible key for some
// row of the block (the window's first tile to the causal diagonal), and
// only the diagonal tile, the window's edge tile and the ragged tail are
// masked element by element.  Under a causal mask the heaviest query
// tiles are launched first.  Inputs whose base pointers or strides are
// not 16-byte aligned are staged element by element into the same layout.
// Tiles (Bf16Tiles): see the table there for the choice, the shared
// memory and ptxas's registers and spills.
//
// float32: FMAs on the CUDA cores (flash_fwd_f32_kernel), float32
// throughout, bound by its operations (67 TFLOP/s: nemotron-4-340b's
// prefill at hd 192 does 77.3 GFLOP, 1.154 ms).  To keep the FMA units fed
// from shared memory, each lane sums an 8 x 8 block of scores (and an 8 x
// TC block of O) from 16-byte loads, 4 FMAs for every float it reads
// (4.8 at hd 192); where the block's K and V tiles leave too few scores
// for 8 x 8 a lane (every head dim but 16), the lanes of a row group split
// Q K^T's depth and sum their partial blocks by a reduce-scatter of warp
// shuffles, which leaves each lane whole rows for the softmax.  P goes to
// shared memory and is read back by the same warp.  K and V are staged by
// 16-byte cp.async into a two-stage ring as in bf16 (one barrier a tile),
// and the KV range, the masks of the edge tiles only, the heaviest-first
// order and the unaligned staging are the bf16 kernel's; a warp also skips
// the tiles in which none of its own rows sees a key.  Tiles (F32Tiles):
// at least 8 warps an SM at every head dim; see the table there.
//
// Head dims: 16, 32, 64, 128, 192 and 256 (with_hd), those of every
// configured arch with attention; any other is refused.
//
// Numerics follow the TPU kernel: scores are scaled, masked with the finite
// NEG_INF = -1e30 (with -inf, a row whose first tile is fully masked would
// turn into NaN; with -1e30 the junk it gathers is wiped by the later
// alpha = exp(m_prev - m_new) = 0), and the output is acc / max(l, 1e-30)
// in q's dtype.  Keys past T (the ragged edge) get -inf, so they add
// exactly nothing.  Both kernels work in base 2: log2(e) is folded into the
// scale and exp2f takes the place of exp, which changes nothing but the
// last bits.  The bf16 kernel rounds P to bf16 before the P V product, as
// the JAX model's chunked_attention and every tensor-core flash kernel do;
// l sums the unrounded f32 P.  That rounding costs about one bf16 ulp of the
// output (tests/test_torch_flash_numerics.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;

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
//   192   4      32   73,728 B      227         0       2
//   256   4      32   98,304 B      255         0       2
//
// Chosen on the card among 4 and 8 warps and BK 32 and 64: 8 warps were
// no faster at any head dim, and at hd 256 BK 64 spills registers and is
// slower, while BK 32 keeps two blocks on an SM (that sweep's script is
// not kept, so its times are not recorded).  At hd 192 (nemotron-4-340b)
// BK 64 spills nothing at 255 registers but its 122,880 B leave one block
// on an SM, and it took 0.787 ms at nemotron's prefill against BK 32's
// 0.537 (flash_sweep.py; PERF.md section 6).
template <int HD>
struct Bf16Tiles {
  static constexpr int WARPS = 4;
  static constexpr int BK = HD >= 192 ? 32 : 64;
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

// ---------------------------------------------------------------------------
// float32 kernel: FMAs on the CUDA cores from register tiles
// ---------------------------------------------------------------------------

// Tiles of the float32 kernel, by head dim.  A warp owns WR query rows in
// row groups of 8; the CG lanes of a row group split them two ways.  In
// Q K^T each lane sums an 8 x 8 block of scores (8 rows by 8 keys: keys
// j KG + kg) over 1 / DG of the depth, from 16-byte loads of 8 q and 8 k
// values: 256 FMAs for 16 float4, 4 FMAs a float read; the DG partial
// blocks are then summed by a reduce-scatter over the lanes, which leaves
// each lane R = 8 / DG rows of 8 keys for the softmax.  In P V each lane
// owns its row group's 8 rows by TC of O's columns (8 x 8 FMAs for 4 + 4
// floats a key, 4 FMAs a float read; 8 x 12 for 5 float4 at hd 192, 4.8),
// reading P^T and V as float4.  P goes through shared memory, written and
// read within one warp.  K rows are padded by DG % 8 16-byte units so that
// the 8 lanes of a 16-byte load phase fall in 8 different bank groups.
// What the card reports (chip_smoke.py phase 2: cudaFuncGetAttributes and
// the occupancy calculator; the registers and spills are ptxas's), built
// by CUDA 12.8 on an H100 80GB HBM3:
//
//   hd   warps  BQ   BK  TC  DG  shared memory  registers  spills  blocks/SM
//   16   1      128  16  8   1    21,504 B      254        0       8
//   32   1       64  16  8   2    21,760 B      233        0       8
//   64   4      128  32  8   2    84,480 B      233        0       2
//   128  4       64  32  8   4   110,848 B      247        0       2
//   192  8      128  32  12  4   217,600 B      255        0       1
//   256  8       64  32  8   8   205,056 B      254        0       1
//
// So 8 warps are resident on an SM at every head dim (4 at hd 192 and
// 256 before).  O's accumulators take 8 TC registers a lane (96 at hd
// 192), the scores 64, one depth unit's K values 32.  With the depth loop
// unrolled whole the compiler hoists the next units' loads, and at hd 128
// and 192 spills (16 and 40 bytes); so the loads go one unit at a time
// (DUB), but at hd 256, where whole is 1.5-2.8 % faster (flash_sweep.py
// --dtype float32, call flash32c; there also P V's key loop unrolled by 2
// or 8, hd 64 in 2-warp blocks of 16 keys and hd 192 in 4-warp blocks of
// 16 keys, none faster by more than 2.4 % at any cell).
template <int HD>
struct F32Tiles {
  static constexpr int TC = HD == 192 ? 12 : 8;  // O's columns a lane
  static constexpr int CG = HD / TC;             // lanes of a row group
  static constexpr int WR = 8 * (32 / CG);       // rows a warp
  static constexpr int WARPS = HD >= 192 ? 8 : HD >= 64 ? 4 : 1;
  static constexpr int BQ = WR * WARPS;
  static constexpr int BK = HD <= 32 ? 16 : 32;
  static constexpr int KG = BK / 8;              // key groups of 8 keys
  static constexpr int DG = CG / KG;             // depth split of Q K^T
  static constexpr int R = 8 / DG;               // rows a lane in softmax
  static constexpr int NT = 32 * WARPS;
  static constexpr int KS = HD + 4 * (DG % 8);   // K's row stride
  // depth units of Q K^T whose loads the compiler may issue together
  static constexpr int DUB = HD == 256 ? HD / 4 / DG : 1;
  // floats: Q, two stages of K and of V, P^T, a value a row (alpha, l)
  static constexpr int SMEM = 4 * (BQ * HD + 2 * BK * (KS + HD) + BQ * BK + BQ);
  static_assert(CG * TC == HD && 32 % CG == 0 && KG * DG == CG &&
                    TC % 4 == 0 && (HD / 4) % DG == 0 &&
                    (HD / 4 / DG) % DUB == 0,
                "float32 tiles");
};

// Stage rows r0 .. r0 + R - 1 of one head (row stride rs elements) into a
// tile of row stride LD floats; rows at or past n are zero-filled.  With
// vec by 16-byte cp.async, else element by element.
template <int HD, int R, int LD, int NT>
__device__ __forceinline__ void stage_rows_f32(float* s, const float* g,
                                               long long rs, int r0, int n,
                                               bool vec) {
  constexpr int UPR = HD / 4;  // 16-byte units a row
  constexpr int UNITS = R * UPR;
#pragma unroll
  for (int i0 = 0; i0 < UNITS; i0 += NT) {
    const int i = i0 + threadIdx.x;
    if (UNITS % NT != 0 && i >= UNITS) break;
    const int r = i / UPR, c = i % UPR;
    const bool in = r0 + r < n;
    const float* src = g + (in ? r0 + r : 0) * rs + c * 4;
    float* dst = s + r * LD + c * 4;
    if (vec) {
      cp_async_16(smem_addr(dst), src, in ? 16 : 0);
    } else {
      *reinterpret_cast<float4*>(dst) =
          in ? make_float4(src[0], src[1], src[2], src[3])
             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(F32Tiles<HD>::NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int Tk, int H, int G, long long sqb,
                     long long sqs, long long sqh, long long skb,
                     long long sks, long long skh, long long svb,
                     long long svs, long long svh, int causal, int window,
                     float scale_log2, int vec) {
  using C = F32Tiles<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, WR = C::WR;
  constexpr int CG = C::CG, KG = C::KG, DG = C::DG, R = C::R, KS = C::KS;
  constexpr int DU = HD / 4 / DG;  // 16-byte depth units a lane sums
  constexpr int TU = C::TC / 4;    // 16-byte units of O a lane owns
  extern __shared__ __align__(16) float smem_f[];
  float* sQ = smem_f;                // BQ x HD
  float* sK = sQ + BQ * HD;          // two stages of BK x KS
  float* sV = sK + 2 * BK * KS;      // two stages of BK x HD
  float* sP = sV + 2 * BK * HD;      // each warp's P^T, BK x WR
  float* sA = sP + BQ * BK;          // each warp's alpha, then l

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane % CG, kg = c / DG, dg = c % DG;
  const int prow = (lane / CG) * 8;  // the row group's first row in the warp
  const int srow = prow + dg * R;    // this lane's first softmax row
  // under a causal mask the last query tiles see the most keys: first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + (h / G) * skh;
  const float* vb = v + b * svb + (h / G) * svh;

  // the KV tiles that hold a visible key for some row of this block, and
  // of this warp (rows w0 .. w1; none past S)
  const int nk = (Tk + BK - 1) / BK;
  const int kt_lo = window ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = causal ? min(nk, (min(q0 + BQ, S) - 1) / BK + 1) : nk;
  const int w0 = q0 + warp * WR, w1 = min(w0 + WR, S) - 1;
  const int wk_lo = window ? max(0, w0 - window + 1) / BK : 0;
  const int wk_hi = w1 < w0 ? 0 : causal ? min(nk, w1 / BK + 1) : nk;

  stage_rows_f32<HD, BQ, HD, NT>(sQ, qb, sqs, q0, S, vec);
  stage_rows_f32<HD, BK, KS, NT>(sK, kb, sks, kt_lo * BK, Tk, vec);
  stage_rows_f32<HD, BK, HD, NT>(sV, vb, svs, kt_lo * BK, Tk, vec);
  cp_async_commit();

  float* pw = sP + warp * WR * BK;  // P^T of this warp: [key][row]
  float* aw = sA + warp * WR;
  const float* qw = sQ + (warp * WR + prow) * HD;
  float acc[8][C::TC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < C::TC; ++e) acc[i][e] = 0.f;
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) {
      stage_rows_f32<HD, BK, KS, NT>(sK + (stage ^ 1) * BK * KS, kb, sks,
                                     (kt + 1) * BK, Tk, vec);
      stage_rows_f32<HD, BK, HD, NT>(sV + (stage ^ 1) * BK * HD, vb, svs,
                                     (kt + 1) * BK, Tk, vec);
      cp_async_commit();
    }
    if (kt < wk_lo || kt >= wk_hi) continue;  // no visible key: the warp
    const float* cK = sK + stage * BK * KS;
    const float* cV = sV + stage * BK * HD;

    // this lane's part of Q K^T: rows prow + i, keys j KG + kg, depth
    // units du DG + dg
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int du0 = 0; du0 < DU; du0 += C::DUB) {
#pragma unroll
      for (int du = du0; du < du0 + C::DUB; ++du) {
        const int d = (du * DG + dg) * 4;
        float4 kf[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kf[j] =
              *reinterpret_cast<const float4*>(cK + (j * KG + kg) * KS + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qf =
              *reinterpret_cast<const float4*>(qw + i * HD + d);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
          }
        }
      }
    }
    // the DG partial sums by a reduce-scatter over the depth lanes: each
    // step keeps half of the rows and sends the other half; rows srow ..
    // srow + R - 1 end in s[0 .. R - 1]
#pragma unroll
    for (int msk = DG / 2, cnt = 8; msk >= 1; msk >>= 1, cnt >>= 1) {
      const bool up = dg & msk;
#pragma unroll
      for (int i = 0; i < cnt / 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float send = up ? s[i][j] : s[cnt / 2 + i][j];
          const float keep = up ? s[cnt / 2 + i][j] : s[i][j];
          s[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, msk);
        }
    }

    // scale, then mask: only the diagonal tile, the window's edge tile and
    // the ragged tail hold masked keys (warp-uniform branch)
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > w0) ||
                      (window && k0 <= w0 + WR - 1 - window);
    float mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = m[r];
      const int qpos = w0 + srow + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[r][j] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * KG + kg;
          if (kpos >= Tk)
            x = -CUDART_INF_F;
          else if ((causal && kpos > qpos) ||
                   (window && kpos <= qpos - window))
            x = NEG_INF;
        }
        s[r][j] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    // online softmax over the key lanes of each row; each lane keeps its
    // own part of l until the end
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int msk = DG; msk < CG; msk <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], msk));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    __syncwarp();  // the warp's reads of the last tile's P and alpha are done
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[r][j] - m[r]);
        l[r] += p;
        pw[(j * KG + kg) * WR + srow + r] = p;
      }
      if (kg == 0) aw[srow + r] = alpha[r];
    }
    __syncwarp();

    // O = alpha O + P V: the row group's 8 rows, columns (tu CG + c) 4 ..
    {
      const float4 a0 = *reinterpret_cast<const float4*>(aw + prow);
      const float4 a1 = *reinterpret_cast<const float4*>(aw + prow + 4);
      const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < C::TC; ++e) acc[i][e] *= al[i];
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(pw + j * WR + prow);
      const float4 p1 =
          *reinterpret_cast<const float4*>(pw + j * WR + prow + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int tu = 0; tu < TU; ++tu) {
        const float4 vv =
            *reinterpret_cast<const float4*>(cV + j * HD + (tu * CG + c) * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * tu] = fmaf(pv[i], vv.x, acc[i][4 * tu]);
          acc[i][4 * tu + 1] = fmaf(pv[i], vv.y, acc[i][4 * tu + 1]);
          acc[i][4 * tu + 2] = fmaf(pv[i], vv.z, acc[i][4 * tu + 2]);
          acc[i][4 * tu + 3] = fmaf(pv[i], vv.w, acc[i][4 * tu + 3]);
        }
      }
    }
  }
  cp_async_wait_all();  // nothing in flight at exit, even with no KV tile

  // l over the key lanes, then each row's l to the lanes that own its O
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int msk = DG; msk < CG; msk <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], msk);
  __syncwarp();
  if (kg == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) aw[srow + r] = l[r];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = w0 + prow + i;
    if (qpos >= S) continue;
    const float den = fmaxf(aw[prow + i], 1e-30f);
    float* orow = o + ((long long)b * S + qpos) * H * HD + (long long)h * HD;
#pragma unroll
    for (int tu = 0; tu < TU; ++tu)
      *reinterpret_cast<float4*>(orow + (tu * CG + c) * 4) = make_float4(
          acc[i][4 * tu] / den, acc[i][4 * tu + 1] / den,
          acc[i][4 * tu + 2] / den, acc[i][4 * tu + 3] / den);
  }
}

template <int HD>
cudaError_t prepare_f32() {
  auto kern = flash_fwd_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F32Tiles<HD>::SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Tk, int H, int KV, long long sqb,
                       long long sqs, long long sqh, long long skb,
                       long long sks, long long skh, long long svb,
                       long long svs, long long svh, int causal, int window,
                       float scale, cudaStream_t stream) {
  using C = F32Tiles<HD>;
  cudaError_t err = prepare_f32<HD>();
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   (sqb | sqs | sqh | skb | sks | skh | svb | svs | svh) % 4 ==
                       0;
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  flash_fwd_f32_kernel<HD><<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, H / KV,
      sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, causal, window,
      scale * LOG2E, vec);
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
    case 192: return f(std::integral_constant<int, 192>{});
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
// tensor-core kernel, float32 the register-tiled FMA kernel.
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
    return launch_f32<HD>(q, k, v, o, B, S, Tk, H, KV, sqb, sqs, sqh, skb,
                          sks, skh, svb, svs, svh, causal, window, scale, st);
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
    cudaError_t err = prepare_f32<HD>();
    if (err != cudaSuccess) return err;
    return attrs_of(flash_fwd_f32_kernel<HD>, F32Tiles<HD>::NT,
                    F32Tiles<HD>::SMEM, out);
  });
}
