// Flash attention forward, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:108): GQA attention forward, causal
// and/or local window, online softmax with f32 accumulators, KV tiles that
// the mask fully excludes skipped.  Query head h reads KV head h / G.
//
// What bounds it on the H100.  At the serving shape (B 8, S = T 512, H 9,
// KV 3, hd 64, bf16, causal) the function must move about 12.6 MB (q, k, v
// read once, o written once: 3.8 us at 3.35 TB/s) and do about 2.4 GFLOP
// (causal half of 4*B*H*S*T*hd: 2.4 us at 989 TFLOP/s), so bytes set the
// least time.  This first version does both products as f32 FMAs out of
// shared memory, without tensor cores (no wgmma, no TMA, no warp
// specialisation), so FMA issue and shared-memory loads, not device memory,
// bound it; tensor cores are the next step.
//
// What the design does about the bytes.  The TPU grid walks the KV tiles in
// order and carries m, l and acc in VMEM scratch from one grid step to the
// next.  Here one block owns one (query tile, head, batch) and loops over
// the KV tiles itself, up to the causal / window limit: m, l and acc live in
// registers, K/V tiles are staged once in shared memory and used by all 64
// query rows, and scores and probabilities never leave the SM.  Each q tile
// is read once.  The G query heads of one KV head re-read its tiles, which
// the 50 MB L2 serves.  q/k/v are read in the public (B, S, H, hd) layout
// through their strides: no transpose copy.  Ragged S and T are masked at
// the edge instead of being padded.
//
// Head dims 16 to 256.  At hd 256 (recurrentgemma-9b's local attention) a
// block takes 213,760 bytes of dynamic shared memory, so one block runs per
// SM, and ptxas gives a thread 240 registers with no spills (CUDA 12.8); a
// 32-key tile (139,904 bytes, 212 registers) measured no faster on the H100.
//
// Numerics follow the TPU kernel: scores are scaled, masked with the finite
// NEG_INF = -1e30 (with -inf, a row whose first tile is fully masked would
// turn into NaN; with -1e30 the junk it gathers is wiped by the later
// alpha = exp(m_prev - m_new) = 0), and the output is acc / max(l, 1e-30)
// in q's dtype.  Keys past T (the ragged edge) get -inf, so they add
// exactly nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int NTHREADS = 128;  // 4 warps; warp w owns query rows 16w..16w+15
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int H, int G, long long sqb, long long sqs, long long sqh,
                 long long skb, long long sks, long long skh, long long svb,
                 long long svs, long long svh, int causal, int window,
                 float scale) {
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

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * svb + kvh * svh;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    sQ[r * QS + d] =
        (q0 + r < S) ? to_f32(qb[(long long)(q0 + r) * sqs + d]) : 0.f;
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
      sK[r * KS + d] = in ? to_f32(kb[(long long)(k0 + r) * sks + d]) : 0.f;
      sV[r * HD + d] = in ? to_f32(vb[(long long)(k0 + r) * svs + d]) : 0.f;
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
    T* orow = o + ((long long)b * S + qpos) * H * HD + (long long)h * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(orow + tx + 8 * c, acc[i][c] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV, long long sqb,
                   long long sqs, long long sqh, long long skb, long long sks,
                   long long skh, long long svb, long long svs, long long svh,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, H / KV, sqb,
      sqs, sqh, skb, sks, skh, svb, svs, svh, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int S, int Tk, int H, int KV,
                      long long sqb, long long sqs, long long sqh,
                      long long skb, long long sks, long long skh,
                      long long svb, long long svs, long long svh,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
#define FLASH_HD_CASE(N)                                                      \
  case N:                                                                     \
    return launch<T, N>(q, k, v, o, B, S, Tk, H, KV, sqb, sqs, sqh, skb, sks, \
                        skh, svb, svs, svh, causal, window, scale, stream);
  switch (hd) {
    FLASH_HD_CASE(16)
    FLASH_HD_CASE(32)
    FLASH_HD_CASE(64)
    FLASH_HD_CASE(128)
    FLASH_HD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_HD_CASE
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).  The caller
// has checked shapes, dtypes and strides (stride 1 on hd); `o` is a
// contiguous (B, S, H, hd) tensor of q's dtype.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int S, int Tk, int H, int KV, int hd, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, int causal, int window, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, Tk, H, KV, sqb,
                                         sqs, sqh, skb, sks, skh, svb, svs,
                                         svh, causal, window, scale, st);
  return (int)launch_hd<float>(hd, q, k, v, o, B, S, Tk, H, KV, sqb, sqs, sqh,
                               skb, sks, skh, svb, svs, svh, causal, window,
                               scale, st);
}
