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
// (and of this package's ref.wkv6_ref), at every sequence length.
//
// What bounds it on the H100.  At the serving shape of rwkv6-3b (B 8, S 512,
// H 40, N 64; r, k, v and the output in bf16, w in f32, the state in and out
// in f32) the function must move 136,325,120 bytes (0.0407 ms at 3.35 TB/s)
// and do 5 N^2 float32 operations per token and head (k v^T 1, the state
// update 2, the output product 2): 3.36 GFLOP, 0.0501 ms at the 67 TFLOP/s
// of the CUDA cores.  So the float32 operations set the least time, by a
// little.  The recurrence over S is sequential; only (batch, head) and the
// state's columns give parallel work.
//
// What the design does about it.  The TPU kernel walks the sequence as a
// sequential grid over chunks of 16 tokens and keeps the state in VMEM
// between grid steps, with the intra-chunk terms as MXU products.  Hopper
// has no ordered grid, so one block owns one (batch, head) and loops over
// the sequence itself; the state never leaves registers.  Thread (m, p),
// p < P, holds rows n = j * P + p (j < N / P) of column m of S, so each
// state element lives in one register of one thread; per token the P
// partial sums of o_t[m] are folded with two warp shuffles.  The block
// stages C = 16 tokens of r, k, v and w in shared memory per pair of
// barriers: every input element is read from device memory once and the
// output written once.  Rows are interleaved across p so that the four
// rows one warp reads at a time sit in four banks.  Tokens are taken one
// by one in the oracle's order, so no cumulative decay is ever formed and
// no decay floor is needed for range (the model keeps its clip).
//
// This first version runs B * H blocks of N * P threads (320 blocks of 256
// at the serving shape, about 2.4 per SM); the chunked tensor-core form
// (intra-chunk products on the tensor cores, as the TPU kernel does on its
// MXU) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int P = 4;   // threads per state column
constexpr int C = 16;  // tokens staged per pair of barriers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N * P)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ s_out, int S, int H) {
  constexpr int R = N / P;  // state rows per thread
  constexpr int NT = N * P;
  __shared__ float sr[C][N], sk[C][N], sv[C][N], sw[C][N], su[N];

  const int tid = threadIdx.x;
  const int m = tid / P;
  const int p = tid % P;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh % H;

  const long long sbase = (long long)bh * N * N;
  float st[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    st[j] = s0 ? s0[sbase + (long long)(j * P + p) * N + m] : 0.f;
  if (tid < N) su[tid] = u[h * N + tid];

  // element (b, t, h, n) of the (B, S, H, N) inputs and output
  const long long tstride = (long long)H * N;
  const long long base = (long long)b * S * tstride + (long long)h * N;

  for (int t0 = 0; t0 < S; t0 += C) {
    const int nc = min(C, S - t0);
    __syncthreads();  // the previous chunk is consumed (and su is written)
    for (int i = tid; i < nc * N; i += NT) {
      const int c = i / N, n = i % N;
      const long long off = base + (long long)(t0 + c) * tstride + n;
      sr[c][n] = to_f32(r[off]);
      sk[c][n] = to_f32(k[off]);
      sv[c][n] = to_f32(v[off]);
      sw[c][n] = w[off];
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float vm = sv[c][m];
      float o0 = 0.f, o1 = 0.f;  // two chains of FMAs, not one
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int n = j * P + p;
        const float kv = sk[c][n] * vm;
        const float a = fmaf(su[n], kv, st[j]);
        if (j & 1)
          o1 = fmaf(sr[c][n], a, o1);
        else
          o0 = fmaf(sr[c][n], a, o0);
        st[j] = fmaf(sw[c][n], st[j], kv);
      }
      float o = o0 + o1;
#pragma unroll
      for (int d = P / 2; d > 0; d >>= 1)
        o += __shfl_xor_sync(0xffffffffu, o, d);
      if (p == 0) store(out + base + (long long)(t0 + c) * tstride + m, o);
    }
  }

#pragma unroll
  for (int j = 0; j < R; ++j)
    s_out[sbase + (long long)(j * P + p) * N + m] = st[j];
}

template <typename T>
cudaError_t launch(int N, const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, void* out,
                   float* s_out, int B, int S, int H, cudaStream_t stream) {
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  const dim3 grid(B * H);
  switch (N) {
    case 16:
      wkv6_kernel<T, 16><<<grid, 16 * P, 0, stream>>>(rr, kk, vv, w, u, s0,
                                                     oo, s_out, S, H);
      break;
    case 32:
      wkv6_kernel<T, 32><<<grid, 32 * P, 0, stream>>>(rr, kk, vv, w, u, s0,
                                                     oo, s_out, S, H);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64 * P, 0, stream>>>(rr, kk, vv, w, u, s0,
                                                     oo, s_out, S, H);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  r, k, v (bf16 when is_bf16, else
// f32), w (f32) and out (r's type) are contiguous (B, S, H, N); u is (H, N)
// f32; s0 is (B, H, N, N) f32 or null for a zero state; s_out is (B, H, N, N)
// f32.  S >= 1, N in {16, 32, 64}.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* s0,
                        void* out, float* s_out, int is_bf16, int B, int S,
                        int H, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(N, r, k, v, w, u, s0, out, s_out, B, S,
                                      H, st);
  return (int)launch<float>(N, r, k, v, w, u, s0, out, s_out, B, S, H, st);
}
