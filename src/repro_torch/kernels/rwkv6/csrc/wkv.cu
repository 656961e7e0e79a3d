// RWKV-6 WKV chunk for Hopper (sm_90a): one chunk of the chunked-parallel
// WKV recurrence, one thread block per (batch * head) row.
//
// Replaces the TPU kernel of the reference:
//   wkv_chunk_kernel  <- src/repro/kernels/rwkv6/kernel.py:59
//                        (wkv_chunk_kernel, body _wkv_kernel :20)
//
// What it computes, per row bh, on r, k, v, logw (C, N), u (N) and the
// state s0 (N, N), all in f32 whatever the input dtype:
//   L = cumsum_t(logw), Lprev = L - logw, wc = L[C - 1]
//   y[t]  = (r_t exp(Lprev_t)) s0
//         + sum_{s<t} ((r_t exp(Lprev_t)) . (k_s exp(-L_s))) v_s
//         + (r_t . u k_t) v_t
//   s1    = diag(exp(wc)) s0 + sum_s (k_s exp(wc - L_s)) v_s^T
// The exponentials are factored as the TPU kernel factors them (r times
// exp(Lprev), k times exp(-L)), so the port rounds like the reference and,
// like it, overflows exp(-L) only at decays far beyond the model's clip.
// The scores at s >= t are not computed but written as 0, where the
// reference computes them and masks them to 0.  The wrapper's plain
// version (ref.py::wkv_chunk_ref) computes the same function.
//
// What bounds it on this card.  Reading r, k, v, logw and s0 and writing y
// and s1 once is the byte bound (RWKV-6 7B's prefill chunk, B 4, C 32,
// H 64, N 64, f32: 18.9 MB, 5.6 us at 3.35 TB/s); its ~201 MFLOP at 67
// TFLOP/s f32 take 3.0 us.  This design does its products on the CUDA
// cores from shared memory (each FMA reads one broadcast and one
// conflict-free word), so it is bound by shared-memory bandwidth, well
// above both.  Tensor cores, carrying the state across chunks inside one
// launch (one launch per layer instead of one per chunk) and TMA loads are
// later work.
//
// What the design does.  The TPU grid over BH becomes the CUDA grid: rows
// are independent.  A block of 256 threads stages r, k, v, logw (C x N,
// rows padded to N + 1 floats, so a warp reading one column of 32 rows
// hits 32 banks) and s0 (N x N) in shared memory, as f32.  Then, with a
// barrier between steps:
//   1. N threads run the cumulative sum over t, one channel each, serial
//      as the definition; the warps take the bonus r . (u k) of each row.
//   2. every (t, n) element turns r into r exp(Lprev), logw into
//      k exp(-L) and k into k exp(wc - L), in place.
//   3. the C x C scores: each thread owns one column s and C/4 rows.
//   4. y (each thread one column m, C*N/256 rows) and s1 (one column m,
//      N*N/256 rows), accumulated in registers and stored once.
// Shared memory: (5 C (N + 1) + N^2 + C^2 + C + 2 N) floats, 114 KB at
// C 64, N 64 (above 48 KB only through cudaFuncSetAttribute).  C is a
// runtime value from 1 to 64; N is a template parameter, 16 or 64.
//
// Interface: plain C, loaded with ctypes (kernel.py).  The entry point
// returns cudaGetLastError() after its launch; the wrapper raises if it is
// not 0.  The launch goes to the caller's stream and never synchronizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;           // longest chunk
constexpr int kScoreGroups = kThreads / kMaxC;   // row groups of the scores

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int N>
size_t smem_bytes(int C) {
  return (static_cast<size_t>(5) * C * (N + 1) + N * N + C * C + C + 2 * N) *
         sizeof(float);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ state,
                 float* __restrict__ y, float* __restrict__ s1, int C, int H) {
  static_assert(N * N >= kThreads && kThreads % N == 0, "N must be 16 or 64");
  constexpr int P = N + 1;                      // padded row of a C x N tile
  constexpr int kGroups = kThreads / N;         // row groups of y and s1
  constexpr int kYRows = (kMaxC + kGroups - 1) / kGroups;
  constexpr int kSRows = N / kGroups;
  constexpr int kScoreRows = kMaxC / kScoreGroups;

  extern __shared__ float smem[];
  float* rs = smem;              // [C][P] r, then r exp(Lprev)
  float* ks = rs + C * P;        // [C][P] k, then k exp(wc - L)
  float* vs = ks + C * P;        // [C][P] v
  float* lws = vs + C * P;       // [C][P] logw, then k exp(-L)
  float* Ls = lws + C * P;       // [C][P] L = cumsum(logw)
  float* s0 = Ls + C * P;        // [N][N] incoming state
  float* att = s0 + N * N;       // [C][C] strictly lower scores
  float* bonus = att + C * C;    // [C] r_t . (u k_t)
  float* us = bonus + C;         // [N] u of this head
  float* wc = us + N;            // [N] L[C - 1]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const size_t tile = static_cast<size_t>(C) * N;
  const size_t row0 = static_cast<size_t>(bh) * tile;

  for (int e = tid; e < C * N; e += kThreads) {
    const int i = (e / N) * P + e % N;
    rs[i] = to_f32(r[row0 + e]);
    ks[i] = to_f32(k[row0 + e]);
    vs[i] = to_f32(v[row0 + e]);
    lws[i] = logw[row0 + e];
  }
  const float* sb = state + static_cast<size_t>(bh) * N * N;
  for (int e = tid; e < N * N; e += kThreads) s0[e] = sb[e];
  if (tid < N) us[tid] = u[static_cast<size_t>(bh % H) * N + tid];
  __syncthreads();

  // 1. cumulative log-decay per channel; the bonus of each row
  if (tid < N) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      acc += lws[t * P + tid];
      Ls[t * P + tid] = acc;
    }
    wc[tid] = acc;
  }
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int t = warp; t < C; t += kThreads / 32) {
      float part = 0.f;
      for (int n = lane; n < N; n += 32) part += rs[t * P + n] * (us[n] * ks[t * P + n]);
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) bonus[t] = part;
    }
  }
  __syncthreads();

  // 2. the decay factors, in place
  for (int e = tid; e < C * N; e += kThreads) {
    const int n = e % N;
    const int i = (e / N) * P + n;
    const float L = Ls[i];
    const float kv = ks[i];
    rs[i] = rs[i] * expf(L - lws[i]);
    lws[i] = kv * expf(-L);
    ks[i] = kv * expf(wc[n] - L);
  }
  __syncthreads();

  // 3. scores att[t][s] = (r_t exp(Lprev_t)) . (k_s exp(-L_s)), s < t
  {
    const int s = tid % kMaxC;
    const int g = tid / kMaxC;
    if (s < C) {
      float acc[kScoreRows];
#pragma unroll
      for (int j = 0; j < kScoreRows; ++j) acc[j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float kn = lws[s * P + n];
#pragma unroll
        for (int j = 0; j < kScoreRows; ++j) {
          const int t = g + kScoreGroups * j;
          if (t < C) acc[j] += rs[t * P + n] * kn;
        }
      }
#pragma unroll
      for (int j = 0; j < kScoreRows; ++j) {
        const int t = g + kScoreGroups * j;
        if (t < C) att[t * C + s] = s < t ? acc[j] : 0.f;
      }
    }
  }
  __syncthreads();

  const int m = tid % N;
  const int g = tid / N;
  // 4a. y = (r exp(Lprev)) s0 + att v + bonus v
  {
    float inter[kYRows], intra[kYRows];
#pragma unroll
    for (int j = 0; j < kYRows; ++j) inter[j] = intra[j] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float sv = s0[n * N + m];
#pragma unroll
      for (int j = 0; j < kYRows; ++j) {
        const int t = g + kGroups * j;
        if (t < C) inter[j] += rs[t * P + n] * sv;
      }
    }
    for (int s = 0; s < C; ++s) {
      const float vv = vs[s * P + m];
#pragma unroll
      for (int j = 0; j < kYRows; ++j) {
        const int t = g + kGroups * j;
        if (t < C) intra[j] += att[t * C + s] * vv;
      }
    }
    float* yb = y + row0;
#pragma unroll
    for (int j = 0; j < kYRows; ++j) {
      const int t = g + kGroups * j;
      if (t < C) yb[t * N + m] = (inter[j] + intra[j]) + bonus[t] * vs[t * P + m];
    }
  }
  // 4b. s1 = diag(exp(wc)) s0 + (k exp(wc - L))^T v
  {
    float acc[kSRows];
#pragma unroll
    for (int j = 0; j < kSRows; ++j) acc[j] = 0.f;
    for (int s = 0; s < C; ++s) {
      const float vv = vs[s * P + m];
#pragma unroll
      for (int j = 0; j < kSRows; ++j) acc[j] += ks[s * P + g + kGroups * j] * vv;
    }
    float* ob = s1 + static_cast<size_t>(bh) * N * N;
#pragma unroll
    for (int j = 0; j < kSRows; ++j) {
      const int n = g + kGroups * j;
      ob[n * N + m] = s0[n * N + m] * expf(wc[n]) + acc[j];
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* state, float* y, float* s1, int BH,
                   int C, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes<N>(C);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_chunk_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<N>(kMaxC)));
  if (err != cudaSuccess) return err;
  wkv_chunk_kernel<T, N><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      logw, u, state, y, s1, C, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int N, const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* state,
                       float* y, float* s1, int BH, int C, int H,
                       cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16>(r, k, v, logw, u, state, y, s1, BH, C, H, stream);
    case 64: return launch<T, 64>(r, k, v, logw, u, state, y, s1, BH, C, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v (BH, C, N) in the dtype of `dtype`, logw (BH, C, N), u (H, N)
// (row bh reads u[bh % H]) and state (BH, N, N) in f32, all contiguous
// -> y (BH, C, N) f32 and s1 (BH, N, N) f32.
int wkv_chunk_fwd(const void* r, const void* k, const void* v, const void* logw,
                  const void* u, const void* state, void* y, void* s1, int BH,
                  int C, int N, int H, int dtype, int device, void* stream) {
  if (BH < 1 || C < 1 || C > kMaxC || H < 1 || BH % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* lw = static_cast<const float*>(logw);
  const auto* uf = static_cast<const float*>(u);
  const auto* s0 = static_cast<const float*>(state);
  auto* yf = static_cast<float*>(y);
  auto* s1f = static_cast<float*>(s1);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_n<float>(N, r, k, v, lw, uf, s0, yf, s1f, BH,
                                                C, H, st));
    case kBF16:
      return static_cast<int>(dispatch_n<__nv_bfloat16>(N, r, k, v, lw, uf, s0, yf,
                                                        s1f, BH, C, H, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
