// Flash-attention forward for Hopper (sm_90a): causal or full online-softmax
// attention, one (batch, q head, 64-row q tile) per thread block.
//
// Replaces the TPU kernel of the reference:
//   flash_attention_fwd  <- src/repro/kernels/flash_attention/kernel.py:78
//                           (flash_attention_fwd, body _fwd_kernel :25)
//
// What it computes.  For each q row: q is cast to f32 and multiplied by
// scale = 1/sqrt(D) before the product with k (f32); scores the causal mask
// hides become -1e30 (not -inf); a running max m, running sum l and the
// output accumulator stay in f32 and are rescaled by exp(m_old - m_new)
// each k tile; P.V is an f32 product (v read as f32).  k tiles wholly above
// the diagonal are skipped.  The output is acc / (l > 0 ? l : 1), cast to
// q's dtype.  These are the TPU kernel's numerics; the wrapper's plain
// version (ref.py) computes the same function with a dense softmax.
//
// What bounds it on this card.  Moving q, k, v and o once is the byte
// bound (Qwen3-1.7B's static prefill, B 4, S 512, 16 q / 8 kv heads, D 128,
// bf16: 25.2 MB, 7.5 us at 3.35 TB/s); its 4.3 GFLOP of causal scores and
// P.V are below that only on the tensor cores.  This design keeps the TPU
// kernel's f32 arithmetic on the CUDA cores (67 TFLOP/s f32: at least 64 us
// at that shape), so it is bound by operations, and far above the byte
// bound.  Rounding P to bf16 for wgmma, TMA loads and a pipelined k loop
// are later work.
//
// What the design does.  The TPU's sequential k grid axis becomes a loop
// inside the block that stops at the diagonal tile.  The q tile (scaled,
// f32) and each k tile are staged transposed in shared memory, the v tile
// row-major, in the input dtype (64 x 128 bf16 is 16 KB).  256 threads form
// a 16 x 16 grid: each computes a 4 x 4 block of the 64 x 64 score tile
// from float4 reads of the q tile, and the row max and row sum are reduced
// over the 16 threads that share a row with warp shuffles.  The
// probabilities go through shared memory (transposed) to P.V, where each
// thread owns 4 rows x D/16 output columns of the accumulator, in
// registers, with m and l.  GQA reads kv head h / (Hq / Hkv) instead of
// repeating k and v, and every tensor is read through its (B, S, H, D)
// strides, so the wrapper needs no transpose or copy.  A ragged last tile
// (S not a multiple of 64) is masked: missing k rows load as zeros with
// score -1e30, missing q rows are computed and not stored.
//
// Interface: plain C, loaded with ctypes (kernel.py).  The entry point
// returns cudaGetLastError() after its launch; the wrapper raises if it is
// not 0.  The launch goes to the caller's stream and never synchronizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockQ = 64;     // q rows per block
constexpr int kBlockK = 64;     // k rows per tile of the inner loop
constexpr int kThreads = 256;   // 16 x 16: a 4 x 4 score block each
constexpr int kPad = 68;        // row stride of the transposed tiles (16-byte rows)
constexpr float kNegInf = -1e30f;

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element strides of a (B, S, H, D) tensor whose last dim is contiguous.
struct Strides {
  int64_t b, s, h;
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(D) * kPad + kBlockK * kPad) * sizeof(float) +
         (static_cast<size_t>(D) * kPad + static_cast<size_t>(kBlockK) * D) * sizeof(T);
}

__device__ __forceinline__ float row_max16(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Hq,
                 int group, Strides qs, Strides ks, Strides vs, float scale,
                 bool causal) {
  static_assert(D % 16 == 0 && D <= 256, "D must be a multiple of 16, at most 256");
  constexpr int kCols = D / 16;                  // output columns per thread
  constexpr int kVec = kCols < 4 ? kCols : 4;    // consecutive columns per group
  constexpr int kGroups = kCols / kVec;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_t = reinterpret_cast<float*>(smem);            // [D][kPad] q * scale, f32
  float* p_t = q_t + D * kPad;                            // [kBlockK][kPad] probabilities
  T* k_t = reinterpret_cast<T*>(p_t + kBlockK * kPad);    // [D][kPad] k tile
  T* v_s = k_t + D * kPad;                                // [kBlockK][D] v tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = q0 + r;
    q_t[d * kPad + r] = row < S ? to_f32(qb[row * qs.s + d]) * scale : 0.f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_k = (S + kBlockK - 1) / kBlockK;
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int kt_end = causal ? min(n_k, q_last / kBlockK + 1) : n_k;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();   // the last tile's k_t, v_s and p_t are read; q_t is written
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int row = k0 + r;
      T kx = from_f32<T>(0.f), vx = from_f32<T>(0.f);
      if (row < S) {
        kx = kb[row * ks.s + d];
        vx = vb[row * vs.s + d];
      }
      k_t[d * kPad + r] = kx;
      v_s[r * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&q_t[d * kPad + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = to_f32(k_t[d * kPad + tx * 4 + j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool valid = kpos < S && (!causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_t[(tx * 4 + j) * kPad + ty * 4 + i] = s[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr[i];
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&p_t[c * kPad + ty * 4]);
      const float pv[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float vx = to_f32(v_s[c * D + g * 16 * kVec + tx * kVec + e]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][g * kVec + e] = fmaf(pv[i], vx, acc[i][g * kVec + e]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    T* orow = o + ((static_cast<int64_t>(b) * S + row) * Hq + h) * D;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        orow[g * 16 * kVec + tx * kVec + e] = from_f32<T>(acc[i][g * kVec + e] / l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Hq, int Hkv, const Strides& qs, const Strides& ks,
                   const Strides& vs, float scale, bool causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hq / Hkv, qs, ks,
      vs, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int S, int Hq, int Hkv, const Strides& qs,
                       const Strides& ks, const Strides& vs, float scale,
                       bool causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Hq, Hkv, qs, ks, vs, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, qs, ks, vs, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, qs, ks, vs, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, Hq, Hkv, qs, ks, vs, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, S, Hq, D), k/v (B, S, Hkv, D) through their (b, s, h) element
// strides, last dim contiguous -> o (B, S, Hq, D) contiguous.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int D,
                        const int64_t* q_strides, const int64_t* k_strides,
                        const int64_t* v_strides, int dtype, int causal,
                        float scale, int device, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_strides[0], q_strides[1], q_strides[2]};
  const Strides ks{k_strides[0], k_strides[1], k_strides[2]};
  const Strides vs{v_strides[0], v_strides[1], v_strides[2]};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_d<float>(D, q, k, v, o, B, S, Hq, Hkv, qs,
                                                ks, vs, scale, causal != 0, st));
    case kBF16:
      return static_cast<int>(dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, Hq,
                                                        Hkv, qs, ks, vs, scale,
                                                        causal != 0, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
