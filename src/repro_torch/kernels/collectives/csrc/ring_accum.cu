// Ring-hop combine for Hopper (sm_90a): out = msg + chunk.
//
// Replaces the TPU kernel of the reference:
//   ring_accum_kernel  <- src/repro/kernels/collectives/kernel.py:117
//                         (ring_accum_kernel, body _accum_kernel :113)
//
// What it computes.  One hop of a ring reduce-scatter: the partial sum of
// a chunk received from the ring neighbour, plus this rank's own value of
// that chunk, elementwise in the comm dtype.  f32 adds in f32; bf16 and
// f16 widen both operands to f32, add once and round to nearest-even, as
// torch.add (the plain version, ref.py) rounds them.  ``out`` may be the
// received buffer itself: each element is read before it is written, by
// the same thread.
//
// What bounds it.  No arithmetic worth counting: two reads and one write
// per element, so device-memory bandwidth.  A ResNet-50 half-shard at a
// ring of 4 is about 131,072 f32 elements (1.5 MB of traffic, 0.47 us at
// 3.35 TB/s), so one launch is far shorter than its launch overhead: at
// these sizes the count of launches (2 per hop, 2(g-1) per reduce-
// scatter) is what costs, not the bytes.
//
// What the design does about it.  On the TPU the grid walked the shard
// in 1024-element VMEM blocks, in order.  Here one launch covers the
// whole chunk: a grid-stride loop over 16-byte vectors (4 f32 or 8 bf16/
// f16 a thread) when all three pointers are 16-byte aligned, then a
// scalar tail; a misaligned chunk (the odd halves of a bidirectional
// ring) takes the scalar loop alone.  Neighbouring threads touch
// neighbouring vectors; the grid is capped at 8 blocks a multiprocessor
// and strides over whatever a larger chunk holds beyond that.
// Fusing the two directions' combines into one launch, or the hop into
// the transfer, is left for later.
//
// Interface: plain C, loaded with ctypes (kernel.py).  The entry point
// returns cudaGetLastError() after its launch; the wrapper raises if it
// is not 0.  The launch goes to the caller's stream and never
// synchronizes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return from_f32<T>(to_f32(a) + to_f32(b));
}

// No __restrict__: out may alias msg.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_accum_kernel(const T* msg, const T* chunk, T* out, int64_t n,
                  bool vec) {
  constexpr int kV = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nv = vec ? n / kV : 0;
  for (int64_t i = tid; i < nv; i += stride) {
    const uint4 a = reinterpret_cast<const uint4*>(msg)[i];
    const uint4 b = reinterpret_cast<const uint4*>(chunk)[i];
    uint4 o;
    const T* pa = reinterpret_cast<const T*>(&a);
    const T* pb = reinterpret_cast<const T*>(&b);
    T* po = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < kV; ++j) po[j] = add(pa[j], pb[j]);
    reinterpret_cast<uint4*>(out)[i] = o;
  }
  for (int64_t i = nv * kV + tid; i < n; i += stride) {
    out[i] = add(msg[i], chunk[i]);
  }
}

template <typename T>
cudaError_t launch(const void* msg, const void* chunk, void* out, int64_t n,
                   cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = aligned(msg) && aligned(chunk) && aligned(out);
  const int64_t work = vec ? n / kV + n % kV : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ring_accum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(msg), static_cast<const T*>(chunk),
      static_cast<T*>(out), n, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[0, n) = msg[0, n) + chunk[0, n), all three of one dtype code.
int ring_accum(const void* msg, const void* chunk, void* out, int64_t n,
               int dtype, int device, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: err = launch<float>(msg, chunk, out, n, s); break;
    case kBF16: err = launch<__nv_bfloat16>(msg, chunk, out, n, s); break;
    case kF16: err = launch<__half>(msg, chunk, out, n, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
