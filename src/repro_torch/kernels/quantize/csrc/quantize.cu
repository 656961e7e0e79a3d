// int8 block quantize / dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels of the reference:
//   quantize_blocks_kernel    <- src/repro/kernels/quantize/kernel.py:33
//                                (quantize_blocks_kernel, body _quant_kernel :19)
//   dequantize_blocks_kernel  <- src/repro/kernels/quantize/kernel.py:54
//                                (dequantize_blocks_kernel, body _dequant_kernel :28)
//
// What they compute.  The wire format of the compressed reducer
// (core/compression.py), per block of 256 f32 elements:
//   scale = amax * fl(1/127) (1 when amax = 0), amax = max |x| over the block;
//   q     = clip(round-half-even(x / scale), -127, 127) as int8;
// and back: x = float(q) * scale.  The reference writes amax / 127.0;
// compiled (the Pallas kernel, and the reducer inside the jitted step) XLA
// turns a division by a constant into a product with its f32 reciprocal,
// and that is the arithmetic kept here, so the scales match the reference
// bit for bit.  x / scale stays an IEEE division (no fast-math flags:
// _build.py passes none, and nothing here uses __fdividef), the product
// is IEEE f32 and rintf rounds half to even, so on finite inputs every q,
// scale and dequantized value equals the plain PyTorch version's (ref.py)
// bit for bit.
//
// What bounds them.  Bytes: quantize reads 4 bytes and writes 1 per
// element plus 4 per block; dequantize the reverse.  A few operations an
// element are far below the card's rate.  At ResNet-50's bucket sizes
// (0.5-9.4 MB of f32) one launch moves less than its launch overhead
// costs, so at these sizes the count of launches (2 quantize and 2
// dequantize a bucket a step) is what costs.
//
// What the design does about it.  On the TPU a grid step took 64 rows of
// 256 in VMEM.  Here one warp owns one block: lane l loads elements
// [4l, 4l + 4) and [128 + 4l, 128 + 4l + 4) as two 16-byte loads, so a
// warp's loads cover 512 contiguous bytes twice, the block's amax is a
// butterfly of __shfl_xor_sync with no shared memory, and each lane stores
// its 8 int8 values as two 4-byte words.  Eight warps (eight blocks of
// 256) make a thread block.
//
// Interface: plain C, loaded with ctypes (kernel.py).  Each entry point
// returns cudaGetLastError() after its launch; the wrapper raises if it is
// not 0.  Launches go to the caller's stream and never synchronize.  The
// wrapper checks that every pointer is 16-byte aligned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;           // kernel.py BLOCK
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kInv127 = 1.0f / 127.0f;   // ref.py INV_127

__device__ __forceinline__ signed char quant(float x, float scale) {
  return static_cast<signed char>(fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f));
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__global__ void __launch_bounds__(kThreads)
quantize_blocks_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                       float* __restrict__ scales, int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;        // uniform across the warp
  const float4* xb = reinterpret_cast<const float4*>(x + blk * kBlock);
  const float4 a = xb[lane];
  const float4 b = xb[32 + lane];
  float amax = fmaxf(absmax4(a), absmax4(b));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float scale = amax > 0.0f ? amax * kInv127 : 1.0f;
  char4* qb = reinterpret_cast<char4*>(q + blk * kBlock);
  qb[lane] = make_char4(quant(a.x, scale), quant(a.y, scale),
                        quant(a.z, scale), quant(a.w, scale));
  qb[32 + lane] = make_char4(quant(b.x, scale), quant(b.y, scale),
                             quant(b.z, scale), quant(b.w, scale));
  if (lane == 0) scales[blk] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize_blocks_kernel(const signed char* __restrict__ q,
                         const float* __restrict__ scales,
                         float* __restrict__ x, int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  const float s = scales[blk];        // one word, broadcast to the warp
  const char4* qb = reinterpret_cast<const char4*>(q + blk * kBlock);
  const char4 a = qb[lane];
  const char4 b = qb[32 + lane];
  float4* xb = reinterpret_cast<float4*>(x + blk * kBlock);
  xb[lane] = make_float4(static_cast<float>(a.x) * s, static_cast<float>(a.y) * s,
                         static_cast<float>(a.z) * s, static_cast<float>(a.w) * s);
  xb[32 + lane] = make_float4(static_cast<float>(b.x) * s, static_cast<float>(b.y) * s,
                              static_cast<float>(b.z) * s, static_cast<float>(b.w) * s);
}

unsigned grid_for(int64_t n_blocks) {
  return static_cast<unsigned>((n_blocks + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// x (n_blocks * 256 f32) -> q (n_blocks * 256 int8), scales (n_blocks f32)
int quantize_blocks(const void* x, void* q, void* scales, int64_t n_blocks,
                    int device, void* stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_blocks_kernel<<<grid_for(n_blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(q),
      static_cast<float*>(scales), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// q (n_blocks * 256 int8), scales (n_blocks f32) -> x (n_blocks * 256 f32)
int dequantize_blocks(const void* q, const void* scales, void* x,
                      int64_t n_blocks, int device, void* stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dequantize_blocks_kernel<<<grid_for(n_blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scales),
      static_cast<float*>(x), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
