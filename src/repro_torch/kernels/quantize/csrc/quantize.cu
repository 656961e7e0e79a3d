// int8 block quantize / dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels of the reference:
//   quantize_blocks_kernel    <- src/repro/kernels/quantize/kernel.py:33
//                                (quantize_blocks_kernel, body _quant_kernel :19)
//   dequantize_blocks_kernel  <- src/repro/kernels/quantize/kernel.py:54
//                                (dequantize_blocks_kernel, body _dequant_kernel :28)
// and, as further entries, the compressed reducer's phases 2 and 3
// (src/repro/core/compression.py:79-89: jnp.sum over the peers of the
// vmapped dequantize, which XLA fuses into one loop, then the quantize of
// the reduced shard):
//   dequantize_sum_blocks_kernel: g peers' shards, dequantized and summed
//     (phase 2 alone; the f32 sum is the output);
//   dequantize_sum_quantize_blocks_kernel: the same sum, quantized where
//     it is made (phases 2 and 3 in one launch; the f32 sum never reaches
//     device memory).
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
// bit for bit.  The quantize takes the valid length n of its buffer
// beside the block count: elements at n and past it act as 0, which gives
// the bits of a zero-padded copy (|0| never raises a block's amax, and
// 0 / scale rounds to 0) without the copy.  The peer sum adds the g
// dequantized shards in peer order, deq[0] + deq[1] + ... + deq[g-1], each
// product rounded once and each add rounded once, as the plain version
// does: __fmul_rn and __fadd_rn, since nvcc would otherwise contract a
// product and an add into one FMA, which rounds once (as XLA's CPU build
// of the reference does).  The fused entry runs that sum and then the
// quantize's own amax, scale and quant() on it, so its q and scales equal
// the quantize of the peer sum bit for bit.
//
// What bounds them.  Bytes: quantize reads 4 bytes an element (of the
// unpadded buffer) and writes 1 per element plus 4 per block; dequantize
// the reverse; the peer sum reads g int8 values and writes one f32 an
// element; the fused entry reads the same and writes one int8 an element
// plus 4 per block.  A few operations an element are far below the card's
// rate.  At ResNet-50 on one rank of a ring of 4 (24 buckets, M =
// 23,515,136 elements padded to 256 * 4): a step's 48 quantizes moved
// 117,943,104 + 29,485,776 bytes (0.0440 ms at 3.35 TB/s); what this
// design replaces (24 phase-1 quantizes of a padded copy, 24 peer sums,
// 24 phase-3 quantizes, 4 pad copies) 212,283,728 bytes (0.0634 ms); the
// step as it runs now (24 unpadded quantizes, 24 fused launches)
// 117,935,168 + 29,853,200 bytes (0.0441 ms).  A launch at these sizes
// (0.5-9.4 MB of f32) moves about as much as its launch costs, so the
// count of launches (now 1 quantize, 1 fused sum-requantize and 1
// dequantize a bucket a step, was 2 quantizes, 1 peer sum, 1 dequantize
// and a pad copy for a ragged bucket) matters as much as the bytes.
//
// What the design does about it.  On the TPU a grid step took 64 rows of
// 256 in VMEM.  Quantize: a warp owns one block (a warp that took 2 or 4
// blocks with all their loads issued first was measured slower on the H100
// at every size of the main path): lane l loads
// elements [4l, 4l + 4) and [128 + 4l, 128 + 4l + 4) as two
// 16-byte loads, so a warp's loads cover 512 contiguous bytes twice, the
// block's amax is a butterfly of __shfl_xor_sync with no shared memory,
// and each lane stores its 8 int8 values as two 4-byte words.  A block
// wholly below n takes that path; a block wholly past n loads nothing and
// writes q = 0 and scale 1; the block that holds n loads with guards (n
// need not be a multiple of 4, so its last float4 would read past the
// tensor).  Eight warps make a thread block.  Dequantize and peer sum: a
// flat grid over 4-byte words of int8 (four values each; a quantization
// block is 64 words).  A thread loads its words at a stride of the thread
// block, so a warp's load covers 128 contiguous bytes, with each word's
// block scale (one 4-byte load, the same word for 64 threads, which the
// L1 broadcasts), and stores each word's four values as one float4, so a
// warp's store covers 512 contiguous bytes.  Loads come first: the
// dequantize keeps kDqWords words in flight a thread; the peer sum loads
// the same word of up to kPeerChunk peers at once (a loop over the peers
// that waited for each peer's load before the next was measured far
// slower), then adds them in peer order.  (A thread that takes 16 values
// with one 16-byte load writes them as four float4 stores 64 bytes apart
// across the warp, half of every 32-byte sector an instruction touches;
// on the H100 that was slower than one warp a block with 4-byte loads.)
// Fused sum-requantize: one warp owns one output block; lane l takes
// int8 words l and 32 + l of each peer (a warp's load covers 128
// contiguous bytes of a peer), the words of up to kPeerChunk peers loaded
// first, so its 8 values are the quantize's elements [4l, 4l + 4) and
// [128 + 4l, 128 + 4l + 4); the sum stays in registers, and the block is
// quantized by the quantize's own butterfly and stored as two char4.
//
// Interface: plain C, loaded with ctypes (kernel.py).  Each entry point
// returns cudaGetLastError() after its launch; the wrapper raises if it is
// not 0.  Launches go to the caller's stream and never synchronize.  The
// wrapper checks that the int8 and f32 element pointers are 16-byte
// aligned (scales are read and written one word at a time).

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

__device__ __forceinline__ char4 quant4(float4 v, float scale) {
  return make_char4(quant(v.x, scale), quant(v.y, scale), quant(v.z, scale),
                    quant(v.w, scale));
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Four elements from e on, those at n and past it as 0 (e % 4 == 0).
__device__ __forceinline__ float4 load4_upto(const float* __restrict__ x, int64_t e,
                                             int64_t n) {
  if (e + 4 <= n) return *reinterpret_cast<const float4*>(x + e);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < n) v.x = x[e];
  if (e + 1 < n) v.y = x[e + 1];
  if (e + 2 < n) v.z = x[e + 2];
  return v;
}

// Lane l's elements of block blk: [4l, 4l + 4) in a, [128 + 4l, 128 + 4l + 4)
// in b, elements at n and past it as 0.  The branch is uniform across the warp.
__device__ __forceinline__ void load_block(const float* __restrict__ x, int64_t blk,
                                           int64_t n, int lane, float4& a, float4& b) {
  const int64_t base = blk * kBlock;
  if (base + kBlock <= n) {
    const float4* xb = reinterpret_cast<const float4*>(x + base);
    a = xb[lane];
    b = xb[32 + lane];
  } else if (base >= n) {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    a = load4_upto(x, base + 4 * lane, n);
    b = load4_upto(x, base + 128 + 4 * lane, n);
  }
}

// The warp's block blk from lane l's values (as load_block lays them out):
// its amax by a butterfly, its scale, and its 256 int8 values.
__device__ __forceinline__ void quantize_store(float4 a, float4 b, int lane,
                                               signed char* __restrict__ q,
                                               float* __restrict__ scales, int64_t blk) {
  float amax = fmaxf(absmax4(a), absmax4(b));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float scale = amax > 0.0f ? amax * kInv127 : 1.0f;
  char4* qb = reinterpret_cast<char4*>(q + blk * kBlock);
  qb[lane] = quant4(a, scale);
  qb[32 + lane] = quant4(b, scale);
  if (lane == 0) scales[blk] = scale;
}

// x (n valid f32, read as n_blocks * 256 with zeros past n) -> q, scales;
// warp w owns block w.
__global__ void __launch_bounds__(kThreads)
quantize_blocks_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                       float* __restrict__ scales, int64_t n_blocks, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;        // uniform across the warp
  float4 a, b;
  load_block(x, blk, n, lane, a, b);
  quantize_store(a, b, lane, q, scales, blk);
}

constexpr int kDqThreads = 128;            // dequantize
constexpr int kDqWords = 4;                // int8 words in flight a thread
constexpr int kSumThreads = 256;           // peer sum
constexpr int kPeerChunk = 8;              // peers whose words a thread loads at once
constexpr int kWordsPerBlock = kBlock / 4;  // 64 words a quantization block

// The signed byte e (0-3) of a 32-bit word, as f32 (exact).
template <int e>
__device__ __forceinline__ float byte_f32(unsigned w) {
  return __int2float_rn(static_cast<int>(w << (24 - 8 * e)) >> 24);
}

// A word's four int8 values times their block's scale, each product rounded once.
__device__ __forceinline__ float4 dequant4(unsigned w, float s) {
  return make_float4(__fmul_rn(byte_f32<0>(w), s), __fmul_rn(byte_f32<1>(w), s),
                     __fmul_rn(byte_f32<2>(w), s), __fmul_rn(byte_f32<3>(w), s));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// q (n_words words of four int8), scales (n_words / 64) -> x (n_words float4)
__global__ void __launch_bounds__(kDqThreads)
dequantize_blocks_kernel(const unsigned* __restrict__ q, const float* __restrict__ scales,
                         float4* __restrict__ x, int64_t n_words) {
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * (kDqThreads * kDqWords) + threadIdx.x;
  unsigned r[kDqWords];
  float s[kDqWords];
#pragma unroll
  for (int j = 0; j < kDqWords; ++j) {
    const int64_t w = w0 + j * kDqThreads;
    if (w < n_words) {
      r[j] = q[w];
      s[j] = scales[w / kWordsPerBlock];
    }
  }
#pragma unroll
  for (int j = 0; j < kDqWords; ++j) {
    const int64_t w = w0 + j * kDqThreads;
    if (w < n_words) x[w] = dequant4(r[j], s[j]);
  }
}

// q (g rows of n_words words), scales (g rows of n_words / 64), row p
// peer p's shard -> x (n_words float4) = sum over the rows, in row order,
// of q * scale.
__global__ void __launch_bounds__(kSumThreads)
dequantize_sum_blocks_kernel(const unsigned* __restrict__ q, const float* __restrict__ scales,
                             float4* __restrict__ x, int64_t n_words, int g) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (w >= n_words) return;
  const int64_t n_blocks = n_words / kWordsPerBlock;
  const int64_t b = w / kWordsPerBlock;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = 0; p0 < g; p0 += kPeerChunk) {
    unsigned r[kPeerChunk];
    float s[kPeerChunk];
#pragma unroll
    for (int p = 0; p < kPeerChunk; ++p) {
      if (p0 + p < g) {
        r[p] = q[(p0 + p) * n_words + w];
        s[p] = scales[(p0 + p) * n_blocks + b];
      }
    }
#pragma unroll
    for (int p = 0; p < kPeerChunk; ++p) {
      if (p0 + p < g) {
        const float4 o = dequant4(r[p], s[p]);
        acc = p0 + p == 0 ? o : add4(acc, o);
      }
    }
  }
  x[w] = acc;
}

// q (g rows of n_blocks * 64 words), scales (g rows of n_blocks), row p
// peer p's shard -> q2 (n_blocks * 256 int8), s2 (n_blocks): the peer sum
// of dequantize_sum_blocks_kernel, quantized.  Warp w owns output block w.
__global__ void __launch_bounds__(kThreads)
dequantize_sum_quantize_blocks_kernel(const unsigned* __restrict__ q,
                                      const float* __restrict__ scales,
                                      signed char* __restrict__ q2, float* __restrict__ s2,
                                      int64_t n_blocks, int g) {
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;        // uniform across the warp
  const int64_t n_words = n_blocks * kWordsPerBlock;
  const unsigned* qb = q + blk * kWordsPerBlock;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b = a;
  for (int p0 = 0; p0 < g; p0 += kPeerChunk) {
    unsigned ra[kPeerChunk], rb[kPeerChunk];
    float s[kPeerChunk];
#pragma unroll
    for (int p = 0; p < kPeerChunk; ++p) {
      if (p0 + p < g) {
        ra[p] = qb[(p0 + p) * n_words + lane];
        rb[p] = qb[(p0 + p) * n_words + 32 + lane];
        s[p] = scales[(p0 + p) * n_blocks + blk];
      }
    }
#pragma unroll
    for (int p = 0; p < kPeerChunk; ++p) {
      if (p0 + p < g) {
        const float4 da = dequant4(ra[p], s[p]);
        const float4 db = dequant4(rb[p], s[p]);
        a = p0 + p == 0 ? da : add4(a, da);
        b = p0 + p == 0 ? db : add4(b, db);
      }
    }
  }
  quantize_store(a, b, lane, q2, s2, blk);
}

unsigned grid_for(int64_t n_blocks) {
  return static_cast<unsigned>((n_blocks + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// x (n f32, n <= n_blocks * 256, read as zero-padded to n_blocks * 256)
// -> q (n_blocks * 256 int8), scales (n_blocks f32)
int quantize_blocks(const void* x, void* q, void* scales, int64_t n_blocks, int64_t n,
                    int device, void* stream) {
  if (n_blocks < 1 || n < 0 || n > n_blocks * kBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_blocks_kernel<<<grid_for(n_blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(q),
      static_cast<float*>(scales), n_blocks, n);
  return static_cast<int>(cudaGetLastError());
}

// q (n_blocks * 256 int8), scales (n_blocks f32) -> x (n_blocks * 256 f32)
int dequantize_blocks(const void* q, const void* scales, void* x,
                      int64_t n_blocks, int device, void* stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_words = n_blocks * kWordsPerBlock;
  constexpr int64_t kTile = kDqThreads * kDqWords;
  dequantize_blocks_kernel<<<static_cast<unsigned>((n_words + kTile - 1) / kTile), kDqThreads,
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(q), static_cast<const float*>(scales),
      static_cast<float4*>(x), n_words);
  return static_cast<int>(cudaGetLastError());
}

// q (g x n_blocks * 256 int8), scales (g x n_blocks f32), row p peer p's
// shard -> x (n_blocks * 256 f32), the peers' dequantized values summed in
// peer order.
int dequantize_sum_blocks(const void* q, const void* scales, void* x, int64_t n_blocks,
                          int g, int device, void* stream) {
  if (n_blocks < 1 || g < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_words = n_blocks * kWordsPerBlock;
  dequantize_sum_blocks_kernel<<<static_cast<unsigned>((n_words + kSumThreads - 1) / kSumThreads),
                                 kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(q), static_cast<const float*>(scales),
      static_cast<float4*>(x), n_words, g);
  return static_cast<int>(cudaGetLastError());
}

// q (g x n_blocks * 256 int8), scales (g x n_blocks f32), row p peer p's
// shard -> q2 (n_blocks * 256 int8), s2 (n_blocks f32): the peer sum of
// dequantize_sum_blocks, quantized as quantize_blocks would.
int dequantize_sum_quantize_blocks(const void* q, const void* scales, void* q2, void* s2,
                                   int64_t n_blocks, int g, int device, void* stream) {
  if (n_blocks < 1 || g < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dequantize_sum_quantize_blocks_kernel<<<grid_for(n_blocks), kThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(q), static_cast<const float*>(scales),
      static_cast<signed char*>(q2), static_cast<float*>(s2), n_blocks, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
