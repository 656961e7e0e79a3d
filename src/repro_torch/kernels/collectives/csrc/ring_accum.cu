// Ring-hop combine for Hopper (sm_90a): out[i] = a[i] + b[i] for up to
// kMaxPairs pairs of one dtype, in one launch.
//
// Replaces the TPU kernel of the reference:
//   ring_accum_kernel  <- src/repro/kernels/collectives/kernel.py:117
//                         (ring_accum_kernel, body _accum_kernel :113)
//
// What it computes.  One hop of a ring reduce-scatter: the partial sum of
// a chunk received from the ring neighbour, plus this rank's own value of
// that chunk, elementwise in the comm dtype.  A bidirectional ring has two
// such pairs a hop (one half-chunk each way); the ring passes both to one
// launch, with out = the received buffer.  f32 adds in f32; bf16 and f16
// widen both operands to f32, add once and round to nearest-even, as
// torch.add (the plain version, ref.py) rounds them.  ``out`` may be
// ``a`` itself: each element is read before it is written, by the same
// thread.
//
// What bounds it.  No arithmetic worth counting: two reads and one write
// per element, so device-memory bandwidth.  A ResNet-50 half-shard at a
// ring of 4 is about 131,072 f32 elements (1.5 MB of traffic, 0.47 us at
// 3.35 TB/s), so a launch is short against its own ramp and tail, and
// the count of launches is what costs.
//
// What the design does about it.  One launch per hop: the pairs travel
// by value in the kernel's argument space (pointers, length, first tile),
// the grid is the sum of the pairs' tiles, and each block finds its pair
// in the first-tile column, so no block idles and no host-to-device copy
// is needed.  A tile is kThreads x kUnroll 16-byte vectors of each
// operand; a thread issues its kUnroll loads of both operands before its
// first store.  Whether a pair takes vectors is decided per pair: the two
// halves of a bidirectional ring differ in alignment (a row of
// x2d[:, h:] starts at row * c + h).  A pair whose three pointers are not
// all 16-byte aligned walks the same tile in scalars, kUnroll x kV of
// them a thread, loads first; an aligned pair's tail (length % kV) goes
// to its last tile.
//
// Interface: plain C, loaded with ctypes (kernel.py).  kernel.py packs an
// AccumArgs table (the count, then pointers and length a pair) into a
// preallocated buffer and passes its address; the entry point adds the
// tile column and the alignment flags and launches, returning
// cudaGetLastError().  The launch goes to the caller's stream and never
// synchronizes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPairs = 8;   // kernel.py MAX_PAIRS
constexpr int kThreads = 128;
constexpr int kUnroll = 2;     // 16-byte vectors of each operand in flight a thread

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

// What kernel.py fills (one struct.pack_into of the count and the pairs):
// pair i is out = a + b over n >= 1 elements.
struct Pair {
  const void* a;
  const void* b;
  void* out;
  int64_t n;
};
struct AccumArgs {
  int64_t count;
  Pair pair[kMaxPairs];
};

// What the kernel receives, by value.
struct AccumTable {
  const void* a[kMaxPairs];
  const void* b[kMaxPairs];
  void* out[kMaxPairs];
  int64_t n[kMaxPairs];
  int64_t first_tile[kMaxPairs + 1];   // pair i owns tiles [first_tile[i], first_tile[i + 1])
  int32_t vec[kMaxPairs];              // all three pointers 16-byte aligned
  int32_t count;
};

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

template <typename T>
__host__ __device__ constexpr int64_t tile_elems() {
  return static_cast<int64_t>(kThreads) * kUnroll * (16 / sizeof(T));
}

// No __restrict__: out may alias a.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_accum_kernel(const __grid_constant__ AccumTable t) {
  constexpr int kV = 16 / sizeof(T);
  const int64_t tile = blockIdx.x;
  int p = 0;
  while (p + 1 < t.count && tile >= t.first_tile[p + 1]) ++p;
  const T* a = static_cast<const T*>(t.a[p]);
  const T* b = static_cast<const T*>(t.b[p]);
  T* out = static_cast<T*>(t.out[p]);
  const int64_t n = t.n[p];
  const int64_t base = (tile - t.first_tile[p]) * tile_elems<T>();

  if (t.vec[p]) {
    const int64_t nv = n / kV;
    const int64_t v0 = base / kV + threadIdx.x;
    uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t v = v0 + j * kThreads;
      if (v < nv) {
        ra[j] = reinterpret_cast<const uint4*>(a)[v];
        rb[j] = reinterpret_cast<const uint4*>(b)[v];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t v = v0 + j * kThreads;
      if (v < nv) {
        uint4 o;
        const T* pa = reinterpret_cast<const T*>(&ra[j]);
        const T* pb = reinterpret_cast<const T*>(&rb[j]);
        T* po = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int e = 0; e < kV; ++e) po[e] = add(pa[e], pb[e]);
        reinterpret_cast<uint4*>(out)[v] = o;
      }
    }
    // the last (n % kV) elements, in the pair's last tile
    const int64_t i = nv * kV + threadIdx.x;
    if (tile + 1 == t.first_tile[p + 1] && i < n) out[i] = add(a[i], b[i]);
    return;
  }
  constexpr int kS = kUnroll * kV;
  T ra[kS], rb[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n) {
      ra[j] = a[i];
      rb[j] = b[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n) out[i] = add(ra[j], rb[j]);
  }
}

template <typename T>
cudaError_t launch(const AccumArgs& args, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  AccumTable t;
  t.count = static_cast<int32_t>(args.count);
  t.first_tile[0] = 0;
  for (int i = 0; i < args.count; ++i) {
    const Pair& p = args.pair[i];
    if (p.n < 1) return cudaErrorInvalidValue;
    t.a[i] = p.a;
    t.b[i] = p.b;
    t.out[i] = p.out;
    t.n[i] = p.n;
    t.vec[i] = aligned(p.a) && aligned(p.b) && aligned(p.out);
    t.first_tile[i + 1] = t.first_tile[i] + (p.n + tile_elems<T>() - 1) / tile_elems<T>();
  }
  const int64_t tiles = t.first_tile[args.count];
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  ring_accum_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// For each pair of the AccumArgs at ``table``:
// out[0, n) = a[0, n) + b[0, n), all of one dtype code.
// One launch.  (The table comes as void*: a parameter of the anonymous
// namespace's type would keep the symbol out of the library.)
int ring_accum_pairs(const void* table, int dtype, int device, void* stream) {
  const auto* args = static_cast<const AccumArgs*>(table);
  if (args == nullptr || args->count < 1 || args->count > kMaxPairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: err = launch<float>(*args, s); break;
    case kBF16: err = launch<__nv_bfloat16>(*args, s); break;
    case kF16: err = launch<__half>(*args, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
