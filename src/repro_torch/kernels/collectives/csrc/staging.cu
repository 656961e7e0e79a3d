// Bucket staging kernels for Hopper (sm_90a): the paper's CopyFromTo
// between a bucket's gradient leaves and its 1-D communication buffer.
//
// Replaces the TPU kernels of the reference:
//   pack_bucket_kernel    <- src/repro/kernels/collectives/kernel.py:76
//                            (pack_bucket_kernel, body _pack_kernel :58)
//   unpack_bucket_kernel  <- src/repro/kernels/collectives/kernel.py:99
//                            (unpack_bucket_kernel, body _unpack_kernel :87)
//
// What they compute.  Pack gathers every leaf of a bucket into the comm
// buffer at fixed offsets, casting to the comm dtype, with an optional
// loss-scale multiplied in f32 before the cast.  Unpack is the inverse:
// it slices the reduced buffer back into the leaves, casting back and
// applying the inverse scale in the same read.  Each value rounds exactly
// as the plain PyTorch version (ref.py) rounds it: a source value becomes
// f32 (f64 rounds to nearest), is multiplied by the f32 scale when the
// scale is not 1, and rounds to nearest-even into the destination type.
// A same-type copy at scale 1 moves the bits unchanged (f64 stays f64).
//
// What bounds them.  Neither does arithmetic worth counting: each reads
// every element once and writes it once, so device-memory bandwidth is
// the bound (ResNet-50 in f32: 94.05 MB read + 94.05 MB written per
// direction per step, about 56 us at 3.35 TB/s).  On the TPU one grid
// step owned a whole bucket in VMEM; here the blocks of one launch spread
// over the SMs instead.
//
// What the design does about it.  One launch covers a whole bucket: the
// leaf table (pointer, offset, size of up to kMaxLeaves leaves) travels by
// value in the kernel's argument space, so no host-to-device copy and no
// per-leaf launch is needed.  The leaf and comm dtypes are template
// parameters (one instantiation per pair); a bucket whose leaves differ in
// dtype, or that holds more than kMaxLeaves leaves, is split by the
// wrapper into consecutive launches.
//
// Both directions run on one flat grid of fixed-size tiles over the
// bucket's elements.  Each leaf owns ceil(size / tile) consecutive tiles;
// a block finds its leaf by a binary search of the table's first-tile
// column, so no block idles (a longest-leaf x leaves grid leaves most blocks
// of a bucket of small leaves with nothing to do).  A
// tile is kThreads x kUnroll 16-byte vectors of the SOURCE type (the
// leaf's for pack, the buffer's for unpack): when the source and the
// destination of a leaf are both 16-byte aligned, a thread loads its
// kUnroll vectors before its first store and stores each as the widest
// aligned access its kV destination values fill (8 bytes for f32 -> bf16,
// 32 for bf16 -> f32); the leaf's tail (size % kV) goes to its last tile.
// A misaligned leaf walks the same tile in scalars, kUnroll x kV a
// thread, loads first.  A bucket's layout (offsets, sizes, launch groups)
// is the same in both directions: the wrapper keeps it under the leaves'
// dtypes and sizes and the buffer's dtype, so a call passes only the
// leaves' pointers (one packed column: the training loop's .grad tensors
// are new each step), the buffer's pointer, the scale and the stream.
//
// Interface: plain C, loaded with ctypes (kernel.py).  Each entry point
// returns cudaGetLastError() after its launch; the wrapper raises if it is
// not 0.  Launches go to the caller's stream and never synchronize.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxLeaves = 64;   // kernel.py MAX_LEAVES
constexpr int kThreads = 128;
constexpr int kUnroll = 2;       // 16-byte vectors in flight a thread

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;
constexpr int kF64 = 3;

// A bucket's layout, built once by kernel.py (ctypes _Layout) and used by
// both directions: leaf i, of size[i] >= 1 elements, is buf[offset[i] ...].
// The leaves' pointers come with each call.
struct Layout {
  int64_t offset[kMaxLeaves];
  int64_t size[kMaxLeaves];
  int32_t count;
};

// What a staging kernel receives, by value.
struct TileTable {
  void* ptr[kMaxLeaves];
  int64_t offset[kMaxLeaves];
  int64_t size[kMaxLeaves];
  int64_t first_tile[kMaxLeaves + 1];   // leaf i owns tiles [first_tile[i], first_tile[i + 1])
  int32_t count;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ double from_f32<double>(float v) {
  return static_cast<double>(v);
}

// One value: bits unchanged for a same-type copy at scale 1,
// else through f32 (times the scale when scaled) into D.
template <typename S, typename D>
__device__ __forceinline__ D convert(S x, float scale, bool scaled) {
  if constexpr (std::is_same<S, D>::value) {
    if (!scaled) return x;
  }
  return from_f32<D>(scaled ? to_f32(x) * scale : to_f32(x));
}

// kV destination values, aligned as widely as their bytes allow (at most
// 16), so that one assignment stores them in the fewest accesses.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

template <typename S>
__host__ __device__ constexpr int64_t tile_elems() {
  return static_cast<int64_t>(kThreads) * kUnroll * (16 / sizeof(S));
}

// The leaf that owns ``tile``: the last whose first tile is <= tile.
__device__ __forceinline__ int leaf_of(const TileTable& t, int64_t tile) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.first_tile[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// One tile of one leaf: src[base ...] (type S) -> dst[base ...] (type D),
// of the leaf's n elements; ``last`` when this is the leaf's last tile.
template <typename S, typename D>
__device__ __forceinline__ void stage_tile(const S* __restrict__ src, D* __restrict__ dst,
                                           int64_t n, int64_t base, bool last,
                                           float scale, bool scaled) {
  constexpr int kV = 16 / sizeof(S);
  const bool vec = (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16 == 0;
  if (vec) {
    const int64_t nv = n / kV;
    const int64_t v0 = base / kV + threadIdx.x;
    uint4 r[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t v = v0 + j * kThreads;
      if (v < nv) r[j] = reinterpret_cast<const uint4*>(src)[v];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t v = v0 + j * kThreads;
      if (v < nv) {
        const S* ps = reinterpret_cast<const S*>(&r[j]);
        Pack<D, kV> o;
#pragma unroll
        for (int e = 0; e < kV; ++e) o.v[e] = convert<S, D>(ps[e], scale, scaled);
        reinterpret_cast<Pack<D, kV>*>(dst)[v] = o;
      }
    }
    // the last (n % kV) elements, in the leaf's last tile
    const int64_t i = nv * kV + threadIdx.x;
    if (last && i < n) dst[i] = convert<S, D>(src[i], scale, scaled);
    return;
  }
  constexpr int kS = kUnroll * kV;
  S r[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n) r[j] = src[i];
  }
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n) dst[i] = convert<S, D>(r[j], scale, scaled);
  }
}

// Leaves (type S) -> comm buffer (type D), one tile a block.
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
pack_bucket_kernel(const __grid_constant__ TileTable t, D* __restrict__ buf, float scale,
                   bool scaled) {
  const int64_t tile = blockIdx.x;
  const int i = leaf_of(t, tile);
  stage_tile<S, D>(static_cast<const S*>(t.ptr[i]), buf + t.offset[i], t.size[i],
                   (tile - t.first_tile[i]) * tile_elems<S>(), tile + 1 == t.first_tile[i + 1],
                   scale, scaled);
}

// Comm buffer (type S) -> leaves (type D), one tile a block.
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
unpack_bucket_kernel(const __grid_constant__ TileTable t, const S* __restrict__ buf,
                     float scale, bool scaled) {
  const int64_t tile = blockIdx.x;
  const int i = leaf_of(t, tile);
  stage_tile<S, D>(buf + t.offset[i], static_cast<D*>(t.ptr[i]), t.size[i],
                   (tile - t.first_tile[i]) * tile_elems<S>(), tile + 1 == t.first_tile[i + 1],
                   scale, scaled);
}

// One launch over a layout: kPack moves leaves (S) into buf (D), else buf
// (S) into the leaves (D).  Tiles are counted in the source type.
template <bool kPack, typename S, typename D>
cudaError_t launch(const Layout& args, void* const* leaves, void* buf, float scale,
                   bool scaled, cudaStream_t stream) {
  TileTable t;
  t.count = args.count;
  t.first_tile[0] = 0;
  for (int i = 0; i < args.count; ++i) {
    if (args.size[i] < 1 || args.offset[i] < 0) return cudaErrorInvalidValue;
    t.ptr[i] = leaves[i];
    t.offset[i] = args.offset[i];
    t.size[i] = args.size[i];
    t.first_tile[i + 1] = t.first_tile[i] + (args.size[i] + tile_elems<S>() - 1) / tile_elems<S>();
  }
  const int64_t tiles = t.first_tile[args.count];
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const auto grid = static_cast<unsigned>(tiles);
  if constexpr (kPack) {
    pack_bucket_kernel<S, D><<<grid, kThreads, 0, stream>>>(t, static_cast<D*>(buf), scale,
                                                            scaled);
  } else {
    unpack_bucket_kernel<S, D><<<grid, kThreads, 0, stream>>>(
        t, static_cast<const S*>(buf), scale, scaled);
  }
  return cudaGetLastError();
}

template <bool kPack, typename S>
cudaError_t launch_to(int dst, const Layout& args, void* const* leaves, void* buf,
                      float scale, bool scaled, cudaStream_t stream) {
  switch (dst) {
    case kF32: return launch<kPack, S, float>(args, leaves, buf, scale, scaled, stream);
    case kBF16: return launch<kPack, S, __nv_bfloat16>(args, leaves, buf, scale, scaled, stream);
    case kF16: return launch<kPack, S, __half>(args, leaves, buf, scale, scaled, stream);
    case kF64: return launch<kPack, S, double>(args, leaves, buf, scale, scaled, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Checks the layout, selects the card and dispatches on the source (src)
// and destination (dst) dtype codes.
template <bool kPack>
int stage(const void* layout, void* const* leaves, int src, int dst, void* buf, float scale,
          int scaled, int device, void* stream) {
  const auto* args = static_cast<const Layout*>(layout);
  if (args == nullptr || leaves == nullptr || args->count < 1 || args->count > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool sc = scaled != 0;
  switch (src) {
    case kF32: err = launch_to<kPack, float>(dst, *args, leaves, buf, scale, sc, s); break;
    case kBF16: err = launch_to<kPack, __nv_bfloat16>(dst, *args, leaves, buf, scale, sc, s); break;
    case kF16: err = launch_to<kPack, __half>(dst, *args, leaves, buf, scale, sc, s); break;
    case kF64: err = launch_to<kPack, double>(dst, *args, leaves, buf, scale, sc, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// For each leaf i of the Layout at ``layout``: leaves[i] (leaf_dtype,
// size[i] elements) -> buf[offset[i] ...] (comm_dtype).  One launch.
int staging_pack(const void* layout, void* const* leaves, int leaf_dtype, void* buf,
                 int comm_dtype, float scale, int scaled, int device, void* stream) {
  return stage<true>(layout, leaves, leaf_dtype, comm_dtype, buf, scale, scaled, device,
                     stream);
}

// For each leaf i of the Layout at ``layout``: buf[offset[i] ...]
// (comm_dtype) -> leaves[i] (leaf_dtype, size[i] elements).  One launch.
int staging_unpack(const void* layout, void* const* leaves, int leaf_dtype, const void* buf,
                   int comm_dtype, float scale, int scaled, int device, void* stream) {
  return stage<false>(layout, leaves, comm_dtype, leaf_dtype, const_cast<void*>(buf), scale,
                      scaled, device, stream);
}

}  // extern "C"
