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
// per-leaf launch is needed.  blockIdx.y picks the leaf and a grid-stride
// loop over blockIdx.x/threadIdx.x walks its elements, so neighbouring
// threads touch neighbouring addresses.  The leaf and comm dtypes are
// template parameters (one instantiation per pair); a bucket whose leaves
// differ in dtype, or that holds more than kMaxLeaves leaves, is split by
// the wrapper into consecutive launches.  Launch latency rather than
// bandwidth may dominate the many small buckets of a step; 16-byte
// vector access, a persistent grid and CUDA graphs are left for later.
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
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;
constexpr int kF64 = 3;

struct LeafTable {
  void* ptr[kMaxLeaves];         // pack: source leaves; unpack: destinations
  int64_t offset[kMaxLeaves];    // element offset of the leaf in the buffer
  int64_t size[kMaxLeaves];      // elements
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

// One leaf's elements, src[0, n) -> dst[0, n), grid-strided over x.
// ``scaled`` is the caller's (scale != 1) in double precision, so a
// scale that rounds to 1.0f still takes the f32 path, as ref.py does.
template <typename S, typename D>
__device__ __forceinline__ void cast_copy(const S* __restrict__ src,
                                          D* __restrict__ dst, int64_t n,
                                          float scale, bool scaled) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (std::is_same<S, D>::value) {
    if (!scaled) {
      for (; i < n; i += stride) dst[i] = src[i];
      return;
    }
  }
  if (!scaled) {
    for (; i < n; i += stride) dst[i] = from_f32<D>(to_f32(src[i]));
  } else {
    for (; i < n; i += stride) dst[i] = from_f32<D>(to_f32(src[i]) * scale);
  }
}

// Leaves (type S) -> comm buffer (type D).
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
pack_bucket_kernel(const LeafTable table, D* __restrict__ buf, float scale,
                   bool scaled) {
  const int leaf = blockIdx.y;
  cast_copy(static_cast<const S*>(table.ptr[leaf]), buf + table.offset[leaf],
            table.size[leaf], scale, scaled);
}

// Comm buffer (type S) -> leaves (type D).
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
unpack_bucket_kernel(const LeafTable table, const S* __restrict__ buf,
                     float scale, bool scaled) {
  const int leaf = blockIdx.y;
  cast_copy(buf + table.offset[leaf], static_cast<D*>(table.ptr[leaf]),
            table.size[leaf], scale, scaled);
}

template <bool kPack, typename S, typename D>
cudaError_t launch(const LeafTable& table, dim3 grid, void* buf, float scale,
                   bool scaled, cudaStream_t stream) {
  if constexpr (kPack) {
    pack_bucket_kernel<S, D><<<grid, kThreads, 0, stream>>>(
        table, static_cast<D*>(buf), scale, scaled);
  } else {
    unpack_bucket_kernel<S, D><<<grid, kThreads, 0, stream>>>(
        table, static_cast<const S*>(buf), scale, scaled);
  }
  return cudaGetLastError();
}

template <bool kPack, typename S>
cudaError_t dispatch_dst(int dst, const LeafTable& table, dim3 grid, void* buf,
                         float scale, bool scaled, cudaStream_t stream) {
  switch (dst) {
    case kF32: return launch<kPack, S, float>(table, grid, buf, scale, scaled, stream);
    case kBF16: return launch<kPack, S, __nv_bfloat16>(table, grid, buf, scale, scaled, stream);
    case kF16: return launch<kPack, S, __half>(table, grid, buf, scale, scaled, stream);
    case kF64: return launch<kPack, S, double>(table, grid, buf, scale, scaled, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPack>
cudaError_t dispatch(int src, int dst, const LeafTable& table, dim3 grid,
                     void* buf, float scale, bool scaled, cudaStream_t stream) {
  switch (src) {
    case kF32: return dispatch_dst<kPack, float>(dst, table, grid, buf, scale, scaled, stream);
    case kBF16: return dispatch_dst<kPack, __nv_bfloat16>(dst, table, grid, buf, scale, scaled, stream);
    case kF16: return dispatch_dst<kPack, __half>(dst, table, grid, buf, scale, scaled, stream);
    case kF64: return dispatch_dst<kPack, double>(dst, table, grid, buf, scale, scaled, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPack>
int stage(void* const* ptrs, const int64_t* offsets, const int64_t* sizes,
          int n, int src, int dst, void* buf, float scale, int scaled,
          int device, void* stream) {
  if (n < 1 || n > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  LeafTable table;
  int64_t longest = 0;
  for (int i = 0; i < n; ++i) {
    table.ptr[i] = ptrs[i];
    table.offset[i] = offsets[i];
    table.size[i] = sizes[i];
    if (sizes[i] > longest) longest = sizes[i];
  }
  int64_t bx = (longest + 4 * kThreads - 1) / (4 * kThreads);
  if (bx < 1) bx = 1;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(n));
  return static_cast<int>(dispatch<kPack>(src, dst, table, grid, buf, scale,
                                          scaled != 0,
                                          static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// leaves[i] (leaf_dtype, sizes[i] elements) -> buf[offsets[i] ...] (comm_dtype)
int staging_pack(void* const* leaves, const int64_t* offsets,
                 const int64_t* sizes, int n, int leaf_dtype, void* buf,
                 int comm_dtype, float scale, int scaled, int device,
                 void* stream) {
  return stage<true>(leaves, offsets, sizes, n, leaf_dtype, comm_dtype, buf,
                     scale, scaled, device, stream);
}

// buf[offsets[i] ...] (comm_dtype) -> leaves[i] (leaf_dtype, sizes[i] elements)
int staging_unpack(void* const* leaves, const int64_t* offsets,
                   const int64_t* sizes, int n, int leaf_dtype, void* buf,
                   int comm_dtype, float scale, int scaled, int device,
                   void* stream) {
  return stage<false>(leaves, offsets, sizes, n, comm_dtype, leaf_dtype, buf,
                      scale, scaled, device, stream);
}

}  // extern "C"
