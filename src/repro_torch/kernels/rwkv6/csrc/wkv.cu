// RWKV-6 WKV for Hopper (sm_90a): one launch for a whole layer's WKV, the
// chunked-parallel recurrence over every chunk of the sequence, with the
// state carried from chunk to chunk on chip.
//
// Replaces the TPU kernel of the reference and the scan around it:
//   wkv_chunk_kernel  <- src/repro/kernels/rwkv6/kernel.py:59
//                        (wkv_chunk_kernel, body _wkv_kernel :20)
//   the lax.scan of src/repro/models/rwkv.py::wkv_chunked (:161-216), which
//   runs that chunk math once a chunk with the state through device memory.
//
// What it computes, per (b, h) row, on r, k, v, logw (S, N), u (N) and the
// state s0 (N, N), in f32 whatever the input dtype.  For each chunk of
// C = min(chunk, S) rows in order (the last one ragged):
//   L = cumsum_t(logw), Lprev = L - logw, wc = L[C - 1]
//   y[t]  = (r_t exp(Lprev_t)) s
//         + sum_{s<t} ((r_t exp(Lprev_t)) . (k_s exp(-L_s))) v_s
//         + (r_t . u k_t) v_t
//   s    <- diag(exp(wc)) s + sum_s (k_s exp(wc - L_s)) v_s^T
// Rows past S act as k = 0 and logw = 0, which is what the reference's zero
// padding gives (src/repro/models/rwkv.py:169-179), so no padded copy is
// made.  The exponentials are factored as the TPU kernel factors them, in
// f32, with the device's expf.  y is rounded once to the output's dtype
// (nearest even: the bits of the reference's .astype(r.dtype)).  The plain
// version (ref.py::wkv_sequence_ref) computes the same function.
//
// What bounds it on this card.  RWKV-6 7B's prefill layer (B 4, S 512,
// H 64, N 64, chunk 32, r/k/v and y bf16, logw f32) reads r, k, v, logw and
// the state once and writes y and the state once: 109,068,288 bytes, 0.0326
// ms at 3.35 TB/s.  Its products, counting only what the function needs
// (the inter-chunk read and the state update in full, the scores and the
// intra-chunk product on their strictly lower triangle), are 16 chunks x
// 256 rows x (4 C N^2 + 2 C (C - 1) N) = 2.67 GFLOP, 0.0398 ms at 67 TFLOP/s
// f32: it is bound by operations.  A decode step (S 1) is bound by the
// state's 8.4 MB.
//
// What the design does about it.
//   Bytes: one block owns one (b, h) row and a slice of MV state columns
//   (the v-dim) and loops over the chunks itself, as a loop inside the block
//   takes the place of the TPU grid's sequential dimension.  Its state slice
//   (N x MV f32) is read from device memory once, stays in shared memory
//   across all chunks, and is written once.  r, k, v and logw are read
//   straight from the model's (B, S, H, N) layout through strides; a chunk's
//   rows are 32-256 contiguous bytes each and are fetched with 16-byte
//   cp.async into a staging buffer while the previous chunk's products run
//   (the staging buffer is free once its chunk has been turned into the f32
//   operands below).
//   Operations: the four products of a chunk -- the scores (C x C over N),
//   the inter-chunk read (C x MV over N), the intra-chunk product (C x MV
//   over C) and the state update (N x MV over C) -- are register-tiled on
//   the CUDA cores in f32.  Every product's output is cut into a 16 x 16
//   grid of thread tiles (a warp 8 x 4 of them), and each thread keeps its
//   tile (up to 4 x 4) in registers, fed by float2/float4 reads of padded
//   shared-memory rows laid out depth-major (k-th row holds the k-th term
//   for every output row or column), so each word read feeds up to four
//   FMAs and a warp's reads touch few distinct addresses.  The inter and
//   intra products accumulate into the same register tile of y.  The bonus
//   (r_t . u k_t) is reduced across the channels with warp shuffles and
//   stored on the diagonal of the scores, so the intra product adds it.
//   Columns of y and of the state are independent given the C x C scores,
//   so a grid of (B H, splits) blocks, splits = N / MV, recomputes only the
//   scores and the decay factors: the wrapper picks the split from B H so
//   that the grid fills the card (B 1 has only 64 rows).
//   On the card this runs at about 4.2x the operations bound (PERF.md): it
//   is bound by instruction issue -- the FMAs, their shared-memory reads and
//   the decay factors' expf -- and not by its barriers or its loads, since
//   preparing the next chunk beside the last products (two barriers a chunk
//   instead of four, the prepared operands double-buffered) was no faster.
//   No tensor cores (ref.py's note): exp(-L) reaches several hundred within
//   a chunk, so an error in one factor comes out about 100x larger in y, and
//   TF32's 10-bit mantissa would put y far outside 5e-4 of the plain
//   version.  A split-precision product on the tensor cores is open.
//
// Per chunk, with barriers between steps:
//   1. each thread scans SEG rows of one channel (the log-decay's running
//      sum), and stores its segment's total;
//   2. from the totals each thread has its rows' L and wc, and writes
//      r exp(Lprev) and k exp(-L) transposed ([n][t]), k exp(wc - L) and v
//      as f32, and its share of the bonus; then the next chunk's loads are
//      issued into the staging buffer;
//   3. the scores (strictly lower, the bonus on the diagonal, zeros above)
//      and the inter-chunk read into y's register tile;
//   4. the intra-chunk product into y, y stored, and the state updated in
//      place (each thread its own tile).
// A block reads its state slice before it writes anything and no other block
// touches that slice, so s1 may be the state itself (the model's decode
// updates its state in place).
// Shared memory (Layout below): one chunk's f32 operands, the state slice
// and one chunk's staging, for chunks of up to C' = 32 rows (64 above):
// 78,592 bytes at N 64, MV 64, C' 32 with bf16 inputs (90,880 with f32), so
// two blocks an SM; 171,776 at C' 64.
//
// Training: where the caller passes `states`, each block also writes its
// state slice at the top of every chunk (the state the chunk starts from)
// to states[i] (chunks, B H, N, N) f32: N x MV floats a chunk from shared
// memory, 16 bytes a thread at a time, which the backward
// (ops.py::_WKVSequence) recomputes every chunk from at once.  The write
// adds the chunks' states to the bytes moved (by the shapes, 128 MiB a
// layer at RWKV-6 7B's training shape, B 4, S 1024: 0.8x the layer's
// inputs); prefill and decode pass null and move what they did.
//
// The one-chunk entry wkv_chunk_fwd (the TPU kernel's flat (BH, C, N)
// layout, y in f32) is this kernel with one chunk.
//
// Interface: plain C, loaded with ctypes (kernel.py).  Each entry point
// returns cudaGetLastError() after its launch; the wrapper raises if it is
// not 0.  The launch goes to the caller's stream and never synchronizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // a 16 x 16 grid of thread tiles
constexpr int kMaxDevices = 64;

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// R contiguous floats of shared memory (R = 4 and 2 aligned to 16 and 8 bytes)
template <int R>
__device__ __forceinline__ void load_frag(float (&f)[R], const float* p) {
  if constexpr (R == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    f[0] = q.x; f[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) f[i] = p[i];
  }
}

// acc[i][j] += sum_{d < depth} A[d lda + i] B[d ldb + j]: one thread's tile of
// a product whose operands are stored depth-major
template <int RA, int RB>
__device__ __forceinline__ void tile_product(float (&acc)[RA][RB], const float* A, int lda,
                                             const float* B, int ldb, int depth) {
#pragma unroll 4
  for (int d = 0; d < depth; ++d) {
    float a[RA], b[RB];
    load_frag<RA>(a, A + d * lda);
    load_frag<RB>(b, B + d * ldb);
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// R consecutive values of y, rounded once to the output's type
template <int R>
__device__ __forceinline__ void store_y(float* p, const float (&x)[R]) {
  if constexpr (R == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = x[i];
  }
}
template <int R>
__device__ __forceinline__ void store_y(__nv_bfloat16* p, const float (&x)[R]) {
  if constexpr (R == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 w;
    w.x = *reinterpret_cast<const unsigned*>(&lo);
    w.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  } else if constexpr (R == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = __float2bfloat16_rn(x[i]);
  }
}

// Shared-memory carve-up of one block (offsets in floats, then bytes for the
// staging of one chunk's raw rows).
template <typename T, int N, int MV, int KC>
struct Layout {
  static constexpr int RT = KC / 16;          // rows (t) of a thread's y and score tile
  static constexpr int RM = MV / 16;          // columns (m) of its y and state tile
  static constexpr int RN = N / 16;           // rows (n) of its state tile
  static constexpr int LDT = KC + RT;         // pitch of rdT, kdT and At
  static constexpr int LDK = N + 4;           // pitch of kw
  static constexpr int LDV = MV + 4;          // pitch of vS and the state
  static constexpr int SEGS = kThreads / N;   // row segments of the scan
  static constexpr int SEG = KC / SEGS;       // rows a thread scans
  static constexpr int GL = N < 32 ? N : 32;  // lanes that share a bonus sum
  static constexpr int GROUPS = N / GL;       // partial bonus sums a row
  static constexpr int rdT = 0;               // [N][LDT] r exp(Lprev), transposed
  static constexpr int kdT = rdT + N * LDT;   // [N][LDT] k exp(-L), transposed
  static constexpr int At = kdT + N * LDT;    // [KC][LDT] At[s][t]: scores, bonus on s = t
  static constexpr int kw = At + KC * LDT;    // [KC][LDK] k exp(wc - L)
  static constexpr int vS = kw + KC * LDK;    // [KC][LDV] v, this block's columns
  static constexpr int sst = vS + KC * LDV;   // [N][LDV] the state slice
  static constexpr int expwc = sst + N * LDV; // [N] exp(wc)
  static constexpr int bpart = expwc + N;     // [GROUPS][KC] partial bonus sums
  static constexpr int segtot = bpart + GROUPS * KC;   // [SEGS][N] segment totals
  static constexpr int floats = segtot + SEGS * N;
  static constexpr size_t rraw = ((floats * sizeof(float) + 15) / 16) * 16;
  static constexpr size_t kraw = rraw + KC * N * sizeof(T);
  static constexpr size_t vraw = kraw + KC * N * sizeof(T);
  static constexpr size_t lwraw = vraw + KC * MV * sizeof(T);
  static constexpr size_t bytes = lwraw + KC * N * sizeof(float);
  static_assert(KC % 16 == 0 && MV % 16 == 0 && N % 16 == 0, "tiles of 16 x 16 threads");
  static_assert(N * sizeof(T) % 16 == 0 && MV * sizeof(T) % 16 == 0, "16-byte copies");
  static_assert(kThreads % N == 0 && KC % SEGS == 0, "scan segments");
  static_assert(bytes <= 232448, "more than a block's shared memory");
};

// Row t of (b, h) starts at element b sb + h sh + t st of r, k, v, logw and
// y; the state is (B H, N, N).  y is y_t's type (float or bf16).
template <typename T, typename YT, int N, int MV, int KC>
__global__ void __launch_bounds__(kThreads, 2)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ logw, const float* __restrict__ u,
           const float* state, YT* __restrict__ y, float* s1,   // s1 may be state
           float* __restrict__ states,                          // null, or (chunks, BH, N, N)
           int H, int S, int C, int chunks, long long sb, long long sh, long long st) {
  using Lo = Layout<T, N, MV, KC>;
  constexpr int RT = Lo::RT, RM = Lo::RM, RN = Lo::RN;
  constexpr int LDT = Lo::LDT, LDK = Lo::LDK, LDV = Lo::LDV;
  constexpr int SEGS = Lo::SEGS, SEG = Lo::SEG, GL = Lo::GL, GROUPS = Lo::GROUPS;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  float* rdT = sm + Lo::rdT;
  float* kdT = sm + Lo::kdT;
  float* At = sm + Lo::At;
  float* kw = sm + Lo::kw;
  float* vS = sm + Lo::vS;
  float* ss = sm + Lo::sst;
  float* expwc = sm + Lo::expwc;
  float* bpart = sm + Lo::bpart;
  float* segtot = sm + Lo::segtot;
  T* rraw = reinterpret_cast<T*>(smem + Lo::rraw);
  T* kraw = reinterpret_cast<T*>(smem + Lo::kraw);
  T* vraw = reinterpret_cast<T*>(smem + Lo::vraw);
  float* lwraw = reinterpret_cast<float*>(smem + Lo::lwraw);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int col0 = blockIdx.y * MV;                 // this block's columns (v-dim)
  const long long base = static_cast<long long>(bh / H) * sb + h * sh;

  // the state slice, then chunk 0, into shared memory
  {
    const float* src = state + static_cast<size_t>(bh) * N * N + col0;
    constexpr int U = MV / 4;
    for (int e = tid; e < N * U; e += kThreads) {
      const int n = e / U, c = e % U;
      cp_async16(ss + n * LDV + c * 4, src + static_cast<size_t>(n) * N + c * 4);
    }
  }
  auto load_chunk = [&](int i) {
    constexpr int E = 16 / sizeof(T);               // elements of a 16-byte copy
    constexpr int UR = N / E, UV = MV / E, UL = N / 4;
    const int t0 = i * C;
    const int cv = min(C, S - t0);
    for (int e = tid; e < cv * UR; e += kThreads) {
      const int t = e / UR, c = e % UR;
      const long long g = base + (t0 + t) * st + c * E;
      cp_async16(rraw + t * N + c * E, r + g);
      cp_async16(kraw + t * N + c * E, k + g);
    }
    for (int e = tid; e < cv * UV; e += kThreads) {
      const int t = e / UV, c = e % UV;
      cp_async16(vraw + t * MV + c * E, v + base + (t0 + t) * st + col0 + c * E);
    }
    for (int e = tid; e < cv * UL; e += kThreads) {
      const int t = e / UL, c = e % UL;
      cp_async16(lwraw + t * N + c * 4, logw + base + (t0 + t) * st + c * 4);
    }
  };
  load_chunk(0);
  cp_async_commit();

  // this thread's channel and scan segment, and its tiles of every product
  const int n = tid % N, seg = tid / N;
  const float un = u[h * N + n];
  const int lane = tid & 31, warp = tid >> 5;
  const int ta = (warp & 1) * 8 + (lane & 7);       // 16 tile rows: 2 warps of 8
  const int tb = (warp >> 1) * 4 + (lane >> 3);     // 16 tile columns: 4 warps of 4
  const int t_0 = ta * RT;                          // first row t of its y / score tile
  const int s_0 = tb * RT;                          // first column s of its score tile
  const int m_0 = tb * RM;                          // first column m of its y / state tile
  const int n_0 = ta * RN;                          // first row n of its state tile

  for (int i = 0; i < chunks; ++i) {
    const int t0 = i * C;
    const int cv = min(C, S - t0);                  // rows of this chunk inside S
    cp_async_wait_all();
    __syncthreads();

    // the state at the chunk's start, for the backward; no step below
    // writes the slice before the barrier after step 3
    if (states != nullptr) {
      float* dst = states + (static_cast<size_t>(i) * gridDim.x + bh) * N * N + col0;
      constexpr int U = MV / 4;
      for (int e = tid; e < N * U; e += kThreads) {
        const int nn = e / U, c = e % U;
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(nn) * N + c * 4) =
            *reinterpret_cast<const float4*>(ss + nn * LDV + c * 4);
      }
    }

    // 1. the running log-decay of this thread's segment
    float lw[SEG], pre[SEG];
    {
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        const int t = seg * SEG + j;
        lw[j] = t < cv ? lwraw[t * N + n] : 0.f;
        run += lw[j];
        pre[j] = run;
      }
      segtot[seg * N + n] = run;
    }
    __syncthreads();

    // 2. the chunk's f32 operands and the bonus
    {
      float off = 0.f, wc = 0.f;                    // sums of the segments before, and of all
#pragma unroll
      for (int q = 0; q < SEGS; ++q) {
        if (q == seg) off = wc;
        wc += segtot[q * N + n];
      }
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        const int t = seg * SEG + j;
        float rd = 0.f, kd = 0.f, kwv = 0.f, bon = 0.f;
        if (t < cv) {
          const float L = off + pre[j];
          const float rr = to_f32(rraw[t * N + n]);
          const float kk = to_f32(kraw[t * N + n]);
          rd = rr * expf(L - lw[j]);
          kd = kk * expf(-L);
          kwv = kk * expf(wc - L);
          bon = rr * (un * kk);
        }
        rdT[n * LDT + t] = rd;
        kdT[n * LDT + t] = kd;
        kw[t * LDK + n] = kwv;
#pragma unroll
        for (int o = GL / 2; o > 0; o >>= 1) bon += __shfl_xor_sync(0xffffffffu, bon, o);
        if (n % GL == 0) bpart[(n / GL) * KC + t] = bon;
      }
      if (seg == 0) expwc[n] = expf(wc);
      for (int e = tid; e < KC * MV; e += kThreads) {
        const int t = e / MV, m = e % MV;
        vS[t * LDV + m] = t < cv ? to_f32(vraw[t * MV + m]) : 0.f;
      }
    }
    __syncthreads();
    if (i + 1 < chunks) load_chunk(i + 1);          // overlaps steps 3 and 4
    cp_async_commit();

    // 3. scores into At[s][t], and the inter-chunk read into y's tile
    {
      float acc[RT][RT] = {};
      if (t_0 < C && s_0 < t_0 + RT - 1)           // some s < t in this tile
        tile_product<RT, RT>(acc, rdT + t_0, LDT, kdT + s_0, LDT, N);
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int b = 0; b < RT; ++b) {
          const int t = t_0 + a, s = s_0 + b;
          float val = 0.f;
          if (s < t) {
            val = acc[a][b];
          } else if (s == t) {
#pragma unroll
            for (int g = 0; g < GROUPS; ++g) val += bpart[g * KC + t];
          }
          At[s * LDT + t] = val;
        }
    }
    float yacc[RT][RM] = {};
    if (t_0 < C) tile_product<RT, RM>(yacc, rdT + t_0, LDT, ss + m_0, LDV, N);
    __syncthreads();

    // 4. the intra-chunk product (with the bonus) into y, y out; the state
    if (t_0 < C) {
      tile_product<RT, RM>(yacc, At + t_0, LDT, vS + m_0, LDV, C);
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const int t = t_0 + a;
        if (t < cv) store_y<RM>(y + base + (t0 + t) * st + col0 + m_0, yacc[a]);
      }
    }
    {
      float sacc[RN][RM] = {};
      tile_product<RN, RM>(sacc, kw + n_0, LDK, vS + m_0, LDV, C);
#pragma unroll
      for (int a = 0; a < RN; ++a) {
        const float e = expwc[n_0 + a];
#pragma unroll
        for (int b = 0; b < RM; ++b) {
          float* p = ss + (n_0 + a) * LDV + m_0 + b;
          *p = *p * e + sacc[a][b];
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  {
    float* dst = s1 + static_cast<size_t>(bh) * N * N + col0;
    constexpr int U = MV / 4;
    for (int e = tid; e < N * U; e += kThreads) {
      const int nn = e / U, c = e % U;
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(nn) * N + c * 4) =
          *reinterpret_cast<const float4*>(ss + nn * LDV + c * 4);
    }
  }
}

struct Args {
  const void *r, *k, *v, *logw, *u, *state;
  void *y, *s1, *states;
  int BH, H, S, C, chunks;
  long long sb, sh, st;
  int device;
  cudaStream_t stream;
};

template <typename T, typename YT, int N, int MV, int KC>
cudaError_t launch(const Args& a) {
  using Lo = Layout<T, N, MV, KC>;
  auto kern = wkv_kernel<T, YT, N, MV, KC>;
  // the attribute is set once a device; setting it twice is harmless
  static bool attr_set[kMaxDevices] = {};
  if (a.device >= kMaxDevices || !attr_set[a.device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Lo::bytes));
    if (err != cudaSuccess) return err;
    if (a.device < kMaxDevices) attr_set[a.device] = true;
  }
  const dim3 grid(a.BH, N / MV);
  kern<<<grid, kThreads, Lo::bytes, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.logw), static_cast<const float*>(a.u),
      static_cast<const float*>(a.state), static_cast<YT*>(a.y), static_cast<float*>(a.s1),
      static_cast<float*>(a.states), a.H, a.S, a.C, a.chunks, a.sb, a.sh, a.st);
  return cudaGetLastError();
}

// the instantiations: N 64 with 1 or 2 column splits for chunks of up to 32
// rows (the wrapper picks 1 at B 4 and 2 at B 1) and 1 split above; N 16
// (the smoke config's head size) with 1
template <typename T, typename YT>
cudaError_t dispatch(int N, int splits, const Args& a) {
  if (N == 64) {
    if (a.C > 32) return splits == 1 ? launch<T, YT, 64, 64, 64>(a) : cudaErrorInvalidValue;
    switch (splits) {
      case 1: return launch<T, YT, 64, 64, 32>(a);
      case 2: return launch<T, YT, 64, 32, 32>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (N == 16 && splits == 1)
    return a.C > 32 ? launch<T, YT, 16, 16, 64>(a) : launch<T, YT, 16, 16, 32>(a);
  return cudaErrorInvalidValue;
}

cudaError_t run(int N, int splits, int dtype, bool y_f32, const Args& a) {
  if (a.BH < 1 || a.H < 1 || a.BH % a.H != 0 || a.C < 1 || a.C > 64 || a.S < 1 ||
      a.chunks != (a.S + a.C - 1) / a.C)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case kF32: return dispatch<float, float>(N, splits, a);
    case kBF16:
      return y_f32 ? dispatch<__nv_bfloat16, float>(N, splits, a)
                   : dispatch<__nv_bfloat16, __nv_bfloat16>(N, splits, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One layer: r, k, v (B, S, H, N) in the dtype of `dtype`, logw (B, S, H, N),
// u (H, N) and state (B, H, N, N) in f32, all contiguous and 16-byte aligned,
// in chunks of C = min(chunk, S) rows -> y (B, S, H, N) in r's dtype and the
// final state s1 (B, H, N, N) f32, which may be the state itself; where
// `states` is not null, also the state at the start of each chunk into it,
// (chunks, B, H, N, N) f32 (what the backward recomputes the chunks from).
// Grid (B H, splits).
int wkv_seq_fwd(const void* r, const void* k, const void* v, const void* logw,
                const void* u, const void* state, void* y, void* s1, void* states, int B,
                int S, int H, int N, int C, int splits, int dtype, int device,
                void* stream) {
  if (B < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long row = static_cast<long long>(H) * N;
  const Args a{r, k, v, logw, u, state, y, s1, states, B * H, H, S, C, (S + C - 1) / C,
               static_cast<long long>(S) * row, N, row, device,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(run(N, splits, dtype, /*y_f32=*/dtype == kF32, a));
}

// One chunk, the TPU kernel's flat layout: r, k, v (BH, C, N) in the dtype of
// `dtype`, logw (BH, C, N), u (H, N) (row bh reads u[bh % H]) and state
// (BH, N, N) in f32, all contiguous -> y (BH, C, N) f32 and s1 (BH, N, N) f32.
int wkv_chunk_fwd(const void* r, const void* k, const void* v, const void* logw,
                  const void* u, const void* state, void* y, void* s1, int BH,
                  int C, int N, int H, int dtype, int device, void* stream) {
  if (H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(C) * N;
  const Args a{r, k, v, logw, u, state, y, s1, nullptr, BH, H, C, C, 1,
               H * rows, rows, N, device, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(run(N, 1, dtype, /*y_f32=*/true, a));
}

}  // extern "C"
