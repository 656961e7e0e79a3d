// Flash-attention forward for Hopper (sm_90a) on the tensor cores: bf16
// q, k, v, causal or full online-softmax attention, one (batch, q head,
// 64-row q tile) per thread block.
//
// Replaces the TPU kernel of the reference, for bf16 inputs:
//   flash_attention_fwd  <- src/repro/kernels/flash_attention/kernel.py:78
//                           (flash_attention_fwd, body _fwd_kernel :25)
// f32 inputs stay on the CUDA-core kernel of csrc/flash_attention.cu, which
// keeps the TPU kernel's f32 arithmetic; kernel.py dispatches by dtype.
//
// What it computes.  For each q row, over the k tiles it can see:
// S = q k^T in f32, times scale = 1/sqrt(D); scores the causal mask hides
// (or k rows past S) become -1e30; a running max m and sum l in f32
// rescale the f32 output accumulator by exp(m_old - m_new) each k tile;
// P = exp(S - m_new) goes to P.V as two bf16 parts, P_hi = bf16(P) and
// P_lo = bf16(P - P_hi).  k tiles wholly above the diagonal are skipped.
// The output is acc / (l > 0 ? l : 1) in bf16.
//
// Numerics against the TPU kernel (which computes (q * scale) k^T and P.V
// in f32):
//   - Q.K^T: a product of two bf16 values is exact in f32, so only the
//     order of the f32 accumulation differs.
//   - The scale is applied to S in f32 after the product, not to q before
//     it, and exp is taken as exp2 of S * (scale * log2 e): f32 rounding
//     differences, about 1e-7 relative.
//   - P in bf16.  Rounded once, each weight would move by up to 2^-9 of
//     itself, and an output by up to 2^-9 times the P-weighted mean of |v|.
//     On an H100 (chip_smoke.py's flash phase) that put the kernel
//     1.5625e-2 from the plain version at the static prefill shape, over
//     half the bf16 tolerance of 2e-2 (tests/test_kernels.py:34).  So P is
//     split: P_hi = bf16(P), P_lo = bf16(P - P_hi), and P.V is two wgmma,
//     P_hi.V + P_lo.V, which carries P to about 2^-17 of itself; the same
//     check then gave 3.90625e-3.  What is left between kernel and plain
//     version is mostly their final casts to bf16, half an ulp each.  l
//     sums the unrounded P.
//
// What bounds it on this card.  Moving q, k, v and o once is the byte
// bound (Qwen3-1.7B's static prefill, B 4, S 512, 16 q / 8 kv heads, D 128,
// bf16: 25.2 MB, 7.5 us at 3.35 TB/s); its 4.3 GFLOP of causal scores and
// P.V take 4.4 us at the 989 TFLOP/s of the bf16 tensor cores (6.5 GFLOP
// and 6.5 us with P.V done twice, for P_hi and P_lo).  So it is bound by
// bytes, and only a kernel that keeps the tensor cores fed comes near that.
//
// What the design does.
//   - Warp specialisation: warps 0-3 are one consumer warpgroup, warp 4 a
//     producer of which one thread issues every load.
//   - Loads: TMA (cp.async.bulk.tensor) from tensor maps built on the host
//     over the (B, S, H, D) strides, in boxes of 64 rows x min(D, 64)
//     columns, with the 128-byte swizzle (32-byte at D 16) that wgmma
//     reads.  Q is loaded once; K and V tiles go through a ring of
//     kStages stages, each with a "K full", a "V full" and an "empty"
//     mbarrier, so the loads of the next tiles run under this tile's math.
//     Rows past S are filled with zeros by the TMA unit.  GQA reads kv head
//     h / (Hq / Hkv) in place.
//   - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//     D / 16 instructions into 32 f32 registers a thread.
//   - Softmax in registers on the accumulator fragment: each thread holds
//     two rows (r and r + 8) of 16 columns each; row max and sum are
//     reduced over the 4 lanes that share a row.  The mask is computed
//     only on the diagonal tile and on a ragged last tile.
//   - Overlap inside the warpgroup: tile k's S wgmma is issued together
//     with tile k - 1's P.V wgmma, and tile k's softmax runs while that
//     P.V is still on the tensor cores; O is rescaled by tile k's
//     correction once P.V is done, before tile k's own P.V.
//   - P.V: P_hi and P_lo are packed to bf16 in registers and are the
//     register A operand of wgmma m64nWk16 (W = min(D, 64)), with V (16 k
//     rows x W columns a step, MN-major) read from shared memory with the
//     transpose flag; one accumulator of W / 2 registers for each W
//     columns of the output.  P never goes through shared memory.
//   - Heaviest causal q tiles are launched first (grid z walks the q tiles
//     from the last), so the short ones fill the tail.
//   - The output goes from registers to o as bf16 pairs, rows past S not
//     stored.
//
// Interface: plain C, loaded with ctypes (kernel.py).  The entry point
// returns cudaGetLastError() after its launch (or a code of its own below);
// the wrapper raises if it is not 0.  The launch goes to the caller's
// stream and never synchronizes.  A wait on an mbarrier that has not
// completed after about 2^34 cycles traps, so a fault in the pipeline
// ends in a launch error instead of a hang.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kBlockQ = 64;                  // q rows per block (one wgmma M)
constexpr int kBlockK = 64;                  // k rows per tile
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kStages = 2;                   // K/V ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kWaitCycles = 1LL << 34;
constexpr int kMaxDevices = 64;

constexpr int kErrEntryPoint = 90001;   // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMap = 91000;    // + CUresult of cuTensorMapEncodeTiled

template <int D>
struct Tile {
  static_assert(D == 16 || D == 64 || D == 128 || D == 256, "D in {16, 64, 128, 256}");
  static constexpr int W = D < 64 ? D : 64;            // columns of one box
  static constexpr int kChunks = D / W;                // boxes across D
  static constexpr int kRowBytes = 2 * W;              // 32 or 128: the swizzle span
  static constexpr int kChunkBytes = kBlockK * kRowBytes;
  static constexpr int kTileBytes = kChunks * kChunkBytes;   // 64 rows x D bf16
  static constexpr int kGroupBytes = 8 * kRowBytes;          // 8 rows: the SBO
  static constexpr uint64_t kLayout = W == 64 ? 1 : 3;       // wgmma B128 / B32
  static constexpr int kAlign = 1024;                        // a swizzle atom's span
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr size_t kSmem = kAlign + static_cast<size_t>(1 + 2 * kStages) * kTileBytes +
                                  8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kWaitCycles) {
      __trap();
    }
  }
}

// One box of a 4-d tensor map (D, H, S, B) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, LBO 16 bytes (no
// operand here spans two swizzle atoms along its leading dimension), SBO
// = the stride between groups of 8 rows, swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo_bytes,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers at this point of the instruction stream: the
// compiler must not read them between an mma_async and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64 x n64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (m64 x n16, f32) += A (64 x 16, bf16 registers) * B (16 x 16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                    int S, int Hq, int group, int n_q, float scale_log2, int causal) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + T::kAlign - 1) & ~static_cast<uint32_t>(T::kAlign - 1);
  const uint32_t q_s = base;
  const uint32_t k_s = base + T::kTileBytes;                  // + stage * kTileBytes
  const uint32_t v_s = k_s + kStages * T::kTileBytes;         // + stage * kTileBytes
  const uint32_t bars = v_s + kStages * T::kTileBytes;
  const uint32_t q_full = bars;
  const auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  const auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  const auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.z);   // heaviest causal tiles first
  const int q0 = qt * kBlockQ;
  const int n_k = (S + kBlockK - 1) / kBlockK;
  const int kt_end = causal ? qt + 1 : n_k;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumers / 32) {
    // ---- producer: one thread issues every TMA load ----
    if (lane == 0) {
      const int hk = h / group;
      mbar_expect_tx(q_full, T::kTileBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_s + c * T::kChunkBytes, &q_map, q_full, c * T::W, h, q0, b);
      for (int kt = 0; kt < kt_end; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) + 1) & 1);
        const uint32_t ks = k_s + s * T::kTileBytes;
        const uint32_t vs = v_s + s * T::kTileBytes;
        mbar_expect_tx(k_full(s), T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(ks + c * T::kChunkBytes, &k_map, k_full(s), c * T::W, hk, kt * kBlockK, b);
        mbar_expect_tx(v_full(s), T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(vs + c * T::kChunkBytes, &v_map, v_full(s), c * T::W, hk, kt * kBlockK, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int r_lo = 16 * warp + lane / 4;   // this thread's rows: r_lo and r_lo + 8
  const int cq = 2 * (lane % 4);           // and columns cq, cq + 1 of every 8
  const int q_lo = q0 + r_lo;
  const int q_hi = q_lo + 8;

  float acc[T::kChunks][T::W / 2];
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < T::W / 2; ++i) acc[c][i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;   // running max, in units of log2
  float l_lo = 0.f, l_hi = 0.f;           // this thread's share of the running sum
  float corr_lo = 0.f, corr_hi = 0.f;     // exp(m_old - m_new) of the last softmax
  // sc[4j + e] is S or P at (r_lo, 8j + cq + e), sc[4j + 2 + e] at (r_lo + 8, ...)
  float sc[32];
  // P of the last softmax as the A operand of m64nWk16, k step kk = columns
  // 16kk..16kk+15: (r_lo, cols), (r_lo + 8, cols), (r_lo, cols + 8),
  // (r_lo + 8, cols + 8); P = P_hi + P_lo, each bf16, P_lo = bf16(P - P_hi)
  uint32_t p_hi[4][4], p_lo[4][4];

  // S = Q K^T of tile kt into sc: issued and committed, not waited for
  const auto issue_s = [&](int kt) {
    const int st = kt % kStages;
    const uint32_t ks = k_s + st * T::kTileBytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(k_full(st), (kt / kStages) & 1);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / (T::W / 16)) * T::kChunkBytes + (kk % (T::W / 16)) * 32;
      wgmma_ss_m64n64k16(sc, smem_desc(q_s + off, T::kGroupBytes, T::kLayout),
                         smem_desc(ks + off, T::kGroupBytes, T::kLayout), kk > 0);
    }
    wgmma_commit();
  };

  // O += P V of tile kt, with the packed P: issued and committed
  const auto issue_pv = [&](int kt) {
    const int st = kt % kStages;
    const uint32_t vs = v_s + st * T::kTileBytes;
    mbar_wait(v_full(st), (kt / kStages) & 1);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        const uint64_t dv = smem_desc(vs + c * T::kChunkBytes + kk * 2 * T::kGroupBytes,
                                      T::kGroupBytes, T::kLayout);
        wgmma_rs_tb(acc[c], p_hi[kk], dv);
        wgmma_rs_tb(acc[c], p_lo[kk], dv);
      }
    wgmma_commit();
  };

  // online softmax of tile kt on sc, in place (S -> P in f32), on the
  // fragment: m, l and corr of both rows
  const auto softmax = [&](int kt) {
    const int k0 = kt * kBlockK;
    const bool edge = (causal && kt == kt_end - 1) || k0 + kBlockK > S;
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x_lo = sc[4 * j + e] * scale_log2;
        float x_hi = sc[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + cq + e;
          if (kpos >= S || (causal && kpos > q_lo)) x_lo = kNegInf;
          if (kpos >= S || (causal && kpos > q_hi)) x_hi = kNegInf;
        }
        sc[4 * j + e] = x_lo;
        sc[4 * j + 2 + e] = x_hi;
        mx_lo = fmaxf(mx_lo, x_lo);
        mx_hi = fmaxf(mx_hi, x_hi);
      }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    corr_lo = exp2f(m_lo - mn_lo);
    corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mn_lo);
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn_hi);
        sum_lo += sc[4 * j + e];
        sum_hi += sc[4 * j + 2 + e];
      }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
  };

  // the last softmax's P into p_hi / p_lo, and O rescaled by its corr
  const auto pack_and_rescale = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = sc[8 * kk + 2 * i], x1 = sc[8 * kk + 2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        p_hi[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][i] = pack_bf16(x0 - __bfloat162float(hi.x), x1 - __bfloat162float(hi.y));
      }
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < T::W / 8; ++j) {
        acc[c][4 * j + 0] *= corr_lo;
        acc[c][4 * j + 1] *= corr_lo;
        acc[c][4 * j + 2] *= corr_hi;
        acc[c][4 * j + 3] *= corr_hi;
      }
  };

  // Tile kt's scores are computed while tile kt - 1's P.V runs, and its
  // softmax runs under that P.V too: O is rescaled only once P.V is done.
  mbar_wait(q_full, 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  pack_and_rescale();
  for (int kt = 1; kt < kt_end; ++kt) {
    issue_s(kt);
    issue_pv(kt - 1);
    wgmma_wait<1>();                      // S of tile kt is in
    fence_regs(sc);
    softmax(kt);
    wgmma_wait<0>();                      // P.V of tile kt - 1 is done
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) fence_regs(acc[c]);
    mbar_arrive(empty((kt - 1) % kStages));
    pack_and_rescale();
  }
  issue_pv(kt_end - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c) fence_regs(acc[c]);

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float d_lo = l_lo > 0.f ? l_lo : 1.f;
  const float d_hi = l_hi > 0.f ? l_hi : 1.f;
  __nv_bfloat16* o_lo = o + ((static_cast<int64_t>(b) * S + q_lo) * Hq + h) * D;
  __nv_bfloat16* o_hi = o + ((static_cast<int64_t>(b) * S + q_hi) * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
    for (int j = 0; j < T::W / 8; ++j) {
      const int col = c * T::W + 8 * j + cq;
      if (q_lo < S)
        *reinterpret_cast<__nv_bfloat162*>(o_lo + col) =
            __floats2bfloat162_rn(acc[c][4 * j] / d_lo, acc[c][4 * j + 1] / d_lo);
      if (q_hi < S)
        *reinterpret_cast<__nv_bfloat162*>(o_hi + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2] / d_hi, acc[c][4 * j + 3] / d_hi);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled g_encode = nullptr;
std::once_flag g_once;
int g_entry_rc = 0;

int load_encode() {
  std::call_once(g_once, [] {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) {
      g_entry_rc = static_cast<int>(e);
    } else if (q != cudaDriverEntryPointSuccess || fn == nullptr) {
      g_entry_rc = kErrEntryPoint;
    } else {
      g_encode = reinterpret_cast<EncodeTiled>(fn);
    }
  });
  return g_entry_rc;
}

// A (B, S, H, D) bf16 tensor with element strides (b, s, h) and a
// contiguous D, as a 4-d map (D, H, S, B) read in boxes of 64 rows x w
// columns of one head.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, const int64_t* st,
             int w, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(w), 1, kBlockK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = g_encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq, int Hkv,
           const int64_t* qs, const int64_t* ks, const int64_t* vs, float scale, bool causal,
           int device, cudaStream_t stream) {
  using T = Tile<D>;
  const CUtensorMapSwizzle sw = T::W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map(&q_map, q, B, S, Hq, D, qs, T::W, sw);
  if (!rc) rc = make_map(&k_map, k, B, S, Hkv, D, ks, T::W, sw);
  if (!rc) rc = make_map(&v_map, v, B, S, Hkv, D, vs, T::W, sw);
  if (rc) return rc;
  static bool smem_set[kMaxDevices] = {};   // per device, once
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(T::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  const int n_q = (S + kBlockQ - 1) / kBlockQ;
  const dim3 grid(Hq, B, n_q);
  flash_fwd_tc_kernel<D><<<grid, kThreads, T::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), S, Hq, Hq / Hkv, n_q,
      scale * kLog2e, causal ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, S, Hq, D), k/v (B, S, Hkv, D) bf16 through their (b, s, h) element
// strides, last dim contiguous, base pointers and strides 16-byte aligned
// (kernel.py checks) -> o (B, S, Hq, D) contiguous bf16.
int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o, int B, int S,
                           int Hq, int Hkv, int D, const int64_t* q_strides,
                           const int64_t* k_strides, const int64_t* v_strides, int causal,
                           float scale, int device, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || (S + kBlockQ - 1) / kBlockQ > 65535 || Hkv < 1 ||
      Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = load_encode();
  if (rc) return rc;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, S, Hq, Hkv, q_strides, k_strides, v_strides, scale, c, device, st);
    case 64: return launch<64>(q, k, v, o, B, S, Hq, Hkv, q_strides, k_strides, v_strides, scale, c, device, st);
    case 128: return launch<128>(q, k, v, o, B, S, Hq, Hkv, q_strides, k_strides, v_strides, scale, c, device, st);
    case 256: return launch<256>(q, k, v, o, B, S, Hq, Hkv, q_strides, k_strides, v_strides, scale, c, device, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
