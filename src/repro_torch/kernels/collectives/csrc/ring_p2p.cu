// Peer-memory ring reduce-scatter and all-gather for Hopper (sm_90a).
//
// Replaces the TPU kernels of the reference:
//   ring_reduce_scatter_tpu <- src/repro/kernels/collectives/kernel.py:208
//                              (body _ring_rs_kernel :153)
//   ring_all_gather_tpu     <- src/repro/kernels/collectives/kernel.py:227
//                              (body _ring_ag_kernel :184)
//
// What they compute.  The ring of ``ref.py::ring_reduce_scatter_ref`` /
// ``ring_all_gather_ref`` over the g ranks of one intra-pod group, each
// chunk's adds in the same order, so the result equals the plain ring bit
// for bit.  Reduce-scatter: x is (g, c); rank r's hop-0 payload is its own
// chunk r - 1; at hop s it receives the partial of chunk r - 1 - s from
// rank r - 1, adds its own value of that chunk and passes the sum on; after
// g - 1 hops it owns chunk r.  All-gather: rank r starts with chunk r and
// hop s delivers chunk r - s.  Bidirectional (the reference's default):
// columns [0, c/2) run that clockwise ring and [c/2, c) the
// counter-clockwise one (signs flipped), both in every launch; a chunk of
// one column runs clockwise alone.  f32 adds in f32; bf16 and f16 widen to
// f32, add once and round to nearest-even, as torch.add.
//
// Transport.  The TPU kernel copied each hop into the neighbour's VMEM by
// RDMA.  Here each rank owns one buffer from cudaMalloc, exported with
// cudaIpcGetMemHandle and opened by its two ring neighbours (once when
// they are one rank, g = 2): a header of flag words, then two message
// slots per direction.  A hop's kernel reads the message in this rank's
// slot, adds its own chunk, and stores the sum straight into the right
// neighbour's other slot (same card: the same HBM through another
// process's mapping; across cards: NVLink P2P stores).
//
// Signalling.  Every wait is in the stream, not on an SM: four processes
// time-sliced on one card make a spinning kernel hold the card for a whole
// time slice, while a stream wait lets the other contexts run (a hop then
// costs about a context switch; PERF.md has the times).  Per direction
// and slot k a rank keeps
//   ready[d][k]     written by the left neighbour after its data stores:
//                   the count of messages it has put into slot k;
//   consumed[d][k]  written by the right neighbour after it read its slot
//                   k: the credit before this rank writes that slot again.
// A hop is: cuStreamWaitValue32 (GEQ) on ready of the slot it reads and on
// the credit of the slot it writes; the kernel; cuStreamWriteValue32 of
// consumed to the left neighbour and of ready to the right one.  The
// writes carry the driver's system-scope fence before the store, so the
// data stores of the kernel are visible before the flag; the reading
// kernel loads the slot with ld.global.cg.  Counts grow across calls and
// are never reset (cyclic GEQ), so back-to-back calls need no host sync;
// every rank issues the same calls in the same order, which keeps the
// counts of both ends of a slot equal.
//
// Bounded waits.  A stream wait has no timeout of its own.  A host thread
// per ring reads a header word that the stream bumps after each hop's
// waits; if it stops short of the hops issued for longer than the
// timeout, the thread records which rank, chain, call, hop and flag it
// stuck on, sets the abort word in this rank's and its neighbours'
// headers (the kernels then store nothing), and releases the waits by
// writing past every expected count.  The wrapper raises with that
// message at the next call or check; a neighbour raises at its check.
//
// What bounds them.  No arithmetic: per hop a rank reads the received
// message and its own chunk and writes the sum (reduce-scatter), or reads
// and writes a chunk (all-gather).  At ResNet-50's bucket sizes the hop's
// cross-process latency (a context switch on one card) dominates the
// bytes; across cards the bytes each rank sends over NVLink at 450 GB/s a
// direction.
//
// Interface: plain C, loaded with ctypes (kernel.py).  Entry points return
// 0, a cudaError_t, kErrDriver + a CUresult, or one of the codes below.
// Launches go to the caller's stream and never synchronize; p2p_check
// waits for the ring's last call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <pthread.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;   // per direction
constexpr int64_t kHeaderBytes = 4096;
constexpr uint32_t kRecords = 1u << 14;
constexpr uint32_t kReleaseAhead = 0x40000000u;

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

// return codes besides cudaError_t (shared with kernel.py)
constexpr int kErrEntryPoint = 90001;   // the driver's stream-memory ops are missing
constexpr int kErrTooLarge = 90002;     // a chunk larger than a slot
constexpr int kErrFailed = 90003;       // the ring has failed: see p2p_message
constexpr int kErrDriver = 100000;      // + 1000 x the stream op (0 wait, 1 write) + CUresult

struct Header {
  uint32_t ready[2][2];
  uint32_t consumed[2][2];
  uint32_t abort;          // 0, or 1 + the rank that timed out
  uint32_t progress;       // hops of this rank whose waits passed (its own stream)
};

typedef CUresult (*StreamValue32)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
StreamValue32 g_wait_value = nullptr;
StreamValue32 g_write_value = nullptr;
std::once_flag g_once;
int g_entry_rc = 0;

int entry_point(const char* name, void** fn) {
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, fn, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  return q == cudaDriverEntryPointSuccess ? 0 : kErrEntryPoint;
}

int load_entry_points() {
  std::call_once(g_once, [] {
    g_entry_rc = entry_point("cuStreamWaitValue32", reinterpret_cast<void**>(&g_wait_value));
    if (!g_entry_rc)
      g_entry_rc = entry_point("cuStreamWriteValue32", reinterpret_cast<void**>(&g_write_value));
  });
  return g_entry_rc;
}

// What one hop waits for, kept for the watchdog's message.
struct HopRecord {
  uint64_t call;
  int op;                 // 0 reduce-scatter, 1 all-gather
  int hop;
  int ndir;
  int ready_slot;         // -1: no ready wait (hop 0)
  int credit_slot;        // -1: no credit wait (last hop)
  uint32_t ready[2];
  uint32_t credit[2];
};

struct Ring {
  int device = 0, g = 0, rank = 0, chain = 0;
  int64_t slot_bytes = 0;
  double timeout_s = 0;
  char* local = nullptr;
  char* peer[2] = {nullptr, nullptr};   // [d]: right neighbour of direction d
  int n_opened = 0;
  char* opened[2] = {nullptr, nullptr};
  uint32_t writes[2][2] = {};           // messages written into peer[d]'s slot k
  uint64_t calls = 0;
  std::atomic<uint32_t> issued{0};         // hops enqueued
  HopRecord* records = nullptr;
  cudaStream_t aux = nullptr;
  cudaEvent_t last = nullptr;
  bool any_call = false;
  pthread_t watchdog{};
  bool watchdog_started = false;
  std::atomic<bool> stop{false};
  std::atomic<int> failed{0};
  char message[1024] = {};
};

Header* header(char* base) { return reinterpret_cast<Header*>(base); }

char* slot(const Ring& R, char* base, int d, int k) {
  return base + kHeaderBytes + static_cast<int64_t>(d * 2 + k) * R.slot_bytes;
}

CUdeviceptr dptr(const void* p) {
  return static_cast<CUdeviceptr>(reinterpret_cast<uintptr_t>(p));
}

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

int wait_geq(cudaStream_t s, const uint32_t* word, uint32_t v) {
  const CUresult r = g_wait_value(reinterpret_cast<CUstream>(s), dptr(word), v,
                                  CU_STREAM_WAIT_VALUE_GEQ);
  return r == CUDA_SUCCESS ? 0 : kErrDriver + static_cast<int>(r);
}

int write_value(cudaStream_t s, uint32_t* word, uint32_t v) {
  const CUresult r = g_write_value(reinterpret_cast<CUstream>(s), dptr(word), v, 0);
  return r == CUDA_SUCCESS ? 0 : kErrDriver + 1000 + static_cast<int>(r);
}

// ------------------------------------------------------------------ kernel

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

// One direction's part of a hop: v = recv (+ own), or v = own; stored to
// dst0 and, if set, dst1.  recv is this rank's slot, written by another
// process or card: loaded at L2 (.cg), never from a stale L1 line.
template <typename T>
struct Seg {
  const T* recv;
  const T* own;
  T* dst0;
  T* dst1;
  int64_t n;
  int vec;
};

template <typename T>
struct HopArgs {
  Seg<T> seg[2];
  const uint32_t* abort;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_hop_kernel(HopArgs<T> args) {
  if (*reinterpret_cast<const volatile uint32_t*>(args.abort)) return;
  const Seg<T> sg = blockIdx.y == 0 ? args.seg[0] : args.seg[1];
  constexpr int kV = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nv = sg.vec ? sg.n / kV : 0;
  for (int64_t i = tid; i < nv; i += stride) {
    uint4 v;
    if (sg.recv) {
      v = __ldcg(reinterpret_cast<const uint4*>(sg.recv) + i);
      if (sg.own) {
        const uint4 o = reinterpret_cast<const uint4*>(sg.own)[i];
        T* pv = reinterpret_cast<T*>(&v);
        const T* po = reinterpret_cast<const T*>(&o);
#pragma unroll
        for (int j = 0; j < kV; ++j) pv[j] = add(pv[j], po[j]);
      }
    } else {
      v = reinterpret_cast<const uint4*>(sg.own)[i];
    }
    reinterpret_cast<uint4*>(sg.dst0)[i] = v;
    if (sg.dst1) reinterpret_cast<uint4*>(sg.dst1)[i] = v;
  }
  for (int64_t i = nv * kV + tid; i < sg.n; i += stride) {
    T v;
    if (sg.recv) {
      v = __ldcg(sg.recv + i);
      if (sg.own) v = add(v, sg.own[i]);
    } else {
      v = sg.own[i];
    }
    sg.dst0[i] = v;
    if (sg.dst1) sg.dst1[i] = v;
  }
}

template <typename T>
bool aligned16(const T* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch_hop(HopArgs<T>& a, int ndir, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  int64_t work = 1;
  for (int d = 0; d < ndir; ++d) {
    Seg<T>& sg = a.seg[d];
    sg.vec = aligned16(sg.recv) && aligned16(sg.own) && aligned16(sg.dst0) &&
             aligned16(sg.dst1);
    const int64_t w = sg.vec ? sg.n / kV + sg.n % kV : sg.n;
    if (w > work) work = w;
  }
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ring_hop_kernel<T><<<dim3(static_cast<unsigned>(blocks), ndir), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// --------------------------------------------------------------- the rings

struct Split {
  int ndir;
  int64_t lo[2];
  int64_t len[2];
};

Split split(int64_t c, bool bidi) {
  const int64_t h = c / 2;
  if (!bidi || h == 0) return Split{1, {0, 0}, {c, 0}};
  return Split{2, {0, h}, {h, c - h}};
}

int64_t wrap(int64_t j, int g) { return ((j % g) + g) % g; }

constexpr int kSign[2] = {1, -1};

// Waits of hop s, then the progress bump the watchdog reads.
int enqueue_waits(Ring& R, const Split& sp, int op, int s, uint64_t call, cudaStream_t st) {
  const int k = s % 2, k2 = (s + 1) % 2;
  const bool last = s == R.g - 1;
  Header* mine = header(R.local);
  HopRecord rec{call, op, s, sp.ndir, s > 0 ? k : -1, last ? -1 : k2, {0, 0}, {0, 0}};
  int rc = 0;
  for (int d = 0; d < sp.ndir && !rc; ++d) {
    if (s > 0) {
      rec.ready[d] = R.writes[d][k];
      rc = wait_geq(st, &mine->ready[d][k], R.writes[d][k]);
    }
    if (!rc && !last) {
      rec.credit[d] = R.writes[d][k2];
      rc = wait_geq(st, &mine->consumed[d][k2], R.writes[d][k2]);
    }
  }
  if (rc) return rc;
  const uint32_t idx = R.issued.load(std::memory_order_relaxed);
  R.records[idx % kRecords] = rec;
  R.issued.store(idx + 1, std::memory_order_release);
  return write_value(st, &mine->progress, idx + 1);
}

// Signals of hop s: slot k consumed (to the left neighbour), slot k2 ready
// (to the right one).
int enqueue_signals(Ring& R, const Split& sp, int s, cudaStream_t st) {
  const int k = s % 2, k2 = (s + 1) % 2;
  const bool last = s == R.g - 1;
  int rc = 0;
  for (int d = 0; d < sp.ndir && !rc; ++d) {
    if (s > 0)
      rc = write_value(st, &header(R.peer[1 - d])->consumed[d][k], R.writes[d][k]);
    if (!rc && !last) {
      ++R.writes[d][k2];
      rc = write_value(st, &header(R.peer[d])->ready[d][k2], R.writes[d][k2]);
    }
  }
  return rc;
}

template <typename T>
int reduce_scatter(Ring& R, const T* x, T* out, int64_t c, bool bidi, cudaStream_t st) {
  const int g = R.g, r = R.rank;
  const Split sp = split(c, bidi);
  const uint64_t call = ++R.calls;
  for (int s = 0; s < g; ++s) {
    const int k = s % 2, k2 = (s + 1) % 2;
    const bool last = s == g - 1;
    int rc = enqueue_waits(R, sp, 0, s, call, st);
    if (rc) return rc;
    HopArgs<T> a{};
    a.abort = &header(R.local)->abort;
    for (int d = 0; d < sp.ndir; ++d) {
      Seg<T>& sg = a.seg[d];
      // hop s combines chunk r - sign (s + 1): hop 0 sends chunk r - sign
      sg.own = x + wrap(r - kSign[d] * (s + 1), g) * c + sp.lo[d];
      sg.recv = s > 0 ? reinterpret_cast<const T*>(slot(R, R.local, d, k)) : nullptr;
      sg.dst0 = last ? out + sp.lo[d] : reinterpret_cast<T*>(slot(R, R.peer[d], d, k2));
      sg.dst1 = nullptr;
      sg.n = sp.len[d];
    }
    rc = static_cast<int>(launch_hop(a, sp.ndir, st));
    if (rc) return rc;
    rc = enqueue_signals(R, sp, s, st);
    if (rc) return rc;
  }
  return 0;
}

template <typename T>
int all_gather(Ring& R, const T* shard, T* out, int64_t c, bool bidi, cudaStream_t st) {
  const int g = R.g, r = R.rank;
  const Split sp = split(c, bidi);
  const uint64_t call = ++R.calls;
  for (int s = 0; s < g; ++s) {
    const int k = s % 2, k2 = (s + 1) % 2;
    const bool last = s == g - 1;
    int rc = enqueue_waits(R, sp, 1, s, call, st);
    if (rc) return rc;
    HopArgs<T> a{};
    a.abort = &header(R.local)->abort;
    for (int d = 0; d < sp.ndir; ++d) {
      Seg<T>& sg = a.seg[d];
      T* next = last ? nullptr : reinterpret_cast<T*>(slot(R, R.peer[d], d, k2));
      if (s == 0) {             // own chunk into place and on to the right
        sg.recv = nullptr;
        sg.own = shard + sp.lo[d];
        sg.dst0 = out + static_cast<int64_t>(r) * c + sp.lo[d];
        sg.dst1 = next;
      } else {                  // hop s delivers chunk r - sign s
        sg.recv = reinterpret_cast<const T*>(slot(R, R.local, d, k));
        sg.own = nullptr;
        sg.dst0 = out + wrap(r - kSign[d] * s, g) * c + sp.lo[d];
        sg.dst1 = next;
      }
      sg.n = sp.len[d];
    }
    rc = static_cast<int>(launch_hop(a, sp.ndir, st));
    if (rc) return rc;
    rc = enqueue_signals(R, sp, s, st);
    if (rc) return rc;
  }
  return 0;
}

// --------------------------------------------------------------- watchdog

uint32_t release_value(const Ring& R) {
  uint32_t m = 0;
  for (int d = 0; d < 2; ++d)
    for (int k = 0; k < 2; ++k)
      if (R.writes[d][k] > m) m = R.writes[d][k];
  return m + kReleaseAhead;
}

void set_abort(Ring& R, char* base, uint32_t code) {
  cudaMemcpyAsync(&header(base)->abort, &code, sizeof(code), cudaMemcpyHostToDevice, R.aux);
}

// Write past every expected count so that the stalled waits pass.
void release_waits(Ring& R) {
  uint32_t flags[8];
  const uint32_t v = release_value(R);
  for (uint32_t& f : flags) f = v;
  cudaMemcpyAsync(R.local, flags, sizeof(flags), cudaMemcpyHostToDevice, R.aux);
  cudaStreamSynchronize(R.aux);
}

void time_out(Ring& R, uint32_t hop_index, double waited) {
  Header seen{};
  cudaMemcpyAsync(&seen, R.local, sizeof(seen), cudaMemcpyDeviceToHost, R.aux);
  cudaStreamSynchronize(R.aux);
  const HopRecord& h = R.records[hop_index % kRecords];
  int n = snprintf(R.message, sizeof(R.message),
                   "peer ring wait timed out after %.1f s: rank %d of an intra-pod ring "
                   "of %d, chain %d, hop %d of %s call %llu;",
                   waited, R.rank, R.g, R.chain, h.hop,
                   h.op == 0 ? "reduce-scatter" : "all-gather",
                   static_cast<unsigned long long>(h.call));
  for (int d = 0; d < h.ndir && n < static_cast<int>(sizeof(R.message)); ++d) {
    const int left = static_cast<int>(wrap(R.rank - kSign[d], R.g));
    const int right = static_cast<int>(wrap(R.rank + kSign[d], R.g));
    if (h.ready_slot >= 0 && n < static_cast<int>(sizeof(R.message)))
      n += snprintf(R.message + n, sizeof(R.message) - n,
                    " dir %d ready[%d] from rank %d: want >= %u, holds %u;", d,
                    h.ready_slot, left, h.ready[d], seen.ready[d][h.ready_slot]);
    if (h.credit_slot >= 0 && n < static_cast<int>(sizeof(R.message)))
      n += snprintf(R.message + n, sizeof(R.message) - n,
                    " dir %d credit[%d] from rank %d: want >= %u, holds %u;", d,
                    h.credit_slot, right, h.credit[d], seen.consumed[d][h.credit_slot]);
  }
  const uint32_t code = 1u + static_cast<uint32_t>(R.rank);
  set_abort(R, R.local, code);
  set_abort(R, R.peer[0], code);
  if (R.peer[1] != R.peer[0]) set_abort(R, R.peer[1], code);
  cudaStreamSynchronize(R.aux);
  R.failed.store(1, std::memory_order_release);
}

void* watchdog_main(void* arg) {
  Ring& R = *static_cast<Ring*>(arg);
  cudaSetDevice(R.device);
  uint32_t seen = 0;
  double since = now_s();
  while (!R.stop.load(std::memory_order_acquire)) {
    usleep(5000);
    const uint32_t issued = R.issued.load(std::memory_order_acquire);
    if (issued == seen && !R.failed.load(std::memory_order_acquire)) {
      since = now_s();     // nothing issued since the last poll found it all passed
      continue;
    }
    uint32_t passed = 0;
    cudaMemcpyAsync(&passed, &header(R.local)->progress, sizeof(passed),
                    cudaMemcpyDeviceToHost, R.aux);
    cudaStreamSynchronize(R.aux);
    if (passed == issued) {
      seen = passed;
      since = now_s();
      continue;
    }
    if (R.failed.load(std::memory_order_acquire)) {   // keep the stream moving
      release_waits(R);
      continue;
    }
    if (passed != seen) {
      seen = passed;
      since = now_s();
      continue;
    }
    if (now_s() - since > R.timeout_s) {
      time_out(R, passed, now_s() - since);
      release_waits(R);
    }
  }
  return nullptr;
}

template <typename F>
int dispatch(int dtype, F&& f) {
  switch (dtype) {
    case kF32: return f(float{});
    case kBF16: return f(__nv_bfloat16{});
    case kF16: return f(__half{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int element_size(int dtype) { return dtype == kF32 ? 4 : 2; }

int begin_call(Ring& R, int64_t c, int dtype, void* stream) {
  if (R.failed.load(std::memory_order_acquire)) return kErrFailed;
  if (c < 1 || dtype < kF32 || dtype > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c * element_size(dtype) > R.slot_bytes) return kErrTooLarge;
  return static_cast<int>(cudaSetDevice(R.device));
}

int end_call(Ring& R, cudaStream_t st) {
  R.any_call = true;
  return static_cast<int>(cudaEventRecord(R.last, st));
}

}  // namespace

extern "C" {

// Allocate this rank's buffer (header + 2 directions x 2 slots of
// slot_bytes) and start its watchdog; write the IPC handle (64 bytes).
int p2p_create(int device, int g, int rank, int chain, int64_t slot_bytes,
               double timeout_s, void** out, void* handle) {
  if (g < 2 || rank < 0 || rank >= g || slot_bytes < 1 || timeout_s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = load_entry_points();
  if (rc) return rc;
  cudaError_t e = cudaSetDevice(device);
  if (e) return static_cast<int>(e);
  Ring* R = new Ring();
  R->device = device;
  R->g = g;
  R->rank = rank;
  R->chain = chain;
  R->slot_bytes = (slot_bytes + 255) / 256 * 256;
  R->timeout_s = timeout_s;
  R->records = new HopRecord[kRecords]();
  const int64_t bytes = kHeaderBytes + 4 * R->slot_bytes;
  if ((e = cudaMalloc(reinterpret_cast<void**>(&R->local), bytes)) ||
      (e = cudaMemset(R->local, 0, kHeaderBytes)) ||
      (e = cudaStreamCreateWithFlags(&R->aux, cudaStreamNonBlocking)) ||
      (e = cudaEventCreateWithFlags(&R->last, cudaEventDisableTiming)) ||
      (e = cudaDeviceSynchronize()) ||
      (e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), R->local))) {
    if (R->local) cudaFree(R->local);
    delete[] R->records;
    delete R;
    return static_cast<int>(e);
  }
  if (pthread_create(&R->watchdog, nullptr, watchdog_main, R) != 0)
    return static_cast<int>(cudaErrorUnknown);
  R->watchdog_started = true;
  *out = R;
  return 0;
}

// Open the neighbours' buffers: right of the clockwise ring (rank + 1) and
// left (rank - 1); one peer, opened once, in a ring of two.
int p2p_open(void* ring, const void* right_handle, const void* left_handle) {
  Ring& R = *static_cast<Ring*>(ring);
  cudaError_t e = cudaSetDevice(R.device);
  if (e) return static_cast<int>(e);
  const void* hs[2] = {right_handle, left_handle};
  const int n = (R.g == 2 || memcmp(right_handle, left_handle, sizeof(cudaIpcMemHandle_t)) == 0)
                    ? 1 : 2;
  for (int i = 0; i < n; ++i) {
    cudaIpcMemHandle_t h;
    memcpy(&h, hs[i], sizeof(h));
    void* p = nullptr;
    e = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
    if (e) return static_cast<int>(e);
    R.opened[R.n_opened++] = static_cast<char*>(p);
  }
  R.peer[0] = R.opened[0];
  R.peer[1] = R.opened[n - 1];
  return 0;
}

// x (g, c) -> out (c,): this rank's reduced chunk.  g launches.
int p2p_reduce_scatter(void* ring, const void* x, void* out, int64_t c, int dtype,
                       int bidi, void* stream) {
  Ring& R = *static_cast<Ring*>(ring);
  int rc = begin_call(R, c, dtype, stream);
  if (rc) return rc;
  const auto st = static_cast<cudaStream_t>(stream);
  rc = dispatch(dtype, [&](auto t) {
    using T = decltype(t);
    return reduce_scatter<T>(R, static_cast<const T*>(x), static_cast<T*>(out), c,
                             bidi != 0, st);
  });
  return rc ? rc : end_call(R, st);
}

// shard (c,) -> out (g, c): every rank's chunk.  g launches.
int p2p_all_gather(void* ring, const void* shard, void* out, int64_t c, int dtype,
                   int bidi, void* stream) {
  Ring& R = *static_cast<Ring*>(ring);
  int rc = begin_call(R, c, dtype, stream);
  if (rc) return rc;
  const auto st = static_cast<cudaStream_t>(stream);
  rc = dispatch(dtype, [&](auto t) {
    using T = decltype(t);
    return all_gather<T>(R, static_cast<const T*>(shard), static_cast<T*>(out), c,
                         bidi != 0, st);
  });
  return rc ? rc : end_call(R, st);
}

// Wait for the ring's last call (a stalled wait is released by the
// watchdog), then report: 0, or kErrFailed with the message in msg.
int p2p_check(void* ring, char* msg, int len) {
  Ring& R = *static_cast<Ring*>(ring);
  cudaError_t e = cudaSetDevice(R.device);
  if (!e && R.any_call) e = cudaEventSynchronize(R.last);
  if (e) return static_cast<int>(e);
  uint32_t abort = 0;
  e = cudaMemcpyAsync(&abort, &header(R.local)->abort, sizeof(abort),
                      cudaMemcpyDeviceToHost, R.aux);
  if (!e) e = cudaStreamSynchronize(R.aux);
  if (e) return static_cast<int>(e);
  if (abort && !R.failed.load(std::memory_order_acquire)) {
    snprintf(R.message, sizeof(R.message),
             "peer ring of chain %d failed: rank %u of the ring (this is rank %d of %d) "
             "timed out, so this rank's results since then are void",
             R.chain, abort - 1, R.rank, R.g);
    R.failed.store(1, std::memory_order_release);
  }
  if (!R.failed.load(std::memory_order_acquire)) return 0;
  snprintf(msg, len, "%s", R.message);
  return kErrFailed;
}

// The message of a failed ring (empty otherwise), without waiting.
int p2p_message(void* ring, char* msg, int len) {
  Ring& R = *static_cast<Ring*>(ring);
  snprintf(msg, len, "%s", R.failed.load(std::memory_order_acquire) ? R.message : "");
  return R.failed.load(std::memory_order_acquire) ? kErrFailed : 0;
}

// Stop the watchdog, close the neighbours' buffers, free this rank's.  The
// caller first waits for the ring's work (p2p_check) on every rank.
int p2p_destroy(void* ring) {
  Ring* R = static_cast<Ring*>(ring);
  cudaSetDevice(R->device);
  if (R->watchdog_started) {
    R->stop.store(true, std::memory_order_release);
    pthread_join(R->watchdog, nullptr);
  }
  int rc = 0;
  for (int i = 0; i < R->n_opened; ++i) {
    const cudaError_t e = cudaIpcCloseMemHandle(R->opened[i]);
    if (e && !rc) rc = static_cast<int>(e);
  }
  cudaError_t e = cudaFree(R->local);
  if (e && !rc) rc = static_cast<int>(e);
  cudaEventDestroy(R->last);
  cudaStreamDestroy(R->aux);
  delete[] R->records;
  delete R;
  return rc;
}

}  // extern "C"
