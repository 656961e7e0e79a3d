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
// they are one rank, g = 2): a header of flag words, then K message slots
// per direction (K = 2g, chosen by kernel.py).  A hop's kernel reads the
// message in this rank's slot, adds its own chunk, and stores the sum
// straight into the right neighbour's slot (same card: the same HBM
// through another process's mapping; across cards: NVLink P2P stores).
// The slots rotate across calls: a link (this rank to one neighbour)
// numbers its messages from the ring's start, and message m goes into slot
// m % K, so a slot is written again only K messages later.
//
// Signalling.  Per neighbour, not per direction and slot, a rank's header
// keeps two counts, both monotone across calls:
//   ready[i]     blocks of neighbour i's hop kernels that stored into this
//                rank's slots;
//   consumed[i]  blocks of neighbour i's hop kernels that read this rank's
//                messages
// (i = 0 the right neighbour, 1 the left; at g = 2 both are one rank, and
// index 0 carries both directions).  A hop's grid depends only on the
// chunk's length, the directions and the dtype, so both ends of a message
// count its blocks alike: a message is ready, or consumed, when the count
// has grown by its blocks.  A hop enqueues, per neighbour it reads from,
// one cuStreamWaitValue32 (GEQ, cyclic) on ready for this hop's message,
// and per neighbour it writes to, one on consumed for the message that
// last held the slot it writes (the credit); then its kernel.  The kernel
// signals for itself: each block, after a block barrier and one fence,
// adds one to the flag of each neighbour it signals (red.add, no return)
// and to this rank's progress word.  No block waits for another, so the
// signals add no round trip to the kernel's tail.  The fence is at GPU
// scope when every neighbour's buffer is on this card (four processes
// sharing it), at system scope when one is on another card (NVLink; the
// set-up compares the cards' UUIDs): a system-scope fence costs a few
// microseconds a block on one card.  The reading kernel loads the slot
// with ld.global.cg.  So a call at g = 2
// enqueues two stream operations (the credit at hop 0, the ready wait at
// hop 1), at g > 2 up to four a hop, and no stream write at all.
//
// Why the credit wait no longer blocks.  A link carries at most g - 1
// messages a call, so with K = 2g the credit of call n refers to a
// message of call n - 2 or earlier.  The neighbour read that message
// before it sent anything of call n - 1 (its stream is in order), and this
// rank's hops of call n - 1 already waited, through the ring, for what
// the neighbour sent in call n - 1.  So the ranks no longer move in
// lockstep: one cross-process wait a hop remains, for the data itself.
// (2(g - 1) slots would do; the two more keep the credit clear of the
// order in which two flag stores from one neighbour land.)
//
// Why the waits stay in the stream.  Four processes time-sliced on one
// card make a spinning kernel hold the card for a whole time slice, while
// a stream wait lets the other contexts run (a hop then costs about a
// context switch; PERF.md has the times).  A call's hops in one launch
// with the waits on an SM suits separate cards only.
//
// Bounded waits.  A stream wait has no timeout of its own.  A host thread
// per ring reads the progress word, which every block of a hop's kernel
// bumps; if it stops short of the blocks issued for longer than the
// timeout, the thread records which rank, chain, call, hop and flag it
// stuck on, sets the abort word in this rank's and its neighbours'
// headers, and releases the waits by writing past every expected count.
// A block that finds the abort word set stores no data and signals no
// neighbour (it still bumps progress, so the watchdog sees the stream
// drain).  The wrapper raises with that message at the next call or
// check; a neighbour raises at its check.
//
// What bounds them.  No arithmetic: per hop a rank reads the received
// message and its own chunk and writes the sum (reduce-scatter), or reads
// and writes a chunk (all-gather).  At ResNet-50's bucket sizes the hop's
// cross-process latency (a context switch on one card) dominates the
// bytes; across cards the bytes each rank sends over NVLink at 450 GB/s a
// direction.  So a hop's kernel is built for latency: each thread moves
// kUnroll 16-byte vectors with every load issued before the first add, so
// that the largest ResNet-50 chunk is one pass of the grid (one memory
// latency), and the blocks signal with adds that return nothing, behind
// one fence each.
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
constexpr int kUnroll = 4;             // 16-byte vectors of each operand in flight a thread
constexpr int kMaxBlocks = 132 * 2;   // per direction
constexpr int64_t kHeaderBytes = 4096;
constexpr uint32_t kRecords = 1u << 14;
constexpr uint32_t kReleaseAhead = 0x40000000u;
constexpr int kMaxSignals = 4;         // ready and consumed to each of two neighbours
constexpr int kMaxSlots = 64;          // K, a direction

// dtype codes shared with kernel.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

// return codes besides cudaError_t (shared with kernel.py)
constexpr int kErrEntryPoint = 90001;   // the driver's stream-memory ops are missing
constexpr int kErrTooLarge = 90002;     // a chunk larger than a slot
constexpr int kErrFailed = 90003;       // the ring has failed: see p2p_message
constexpr int kErrDriver = 100000;      // + CUresult of cuStreamWaitValue32

struct Header {
  uint32_t ready[2];       // [i]: neighbour i's blocks that stored into this rank's slots
  uint32_t consumed[2];    // [i]: neighbour i's blocks that read this rank's messages
  uint32_t abort;          // 0, or 1 + the rank that timed out
  uint32_t progress;       // blocks of this rank's hop kernels that finished
};

typedef CUresult (*StreamWaitValue32)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
StreamWaitValue32 g_wait_value = nullptr;
std::once_flag g_once;
int g_entry_rc = 0;
std::atomic<uint64_t> g_memops[2];     // stream memory operations enqueued, per op

int load_entry_points() {
  std::call_once(g_once, [] {
    cudaDriverEntryPointQueryResult q;
    void** fn = reinterpret_cast<void**>(&g_wait_value);
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuStreamWaitValue32", fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuStreamWaitValue32", fn, cudaEnableDefault, &q);
#endif
    g_entry_rc = e != cudaSuccess ? static_cast<int>(e)
                 : q == cudaDriverEntryPointSuccess ? 0 : kErrEntryPoint;
  });
  return g_entry_rc;
}

// One stream wait of a hop, kept for the watchdog's message.
struct Wait {
  uint32_t want;
  uint8_t credit;         // 0: ready, 1: consumed
  uint8_t link;           // neighbour index
};

// What one hop waits for: fixed size, written per hop.
struct HopRecord {
  uint64_t call;
  uint32_t end;           // this rank's progress once the hop's kernel is done
  uint16_t op;            // 0 reduce-scatter, 1 all-gather
  uint16_t hop;
  uint16_t n;
  Wait wait[kMaxSignals];
};

// This rank and one neighbour: messages and their blocks, each way.
struct Link {
  uint64_t sent = 0, sent_blocks = 0;      // written to the neighbour
  uint64_t recvd = 0, recvd_blocks = 0;    // read from the neighbour
  uint64_t sent_end[kMaxSlots] = {};       // sent_blocks after message m, at m % K
};

struct Ring {
  int device = 0, g = 0, rank = 0, chain = 0, slots = 0;
  int64_t slot_bytes = 0;
  double timeout_s = 0;
  char* local = nullptr;
  char* peer[2] = {nullptr, nullptr};   // [i]: neighbour i (0 right, 1 left)
  int n_opened = 0;
  char* opened[2] = {nullptr, nullptr};
  bool sys = false;                     // a neighbour's buffer is on another card
  Link links[2];                        // [i]: neighbour i
  uint64_t calls = 0;
  uint32_t blocks = 0;                  // this rank's hop blocks enqueued (cyclic)
  std::atomic<uint32_t> issued{0};      // hops enqueued
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

// The index in this rank's header of the neighbour that direction d sends
// to (d) or receives from (1 - d): at g = 2 both neighbours are index 0.
int side(const Ring& R, int i) { return R.g == 2 ? 0 : i; }

// This rank's index in neighbour i's header: its left neighbour's right.
int mirror(const Ring& R, int i) { return R.g == 2 ? 0 : 1 - i; }

int neighbour_rank(const Ring& R, int i) {
  return ((R.rank + (i == 0 ? 1 : -1)) % R.g + R.g) % R.g;
}

template <typename T>
T* slot(const Ring& R, char* base, int d, uint64_t message) {
  const int64_t k = d * R.slots + static_cast<int64_t>(message % R.slots);
  return reinterpret_cast<T*>(base + kHeaderBytes + k * R.slot_bytes);
}

CUdeviceptr dptr(const void* p) {
  return static_cast<CUdeviceptr>(reinterpret_cast<uintptr_t>(p));
}

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

int wait_geq(cudaStream_t s, const uint32_t* word, uint32_t v, int op) {
  const CUresult r = g_wait_value(reinterpret_cast<CUstream>(s), dptr(word), v,
                                  CU_STREAM_WAIT_VALUE_GEQ);
  if (r != CUDA_SUCCESS) return kErrDriver + static_cast<int>(r);
  g_memops[op].fetch_add(1, std::memory_order_relaxed);
  return 0;
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

// A release fence: what this thread did before it (and, through a block
// barrier before it, its block) is ordered before what it does after it,
// for every thread of the card (gpu) or of the system, other cards
// included (sys).  Followed by relaxed adds, it makes them release adds.
__device__ __forceinline__ void fence(bool sys) {
  if (sys)
    asm volatile("fence.acq_rel.sys;" ::: "memory");
  else
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void add_one(uint32_t* p, bool sys) {
  if (sys)
    asm volatile("red.relaxed.sys.add.u32 [%0], 1;" ::"l"(p) : "memory");
  else
    asm volatile("red.relaxed.gpu.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
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

// What every block of a hop adds one to: the neighbours' flags, then this
// rank's progress word.
struct Signals {
  uint32_t* word[kMaxSignals];
  int n;
  int sys;
  const uint32_t* abort;
  uint32_t* progress;
};

template <typename T>
struct HopArgs {
  Seg<T> seg[2];
  Signals sig;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_hop_kernel(HopArgs<T> args) {
  const Signals& sig = args.sig;
  const bool aborted = load_volatile(sig.abort) != 0;
  if (!aborted) {
    const Seg<T> sg = blockIdx.y == 0 ? args.seg[0] : args.seg[1];
    constexpr int kV = 16 / sizeof(T);
    constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kUnroll;
    const uint4* recv = reinterpret_cast<const uint4*>(sg.recv);
    const uint4* own = reinterpret_cast<const uint4*>(sg.own);
    const int64_t nv = sg.vec ? sg.n / kV : 0;
    // a tile of kUnroll vectors a thread: every load issued before the
    // first add, so that a tile costs one memory latency
    for (int64_t base = blockIdx.x * kTile; base < nv; base += gridDim.x * kTile) {
      uint4 v[kUnroll], o[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads + threadIdx.x;
        if (i < nv) {
          v[u] = recv ? __ldcg(recv + i) : own[i];
          if (recv && own) o[u] = own[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads + threadIdx.x;
        if (i >= nv) continue;
        if (recv && own) {
          T* pv = reinterpret_cast<T*>(&v[u]);
          const T* po = reinterpret_cast<const T*>(&o[u]);
#pragma unroll
          for (int j = 0; j < kV; ++j) pv[j] = add(pv[j], po[j]);
        }
        reinterpret_cast<uint4*>(sg.dst0)[i] = v[u];
        if (sg.dst1) reinterpret_cast<uint4*>(sg.dst1)[i] = v[u];
      }
    }
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
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
  // The block's stores (and loads), ordered by the barrier and one fence
  // before its adds, are done before a neighbour sees them counted.
  __syncthreads();
  if (threadIdx.x != 0) return;
  fence(sig.sys);
  if (!aborted)
    for (int k = 0; k < sig.n; ++k) add_one(sig.word[k], sig.sys);
  add_one(sig.progress, false);
}

template <typename T>
bool aligned16(const T* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A hop's blocks a direction: from the longer direction's length and the
// dtype alone, so that both ends of a message count the same blocks.
int grid_x(int64_t n, int64_t elem) {
  const int64_t vectors = (n * elem + 15) / 16;
  const int64_t tile = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t blocks = (vectors + tile - 1) / tile;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
cudaError_t launch_hop(HopArgs<T>& a, int ndir, int bx, cudaStream_t s) {
  for (int d = 0; d < ndir; ++d) {
    Seg<T>& sg = a.seg[d];
    sg.vec = aligned16(sg.recv) && aligned16(sg.own) && aligned16(sg.dst0) &&
             aligned16(sg.dst1);
  }
  ring_hop_kernel<T><<<dim3(static_cast<unsigned>(bx), ndir), kThreads, 0, s>>>(a);
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

// One call, g hops.  op 0: x (g, c) -> out (c,), this rank's reduced
// chunk; op 1: shard (c,) -> out (g, c).
template <typename T>
int ring_call(Ring& R, int op, const T* in, T* out, int64_t c, bool bidi, cudaStream_t st) {
  const int g = R.g, r = R.rank, K = R.slots;
  const Split sp = split(c, bidi);
  const int bx = grid_x(sp.len[sp.ndir - 1], sizeof(T));
  const uint32_t blocks = static_cast<uint32_t>(bx * sp.ndir);
  const uint64_t call = ++R.calls;
  Header* mine = header(R.local);
  for (int s = 0; s < g; ++s) {
    const bool first = s == 0, last = s == g - 1;
    // the neighbours this hop reads from and writes to
    bool reads[2] = {false, false}, writes[2] = {false, false};
    for (int d = 0; d < sp.ndir; ++d) {
      if (!first) reads[side(R, 1 - d)] = true;
      if (!last) writes[side(R, d)] = true;
    }
    const uint32_t idx = R.issued.load(std::memory_order_relaxed);
    HopRecord rec{call, R.blocks + blocks, static_cast<uint16_t>(op), static_cast<uint16_t>(s),
                  0, {}};
    HopArgs<T> a{};
    Signals& sig = a.sig;
    int rc = 0;
    for (int i = 0; i < 2 && !rc; ++i) {
      const Link& L = R.links[i];
      if (reads[i]) {           // this hop's message, all its blocks
        const uint32_t want = static_cast<uint32_t>(L.recvd_blocks + blocks);
        rec.wait[rec.n++] = Wait{want, 0, static_cast<uint8_t>(i)};
        rc = wait_geq(st, &mine->ready[i], want, op);
        sig.word[sig.n++] = &header(R.peer[i])->consumed[mirror(R, i)];
      }
      if (!rc && writes[i]) {   // the slot's last message, L.sent - K, read
        const uint32_t want =
            L.sent >= static_cast<uint64_t>(K) ? static_cast<uint32_t>(L.sent_end[L.sent % K]) : 0u;
        rec.wait[rec.n++] = Wait{want, 1, static_cast<uint8_t>(i)};
        rc = wait_geq(st, &mine->consumed[i], want, op);
        sig.word[sig.n++] = &header(R.peer[i])->ready[mirror(R, i)];
      }
    }
    if (rc) return rc;
    sig.sys = R.sys;
    sig.abort = &mine->abort;
    sig.progress = &mine->progress;
    for (int d = 0; d < sp.ndir; ++d) {
      Seg<T>& sg = a.seg[d];
      const int64_t lo = sp.lo[d];
      const T* recv = first ? nullptr : slot<T>(R, R.local, d, R.links[side(R, 1 - d)].recvd);
      T* next = last ? nullptr : slot<T>(R, R.peer[d], d, R.links[side(R, d)].sent);
      if (op == 0) {            // hop s combines chunk r - sign (s + 1)
        sg.own = in + wrap(r - kSign[d] * (s + 1), g) * c + lo;
        sg.recv = recv;
        sg.dst0 = last ? out + lo : next;
        sg.dst1 = nullptr;
      } else if (first) {       // own chunk into place and on to the neighbour
        sg.recv = nullptr;
        sg.own = in + lo;
        sg.dst0 = out + static_cast<int64_t>(r) * c + lo;
        sg.dst1 = next;
      } else {                  // hop s delivers chunk r - sign s
        sg.recv = recv;
        sg.own = nullptr;
        sg.dst0 = out + wrap(r - kSign[d] * s, g) * c + lo;
        sg.dst1 = next;
      }
      sg.n = sp.len[d];
    }
    rc = static_cast<int>(launch_hop(a, sp.ndir, bx, st));
    if (rc) return rc;
    for (int i = 0; i < 2; ++i) {
      Link& L = R.links[i];
      if (reads[i]) {
        ++L.recvd;
        L.recvd_blocks += blocks;
      }
      if (writes[i]) {
        L.sent_blocks += blocks;
        L.sent_end[L.sent % K] = L.sent_blocks;
        ++L.sent;
      }
    }
    R.blocks += blocks;
    R.records[idx % kRecords] = rec;
    R.issued.store(idx + 1, std::memory_order_release);
  }
  return 0;
}

// --------------------------------------------------------------- watchdog

void set_abort(Ring& R, char* base, uint32_t code) {
  cudaMemcpyAsync(&header(base)->abort, &code, sizeof(code), cudaMemcpyHostToDevice, R.aux);
}

// Write past every expected count so that the stalled waits pass.
void release_waits(Ring& R) {
  uint64_t m = 0;
  for (const Link& L : R.links) {
    m = L.sent_blocks > m ? L.sent_blocks : m;
    m = L.recvd_blocks > m ? L.recvd_blocks : m;
  }
  uint32_t flags[4];   // ready[2], consumed[2]
  for (uint32_t& f : flags) f = static_cast<uint32_t>(m) + kReleaseAhead;
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
  for (int k = 0; k < h.n && n < static_cast<int>(sizeof(R.message)); ++k) {
    const Wait& w = h.wait[k];
    n += snprintf(R.message + n, sizeof(R.message) - n,
                  " %s from rank %d: want >= %u, holds %u;", w.credit ? "credit" : "ready",
                  neighbour_rank(R, w.link), w.want,
                  w.credit ? seen.consumed[w.link] : seen.ready[w.link]);
  }
  const uint32_t code = 1u + static_cast<uint32_t>(R.rank);
  set_abort(R, R.local, code);
  for (int i = 0; i < R.n_opened; ++i) set_abort(R, R.opened[i], code);
  cudaStreamSynchronize(R.aux);
  R.failed.store(1, std::memory_order_release);
}

// Whether progress (cyclic) has reached a hop's end.
bool reached(uint32_t progress, uint32_t end) {
  return static_cast<int32_t>(progress - end) >= 0;
}

void* watchdog_main(void* arg) {
  Ring& R = *static_cast<Ring*>(arg);
  cudaSetDevice(R.device);
  uint32_t done = 0;          // hops whose kernel finished
  uint32_t seen = 0;          // the progress word at the last change
  double since = now_s();
  while (!R.stop.load(std::memory_order_acquire)) {
    usleep(5000);
    const uint32_t issued = R.issued.load(std::memory_order_acquire);
    if (issued == done && !R.failed.load(std::memory_order_acquire)) {
      since = now_s();     // nothing issued since the last poll found it all done
      continue;
    }
    uint32_t passed = 0;
    cudaMemcpyAsync(&passed, &header(R.local)->progress, sizeof(passed),
                    cudaMemcpyDeviceToHost, R.aux);
    cudaStreamSynchronize(R.aux);
    while (done != issued && reached(passed, R.records[done % kRecords].end)) ++done;
    if (done == issued) {
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
      time_out(R, done, now_s() - since);
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

int run(void* ring, int op, const void* in, void* out, int64_t c, int dtype, int bidi,
        void* stream) {
  Ring& R = *static_cast<Ring*>(ring);
  if (R.failed.load(std::memory_order_acquire)) return kErrFailed;
  if (c < 1 || dtype < kF32 || dtype > kF16) return static_cast<int>(cudaErrorInvalidValue);
  if (c * element_size(dtype) > R.slot_bytes) return kErrTooLarge;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (!e && cur != R.device) e = cudaSetDevice(R.device);
  if (e) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
  const int rc = dispatch(dtype, [&](auto t) {
    using T = decltype(t);
    return ring_call<T>(R, op, static_cast<const T*>(in), static_cast<T*>(out), c, bidi != 0, st);
  });
  if (rc) return rc;
  R.any_call = true;
  return static_cast<int>(cudaEventRecord(R.last, st));
}

}  // namespace

extern "C" {

// Allocate this rank's buffer (header + 2 directions x slots x slot_bytes)
// and start its watchdog; write the IPC handle (64 bytes).
int p2p_create(int device, int g, int rank, int chain, int64_t slot_bytes, int slots,
               double timeout_s, void** out, void* handle) {
  if (g < 2 || rank < 0 || rank >= g || slot_bytes < 1 || slots < 1 || slots > kMaxSlots ||
      timeout_s <= 0)
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
  R->slots = slots;
  R->slot_bytes = (slot_bytes + 255) / 256 * 256;
  R->timeout_s = timeout_s;
  R->records = new HopRecord[kRecords]();
  const int64_t bytes = kHeaderBytes + 2 * static_cast<int64_t>(slots) * R->slot_bytes;
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
// left (rank - 1); one peer, opened once, in a ring of two.  sys: a
// neighbour's buffer is on another card, so the hop kernels fence and
// signal at system scope (else at GPU scope).
int p2p_open(void* ring, const void* right_handle, const void* left_handle, int sys) {
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
  R.sys = sys != 0;
  return 0;
}

// x (g, c) -> out (c,): this rank's reduced chunk.  g launches.
int p2p_reduce_scatter(void* ring, const void* x, void* out, int64_t c, int dtype,
                       int bidi, void* stream) {
  return run(ring, 0, x, out, c, dtype, bidi, stream);
}

// shard (c,) -> out (g, c): every rank's chunk.  g launches.
int p2p_all_gather(void* ring, const void* shard, void* out, int64_t c, int dtype,
                   int bidi, void* stream) {
  return run(ring, 1, shard, out, c, dtype, bidi, stream);
}

// The stream memory operations this process's rings have enqueued:
// out[0] by reduce-scatters, out[1] by all-gathers.
int p2p_memops(int64_t* out) {
  for (int op = 0; op < 2; ++op)
    out[op] = static_cast<int64_t>(g_memops[op].load(std::memory_order_relaxed));
  return 0;
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
