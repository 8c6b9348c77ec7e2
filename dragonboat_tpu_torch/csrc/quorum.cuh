// Row functions and kernels of the batched quorum engine on Hopper.
//
// Counterparts: dragonboat_tpu/ops/kernels.py — _kth_largest (:79),
// _self_column (:124), vote_tally (:151), tick_step (:472), _finish_step
// (:619, with the has_hier branch :640-650 as the HIER template flag),
// read_confirm (:331) and _read_plane (:362) as read_plane (the READS
// template flag of K1 and K3), quorum_step_impl (:520),
// quorum_step_dense_impl (:686), _apply_recycle (:931),
// quorum_multiround_impl (:1021), and the R-round scans
// quorum_multistep_impl (:802) and quorum_multistep_dense_impl (:872) as
// multistep_kernel, and bench.py's _staged_multistep_fn (:131) as
// staged_kernel.
//
// Design.  Every update of the quorum engine is row-wise over groups: no
// group reads another group's row.  So every kernel here runs one thread
// per group row and holds the row's P peer columns in registers (P is a
// template parameter for 1 <= P <= 8; P == 0 is the generic form for
// 8 < P <= QS_MAX_GENERIC_P, whose columns live in local memory).  A
// launch reads each state field of the row once and writes back, whole,
// each field it may change (store_row); the K-round kernel keeps the row
// in registers across all K rounds and brings each round's inputs into
// shared memory rounds ahead (see multiround_kernel).
//
// Bound on the H100.  The work is a handful of integer compares per byte,
// so the kernels are bound by memory traffic (3.35 TB/s), not by
// operations.  Per row at P peer slots the dense step with ticks reads 14
// group scalars (44 B), 5 per-peer columns (11 B per slot) and its ack
// inputs (5 B per slot): 124 B per row at P = 5.  What it must write
// depends on the data: five flag bytes per row and the state cells that
// change, which chip_smoke.py counts against the plain version's result
// (kernel_bytes).  The K-round kernel adds 4 B per slot per round of ack
// input (160 B per row at K = 8, P = 5) and reads the state once for the
// whole block.  store_row writes whole rows, more than the cells that
// change: that is one reason a launch takes longer than its bound.  The
// READS instances add the row's read slots (S x (8 + P) B, 52 B at S = 4,
// P = 5) read and written once a launch, S x (8 + P) B of stage and echo
// input a round (832 B a row at K = 16) and the (G, S) egress (8 B a
// slot); the slots stay in registers, the echo bits packed one uint32 a
// slot, across the K rounds.
//
// The same source compiles as host C++ with QS_EMULATE defined: launches
// then run as loops over blocks and threads, which lets the arithmetic be
// exercised without a GPU.  QS_LAUNCH runs the threads one after another,
// so it checks the arithmetic and the binding but none of the concurrency
// of the card (the event launch's atomicMax races; the asynchronous copies
// of K3's ring complete at once).  QS_LAUNCH_COOP, for kernels whose
// threads meet (the telemetry fold and the device state machine), runs
// each block's threads as fibers on the calling thread, blocks one after
// another: a fiber runs until it waits at a barrier of its block
// (__syncthreads) or of its warp, and the warp intrinsics (__syncwarp,
// __ballot_sync, __shfl_sync, __shfl_xor_sync, __match_any_sync,
// __reduce_max_sync, __reduce_add_sync) are each one exchange through the
// warp's 32 slots at one wait of the warp's barrier.  Where the card would
// be undefined, the emulator fails the launch: a barrier that can never
// complete (a lane that left or skipped an intrinsic its warp runs), a
// mask that leaves out its caller, or two lanes that name each other with
// different masks.  chip_smoke.py, which holds the CUDA build against the
// plain versions on the card, is the authority on the kernels.  The CUDA
// build never defines QS_EMULATE.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef QS_EMULATE
#include <ucontext.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <type_traits>
#include <vector>
struct qs_dim3 {
  unsigned x, y, z;
};
inline thread_local qs_dim3 threadIdx, blockIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
#define cudaErrorInvalidValue 1
#define cudaErrorLaunchFailure 719
inline int atomicMax(int* a, int v) {
  int o = *a;
  if (v > o) *a = v;
  return o;
}
inline unsigned atomicMax(unsigned* a, unsigned v) {
  unsigned o = *a;
  if (v > o) *a = v;
  return o;
}
inline int atomicAdd(int* a, int v) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAdd(unsigned* a, unsigned v) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST);
}
inline int __clz(int x) { return __builtin_clz((unsigned)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <typename T>
inline T __ldcg(const T* p) {
  return *p;
}
// The error of the last emulated launch (cudaGetLastError clears it).
inline int qs_emu_error = 0;
// QS_LAUNCH_COOP: one block's threads as fibers.  A barrier completes
// when all of its threads have arrived; a fiber that arrives earlier
// yields to the next one that can run.
struct qs_coop {
  struct Bar {
    unsigned n = 0, arrived = 0, gen = 0;
  };
  struct Fiber {
    ucontext_t ctx;
    std::vector<char> stack;
    Bar* bar = nullptr;  // the barrier it waits at
    unsigned gen = 0;    // ... in this generation
    bool done = false;
  };
  // a warp: its barrier and the slots of its exchanges, two sets used in
  // turn (a lane writes the next set only once every lane has read this)
  struct Warp {
    Bar bar;
    unsigned long long val[2][32];
    unsigned mask[2][32];
  };
  ucontext_t main;
  std::vector<Fiber> fibers;
  std::vector<Warp> warps;
  Bar block;
  unsigned cur = 0;
  const std::function<void()>* body = nullptr;
};
inline thread_local qs_coop* qs_co = nullptr;
inline void qs_coop_fault() { qs_emu_error = cudaErrorLaunchFailure; }
inline void qs_coop_wait(qs_coop::Bar& b) {
  qs_coop& co = *qs_co;
  if (++b.arrived == b.n) {
    b.arrived = 0;
    ++b.gen;
    return;
  }
  qs_coop::Fiber& f = co.fibers[co.cur];
  f.bar = &b;
  f.gen = b.gen;
  swapcontext(&f.ctx, &co.main);
}
inline void qs_coop_entry() {
  (*qs_co->body)();
  qs_co->fibers[qs_co->cur].done = true;
}
inline void qs_run_coop(unsigned grid, unsigned block,
                        const std::function<void()>& body) {
  thread_local qs_coop co;
  qs_co = &co;
  co.body = &body;
  co.fibers.resize(block);
  co.warps.resize((block + 31) / 32);
  gridDim = {grid, 1, 1};
  blockDim = {block, 1, 1};
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx = {b, 0, 0};
    co.block = qs_coop::Bar();
    co.block.n = block;
    for (unsigned w = 0; w < co.warps.size(); ++w) {
      co.warps[w].bar = qs_coop::Bar();
      co.warps[w].bar.n = block - 32 * w < 32 ? block - 32 * w : 32;
    }
    for (qs_coop::Fiber& f : co.fibers) {
      f.stack.resize(1 << 16);
      f.bar = nullptr;
      f.done = false;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = &co.main;
      makecontext(&f.ctx, qs_coop_entry, 0);
    }
    for (unsigned left = block; left > 0;) {
      bool ran = false;
      for (unsigned t = 0; t < block; ++t) {
        qs_coop::Fiber& f = co.fibers[t];
        if (f.done || (f.bar != nullptr && f.bar->gen == f.gen)) continue;
        f.bar = nullptr;
        co.cur = t;
        threadIdx = {t, 0, 0};
        swapcontext(&co.main, &f.ctx);
        ran = true;
        left -= f.done;
      }
      if (!ran) {  // every fiber left waits at a barrier that cannot complete
        qs_coop_fault();
        return;
      }
    }
  }
}
#define QS_LAUNCH_COOP(kern, grid, block, stream, ...) \
  qs_run_coop(unsigned(grid), unsigned(block), [&] { kern(__VA_ARGS__); })
inline void __syncthreads() { qs_coop_wait(qs_co->block); }
// One exchange of a warp intrinsic: publish ``v`` under ``mask``, wait for
// the warp, and return the slots every lane wrote.
inline const unsigned long long* qs_exchange(unsigned mask, unsigned long long v) {
  qs_coop::Warp& w = qs_co->warps[threadIdx.x / 32];
  const unsigned lane = threadIdx.x % 32, set = w.bar.gen & 1;
  w.val[set][lane] = v;
  w.mask[set][lane] = mask;
  qs_coop_wait(w.bar);
  if (!((mask >> lane) & 1u)) qs_coop_fault();
  for (unsigned i = 0; i < 32; ++i)
    if (((mask >> i) & 1u) && w.mask[set][i] != mask) qs_coop_fault();
  return w.val[set];
}
template <typename T>
inline unsigned long long qs_bits(T v) {
  static_assert(sizeof(T) <= 8, "a warp exchange moves at most 8 bytes");
  unsigned long long b = 0;
  memcpy(&b, &v, sizeof(T));
  return b;
}
template <typename T>
inline T qs_from_bits(unsigned long long b) {
  T v;
  memcpy(&v, &b, sizeof(T));
  return v;
}
inline unsigned qs_lane_id() { return threadIdx.x % 32; }
inline void __syncwarp(unsigned mask = 0xffffffffu) { qs_exchange(mask, 0); }
inline unsigned __ballot_sync(unsigned mask, int pred) {
  const unsigned long long* l = qs_exchange(mask, pred != 0);
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i)
    if (((mask >> i) & 1u) && l[i]) r |= 1u << i;
  return r;
}
inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }
template <typename T>
inline T __shfl_sync(unsigned mask, T v, int src, int width = 32) {
  const unsigned long long* l = qs_exchange(mask, qs_bits(v));
  const unsigned base = qs_lane_id() & ~(unsigned)(width - 1);
  return qs_from_bits<T>(l[base + ((unsigned)src & (unsigned)(width - 1))]);
}
template <typename T>
inline T __shfl_xor_sync(unsigned mask, T v, int lane_mask, int width = 32) {
  const unsigned long long* l = qs_exchange(mask, qs_bits(v));
  const unsigned lane = qs_lane_id(), src = lane ^ (unsigned)lane_mask;
  const unsigned seg = ~(unsigned)(width - 1);
  return qs_from_bits<T>(l[(src & seg) == (lane & seg) ? src : lane]);
}
template <typename T>
inline unsigned __match_any_sync(unsigned mask, T v) {
  const unsigned long long b = qs_bits(v);
  const unsigned long long* l = qs_exchange(mask, b);
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i)
    if (((mask >> i) & 1u) && l[i] == b) r |= 1u << i;
  return r;
}
// the reductions run over the lanes of the caller's mask only
template <typename T, typename F>
inline T qs_reduce(unsigned mask, T v, T init, F f) {
  const unsigned long long* l = qs_exchange(mask, qs_bits(v));
  T r = init;
  for (unsigned i = 0; i < 32; ++i)
    if ((mask >> i) & 1u) r = f(r, qs_from_bits<T>(l[i]));
  return r;
}
inline int __reduce_max_sync(unsigned mask, int v) {
  return qs_reduce(mask, v, v, [](int a, int b) { return a > b ? a : b; });
}
inline unsigned __reduce_max_sync(unsigned mask, unsigned v) {
  return qs_reduce(mask, v, v, [](unsigned a, unsigned b) { return a > b ? a : b; });
}
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  return qs_reduce(mask, v, 0u, [](unsigned a, unsigned b) { return a + b; });
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = qs_emu_error;
  qs_emu_error = 0;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == 0 ? "no error"
                : "emulated launch failed: a warp or block barrier cannot "
                  "complete, or a warp intrinsic's mask is inconsistent";
}
#define QS_LAUNCH(kern, grid, block, stream, ...)                      \
  do {                                                                 \
    gridDim = {unsigned(grid), 1, 1};                                  \
    blockDim = {unsigned(block), 1, 1};                                \
    for (unsigned qs_b = 0; qs_b < unsigned(grid); ++qs_b)             \
      for (unsigned qs_t = 0; qs_t < unsigned(block); ++qs_t) {        \
        blockIdx = {qs_b, 0, 0};                                       \
        threadIdx = {qs_t, 0, 0};                                      \
        kern(__VA_ARGS__);                                             \
      }                                                                \
  } while (0)
// Dynamic shared memory: one host buffer the launch sizes.  The kernels
// that use it (K3's ring) give each thread its own column of it, so the
// threads may run one after another.
inline std::vector<uint32_t> qs_dyn_smem;
#define QS_DYN_SMEM(name) uint32_t* name = qs_dyn_smem.data()
#define QS_LAUNCH_DYN(kern, grid, block, smem, stream, ...)            \
  do {                                                                 \
    qs_dyn_smem.assign(((size_t)(smem) + 3) / 4, 0xdeadbeefu);         \
    QS_LAUNCH(kern, grid, block, stream, __VA_ARGS__);                 \
  } while (0)
// The asynchronous copy to shared memory completes at once.
inline void qs_cp_async4(void* dst, const void* src) { memcpy(dst, src, 4); }
inline void qs_cp_commit() {}
template <int N>
inline void qs_cp_wait() {}
template <typename K>
inline cudaError_t qs_set_smem(K, size_t) { return 0; }
#define QS_UNROLL
#else
#include <cuda_runtime.h>
#include <type_traits>
#define QS_LAUNCH(kern, grid, block, stream, ...) \
  kern<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#define QS_LAUNCH_COOP QS_LAUNCH
#define QS_DYN_SMEM(name) extern __shared__ __align__(16) uint32_t name[]
#define QS_LAUNCH_DYN(kern, grid, block, smem, stream, ...) \
  kern<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
// Hopper's per-thread asynchronous copy of one 4-byte word from global to
// shared memory (cp.async, through L1), its commit groups and the wait
// for all but the newest N groups; the thread's own later reads see the
// words once the wait returns.
__device__ __forceinline__ void qs_cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void qs_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void qs_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// A launch above 48 KB of dynamic shared memory must first raise the
// kernel's limit.
template <typename K>
inline cudaError_t qs_set_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
#define QS_UNROLL _Pragma("unroll")
#endif

#define QS_HD __device__ __forceinline__
// for what the host launchers compute too (K3's ring layout)
#define QS_HHD __host__ __device__ __forceinline__

namespace qs {

// Must match dragonboat_tpu_torch/ops/state.py.
constexpr int8_t CANDIDATE = 1;
constexpr int8_t LEADER = 2;
constexpr int8_t VOTE_NONE = -1;
constexpr int8_t VOTE_REJECT = 0;
constexpr int8_t VOTE_GRANT = 1;
constexpr int32_t INDEX_MIN = -2147483647 - 1;
#define QS_MAX_GENERIC_P 32
// The most pending-read slots a row may have (ops/kernels.py
// MAX_KERNEL_READ_SLOTS): S is a launch argument, the slots registers.
#define QS_MAX_READ_SLOTS 8
constexpr int BLOCK = 256;
constexpr unsigned WARP_ALL = 0xffffffffu;  // every lane of a warp

// Launch flags, one bit each (ops/kernels.py passes the same bits).
constexpr int F_DO_TICK = 1;
constexpr int F_TRACK_CONTACT = 2;
constexpr int F_HAS_VOTES = 4;
constexpr int F_HAS_CHURN = 8;
constexpr int F_HAS_HIER = 16;
constexpr int F_RESET_TELEM = 32;  // K3: a recycle zeroes telem_prev_committed
constexpr int F_HAS_READS = 64;    // K1/K3: the READS instances (read plane)
constexpr int F_RESET_READS = 128;  // K3: a recycle zeroes the row's read slots

// The quorum-, hier- and telem-plane fields of QuorumState, as raw device
// pointers.  torch.bool is one byte holding 0 or 1, the layout of C++
// bool.  The field order is the ctypes Structure's in ops/_build.py.
struct State {
  int8_t* node_state;
  int32_t* term;
  int32_t* committed;
  int32_t* last_index;
  int32_t* term_start;
  const int32_t* quorum;
  const int32_t* self_slot;
  int32_t* election_tick;
  int32_t* heartbeat_tick;
  const int32_t* rand_timeout;
  const int32_t* election_timeout;
  const int32_t* heartbeat_timeout;
  const bool* electable;
  const bool* check_quorum_on;
  bool* live;
  int32_t* match;
  int32_t* next;
  const bool* voting;
  bool* active;
  int8_t* votes;
  const bool* near;
  const int32_t* sub_quorum;
  int32_t* telem_prev_committed;
  int32_t G;
  int32_t P;
};

// The read plane's device pointers, in the ctypes Structure's order
// (ops/_build.py CReads): the state's (G, S) slots and (G, S, P) echo
// bits, one dispatch's inputs — (G, S), (G, S) and (G, S, P), with a
// leading round axis for K3 — and the (G, S) egress.  Only the slot
// pointers and S are set for a K3 launch that resets slots on recycle
// without running the plane.
struct Reads {
  int32_t* read_index;
  int32_t* read_count;
  bool* read_acks;
  const int32_t* stage_idx;
  const int32_t* stage_cnt;
  const bool* echo;
  int32_t* done_count;
  int32_t* done_index;
  int32_t S;
};

// (G,) bool outputs: StepOutputs.won / lost and TickFlags.
struct Flags {
  bool* won;
  bool* lost;
  bool* elect_due;
  bool* hb_due;
  bool* checkq_demote;
};

QS_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
QS_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
// int32 addition and subtraction that wrap like XLA's, without
// signed-overflow UB
QS_HD int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
QS_HD int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// The per-slot flags of a row are bit masks (bit i = slot i, P <= 32) and
// its votes four int8 lanes a word: as arrays of bools and bytes, indexed
// through pointers, they kept every row of every kernel in local memory
// (a stack frame of the whole row, stored to and reloaded every round).
template <int P>
struct Row {
  static constexpr int N = P > 0 ? P : QS_MAX_GENERIC_P;
  int np;  // peer slots in this launch (P, or the runtime width when P == 0)
  int32_t match[N];
  int32_t next[N];
  uint32_t voting, active;
  uint32_t votes[(N + 3) / 4];
  uint32_t near;       // loaded only by HIER instances (load_hier)
  int32_t sub_quorum;  // likewise
  int8_t node_state;
  bool live;
  int32_t term, committed, last_index, term_start, quorum, self_slot;
  int32_t election_tick, heartbeat_tick;
};

template <int P>
QS_HD int width(const Row<P>& r) {
  return P > 0 ? P : r.np;
}

QS_HD bool bit(uint32_t m, int i) { return (m >> i) & 1u; }

// All ones where ``c`` holds, else 0.  The row functions pick a column by
// a run-time slot (the self slot, the quorum's column) as an OR of masked
// columns: written as ``if (i == slot) out = a[i]`` the compiler turns the
// pick into a[slot], an indexed load that moves the whole row to local
// memory.
QS_HD int32_t ones_if(bool c) { return -(int32_t)c; }

template <int P>
QS_HD int8_t vote(const Row<P>& r, int i) {
  return (int8_t)(r.votes[i >> 2] >> (8 * (i & 3)));
}

template <int P>
QS_HD void set_vote(Row<P>& r, int i, int8_t v) {
  const int sh = 8 * (i & 3);
  r.votes[i >> 2] = (r.votes[i >> 2] & ~(0xffu << sh)) | ((uint32_t)(uint8_t)v << sh);
}

template <int P>
QS_HD void load_row(Row<P>& r, const State& s, int g) {
  r.np = P > 0 ? P : s.P;
  const int p = width(r);
  const size_t base = (size_t)g * p;
  r.voting = r.active = 0;
  QS_UNROLL
  for (int i = 0; i < (p + 3) / 4; ++i) r.votes[i] = 0;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    r.match[i] = s.match[base + i];
    r.next[i] = s.next[base + i];
    r.voting |= (uint32_t)s.voting[base + i] << i;
    r.active |= (uint32_t)s.active[base + i] << i;
    set_vote(r, i, s.votes[base + i]);
  }
  r.node_state = s.node_state[g];
  r.live = s.live[g];
  r.term = s.term[g];
  r.committed = s.committed[g];
  r.last_index = s.last_index[g];
  r.term_start = s.term_start[g];
  r.quorum = s.quorum[g];
  r.self_slot = s.self_slot[g];
  r.election_tick = s.election_tick[g];
  r.heartbeat_tick = s.heartbeat_tick[g];
}

// The hier geometry of the row (kernels.py _finish_step's has_hier
// inputs): the near-domain mask and the sub-quorum, 0 = the rule off.
template <int P>
QS_HD void load_hier(Row<P>& r, const State& s, int g) {
  const int p = width(r);
  const size_t base = (size_t)g * p;
  r.near = 0;
  QS_UNROLL
  for (int i = 0; i < p; ++i) r.near |= (uint32_t)s.near[base + i] << i;
  r.sub_quorum = s.sub_quorum[g];
}

// Writes back the fields a launch may change.  ``votes`` only when the
// launch merged votes or recycled rows; the group identity scalars only
// when it recycled rows.
template <int P, bool VOTES, bool CHURN>
QS_HD void store_row(const Row<P>& r, const State& s, int g) {
  const int p = width(r);
  const size_t base = (size_t)g * p;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    s.match[base + i] = r.match[i];
    s.next[base + i] = r.next[i];
    s.active[base + i] = bit(r.active, i);
    if (VOTES || CHURN) s.votes[base + i] = vote(r, i);
  }
  if (CHURN) {
    s.node_state[g] = r.node_state;
    s.live[g] = r.live;
    s.term[g] = r.term;
    s.term_start[g] = r.term_start;
  }
  s.committed[g] = r.committed;
  s.last_index[g] = r.last_index;
  s.election_tick[g] = r.election_tick;
  s.heartbeat_tick[g] = r.heartbeat_tick;
}

// Knuth's optimal compare-exchange networks (kernels.py _SORT_NETWORKS):
// each (i, j), i < j, leaves the larger value at i, so the columns end up
// sorted in descending order.
#define QS_CE(i, j)                    \
  {                                    \
    const int32_t hi = imax(c[i], c[j]); \
    c[j] = imin(c[i], c[j]);           \
    c[i] = hi;                         \
  }
template <int P>
QS_HD void sort_net(int32_t* c);
template <>
QS_HD void sort_net<1>(int32_t*) {}
template <>
QS_HD void sort_net<2>(int32_t* c) {
  QS_CE(0, 1)
}
template <>
QS_HD void sort_net<3>(int32_t* c) {
  QS_CE(0, 1) QS_CE(1, 2) QS_CE(0, 1)
}
template <>
QS_HD void sort_net<4>(int32_t* c) {
  QS_CE(0, 1) QS_CE(2, 3) QS_CE(0, 2) QS_CE(1, 3) QS_CE(1, 2)
}
template <>
QS_HD void sort_net<5>(int32_t* c) {
  QS_CE(0, 1) QS_CE(3, 4) QS_CE(2, 4) QS_CE(2, 3) QS_CE(1, 4) QS_CE(0, 3)
  QS_CE(0, 2) QS_CE(1, 3) QS_CE(1, 2)
}
template <>
QS_HD void sort_net<6>(int32_t* c) {
  QS_CE(1, 2) QS_CE(4, 5) QS_CE(0, 2) QS_CE(3, 5) QS_CE(0, 1) QS_CE(3, 4)
  QS_CE(2, 5) QS_CE(0, 3) QS_CE(1, 4) QS_CE(2, 4) QS_CE(1, 3) QS_CE(2, 3)
}
template <>
QS_HD void sort_net<7>(int32_t* c) {
  QS_CE(1, 2) QS_CE(3, 4) QS_CE(5, 6) QS_CE(0, 2) QS_CE(3, 5) QS_CE(4, 6)
  QS_CE(0, 1) QS_CE(4, 5) QS_CE(2, 6) QS_CE(0, 4) QS_CE(1, 5) QS_CE(0, 3)
  QS_CE(2, 5) QS_CE(1, 3) QS_CE(2, 4) QS_CE(2, 3)
}
template <>
QS_HD void sort_net<8>(int32_t* c) {
  QS_CE(0, 1) QS_CE(2, 3) QS_CE(4, 5) QS_CE(6, 7) QS_CE(0, 2) QS_CE(1, 3)
  QS_CE(4, 6) QS_CE(5, 7) QS_CE(1, 2) QS_CE(5, 6) QS_CE(0, 4) QS_CE(3, 7)
  QS_CE(1, 5) QS_CE(2, 6) QS_CE(1, 4) QS_CE(3, 6) QS_CE(2, 4) QS_CE(3, 5)
  QS_CE(3, 4)
}
#undef QS_CE

// The k-th largest (1-based) of the row's match values where ``mask``
// is set, unmasked slots counting as INDEX_MIN (kernels.py _kth_largest).
// For P <= 8 the sorting network, then the column k-1 (column 0 when k
// is out of range, as the reference's where-chain gives); for P > 8 the
// rank form: each value's descending rank counts the values that beat
// it, the slot index breaking ties, and the one of rank k-1 is taken (0
// when none is).  ``mask`` holds a bit a slot.
template <int P>
QS_HD int32_t kth_largest(const Row<P>& r, uint32_t mask, int32_t k) {
  const int32_t ksel = wadd(k, -1);
  if constexpr (P > 0) {
    int32_t c[P];
    QS_UNROLL
    for (int i = 0; i < P; ++i) c[i] = bit(mask, i) ? r.match[i] : INDEX_MIN;
    sort_net<P>(c);
    int32_t out = c[0] & ones_if(ksel < 1 || ksel >= P);
    QS_UNROLL
    for (int i = 1; i < P; ++i) out |= c[i] & ones_if(ksel == i);
    return out;
  } else {
    const int p = r.np;
    int32_t out = 0;
    for (int i = 0; i < p; ++i) {
      const int32_t vi = bit(mask, i) ? r.match[i] : INDEX_MIN;
      int32_t rank = 0;
      for (int j = 0; j < p; ++j) {
        const int32_t vj = bit(mask, j) ? r.match[j] : INDEX_MIN;
        rank += (vj > vi) || (vj == vi && j < i);
      }
      if (rank == ksel) out = wadd(out, vi);
    }
    return out;
  }
}

// match[self_slot], 0 when the slot is out of range (kernels.py
// _self_column's one-hot sum).
template <int P>
QS_HD int32_t self_column(const Row<P>& r) {
  const int p = width(r);
  int32_t out = 0;
  QS_UNROLL
  for (int i = 0; i < p; ++i) out |= r.match[i] & ones_if(i == r.self_slot);
  return out;
}

// One tick (kernels.py tick_step + check_quorum's activity clearing).
template <int P>
QS_HD void tick(Row<P>& r, const State& s, int g, bool& elect_due,
                bool& hb_due, bool& checkq_demote) {
  const bool is_leader = r.node_state == LEADER && r.live;
  int32_t et = r.live ? wadd(r.election_tick, 1) : r.election_tick;
  elect_due = r.live && !is_leader && s.electable[g] && et >= s.rand_timeout[g];
  const bool checkq_due = is_leader && et >= s.election_timeout[g];
  if (elect_due || checkq_due) et = 0;
  const bool run_checkq = checkq_due && s.check_quorum_on[g];
  checkq_demote = run_checkq;
  if (run_checkq) r.active &= ~r.voting;
  int32_t ht = is_leader ? wadd(r.heartbeat_tick, 1) : r.heartbeat_tick;
  hb_due = is_leader && ht >= s.heartbeat_timeout[g];
  if (hb_due) ht = 0;
  r.election_tick = et;
  r.heartbeat_tick = ht;
}

// The shared tail (kernels.py _finish_step): vote tally, won/lost on
// live candidates, the guarded commit, then the tick.  HIER adds the
// sub-quorum rule (has_hier, :640-650): where sub_quorum > 0 the commit
// candidate is max(classic, the sub_quorum-th largest over voting &
// near).  The reference clamps k to >= 1 everywhere and discards the
// near value where sub_quorum == 0, so computing it only where
// sub_quorum > 0 (k = sub_quorum) gives the same result.  The near pick
// runs the same network and column-0 / rank rules as the classic one.
template <int P>
QS_HD void tally(const Row<P>& r, bool& won, bool& lost) {
  const int p = width(r);
  int32_t granted = 0, rejected = 0;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    granted += bit(r.voting, i) && vote(r, i) == VOTE_GRANT;
    rejected += bit(r.voting, i) && vote(r, i) == VOTE_REJECT;
  }
  const bool is_cand = r.node_state == CANDIDATE && r.live;
  won = is_cand && granted >= r.quorum;
  lost = is_cand && rejected >= r.quorum;
}

template <int P, bool HIER>
QS_HD void commit_rule(Row<P>& r) {
  int32_t q = kth_largest(r, r.voting, r.quorum);
  if (HIER && r.sub_quorum > 0)
    q = imax(q, kth_largest(r, r.voting & r.near, r.sub_quorum));
  const bool is_leader = r.node_state == LEADER && r.live;
  if (is_leader && q > r.committed && q >= r.term_start) r.committed = q;
}

template <int P, bool DO_TICK, bool HIER>
QS_HD void finish(Row<P>& r, const State& s, int g, bool& won, bool& lost,
                  bool& elect_due, bool& hb_due, bool& checkq_demote) {
  tally(r, won, lost);
  commit_rule<P, HIER>(r);
  if (DO_TICK) {
    tick(r, s, g, elect_due, hb_due, checkq_demote);
  } else {
    elect_due = hb_due = checkq_demote = false;
  }
}

// Dense ingest of one round (kernels.py quorum_step_dense_impl): ``ack``
// and ``vote_new`` point at this row's P cells.  With SENTINEL the
// untouched cells hold -1 (quorum_multiround's encoding) and ``touched``
// is unused; without it ``touched`` says which cells carry an ack.
// ``track`` (track_contact) is a launch argument, the same for every
// thread, not a template flag: it gates one store, and as a template
// flag it doubled K1's and K3's instances (see launch.cuh).
template <int P, bool VOTES, bool SENTINEL, typename A, typename V>
QS_HD void ingest_dense(Row<P>& r, A ack, const bool* touched, V vote_new,
                        bool track) {
  const int p = width(r);
  bool contacted = false;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    const int32_t a = ack[i];
    const bool t = SENTINEL ? a >= 0 : touched[i];
    r.match[i] = imax(r.match[i], t ? a : 0);
    r.next[i] = imax(r.next[i], wadd(r.match[i], 1));
    r.active |= (uint32_t)t << i;
    contacted = contacted || t;
  }
  if (track && contacted && r.node_state != LEADER && r.live)
    r.election_tick = 0;
  r.last_index = imax(r.last_index, self_column(r));
  if (VOTES) {
    QS_UNROLL
    for (int i = 0; i < p; ++i) {
      const int8_t v = vote_new[i];
      if (vote(r, i) == VOTE_NONE && v != VOTE_NONE) set_vote(r, i, v);
    }
  }
}

// In-program leader recycle of one row (kernels.py _apply_recycle): a
// fresh same-geometry leader tenant; membership columns stay.
template <int P>
QS_HD void recycle(Row<P>& r, int32_t term, int32_t start, int32_t last) {
  const int p = width(r);
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    r.match[i] = last & ones_if(i == r.self_slot);
    r.next[i] = wadd(last, 1);
    set_vote(r, i, VOTE_NONE);
  }
  r.active = 0;
  r.node_state = LEADER;
  r.live = true;
  r.term = term;
  r.term_start = start;
  r.last_index = last;
  r.committed = 0;
  r.election_tick = 0;
  r.heartbeat_tick = 0;
}

// A row's pending-read slots in registers: the captured rel index, the
// reads the batch carries (0 = free) and its echo bits, bit j = peer
// slot j (P <= 32).  Slots at and above S stay zero.
struct ReadRow {
  int32_t index[QS_MAX_READ_SLOTS];
  int32_t count[QS_MAX_READ_SLOTS];
  uint32_t acks[QS_MAX_READ_SLOTS];
};

QS_HD uint32_t pack_bits(const bool* b, int p) {
  uint32_t m = 0;
  QS_UNROLL
  for (int j = 0; j < p; ++j) m |= (uint32_t)b[j] << j;
  return m;
}

QS_HD void clear_reads(ReadRow& rr) {
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; ++i) {
    rr.index[i] = 0;
    rr.count[i] = 0;
    rr.acks[i] = 0;
  }
}

template <int P>
QS_HD void load_reads(ReadRow& rr, const Row<P>& r, const Reads& rd, int g) {
  const int p = width(r);
  clear_reads(rr);
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; ++i) {
    if (i < rd.S) {
      const size_t at = (size_t)g * rd.S + i;
      rr.index[i] = rd.read_index[at];
      rr.count[i] = rd.read_count[at];
      rr.acks[i] = pack_bits(rd.read_acks + at * p, p);
    }
  }
}

template <int P>
QS_HD void store_reads(const ReadRow& rr, const Row<P>& r, const Reads& rd,
                       int g) {
  const int p = width(r);
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; ++i) {
    if (i < rd.S) {
      const size_t at = (size_t)g * rd.S + i;
      rd.read_index[at] = rr.index[i];
      rd.read_count[at] = rr.count[i];
      QS_UNROLL
      for (int j = 0; j < p; ++j) rd.read_acks[at * p + j] = (rr.acks[i] >> j) & 1u;
    }
  }
}

// The egress accumulators of a launch: per slot the reads released
// (summed over K3's rounds) and the largest index released at (-1 =
// none), the reference's multiround carry.
struct ReadDone {
  int32_t count[QS_MAX_READ_SLOTS];
  int32_t index[QS_MAX_READ_SLOTS];
};

QS_HD void init_done(ReadDone& d) {
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; ++i) {
    d.count[i] = 0;
    d.index[i] = -1;
  }
}

QS_HD void store_done(const ReadDone& d, const Reads& rd, int g) {
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; ++i) {
    if (i < rd.S) {
      const size_t at = (size_t)g * rd.S + i;
      rd.done_count[at] = d.count[i];
      rd.done_index[at] = d.index[i];
    }
  }
}

// One round of the read plane on a row (kernels.py _read_plane with
// read_confirm): stage, echo ingest, confirm, release.  ``stage_idx``,
// ``stage_cnt`` and ``echo`` point at this round's S slots of the row
// (echo: S x P bools).  A staged slot (stage_idx >= 0) takes the batch
// and REPLACES its acks with this round's echoes; an unstaged slot ORs
// them in.  A slot confirms where the row is a live leader, holds reads
// (count > 0) and counts a quorum of voters among its acks and the
// leader itself — the self bit only where 0 <= self_slot < P, as
// jax.nn.one_hot's all-zero row for an index out of range.  A confirmed
// slot frees (count 0, acks cleared) and keeps its index; what it
// released adds to ``done``.  The plane reads node_state, live, voting,
// self_slot and quorum, which the tail and the tick leave alone, so it
// may run after either.
template <int P, typename I, typename E>
QS_HD void read_plane(const Row<P>& r, ReadRow& rr, int S, I stage_idx,
                      I stage_cnt, E echo, ReadDone& done) {
  const int p = width(r);
  const uint32_t voting = r.voting;
  const uint32_t self_bit =
      r.self_slot >= 0 && r.self_slot < p ? 1u << r.self_slot : 0u;
  const bool is_leader = r.node_state == LEADER && r.live;
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; ++i) {
    if (i < S) {
      uint32_t e = 0;
      QS_UNROLL
      for (int j = 0; j < p; ++j) e |= (uint32_t)(echo[i * p + j] != 0) << j;
      const int32_t si = stage_idx[i];
      if (si >= 0) {
        rr.index[i] = si;
        rr.count[i] = stage_cnt[i];
        rr.acks[i] = e;
      } else {
        rr.acks[i] |= e;
      }
      const int32_t n = __popc((rr.acks[i] | self_bit) & voting);
      if (is_leader && rr.count[i] > 0 && n >= r.quorum) {
        done.count[i] = wadd(done.count[i], rr.count[i]);
        done.index[i] = imax(done.index[i], rr.index[i]);
        rr.count[i] = 0;
        rr.acks[i] = 0;
      }
    }
  }
}

QS_HD void store_flags(const Flags& f, int g, bool won, bool lost, bool e,
                       bool h, bool c) {
  f.won[g] = won;
  f.lost[g] = lost;
  f.elect_due[g] = e;
  f.hb_due[g] = h;
  f.checkq_demote[g] = c;
}

// K1: quorum_step_dense, in place; the READS instances run the read
// plane after the tail and the tick, as the reference does.
template <int P, bool DO_TICK, bool VOTES, bool HIER, bool READS>
__global__ void dense_kernel(State s, const int32_t* ack_max,
                             const bool* touched, const int8_t* vote_new,
                             bool track, Reads rd, Flags f) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= s.G) return;
  Row<P> r;
  load_row(r, s, g);
  if (HIER) load_hier(r, s, g);
  const size_t base = (size_t)g * width(r);
  ingest_dense<P, VOTES, false>(r, ack_max + base, touched + base,
                                VOTES ? vote_new + base : nullptr, track);
  bool won, lost, e, h, c;
  finish<P, DO_TICK, HIER>(r, s, g, won, lost, e, h, c);
  store_row<P, VOTES, false>(r, s, g);
  store_flags(f, g, won, lost, e, h, c);
  if (READS) {
    ReadRow rr;
    ReadDone done;
    load_reads(rr, r, rd, g);
    init_done(done);
    const size_t at = (size_t)g * rd.S;
    read_plane(r, rr, rd.S, rd.stage_idx + at, rd.stage_cnt + at,
               rd.echo + at * width(r), done);
    store_reads(rr, r, rd, g);
    store_done(done, rd, g);
  }
}

// K2, first launch: the sparse events.  Acks scatter-max into match and
// set the activity bit; any valid event marks its row contacted; votes
// merge first-wins against the value before the batch (the batch holds
// each (g, p) vote cell at most once).  Events outside [0, G) x [0, P)
// are dropped.
template <bool TRACK, bool VOTES>
__global__ void sparse_events_kernel(State s, const int32_t* ack_g,
                                     const int32_t* ack_p,
                                     const int32_t* ack_val,
                                     const bool* ack_valid, int n_acks,
                                     const int32_t* vote_g,
                                     const int32_t* vote_p,
                                     const int8_t* vote_grant,
                                     const bool* vote_valid, int n_votes,
                                     bool* contacted) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_acks && ack_valid[i]) {
    const int32_t g = ack_g[i], p = ack_p[i];
    if (g >= 0 && g < s.G) {
      if (TRACK) contacted[g] = true;
      if (p >= 0 && p < s.P) {
        const size_t cell = (size_t)g * s.P + p;
        atomicMax(&s.match[cell], ack_val[i]);
        s.active[cell] = true;
      }
    }
  }
  if (VOTES && i < n_votes && vote_valid[i]) {
    const int32_t g = vote_g[i], p = vote_p[i];
    if (g >= 0 && g < s.G && p >= 0 && p < s.P) {
      const size_t cell = (size_t)g * s.P + p;
      const int8_t old = s.votes[cell];
      s.votes[cell] = old == VOTE_NONE ? vote_grant[i] : old;
    }
  }
}

// K2, second launch: the row pass after the events — next, the contact
// reset, last_index, then the shared tail.
template <int P, bool DO_TICK, bool TRACK, bool HIER>
__global__ void sparse_rows_kernel(State s, const bool* contacted, Flags f) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= s.G) return;
  Row<P> r;
  load_row(r, s, g);
  if (HIER) load_hier(r, s, g);
  const int p = width(r);
  QS_UNROLL
  for (int i = 0; i < p; ++i) r.next[i] = imax(r.next[i], wadd(r.match[i], 1));
  if (TRACK && contacted[g] && r.node_state != LEADER && r.live)
    r.election_tick = 0;
  r.last_index = imax(r.last_index, self_column(r));
  bool won, lost, e, h, c;
  finish<P, DO_TICK, HIER>(r, s, g, won, lost, e, h, c);
  store_row<P, false, false>(r, s, g);
  store_flags(f, g, won, lost, e, h, c);
}

// K3 pre-pass: the (K, C) recycle records become a (K, G) map from row to
// record index (-1 = none; the launcher fills it first).  Rows outside
// [0, G) are padding and dropped; a round names each row at most once.
static __global__ void churn_map_kernel(const int32_t* churn_row, int n_rounds,
                                 int n_records, int G, int32_t* map) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rounds * n_records) return;
  const int32_t row = churn_row[i];
  if (row >= 0 && row < G) map[(size_t)(i / n_records) * G + row] = i % n_records;
}

// K3: quorum_multiround — K rounds of (recycle, dense ingest, tail, the
// read plane in the READS instances, masked tick) with the row held in
// registers; flags OR over the rounds, the read egress sums counts and
// takes the largest index.  Where ``commit_trace`` is given (the device
// state machine runs after this launch, csrc/kv_plane.cu) each round's
// post-tail watermark is stored to commit_trace[k * G + g].  A recycle
// keeps the hier geometry (a same-geometry tenant); with reset_telem
// (has_telem or purge_telem) it also zeroes the row's
// telem_prev_committed, which the fold after this launch then reads.  It
// drops the old tenant's pending reads: in the READS instances (whose
// reset_reads is always set) the slots in registers, before that round's
// stage; elsewhere, with reset_reads (purge_reads), the row's slots in
// memory once at the end, since no round reads them.
//
// The inputs of a round.  Each round's inputs of a row (its P ack cells,
// its churn-map entry, with votes its P vote bytes, with the read plane
// its S stage indexes and counts and S x P echo bytes) reach shared
// memory by cp.async K3_AHEAD rounds ahead of the round the thread
// computes, into a ring of K3_SLOTS round slots; so two rounds of loads
// are in flight while a round computes, where a thread used to wait out
// a full memory latency every round (three and six rounds ahead were no
// faster on the H100, and six halved the READS instance's blocks an SM).
// Each thread copies and reads only its own row, so no barrier is needed
// (a thread's wait_group covers its own copies) and the ring is
// column-major (word j of a thread's slot at j x B + t): a warp's shared
// reads hit 32 banks at every width.  A warp's copies read P strided
// words of global memory, the pattern of the loads they replace; L1
// serves them in ~4x the wavefronts of a coalesced copy, still far above
// what HBM delivers.  A byte plane is copied as the aligned words that
// cover the row's bytes (the row's offset in its first word is its
// shift); a word that would reach outside the plane, which happens only
// at the plane's two ends (G x P not a multiple of 4, or a tensor not
// word-aligned), is copied byte by byte by the thread itself.  Blocks of
// K3_BLOCK rows, with the registers capped for 6 blocks an SM (4 in the
// READS instances): rung 5's 100,000 rows (782 blocks) and rung 4's
// 65,536 (512) fit the 132 SMs in one wave.
constexpr int K3_BLOCK = 128;
constexpr int K3_AHEAD = 2;  // rounds in flight ahead of the one computed
// the ring: those, the round computed and the one before it, so a slot
// is rewritten two rounds after its last read
constexpr int K3_SLOTS = K3_AHEAD + 2;

// Words of a thread's ring slot: the ack cells, the churn record, the
// words covering the vote bytes, the stage indexes and counts, the words
// covering the echo bytes.
struct K3Layout {
  int ack, churn, votes, idx, cnt, echo, words;
};

QS_HHD int cover_words(int bytes) { return (bytes + 6) / 4; }

QS_HHD K3Layout k3_layout(int p, int S, bool votes, bool churn, bool reads) {
  K3Layout l;
  l.ack = 0;
  l.churn = p;
  l.votes = l.churn + (churn ? 1 : 0);
  l.idx = l.votes + (votes ? cover_words(p) : 0);
  l.cnt = l.idx + (reads ? S : 0);
  l.echo = l.cnt + (reads ? S : 0);
  l.words = l.echo + (reads ? cover_words(S * p) : 0);
  return l;
}

inline size_t k3_smem_bytes(const K3Layout& l, int block) {
  return (size_t)K3_SLOTS * l.words * block * 4;
}

// ``n`` int32 words from ``src`` to the column ``dst`` (stride B).
QS_HD void ring_copy_words(uint32_t* dst, int B, const int32_t* src, int n) {
  for (int j = 0; j < n; ++j) qs_cp_async4(dst + (size_t)j * B, src + j);
}

// The ``n`` bytes at ``src`` of the plane [lo, hi) as the aligned words
// that cover them; a word reaching outside the plane byte by byte.
QS_HD void ring_copy_bytes(uint32_t* dst, int B, const void* src, int n,
                           const void* lo, const void* hi) {
  const uintptr_t a = (uintptr_t)src, l = (uintptr_t)lo, h = (uintptr_t)hi;
  const uintptr_t w0 = a & ~(uintptr_t)3;
  const int nw = (int)((a - w0) + n + 3) / 4;
  for (int j = 0; j < nw; ++j) {
    const uintptr_t w = w0 + 4 * (uintptr_t)j;
    uint32_t* d = dst + (size_t)j * B;
    if (w >= l && w + 4 <= h) {
      qs_cp_async4(d, (const void*)w);
    } else {
      for (int b = 0; b < 4; ++b)
        if (w + b >= l && w + b < h)
          ((uint8_t*)d)[b] = *(const uint8_t*)(w + b);
    }
  }
}

// A thread's view of a region of its ring slot: words, and bytes at the
// shift their first global address had.
struct RingWords {
  const uint32_t* col;
  int B;
  QS_HD int32_t operator[](int i) const { return (int32_t)col[(size_t)i * B]; }
};

struct RingBytes {
  const uint32_t* col;
  int B, shift;
  QS_HD int8_t operator[](int q) const {
    const int x = q + shift;
    return (int8_t)(col[(size_t)(x >> 2) * B] >> (8 * (x & 3)));
  }
};

template <int P, bool DO_TICK, bool VOTES, bool CHURN, bool HIER, bool READS>
__global__ void __launch_bounds__(K3_BLOCK, READS ? 4 : 6)
    multiround_kernel(State s, const int32_t* ack, const int8_t* vote_new,
                      const int32_t* churn_map, const int32_t* churn_term,
                      const int32_t* churn_start, const int32_t* churn_last,
                      int n_records, const bool* tick_mask, int n_rounds,
                      int32_t* commit_trace, bool track, bool reset_telem,
                      bool reset_reads, Reads rd, Flags f) {
  QS_DYN_SMEM(ring);
  const int B = blockDim.x;
  const int g = blockIdx.x * B + threadIdx.x;
  if (g >= s.G) return;
  const int p = P > 0 ? P : s.P;
  const int S = READS ? rd.S : 0;
  const K3Layout lay = k3_layout(p, S, VOTES, CHURN, READS);
  const size_t slot_words = (size_t)lay.words * B;
  uint32_t* const col = ring + threadIdx.x;
  uint32_t* const ring_end = col + K3_SLOTS * slot_words;
  const size_t cells = (size_t)n_rounds * s.G * p;
  // the next round to copy: its index, its row-round (k * G + g) and slot
  int k_in = 0;
  size_t rg_in = g;
  uint32_t* slot_in = col;
  auto issue = [&]() {
    uint32_t* d = slot_in;
    ring_copy_words(d + (size_t)lay.ack * B, B, ack + rg_in * p, p);
    if (CHURN) ring_copy_words(d + (size_t)lay.churn * B, B, churn_map + rg_in, 1);
    if (VOTES)
      ring_copy_bytes(d + (size_t)lay.votes * B, B, vote_new + rg_in * p, p,
                      vote_new, vote_new + cells);
    if (READS) {
      ring_copy_words(d + (size_t)lay.idx * B, B, rd.stage_idx + rg_in * S, S);
      ring_copy_words(d + (size_t)lay.cnt * B, B, rd.stage_cnt + rg_in * S, S);
      ring_copy_bytes(d + (size_t)lay.echo * B, B, rd.echo + rg_in * S * p,
                      S * p, rd.echo, rd.echo + cells * S);
    }
    ++k_in;
    rg_in += s.G;
    slot_in += slot_words;
    if (slot_in == ring_end) slot_in = col;
  };
  for (int k = 0; k < K3_AHEAD; ++k) {
    if (k_in < n_rounds) issue();
    qs_cp_commit();
  }
  Row<P> r;
  load_row(r, s, g);
  if (HIER) load_hier(r, s, g);
  ReadRow rr;
  ReadDone done;
  if (READS) {
    load_reads(rr, r, rd, g);
    init_done(done);
  }
  bool won = false, lost = false, e = false, h = false, c = false;
  // Without vote input a row's tally changes only where it is recycled
  // (kernels.py quorum_multiround_impl :1106-1183 merges votes only with
  // has_votes; _apply_recycle :931 makes the row a leader with no
  // votes, whose tally gives neither flag): so it is taken once, before
  // the rounds, and counts for the rounds before the row's first recycle.
  bool won0 = false, lost0 = false;
  if (!VOTES) tally(r, won0, lost0);
  bool recycled = false;
  const uint32_t* d = col;
  size_t rg = g;
  for (int k = 0; k < n_rounds; ++k, rg += s.G) {
    if (k_in < n_rounds) issue();
    qs_cp_commit();
    qs_cp_wait<K3_AHEAD>();  // round k's copies have landed in slot d
    if (CHURN) {
      const int32_t rec = (int32_t)d[(size_t)lay.churn * B];
      if (rec >= 0) {
        const size_t at = (size_t)k * n_records + rec;
        recycle(r, churn_term[at], churn_start[at], churn_last[at]);
        if (READS) clear_reads(rr);
        recycled = true;
      }
    }
    const RingBytes votes{d + (size_t)lay.votes * B, B,
                          VOTES ? (int)((uintptr_t)(vote_new + rg * p) & 3) : 0};
    ingest_dense<P, VOTES, true>(r, RingWords{d + (size_t)lay.ack * B, B},
                                 nullptr, votes, track);
    bool w = won0 && !recycled, l = lost0 && !recycled;
    if (VOTES) tally(r, w, l);
    commit_rule<P, HIER>(r);
    if (commit_trace != nullptr) commit_trace[rg] = r.committed;
    won = won || w;
    lost = lost || l;
    if (READS) {
      const int shift = (int)((uintptr_t)(rd.echo + rg * S * p) & 3);
      const uint32_t* echo = d + (size_t)lay.echo * B;
      const RingWords idx{d + (size_t)lay.idx * B, B}, cnt{d + (size_t)lay.cnt * B, B};
      read_plane(r, rr, S, idx, cnt, RingBytes{echo, B, shift}, done);
    }
    if (DO_TICK && tick_mask[k]) {
      bool e0, h0, c0;
      tick(r, s, g, e0, h0, c0);
      e = e || e0;
      h = h || h0;
      c = c || c0;
    }
    d += slot_words;
    if (d == ring_end) d = col;
  }
  store_row<P, VOTES, CHURN>(r, s, g);
  if (CHURN && reset_telem && recycled) s.telem_prev_committed[g] = 0;
  store_flags(f, g, won, lost, e, h, c);
  if (READS) {
    store_reads(rr, r, rd, g);
    store_done(done, rd, g);
  } else if (CHURN && reset_reads && recycled) {
    clear_reads(rr);
    store_reads(rr, r, rd, g);
  }
}

// The sparse multistep's scratch holds each round's ack maxima biased to
// unsigned (v ^ 0x80000000), so that unsigned order is int32 order and a
// zero fill is INT32_MIN, the identity of max.
QS_HD uint32_t bias(int32_t v) { return (uint32_t)v ^ 0x80000000u; }
QS_HD int32_t unbias(uint32_t u) { return (int32_t)(u ^ 0x80000000u); }

// Pre-pass of the sparse multistep (quorum_multistep_impl): R rounds of
// padded events, ``cap`` acks and ``vcap`` votes a round, scatter into
// per-round planes the launcher zeroed — the biased ack max (R, G, P),
// the touched bits (R, G, P) and the contacted rows (R, G) — and the
// votes into an (R, G, P) plane the launcher filled with VOTE_NONE.  The
// sparse step's own ingest: a valid ack whose row is in [0, G) marks the
// row contacted even where its slot is out of range; events outside
// [0, G) x [0, P) are dropped; a round holds each vote cell at most once.
template <bool TRACK, bool VOTES>
__global__ void multistep_scatter_kernel(
    int G, int P, const int32_t* ack_g, const int32_t* ack_p,
    const int32_t* ack_val, const bool* ack_valid, long long n_acks, int cap,
    const int32_t* vote_g, const int32_t* vote_p, const int8_t* vote_grant,
    const bool* vote_valid, long long n_votes, int vcap, uint32_t* sc_max,
    bool* sc_touched, int8_t* sc_vote, bool* sc_contacted) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_acks && ack_valid[i]) {
    const int32_t g = ack_g[i], p = ack_p[i];
    if (g >= 0 && g < G) {
      const size_t rg = (size_t)(i / cap) * G + g;
      if (TRACK) sc_contacted[rg] = true;
      if (p >= 0 && p < P) {
        const size_t cell = rg * P + p;
        atomicMax(&sc_max[cell], bias(ack_val[i]));
        sc_touched[cell] = true;
      }
    }
  }
  if (VOTES && i < n_votes && vote_valid[i]) {
    const int32_t g = vote_g[i], p = vote_p[i];
    if (g >= 0 && g < G && p >= 0 && p < P)
      sc_vote[((size_t)(i / vcap) * G + g) * P + p] = vote_grant[i];
  }
}

// B13: R engine rounds in one launch, the row in registers across all of
// them; the state is read once and written once, the flags OR over the
// rounds.  Each round ingests, then runs the tail with its tick (finish,
// DO_TICK: every round ticks).  The ingest, per round k, from the planes
// ``touched`` and ``ack`` (R, G, P), and votes ``vote_new`` (R, G, P)
// merged first-wins.  Dense (quorum_multistep_dense_impl): match =
// max(match, touched ? ack : 0) and contact where any cell is touched.
// ``sparse`` (quorum_multistep_impl, on the pre-pass's planes): ``ack``
// is the biased scratch, an untouched cell keeps its match (the dense
// form would raise a negative one to 0) and the contact comes from
// ``contacted`` (R, G).  ``track`` (track_contact) and ``sparse`` are
// launch arguments.
template <int P, bool DO_TICK, bool VOTES, bool HIER>
__global__ void multistep_kernel(State s, const int32_t* ack,
                                 const bool* touched, const int8_t* vote_new,
                                 const bool* contacted, int n_rounds,
                                 bool track, bool sparse, Flags f) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= s.G) return;
  Row<P> r;
  load_row(r, s, g);
  if (HIER) load_hier(r, s, g);
  const int p = width(r);
  bool won = false, lost = false, e = false, h = false, c = false;
  for (int k = 0; k < n_rounds; ++k) {
    const size_t cells = ((size_t)k * s.G + g) * p;
    bool hit = false;
    QS_UNROLL
    for (int i = 0; i < p; ++i) {
      const bool t = touched[cells + i];
      int32_t a = ack[cells + i];
      if (sparse) a = unbias((uint32_t)a);
      if (t)
        r.match[i] = imax(r.match[i], a);
      else if (!sparse)
        r.match[i] = imax(r.match[i], 0);
      r.next[i] = imax(r.next[i], wadd(r.match[i], 1));
      r.active |= (uint32_t)t << i;
      hit = hit || t;
    }
    if (sparse && track) hit = contacted[(size_t)k * s.G + g];
    if (track && hit && r.node_state != LEADER && r.live) r.election_tick = 0;
    r.last_index = imax(r.last_index, self_column(r));
    if (VOTES) {
      QS_UNROLL
      for (int i = 0; i < p; ++i) {
        const int8_t v = vote_new[cells + i];
        if (vote(r, i) == VOTE_NONE && v != VOTE_NONE) set_vote(r, i, v);
      }
    }
    bool w, l, e0, h0, c0;
    finish<P, DO_TICK, HIER>(r, s, g, w, l, e0, h0, c0);
    won = won || w;
    lost = lost || l;
    e = e || e0;
    h = h || h0;
    c = c || c0;
  }
  store_row<P, VOTES, false>(r, s, g);
  store_flags(f, g, won, lost, e, h, c);
}

// B8 (bench.py _staged_multistep_fn, :131): R dense rounds whose acks the
// kernel makes itself, ticks on, no contact, no votes, no hier, the flags
// returned zeros.  Every round of every row runs whole: the ingest of
// base + 1 + k on slots 0 and 1 (int32 wrap), the commit rule on that
// round's match values, and the tick.  What the round loop does not
// change is read once, before the loop, each an exact identity of the
// reference:
// * the reference's round (quorum_step_dense_impl, kernels.py :686, with
//   _finish_step :619 and tick_step :472) writes only match, next,
//   active, votes, committed, last_index and the two clocks (the
//   st._replace lists :656-664 and :511-515); so node_state, live,
//   voting, quorum, self_slot, term_start, electable, rand_timeout,
//   election_timeout, heartbeat_timeout and check_quorum_on are loop
//   invariants, and so are is_leader (:629 / :478), the slot of the
//   self column (:124) and the column k - 1 the commit pick reads (:79);
// * bench.py passes has_votes=False (:173), so votes never change, and
//   the tally (:627-630) only feeds won/lost, which the staged dispatch
//   discards (:185): it is not computed;
// * track_contact=False (:172): no contact reset;
// * the acks (:159-164): touched = slot < 2 every round, ack base + 1 + r
//   there and 0 elsewhere, so max(match, touched ? ack : 0) is
//   max(match, base + 1 + r) on slots 0 and 1 and max(match, 0) on the
//   others, and active |= the two low bits.
// voting and active are bit masks; one row a thread, STAGED_BLOCK threads
// a block.
constexpr int STAGED_BLOCK = 128;

template <int P>
struct StagedRow {
  static constexpr int N = P > 0 ? P : QS_MAX_GENERIC_P;
  int32_t match[N], next[N];
  uint32_t voting, active;
  int32_t committed, last_index, election_tick, heartbeat_tick;
  // the invariants
  int32_t term_start, self_slot, ksel, rand_timeout, election_timeout,
      heartbeat_timeout;
  bool leader, live, can_elect, checkq_on;
};

template <int P>
QS_HD void staged_load(StagedRow<P>& r, const State& s, int g, int p) {
  const size_t base = (size_t)g * p;
  r.voting = r.active = 0;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    r.match[i] = s.match[base + i];
    r.next[i] = s.next[base + i];
    r.voting |= (uint32_t)s.voting[base + i] << i;
    r.active |= (uint32_t)s.active[base + i] << i;
  }
  r.committed = s.committed[g];
  r.last_index = s.last_index[g];
  r.election_tick = s.election_tick[g];
  r.heartbeat_tick = s.heartbeat_tick[g];
  r.term_start = s.term_start[g];
  r.self_slot = s.self_slot[g];
  r.ksel = wadd(s.quorum[g], -1);
  r.rand_timeout = s.rand_timeout[g];
  r.election_timeout = s.election_timeout[g];
  r.heartbeat_timeout = s.heartbeat_timeout[g];
  r.live = s.live[g];
  r.leader = s.node_state[g] == LEADER && r.live;
  r.can_elect = r.live && !r.leader && s.electable[g];
  r.checkq_on = s.check_quorum_on[g];
}

// One round of the staged loop on a row; ``a`` is base + 1 + k.
template <int P>
QS_HD void staged_round(StagedRow<P>& r, int p, int32_t a) {
  const uint32_t touched = p >= 2 ? 3u : 1u;
  int32_t self = 0;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    r.match[i] = imax(r.match[i], i < 2 ? a : 0);
    r.next[i] = imax(r.next[i], wadd(r.match[i], 1));
    self |= r.match[i] & ones_if(i == r.self_slot);
  }
  r.active |= touched;
  r.last_index = imax(r.last_index, self);
  // the commit rule (kth_largest over the voting slots, column ksel)
  int32_t q;
  if constexpr (P > 0) {
    int32_t c[P];
    QS_UNROLL
    for (int i = 0; i < P; ++i) c[i] = (r.voting >> i) & 1u ? r.match[i] : INDEX_MIN;
    sort_net<P>(c);
    q = c[0] & ones_if(r.ksel < 1 || r.ksel >= P);
    QS_UNROLL
    for (int i = 1; i < P; ++i) q |= c[i] & ones_if(r.ksel == i);
  } else {
    q = 0;
    for (int i = 0; i < p; ++i) {
      const int32_t vi = (r.voting >> i) & 1u ? r.match[i] : INDEX_MIN;
      int32_t rank = 0;
      for (int j = 0; j < p; ++j) {
        const int32_t vj = (r.voting >> j) & 1u ? r.match[j] : INDEX_MIN;
        rank += (vj > vi) || (vj == vi && j < i);
      }
      if (rank == r.ksel) q = wadd(q, vi);
    }
  }
  if (r.leader && q > r.committed && q >= r.term_start) r.committed = q;
  // the tick
  int32_t et = r.live ? wadd(r.election_tick, 1) : r.election_tick;
  const bool elect_due = r.can_elect && et >= r.rand_timeout;
  const bool checkq_due = r.leader && et >= r.election_timeout;
  if (elect_due || checkq_due) et = 0;
  if (checkq_due && r.checkq_on) r.active &= ~r.voting;
  int32_t ht = r.leader ? wadd(r.heartbeat_tick, 1) : r.heartbeat_tick;
  if (r.leader && ht >= r.heartbeat_timeout) ht = 0;
  r.election_tick = et;
  r.heartbeat_tick = ht;
}

template <int P>
QS_HD void staged_store(const StagedRow<P>& r, const State& s, const Flags& f,
                        int g, int p) {
  const size_t base = (size_t)g * p;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    s.match[base + i] = r.match[i];
    s.next[base + i] = r.next[i];
    s.active[base + i] = (r.active >> i) & 1u;
  }
  s.committed[g] = r.committed;
  s.last_index[g] = r.last_index;
  s.election_tick[g] = r.election_tick;
  s.heartbeat_tick[g] = r.heartbeat_tick;
  store_flags(f, g, false, false, false, false, false);
}

template <int P>
__global__ void __launch_bounds__(STAGED_BLOCK)
    staged_kernel(State s, int n_rounds, int32_t base_index, Flags f) {
  const int p = P > 0 ? P : s.P;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= s.G) return;
  StagedRow<P> r;
  staged_load(r, s, g, p);
  int32_t a = wadd(base_index, 1);
  for (int k = 0; k < n_rounds; ++k, a = wadd(a, 1)) staged_round(r, p, a);
  staged_store(r, s, f, g, p);
}

// --- host-side dispatch from runtime flags to template instances --------

template <typename F>
inline void with_p(int p, F&& f) {
  switch (p) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 7: f(std::integral_constant<int, 7>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    default: f(std::integral_constant<int, 0>{}); break;
  }
}

template <typename F>
inline void with_bool(bool b, F&& f) {
  if (b)
    f(std::true_type{});
  else
    f(std::false_type{});
}

inline int grid_for(long long n) { return (int)((n + BLOCK - 1) / BLOCK); }

}  // namespace qs
