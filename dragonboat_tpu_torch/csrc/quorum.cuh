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
// shared memory rounds ahead (see multiround_kernel); the single-round
// steps K1 and K2 stage a block's rows of every per-peer plane through
// shared memory, moved whole by bulk copies (see dense_kernel).
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
// plain versions on the card, is the authority on the kernels.  K1 and
// K2's row pass, whose threads share a block's slabs, launch the same
// way (QS_LAUNCH_COOP_DYN); their bulk copies are memcpy and their
// barrier and grid dependency waits have nothing to wait for.  The CUDA
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
// A cooperative launch with dynamic shared memory (K1's and K2's row
// slabs): the blocks run one after another, so one buffer serves them.
#define QS_LAUNCH_COOP_DYN(kern, grid, block, smem, stream, ...)       \
  do {                                                                 \
    qs_dyn_smem.assign(((size_t)(smem) + 3) / 4, 0xdeadbeefu);         \
    QS_LAUNCH_COOP(kern, grid, block, stream, __VA_ARGS__);            \
  } while (0)
// K2's row launch after its event launch (programmatic dependent launch
// on the card): the event launch has run to its end before it.
#define QS_LAUNCH_PDL QS_LAUNCH_COOP_DYN
inline void qs_grid_wait() {}
inline void qs_grid_launch_dependents() {}
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
// The asynchronous copies to shared memory complete at once; the bulk
// copies' barrier has nothing to wait for.
inline void qs_cp_async4(void* dst, const void* src) { memcpy(dst, src, 4); }
inline void qs_cp_commit() {}
template <int N>
inline void qs_cp_wait() {}
inline void qs_bar_init(uint64_t*) {}
inline void qs_bulk_load(void* dst, const void* src, unsigned n, uint64_t*) {
  memcpy(dst, src, n);
}
inline void qs_bar_expect(uint64_t*, unsigned) {}
inline void qs_bar_wait(uint64_t*) {}
inline void qs_bulk_store_fence() {}
inline void qs_bulk_store(void* dst, const void* src, unsigned n) { memcpy(dst, src, n); }
inline void qs_bulk_store_wait() {}
template <typename K>
inline cudaError_t qs_set_smem(K, size_t) { return 0; }
#define QS_UNROLL
#define QS_NO_UNROLL
#else
#include <cuda_runtime.h>
#include <type_traits>
#include <utility>
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
// The TMA unit's 1-D bulk copies: global to shared memory, completed on
// an mbarrier that counts the bytes to land (init, the copies, then one
// arrival that expects their total); and shared to global memory, in a
// bulk group its issuer waits for before the block's shared memory goes
// (the writers' generic stores made visible to the copy first).
__device__ __forceinline__ unsigned qs_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void qs_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(qs_smem(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void qs_bulk_load(void* dst, const void* src, unsigned n,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];\n" ::"r"(qs_smem(dst)),
      "l"(src), "r"(n), "r"(qs_smem(bar))
      : "memory");
}
__device__ __forceinline__ void qs_bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          qs_smem(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void qs_bar_wait(uint64_t* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(qs_smem(bar))
        : "memory");
  }
}
__device__ __forceinline__ void qs_bulk_store_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void qs_bulk_store(void* dst, const void* src, unsigned n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(qs_smem(src)), "r"(n)
               : "memory");
}
__device__ __forceinline__ void qs_bulk_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Hopper's programmatic dependent launch: the event launch lets K2's row
// launch start early, and the row launch waits for it (and its writes)
// only where it reads what the events write.
__device__ __forceinline__ void qs_grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void qs_grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// A launch above 48 KB of dynamic shared memory must first raise the
// kernel's limit.
template <typename K>
inline cudaError_t qs_set_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
#define QS_LAUNCH_COOP_DYN QS_LAUNCH_DYN
// A launch that may start while the launch before it on the stream runs
// (programmatic stream serialization); the kernel waits with qs_grid_wait.
template <typename... A, typename... B>
inline void qs_launch_pdl(void (*kern)(A...), int grid, int block, size_t smem,
                          cudaStream_t stream, B&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kern, std::forward<B>(args)...);
}
#define QS_LAUNCH_PDL(kern, grid, block, smem, stream, ...) \
  qs_launch_pdl(kern, (grid), (block), (smem), (stream), __VA_ARGS__)
#define QS_UNROLL _Pragma("unroll")
// for the block-strided copy loops: unrolled, each would first divide by
// the block size for its trip count
#define QS_NO_UNROLL _Pragma("unroll 1")
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

// The row's (G,) fields.
template <int P>
QS_HD void load_scalars(Row<P>& r, const State& s, int g) {
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
  load_scalars(r, s, g);
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
template <int P, bool CHURN>
QS_HD void store_scalars(const Row<P>& r, const State& s, int g) {
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
  store_scalars<P, CHURN>(r, s, g);
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

// The (G,) settings a tick reads: read where the tick needs them
// (TickAt), or loaded ahead into registers (TickIn: K1 and K2 issue them
// before they wait for their slabs).
struct TickAt {
  const State& s;
  int g;
  QS_HD bool electable() const { return s.electable[g]; }
  QS_HD bool check_quorum_on() const { return s.check_quorum_on[g]; }
  QS_HD int32_t rand_timeout() const { return s.rand_timeout[g]; }
  QS_HD int32_t election_timeout() const { return s.election_timeout[g]; }
  QS_HD int32_t heartbeat_timeout() const { return s.heartbeat_timeout[g]; }
};

struct TickIn {
  bool e, c;
  int32_t rt, et, ht;
  QS_HD bool electable() const { return e; }
  QS_HD bool check_quorum_on() const { return c; }
  QS_HD int32_t rand_timeout() const { return rt; }
  QS_HD int32_t election_timeout() const { return et; }
  QS_HD int32_t heartbeat_timeout() const { return ht; }
};

QS_HD TickIn load_tick(const State& s, int g) {
  return TickIn{s.electable[g], s.check_quorum_on[g], s.rand_timeout[g],
                s.election_timeout[g], s.heartbeat_timeout[g]};
}

// One tick (kernels.py tick_step + check_quorum's activity clearing).
template <int P, typename T>
QS_HD void tick(Row<P>& r, const T& in, bool& elect_due, bool& hb_due,
                bool& checkq_demote) {
  const bool is_leader = r.node_state == LEADER && r.live;
  int32_t et = r.live ? wadd(r.election_tick, 1) : r.election_tick;
  elect_due = r.live && !is_leader && in.electable() && et >= in.rand_timeout();
  const bool checkq_due = is_leader && et >= in.election_timeout();
  if (elect_due || checkq_due) et = 0;
  const bool run_checkq = checkq_due && in.check_quorum_on();
  checkq_demote = run_checkq;
  if (run_checkq) r.active &= ~r.voting;
  int32_t ht = is_leader ? wadd(r.heartbeat_tick, 1) : r.heartbeat_tick;
  hb_due = is_leader && ht >= in.heartbeat_timeout();
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

template <int P, bool DO_TICK, bool HIER, typename T>
QS_HD void finish(Row<P>& r, const T& in, bool& won, bool& lost,
                  bool& elect_due, bool& hb_due, bool& checkq_demote) {
  tally(r, won, lost);
  commit_rule<P, HIER>(r);
  if (DO_TICK) {
    tick(r, in, elect_due, hb_due, checkq_demote);
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

// --- K1 and K2: a block's rows staged through shared memory ----------
//
// K1 and K2's row pass have one round of work a row and nothing to hide
// memory latency behind, and one thread a row reading its row's P cells
// of each (G, P) plane touches a new 128-byte line every few cells (int32
// cells 4P bytes apart, bool and int8 cells P bytes apart).  So a block
// of SLAB_BLOCK rows owns the contiguous slab of every plane it reads (B
// x P cells; of the read plane's (G, S) and (G, S, P) planes, B x S and B
// x S x P) and moves it whole: into its shared memory, where each thread
// builds its Row and runs the unchanged row functions, then back, for
// the planes the launch may change, after each thread has written its
// changed fields into shared memory.  The (G,) fields and the five flag
// rows are read and written one row a thread, coalesced as they are.
//
// A slab moves in one 1-D bulk copy of the TMA unit each way (one thread
// issues it; the copy lands on an mbarrier that counts its bytes) where
// its plane is 16-byte aligned (a view with an offset need not be: the
// wrappers ask only for contiguity); what is left — the last, ragged
// block's tail, which may end mid-vector, or the whole of a misaligned
// plane — goes element by element, each thread a strided share, still
// coalesced.  On the H100 the bulk copies beat 16-byte cp.async and
// 16-byte vectors through registers, and 256 rows a block matched 128
// (PERF.md §6).  In shared memory a slab keeps its plane's
// row-major layout, each region 16-byte aligned, so a row of P int32
// cells is 16-byte aligned where P is a multiple of 4 and 8-byte aligned
// where it is even: a thread then reads and writes its row's cells as
// 16- and 8-byte vectors, which keeps a warp's accesses off each other's
// banks (scalar reads at a stride of P words would share banks 2- to
// 8-way at even P); at odd P the stride itself keeps them apart.  A row's
// P <= 8 byte cells are read as the two or three words that cover them
// (row_bytes) and written a byte a thread.
constexpr int SLAB_BLOCK = 256;
constexpr int SLAB_SMEM_MAX = 232448;  // an SM's shared memory for a block

// A plane's region: ``rows`` rows of ``row_bytes``, rounded up to 16 so
// that the next region starts on a vector; -1 where the plane is off.
QS_HHD int slab_take(int& at, bool on, int rows, int row_bytes) {
  if (!on) return -1;
  const int o = at;
  at += (rows * row_bytes + 15) & ~15;
  return o;
}

// K1's regions (byte offsets), the bulk copies' barrier last; the
// launcher lays them out and passes them (a kernel parameter: no thread
// computes them).  The read
// egress takes the stage inputs' place: each thread writes its row's
// done counts and indexes over its own stage row, which it has read.
// ``end`` is where the planes' regions end; the barrier sits 16 bytes
// past it (slab_end), out of reach of row_bytes' reads.
struct DenseSlab {
  int match, next, ack, read_index, read_count, stage_idx, stage_cnt;
  int voting, active, votes, touched, vote_new, near, read_acks, echo;
  int end, bar, bytes;
};

// After the last region: 16 bytes that a row read of the last region's
// byte cells may reach into (row_bytes reads up to 7 bytes past a row),
// then the barrier, which only mbarrier instructions touch.
template <typename L>
QS_HHD void slab_end(L& l, int at) {
  l.end = at;
  l.bar = at + 16;
  l.bytes = at + 32;
}

QS_HHD DenseSlab dense_slab(int p, int S, int rows, bool votes, bool hier, bool reads) {
  DenseSlab l;
  int at = 0;
  l.match = slab_take(at, true, rows, 4 * p);
  l.next = slab_take(at, true, rows, 4 * p);
  l.ack = slab_take(at, true, rows, 4 * p);
  l.read_index = slab_take(at, reads, rows, 4 * S);
  l.read_count = slab_take(at, reads, rows, 4 * S);
  l.stage_idx = slab_take(at, reads, rows, 4 * S);
  l.stage_cnt = slab_take(at, reads, rows, 4 * S);
  l.voting = slab_take(at, true, rows, p);
  l.active = slab_take(at, true, rows, p);
  l.votes = slab_take(at, true, rows, p);
  l.touched = slab_take(at, true, rows, p);
  l.vote_new = slab_take(at, votes, rows, p);
  l.near = slab_take(at, hier, rows, p);
  l.read_acks = slab_take(at, reads, rows, S * p);
  l.echo = slab_take(at, reads, rows, S * p);
  slab_end(l, at);
  return l;
}

// K2's row pass: the planes it reads, of which it changes next and
// active (the event launch has written match, active and votes).
struct SparseSlab {
  int match, next, voting, active, votes, near, end, bar, bytes;
};

QS_HHD SparseSlab sparse_slab(int p, int rows, bool hier) {
  SparseSlab l;
  int at = 0;
  l.match = slab_take(at, true, rows, 4 * p);
  l.next = slab_take(at, true, rows, 4 * p);
  l.voting = slab_take(at, true, rows, p);
  l.active = slab_take(at, true, rows, p);
  l.votes = slab_take(at, true, rows, p);
  l.near = slab_take(at, hier, rows, p);
  slab_end(l, at);
  return l;
}

// The rows a block stages: SLAB_BLOCK, halved while the slabs would not
// fit an SM's shared memory (wide generic rows with many read slots).
template <typename F>
inline int slab_rows(F bytes_at) {
  int rows = SLAB_BLOCK;
  while (rows > 32 && bytes_at(rows) > SLAB_SMEM_MAX) rows /= 2;
  return rows;
}

// A launch's layout and the rows a block stages (``rows``), for K1 and for
// K2's row pass: the launchers and qs_slab_layout (quorum_step.cu) call
// these and nothing else.
inline DenseSlab dense_layout(int p, int S, bool votes, bool hier, bool reads, int& rows) {
  rows = slab_rows([&](int n) { return dense_slab(p, S, n, votes, hier, reads).bytes; });
  return dense_slab(p, S, rows, votes, hier, reads);
}

inline SparseSlab sparse_layout(int p, bool hier, int& rows) {
  rows = slab_rows([&](int n) { return sparse_slab(p, n, hier).bytes; });
  return sparse_slab(p, rows, hier);
}

// One block's copies between its shared memory ``m`` and the planes: the
// bulk copies' barrier and the bytes it expects.
struct SlabCopy {
  uint8_t* m;
  uint64_t* bar;
  unsigned tx;
};

QS_HD void slab_begin(SlabCopy& c) {
  c.tx = 0;
  if (threadIdx.x == 0) qs_bar_init(c.bar);
  __syncthreads();
}

// Starts the copy of rows [g0, g0 + n) of a plane of ``row_elems`` cells
// of type T (uint8_t or uint32_t) a row into the region at ``off``.
template <typename T>
QS_HD void slab_in(SlabCopy& c, int off, const void* plane, int row_elems, int g0, int n) {
  if (off < 0) return;
  uint8_t* const dst = c.m + off;
  const uint8_t* const src = (const uint8_t*)plane + (size_t)g0 * row_elems * sizeof(T);
  const int bytes = n * row_elems * (int)sizeof(T);
  const int t = threadIdx.x, B = blockDim.x;
  int bulk = 0;  // the bytes the bulk copy moves
  if (((uintptr_t)src & 15) == 0) {
    bulk = bytes & ~15;
    if (t == 0 && bulk > 0) qs_bulk_load(dst, src, (unsigned)bulk, c.bar);
    c.tx += (unsigned)bulk;
  }
  QS_NO_UNROLL
  for (int e = bulk / (int)sizeof(T) + t; e < bytes / (int)sizeof(T); e += B)
    ((T*)dst)[e] = ((const T*)src)[e];
}

// Waits for the copies in; then any thread may read any row.
QS_HD void slab_wait(SlabCopy& c) {
  if (threadIdx.x == 0) qs_bar_expect(c.bar, c.tx);
  qs_bar_wait(c.bar);
  __syncthreads();
}

// After every thread has written its row back into shared memory.
QS_HD void slab_out_begin() {
  qs_bulk_store_fence();
  __syncthreads();
}

// The region at ``off`` back to rows [g0, g0 + n) of the plane.
template <typename T>
QS_HD void slab_out(const SlabCopy& c, int off, void* plane, int row_elems, int g0, int n) {
  if (off < 0) return;
  const uint8_t* const src = c.m + off;
  uint8_t* const dst = (uint8_t*)plane + (size_t)g0 * row_elems * sizeof(T);
  const int bytes = n * row_elems * (int)sizeof(T);
  const int t = threadIdx.x, B = blockDim.x;
  int bulk = 0;
  if (((uintptr_t)dst & 15) == 0) {
    bulk = bytes & ~15;
    if (t == 0 && bulk > 0) qs_bulk_store(dst, src, (unsigned)bulk);
  }
  QS_NO_UNROLL
  for (int e = bulk / (int)sizeof(T) + t; e < bytes / (int)sizeof(T); e += B)
    ((T*)dst)[e] = ((const T*)src)[e];
}

// The bulk stores must have read the block's shared memory before the
// block ends.
QS_HD void slab_out_end() {
  if (threadIdx.x == 0) qs_bulk_store_wait();
}

// Row ``row``'s P int32 cells of a region, as 16- or 8-byte vectors where
// the row is aligned to them (P a multiple of 4 or 2).
template <int P>
QS_HD void slab_get(int32_t* out, const uint8_t* region, int row, int p) {
  const int32_t* w = (const int32_t*)region + (size_t)row * p;
  if constexpr (P > 0 && P % 4 == 0) {
    QS_UNROLL
    for (int i = 0; i < P; i += 4) {
      const uint4 v = *(const uint4*)(w + i);
      out[i] = (int32_t)v.x;
      out[i + 1] = (int32_t)v.y;
      out[i + 2] = (int32_t)v.z;
      out[i + 3] = (int32_t)v.w;
    }
  } else if constexpr (P > 0 && P % 2 == 0) {
    QS_UNROLL
    for (int i = 0; i < P; i += 2) {
      const uint2 v = *(const uint2*)(w + i);
      out[i] = (int32_t)v.x;
      out[i + 1] = (int32_t)v.y;
    }
  } else {
    QS_UNROLL
    for (int i = 0; i < p; ++i) out[i] = w[i];
  }
}

template <int P>
QS_HD void slab_put(uint8_t* region, int row, int p, const int32_t* in) {
  int32_t* w = (int32_t*)region + (size_t)row * p;
  if constexpr (P > 0 && P % 4 == 0) {
    QS_UNROLL
    for (int i = 0; i < P; i += 4)
      *(uint4*)(w + i) = uint4{(unsigned)in[i], (unsigned)in[i + 1], (unsigned)in[i + 2],
                               (unsigned)in[i + 3]};
  } else if constexpr (P > 0 && P % 2 == 0) {
    QS_UNROLL
    for (int i = 0; i < P; i += 2) *(uint2*)(w + i) = uint2{(unsigned)in[i], (unsigned)in[i + 1]};
  } else {
    QS_UNROLL
    for (int i = 0; i < p; ++i) w[i] = in[i];
  }
}

// Row ``row``'s P <= 8 byte cells of a region as the low bytes of one
// 64-bit value (the cells above P zero), from the two or three aligned
// words that cover them: a handful of instructions where a byte at a
// time takes P loads and P inserts.  A read may reach up to 7 bytes past
// the region's last row, into the next region or the 16 bytes before the
// barrier (slab_end): the bytes read there are masked off.
template <int P>
QS_HD uint64_t row_bytes(const uint8_t* region, int row) {
  static_assert(P > 0 && P <= 8, "one 64-bit value holds 8 cells");
  const int o = row * P;
  const uint32_t* w = (const uint32_t*)region + (o >> 2);
  const int sh = 8 * (o & 3);
  uint64_t x = ((uint64_t)w[0] | ((uint64_t)w[1] << 32)) >> sh;
  if (P > 5 && sh + 8 * P > 64) x |= (uint64_t)w[2] << (64 - sh);
  return P == 8 ? x : x & ((1ull << (8 * P)) - 1);
}

// The mask of eight 0/1 bytes (bit j = byte j): the product puts byte j's
// bit at bit 56 + j, each term at its own power of two, so nothing carries.
QS_HD uint32_t byte_mask(uint64_t x) {
  return (uint32_t)((x * 0x0102040810204080ull) >> 56);
}

// ``n`` bool cells as a mask (bit j = cell j), and back.
QS_HD uint32_t get_bits(const uint8_t* b, int n) {
  uint32_t m = 0;
  QS_UNROLL
  for (int j = 0; j < n; ++j) m |= (uint32_t)(b[j] != 0) << j;
  return m;
}

QS_HD void put_bits(uint8_t* b, int n, uint32_t m) {
  QS_UNROLL
  for (int j = 0; j < n; ++j) b[j] = (m >> j) & 1u;
}

// A row's S read-slot words (index or count), as 16-byte vectors where S
// is a multiple of 4 (the row then is 16-byte aligned), and back.
QS_HD void get_slots(int32_t (&out)[QS_MAX_READ_SLOTS], const uint8_t* region, int row, int S) {
  const int32_t* w = (const int32_t*)region + (size_t)row * S;
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; i += 4) {
    if (i < S) {
      if (S % 4 == 0) {
        const uint4 v = *(const uint4*)(w + i);
        out[i] = (int32_t)v.x;
        out[i + 1] = (int32_t)v.y;
        out[i + 2] = (int32_t)v.z;
        out[i + 3] = (int32_t)v.w;
      } else {
        QS_UNROLL
        for (int j = 0; j < 4; ++j)
          if (i + j < S) out[i + j] = w[i + j];
      }
    }
  }
}

QS_HD void put_slots(uint8_t* region, int row, int S, const int32_t (&in)[QS_MAX_READ_SLOTS]) {
  int32_t* w = (int32_t*)region + (size_t)row * S;
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; i += 4) {
    if (i < S) {
      if (S % 4 == 0) {
        *(uint4*)(w + i) = uint4{(unsigned)in[i], (unsigned)in[i + 1], (unsigned)in[i + 2],
                                 (unsigned)in[i + 3]};
      } else {
        QS_UNROLL
        for (int j = 0; j < 4; ++j)
          if (i + j < S) w[i + j] = in[i + j];
      }
    }
  }
}

// The row's per-peer planes from the slab (match, next, voting, active,
// votes).
template <int P>
QS_HD void row_from_slab(Row<P>& r, const uint8_t* m, int match, int next, int voting,
                         int active, int votes, int row) {
  const int p = width(r);
  slab_get<P>(r.match, m + match, row, p);
  slab_get<P>(r.next, m + next, row, p);
  if constexpr (P > 0) {
    // the votes are four int8 lanes a word, as the cells lie in memory
    r.voting = byte_mask(row_bytes<P>(m + voting, row));
    r.active = byte_mask(row_bytes<P>(m + active, row));
    const uint64_t v = row_bytes<P>(m + votes, row);
    r.votes[0] = (uint32_t)v;
    if constexpr (P > 4) r.votes[1] = (uint32_t)(v >> 32);
  } else {
    r.voting = get_bits(m + voting + (size_t)row * p, p);
    r.active = get_bits(m + active + (size_t)row * p, p);
    for (int i = 0; i < (p + 3) / 4; ++i) r.votes[i] = 0;
    const int8_t* v = (const int8_t*)(m + votes) + (size_t)row * p;
    for (int i = 0; i < p; ++i) set_vote(r, i, v[i]);
  }
}

// A row's near mask (HIER) from the slab.
template <int P>
QS_HD uint32_t near_from_slab(const uint8_t* region, int row, int p) {
  if constexpr (P > 0) {
    return byte_mask(row_bytes<P>(region, row));
  } else {
    return get_bits(region + (size_t)row * p, p);
  }
}

// K1: quorum_step_dense, in place; the READS instances run the read
// plane after the tail and the tick, as the reference does.
template <int P, bool DO_TICK, bool VOTES, bool HIER, bool READS>
__global__ void __launch_bounds__(SLAB_BLOCK)
    dense_kernel(State s, const int32_t* ack_max, const bool* touched,
                 const int8_t* vote_new, bool track, Reads rd, Flags f, DenseSlab L) {
  QS_DYN_SMEM(smem);
  const int B = blockDim.x, t = threadIdx.x, g0 = blockIdx.x * B;
  const int n = imin(B, s.G - g0);
  const int p = P > 0 ? P : s.P;
  const int S = READS ? rd.S : 0;
  SlabCopy c{(uint8_t*)smem, (uint64_t*)((uint8_t*)smem + L.bar), 0};
  slab_begin(c);
  slab_in<uint32_t>(c, L.match, s.match, p, g0, n);
  slab_in<uint32_t>(c, L.next, s.next, p, g0, n);
  slab_in<uint32_t>(c, L.ack, ack_max, p, g0, n);
  slab_in<uint8_t>(c, L.voting, s.voting, p, g0, n);
  slab_in<uint8_t>(c, L.active, s.active, p, g0, n);
  slab_in<uint8_t>(c, L.votes, s.votes, p, g0, n);
  slab_in<uint8_t>(c, L.touched, touched, p, g0, n);
  slab_in<uint8_t>(c, L.vote_new, vote_new, p, g0, n);
  slab_in<uint8_t>(c, L.near, s.near, p, g0, n);
  if (READS) {
    slab_in<uint32_t>(c, L.read_index, rd.read_index, S, g0, n);
    slab_in<uint32_t>(c, L.read_count, rd.read_count, S, g0, n);
    slab_in<uint32_t>(c, L.stage_idx, rd.stage_idx, S, g0, n);
    slab_in<uint32_t>(c, L.stage_cnt, rd.stage_cnt, S, g0, n);
    slab_in<uint8_t>(c, L.read_acks, rd.read_acks, S * p, g0, n);
    slab_in<uint8_t>(c, L.echo, rd.echo, S * p, g0, n);
  }
  // the (G,) fields, coalesced, while the slabs come in
  const int g = g0 + t;
  Row<P> r;
  r.np = p;
  TickIn tin{};
  if (t < n) {
    load_scalars(r, s, g);
    if (HIER) r.sub_quorum = s.sub_quorum[g];
    if (DO_TICK) tin = load_tick(s, g);
  }
  slab_wait(c);
  uint8_t* const m = c.m;
  if (t < n) {
    row_from_slab(r, m, L.match, L.next, L.voting, L.active, L.votes, t);
    if (HIER) r.near = near_from_slab<P>(m + L.near, t, p);
    int32_t ack[Row<P>::N];
    slab_get<P>(ack, m + L.ack, t, p);
    ingest_dense<P, VOTES, false>(
        r, ack, (const bool*)(m + L.touched) + (size_t)t * p,
        VOTES ? (const int8_t*)(m + L.vote_new) + (size_t)t * p : nullptr, track);
    bool won, lost, e, h, cq;
    finish<P, DO_TICK, HIER>(r, tin, won, lost, e, h, cq);
    slab_put<P>(m + L.match, t, p, r.match);
    slab_put<P>(m + L.next, t, p, r.next);
    put_bits(m + L.active + (size_t)t * p, p, r.active);
    if (VOTES) {
      int8_t* v = (int8_t*)(m + L.votes) + (size_t)t * p;
      QS_UNROLL
      for (int i = 0; i < p; ++i) v[i] = vote(r, i);
    }
    store_scalars<P, false>(r, s, g);
    store_flags(f, g, won, lost, e, h, cq);
    if (READS) {
      ReadRow rr;
      ReadDone done;
      clear_reads(rr);
      get_slots(rr.index, m + L.read_index, t, S);
      get_slots(rr.count, m + L.read_count, t, S);
      const uint8_t* acks = m + L.read_acks + (size_t)t * S * p;
      QS_UNROLL
      for (int i = 0; i < QS_MAX_READ_SLOTS; ++i)
        if (i < S) rr.acks[i] = get_bits(acks + i * p, p);
      init_done(done);
      read_plane(r, rr, S, (const int32_t*)(m + L.stage_idx) + (size_t)t * S,
                 (const int32_t*)(m + L.stage_cnt) + (size_t)t * S,
                 (const bool*)(m + L.echo) + (size_t)t * S * p, done);
      put_slots(m + L.read_index, t, S, rr.index);
      put_slots(m + L.read_count, t, S, rr.count);
      uint8_t* out = m + L.read_acks + (size_t)t * S * p;
      QS_UNROLL
      for (int i = 0; i < QS_MAX_READ_SLOTS; ++i)
        if (i < S) put_bits(out + i * p, p, rr.acks[i]);
      put_slots(m + L.stage_idx, t, S, done.count);
      put_slots(m + L.stage_cnt, t, S, done.index);
    }
  }
  slab_out_begin();
  slab_out<uint32_t>(c, L.match, s.match, p, g0, n);
  slab_out<uint32_t>(c, L.next, s.next, p, g0, n);
  slab_out<uint8_t>(c, L.active, s.active, p, g0, n);
  if (VOTES) slab_out<uint8_t>(c, L.votes, s.votes, p, g0, n);
  if (READS) {
    slab_out<uint32_t>(c, L.read_index, rd.read_index, S, g0, n);
    slab_out<uint32_t>(c, L.read_count, rd.read_count, S, g0, n);
    slab_out<uint8_t>(c, L.read_acks, rd.read_acks, S * p, g0, n);
    slab_out<uint32_t>(c, L.stage_idx, rd.done_count, S, g0, n);
    slab_out<uint32_t>(c, L.stage_cnt, rd.done_index, S, g0, n);
  }
  slab_out_end();
}

// K2, first launch: the sparse events.  Acks scatter-max into match and
// set the activity bit; any valid event marks its row contacted; votes
// merge first-wins against the value before the batch (the batch holds
// each (g, p) vote cell at most once).  Events outside [0, G) x [0, P)
// are dropped.  Its blocks let the row launch start at once: that one
// waits for this one's writes before it reads what they change.
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
  qs_grid_launch_dependents();
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
// reset, last_index, then the shared tail.  It stages what the events
// never write (next, voting, near, the (G,) fields) while they may still
// run, then waits for them before it stages match, active and votes and
// reads ``contacted``.  ``contacted`` is a scratch the wrapper keeps zeroed
// (one a stream and width): the events set a row's byte, and this pass
// puts every byte it finds set back to 0, so no launch clears it first.
// The row pass changes only next and active of the planes (and the (G,)
// fields): only those go back.
template <int P, bool DO_TICK, bool TRACK, bool HIER>
__global__ void __launch_bounds__(SLAB_BLOCK)
    sparse_rows_kernel(State s, bool* contacted, Flags f, SparseSlab L) {
  QS_DYN_SMEM(smem);
  const int B = blockDim.x, t = threadIdx.x, g0 = blockIdx.x * B;
  const int n = imin(B, s.G - g0);
  const int p = P > 0 ? P : s.P;
  const int g = g0 + t;
  SlabCopy c{(uint8_t*)smem, (uint64_t*)((uint8_t*)smem + L.bar), 0};
  slab_begin(c);
  slab_in<uint32_t>(c, L.next, s.next, p, g0, n);
  slab_in<uint8_t>(c, L.voting, s.voting, p, g0, n);
  slab_in<uint8_t>(c, L.near, s.near, p, g0, n);
  Row<P> r;
  r.np = p;
  TickIn tin{};
  if (t < n) {
    load_scalars(r, s, g);
    if (HIER) r.sub_quorum = s.sub_quorum[g];
    if (DO_TICK) tin = load_tick(s, g);
  }
  qs_grid_wait();
  slab_in<uint32_t>(c, L.match, s.match, p, g0, n);
  slab_in<uint8_t>(c, L.active, s.active, p, g0, n);
  slab_in<uint8_t>(c, L.votes, s.votes, p, g0, n);
  bool hit = false;
  if (TRACK && t < n) {
    hit = contacted[g];
    if (hit) contacted[g] = false;
  }
  slab_wait(c);
  uint8_t* const m = c.m;
  if (t < n) {
    row_from_slab(r, m, L.match, L.next, L.voting, L.active, L.votes, t);
    if (HIER) r.near = near_from_slab<P>(m + L.near, t, p);
    QS_UNROLL
    for (int i = 0; i < p; ++i) r.next[i] = imax(r.next[i], wadd(r.match[i], 1));
    if (TRACK && hit && r.node_state != LEADER && r.live) r.election_tick = 0;
    r.last_index = imax(r.last_index, self_column(r));
    bool won, lost, e, h, cq;
    finish<P, DO_TICK, HIER>(r, tin, won, lost, e, h, cq);
    slab_put<P>(m + L.next, t, p, r.next);
    put_bits(m + L.active + (size_t)t * p, p, r.active);
    store_scalars<P, false>(r, s, g);
    store_flags(f, g, won, lost, e, h, cq);
  }
  slab_out_begin();
  slab_out<uint32_t>(c, L.next, s.next, p, g0, n);
  slab_out<uint8_t>(c, L.active, s.active, p, g0, n);
  slab_out_end();
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
      tick(r, TickAt{s, g}, e0, h0, c0);
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
    finish<P, DO_TICK, HIER>(r, TickAt{s, g}, w, l, e0, h0, c0);
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
