// Row functions and kernels of the batched quorum engine on Hopper.
//
// Counterparts: dragonboat_tpu/ops/kernels.py — _kth_largest (:79),
// _self_column (:124), vote_tally (:151), tick_step (:472), _finish_step
// (:619, with the has_hier branch :640-650 as the HIER template flag),
// read_confirm (:331) and _read_plane (:362) as read_plane (the READS
// template flag of K1 and K3), quorum_step_impl (:520),
// quorum_step_dense_impl (:686), _apply_recycle (:931),
// quorum_multiround_impl (:1021), and the R-round scans
// quorum_multistep_impl (:802), quorum_multistep_dense_impl (:872) and
// bench.py's _staged_multistep_fn (:131) as multistep_kernel.
//
// Design.  Every update of the quorum engine is row-wise over groups: no
// group reads another group's row.  So every kernel here runs one thread
// per group row and holds the row's P peer columns in registers (P is a
// template parameter for 1 <= P <= 8; P == 0 is the generic form for
// 8 < P <= QS_MAX_GENERIC_P, whose columns live in local memory).  A
// launch reads each state field of the row once and writes back, whole,
// each field it may change (store_row); the K-round kernel keeps the row
// in registers across all K rounds.
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
// of the card (the event launch's atomicMax races).  QS_LAUNCH_COOP, for
// kernels whose threads share memory and meet at __syncthreads (the
// telemetry fold), runs each block's threads as real host threads with a
// barrier, blocks one after another.  chip_smoke.py, which holds the CUDA
// build against the plain versions on the card, is the authority on the
// kernels.  The CUDA build never defines QS_EMULATE.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef QS_EMULATE
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>
struct qs_dim3 {
  unsigned x, y, z;
};
inline thread_local qs_dim3 threadIdx, blockIdx, blockDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
#define cudaErrorInvalidValue 1
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
inline int __clz(int x) { return __builtin_clz((unsigned)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// One block's threads meet here (QS_LAUNCH_COOP).
struct qs_barrier {
  std::mutex mu;
  std::condition_variable cv;
  unsigned n = 0, waiting = 0, gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(mu);
    const unsigned g = gen;
    if (++waiting == n) {
      waiting = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != g; });
    }
  }
};
inline qs_barrier* qs_block_barrier = nullptr;
inline void __syncthreads() { qs_block_barrier->wait(); }
#define QS_LAUNCH_COOP(kern, grid, block, stream, ...)                  \
  do {                                                                  \
    for (unsigned qs_b = 0; qs_b < unsigned(grid); ++qs_b) {            \
      qs_barrier qs_bar;                                                \
      qs_bar.n = unsigned(block);                                       \
      qs_block_barrier = &qs_bar;                                       \
      std::vector<std::thread> qs_threads;                              \
      for (unsigned qs_t = 0; qs_t < unsigned(block); ++qs_t)           \
        qs_threads.emplace_back([&, qs_b, qs_t] {                       \
          blockDim = {unsigned(block), 1, 1};                           \
          blockIdx = {qs_b, 0, 0};                                      \
          threadIdx = {qs_t, 0, 0};                                     \
          kern(__VA_ARGS__);                                            \
        });                                                             \
      for (auto& qs_th : qs_threads) qs_th.join();                      \
    }                                                                   \
  } while (0)
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
#define QS_LAUNCH(kern, grid, block, stream, ...)                      \
  do {                                                                 \
    blockDim = {unsigned(block), 1, 1};                                \
    for (unsigned qs_b = 0; qs_b < unsigned(grid); ++qs_b)             \
      for (unsigned qs_t = 0; qs_t < unsigned(block); ++qs_t) {        \
        blockIdx = {qs_b, 0, 0};                                       \
        threadIdx = {qs_t, 0, 0};                                      \
        kern(__VA_ARGS__);                                             \
      }                                                                \
  } while (0)
#define QS_UNROLL
#else
#include <cuda_runtime.h>
#include <type_traits>
#define QS_LAUNCH(kern, grid, block, stream, ...) \
  kern<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#define QS_LAUNCH_COOP QS_LAUNCH
#define QS_UNROLL _Pragma("unroll")
#endif

#define QS_HD __device__ __forceinline__

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

template <int P>
struct Row {
  static constexpr int N = P > 0 ? P : QS_MAX_GENERIC_P;
  int np;  // peer slots in this launch (P, or the runtime width when P == 0)
  int32_t match[N];
  int32_t next[N];
  bool voting[N];
  bool active[N];
  int8_t votes[N];
  bool near[N];        // loaded only by HIER instances (load_hier)
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

template <int P>
QS_HD void load_row(Row<P>& r, const State& s, int g) {
  r.np = P > 0 ? P : s.P;
  const int p = width(r);
  const size_t base = (size_t)g * p;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    r.match[i] = s.match[base + i];
    r.next[i] = s.next[base + i];
    r.voting[i] = s.voting[base + i];
    r.active[i] = s.active[base + i];
    r.votes[i] = s.votes[base + i];
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
  QS_UNROLL
  for (int i = 0; i < p; ++i) r.near[i] = s.near[base + i];
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
    s.active[base + i] = r.active[i];
    if (VOTES || CHURN) s.votes[base + i] = r.votes[i];
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
// when none is).  ``mask`` is one of the row's register arrays.
template <int P>
QS_HD int32_t kth_largest(const Row<P>& r, const bool* mask, int32_t k) {
  const int32_t ksel = wadd(k, -1);
  if constexpr (P > 0) {
    int32_t c[P];
    QS_UNROLL
    for (int i = 0; i < P; ++i) c[i] = mask[i] ? r.match[i] : INDEX_MIN;
    sort_net<P>(c);
    int32_t out = c[0];
    QS_UNROLL
    for (int i = 1; i < P; ++i)
      if (ksel == i) out = c[i];
    return out;
  } else {
    const int p = r.np;
    int32_t out = 0;
    for (int i = 0; i < p; ++i) {
      const int32_t vi = mask[i] ? r.match[i] : INDEX_MIN;
      int32_t rank = 0;
      for (int j = 0; j < p; ++j) {
        const int32_t vj = mask[j] ? r.match[j] : INDEX_MIN;
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
  for (int i = 0; i < p; ++i)
    if (i == r.self_slot) out = r.match[i];
  return out;
}

// One tick (kernels.py tick_step + check_quorum's activity clearing).
template <int P>
QS_HD void tick(Row<P>& r, const State& s, int g, bool& elect_due,
                bool& hb_due, bool& checkq_demote) {
  const int p = width(r);
  const bool is_leader = r.node_state == LEADER && r.live;
  int32_t et = r.live ? wadd(r.election_tick, 1) : r.election_tick;
  elect_due = r.live && !is_leader && s.electable[g] && et >= s.rand_timeout[g];
  const bool checkq_due = is_leader && et >= s.election_timeout[g];
  if (elect_due || checkq_due) et = 0;
  const bool run_checkq = checkq_due && s.check_quorum_on[g];
  checkq_demote = run_checkq;
  if (run_checkq) {
    QS_UNROLL
    for (int i = 0; i < p; ++i) r.active[i] = r.active[i] && !r.voting[i];
  }
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
template <int P, bool DO_TICK, bool HIER>
QS_HD void finish(Row<P>& r, const State& s, int g, bool& won, bool& lost,
                  bool& elect_due, bool& hb_due, bool& checkq_demote) {
  const int p = width(r);
  int32_t granted = 0, rejected = 0;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    granted += r.voting[i] && r.votes[i] == VOTE_GRANT;
    rejected += r.voting[i] && r.votes[i] == VOTE_REJECT;
  }
  const bool is_cand = r.node_state == CANDIDATE && r.live;
  won = is_cand && granted >= r.quorum;
  lost = is_cand && rejected >= r.quorum;
  int32_t q = kth_largest(r, r.voting, r.quorum);
  if (HIER && r.sub_quorum > 0) {
    bool near_voting[Row<P>::N];
    QS_UNROLL
    for (int i = 0; i < p; ++i) near_voting[i] = r.voting[i] && r.near[i];
    q = imax(q, kth_largest(r, near_voting, r.sub_quorum));
  }
  const bool is_leader = r.node_state == LEADER && r.live;
  if (is_leader && q > r.committed && q >= r.term_start) r.committed = q;
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
template <int P, bool VOTES, bool SENTINEL>
QS_HD void ingest_dense(Row<P>& r, const int32_t* ack, const bool* touched,
                        const int8_t* vote_new, bool track) {
  const int p = width(r);
  bool contacted = false;
  QS_UNROLL
  for (int i = 0; i < p; ++i) {
    const int32_t a = ack[i];
    const bool t = SENTINEL ? a >= 0 : touched[i];
    r.match[i] = imax(r.match[i], t ? a : 0);
    r.next[i] = imax(r.next[i], wadd(r.match[i], 1));
    r.active[i] = r.active[i] || t;
    contacted = contacted || t;
  }
  if (track && contacted && r.node_state != LEADER && r.live)
    r.election_tick = 0;
  r.last_index = imax(r.last_index, self_column(r));
  if (VOTES) {
    QS_UNROLL
    for (int i = 0; i < p; ++i) {
      const int8_t v = vote_new[i];
      if (r.votes[i] == VOTE_NONE && v != VOTE_NONE) r.votes[i] = v;
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
    r.match[i] = i == r.self_slot ? last : 0;
    r.next[i] = wadd(last, 1);
    r.active[i] = false;
    r.votes[i] = VOTE_NONE;
  }
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
template <int P>
QS_HD void read_plane(const Row<P>& r, ReadRow& rr, int S,
                      const int32_t* stage_idx, const int32_t* stage_cnt,
                      const bool* echo, ReadDone& done) {
  const int p = width(r);
  uint32_t voting = 0;
  QS_UNROLL
  for (int j = 0; j < p; ++j) voting |= (uint32_t)r.voting[j] << j;
  const uint32_t self_bit =
      r.self_slot >= 0 && r.self_slot < p ? 1u << r.self_slot : 0u;
  const bool is_leader = r.node_state == LEADER && r.live;
  QS_UNROLL
  for (int i = 0; i < QS_MAX_READ_SLOTS; ++i) {
    if (i < S) {
      const uint32_t e = pack_bits(echo + (size_t)i * p, p);
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
// post-tail watermark is stored to commit_trace[k * G + g].  A recycle keeps the hier geometry (a
// same-geometry tenant); with reset_telem (has_telem or purge_telem) it
// also zeroes the row's telem_prev_committed, which the fold after this
// launch then reads.  It drops the old tenant's pending reads: in the
// READS instances (whose reset_reads is always set) the slots in
// registers, before that round's stage; elsewhere, with reset_reads
// (purge_reads), the row's slots in memory once at the end, since no
// round reads them.
template <int P, bool DO_TICK, bool VOTES, bool CHURN, bool HIER, bool READS>
__global__ void multiround_kernel(State s, const int32_t* ack,
                                  const int8_t* vote_new,
                                  const int32_t* churn_map,
                                  const int32_t* churn_term,
                                  const int32_t* churn_start,
                                  const int32_t* churn_last, int n_records,
                                  const bool* tick_mask, int n_rounds,
                                  int32_t* commit_trace, bool track,
                                  bool reset_telem, bool reset_reads, Reads rd,
                                  Flags f) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= s.G) return;
  Row<P> r;
  load_row(r, s, g);
  if (HIER) load_hier(r, s, g);
  const int p = width(r);
  ReadRow rr;
  ReadDone done;
  if (READS) {
    load_reads(rr, r, rd, g);
    init_done(done);
  }
  bool won = false, lost = false, e = false, h = false, c = false;
  bool recycled = false;
  for (int k = 0; k < n_rounds; ++k) {
    const size_t cells = ((size_t)k * s.G + g) * p;
    if (CHURN) {
      const int32_t rec = churn_map[(size_t)k * s.G + g];
      if (rec >= 0) {
        const size_t at = (size_t)k * n_records + rec;
        recycle(r, churn_term[at], churn_start[at], churn_last[at]);
        if (READS) clear_reads(rr);
        recycled = true;
      }
    }
    ingest_dense<P, VOTES, true>(r, ack + cells, nullptr,
                                 VOTES ? vote_new + cells : nullptr, track);
    bool w, l, e0, h0, c0;
    finish<P, false, HIER>(r, s, g, w, l, e0, h0, c0);
    if (commit_trace != nullptr) commit_trace[(size_t)k * s.G + g] = r.committed;
    won = won || w;
    lost = lost || l;
    if (READS) {
      const size_t at = ((size_t)k * s.G + g) * rd.S;
      read_plane(r, rr, rd.S, rd.stage_idx + at, rd.stage_cnt + at,
                 rd.echo + at * p, done);
    }
    if (DO_TICK && tick_mask[k]) {
      tick(r, s, g, e0, h0, c0);
      e = e || e0;
      h = h || h0;
      c = c || c0;
    }
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

// B13 and B8: R engine rounds in one launch, the row in registers across
// all of them; the state is read once and written once, the flags OR over
// the rounds.  Each round ingests, then runs the tail with its tick
// (finish, DO_TICK: every round ticks).  The ingest, per round k:
// * planes (STAGED false): ``touched`` and ``ack`` (R, G, P), and votes
//   ``vote_new`` (R, G, P) merged first-wins.  Dense (quorum_multistep_
//   dense_impl): match = max(match, touched ? ack : 0) and contact where
//   any cell is touched.  ``sparse`` (quorum_multistep_impl, on the
//   pre-pass's planes): ``ack`` is the biased scratch, an untouched cell
//   keeps its match (the dense form would raise a negative one to 0) and
//   the contact comes from ``contacted`` (R, G);
// * STAGED (bench.py _staged_multistep_fn): no input; slots 0 and 1 are
//   touched with base_index + 1 + k, the dense form, the flags returned
//   are zeros as the reference returns.
// ``track`` (track_contact) and ``sparse`` are launch arguments.
template <int P, bool DO_TICK, bool VOTES, bool HIER, bool STAGED>
__global__ void multistep_kernel(State s, const int32_t* ack,
                                 const bool* touched, const int8_t* vote_new,
                                 const bool* contacted, int n_rounds,
                                 int32_t base_index, bool track, bool sparse,
                                 Flags f) {
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
      bool t;
      int32_t a;
      if (STAGED) {
        t = i < 2;
        a = t ? wadd(wadd(base_index, 1), k) : 0;
      } else {
        t = touched[cells + i];
        a = ack[cells + i];
        if (sparse) a = unbias((uint32_t)a);
      }
      if (t)
        r.match[i] = imax(r.match[i], a);
      else if (!sparse)
        r.match[i] = imax(r.match[i], 0);
      r.next[i] = imax(r.next[i], wadd(r.match[i], 1));
      r.active[i] = r.active[i] || t;
      hit = hit || t;
    }
    if (!STAGED && sparse && track) hit = contacted[(size_t)k * s.G + g];
    if (track && hit && r.node_state != LEADER && r.live) r.election_tick = 0;
    r.last_index = imax(r.last_index, self_column(r));
    if (VOTES) {
      QS_UNROLL
      for (int i = 0; i < p; ++i) {
        const int8_t v = vote_new[cells + i];
        if (r.votes[i] == VOTE_NONE && v != VOTE_NONE) r.votes[i] = v;
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
  if (STAGED)
    store_flags(f, g, false, false, false, false, false);
  else
    store_flags(f, g, won, lost, e, h, c);
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
