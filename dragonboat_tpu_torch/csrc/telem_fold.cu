// B12: the device telemetry fold on Hopper, the one reduction across
// groups.
//
// Replaces dragonboat_tpu/ops/kernels.py telem_fold (:213): a 16-bucket
// log2 histogram of the live groups' commit lag, their count per raft
// state, the stalled count (live, lag > 0, committed equal to the last
// fold's watermark), the read/kv slot occupancy where asked, and the
// top-K rows by lag (dead rows at -1, ties to the lower row); then
// telem_prev_committed = committed for every row.
//
// Design.  One launch, one thread per row, blocks of 256 threads, no
// memset: the last block to finish writes the whole output.
//   * Counters.  A warp adds each counter once (__match_any_sync on the
//     counter a lane adds to, its leader adds the popcount) into shared
//     memory; the occupancy sweeps are a coalesced grid-stride count over
//     the flat (G x S) read_count and (G x E) kv_ent_index.  A block
//     stores its 24 counters to a (blocks, 24) scratch with plain stores.
//     The bucket is the exact integer min(32 - clz(lag), 15) (lag 0 ->
//     0), never a float log2.
//   * Top K by the 64-bit key (lag << 32 | (INT32_MAX - row)), larger
//     first, so a larger lag wins and a tie goes to the lower row; keys
//     are unique, so every selection takes "the largest key below the
//     last one taken".  For k <= 32 each warp takes its own top k with
//     warp reductions (no barrier), then one warp merges the block's
//     8 x k into the block's k candidates, stored to a (blocks, k)
//     scratch.  Above 32 the block takes min(k, 256) rounds of a
//     block-wide max, the tail KEY_NONE: correct for any k, not fast.
//   * The last block.  Each block fences its stores, then draws a ticket
//     (atomicAdd); the block that draws gridDim.x - 1 sums the blocks'
//     counters and merges the blocks x k candidates, reading the scratch
//     through L2 (__ldcg): each thread holds up to 16 of them in
//     registers (all of them at rung 5's 100,000 rows, k = 8), and each
//     of k rounds takes the largest below the last by a warp reduction
//     and one barrier.  It writes the output and puts the ticket back to
//     0.  The wrapper keeps one ticket a stream, so two folds never share
//     one.  (Each warp merging a share and one warp merging the warps'
//     ran 1.2 us slower on the H100: PERF.md, section 6.)
// The global top K lies within the union of the blocks' top K, so the
// merge is exact.
//
// Bound on the H100.  At 100,000 groups x 5 slots with the occupancy
// sweeps off the fold must read live, node_state, last_index, committed
// and telem_prev_committed (14 B a row) and write the watermark cells
// that change: about 1.4-1.8 MB, ~0.5 us at 3.35 TB/s.  One launch's
// fixed cost is larger than that.  count_kv adds G x 16 x 4 B of reads.
#include "quorum.cuh"

namespace qs {

constexpr int TELEM_BUCKETS = 16;
constexpr int TELEM_STATES = 5;
constexpr int TELEM_STALLED = TELEM_BUCKETS + TELEM_STATES;
constexpr int TELEM_READS = TELEM_STALLED + 1;
constexpr int TELEM_KV = TELEM_STALLED + 2;
constexpr int TELEM_HEAD = TELEM_STALLED + 3;  // ops/kernels.py TELEM_HEAD
constexpr int TELEM_BLOCK = 256;               // a power of two
constexpr int TELEM_WARPS = TELEM_BLOCK / 32;
constexpr int TELEM_WARP_K = 32;  // the widest top K of the warp path
constexpr int TELEM_CHUNK = 16;   // keys a thread holds in the last merge
constexpr int F_COUNT_READS = 1;
constexpr int F_COUNT_KV = 2;
constexpr long long KEY_NONE = -9223372036854775807LL - 1;
constexpr long long KEY_TOP = 9223372036854775807LL;

QS_HD long long topk_key(int32_t lag, int32_t row) {
  return (long long)(((unsigned long long)(uint32_t)lag << 32) |
                     (uint32_t)(0x7fffffff - row));
}
QS_HD int32_t key_lag(long long key) {
  return (int32_t)(uint32_t)((unsigned long long)key >> 32);
}
QS_HD int32_t key_row(long long key) {
  return 0x7fffffff - (int32_t)(uint32_t)((unsigned long long)key);
}

// The largest key of the warp, to every lane: the lag's word by one
// reduction, then the row's word among the lanes that hold that lag.
QS_HD long long warp_max_key(long long v) {
  const int32_t hi = key_lag(v);
  const int32_t top = __reduce_max_sync(WARP_ALL, hi);
  const unsigned lo =
      __reduce_max_sync(WARP_ALL, hi == top ? (unsigned)(uint32_t)v : 0u);
  return (long long)(((unsigned long long)(uint32_t)top << 32) | lo);
}

// The largest key of the block, to every thread; every thread calls it,
// with ``j`` counting the calls.  The warps' maxima go to one of two
// halves of ``red`` in turn, so one barrier a call: a half is rewritten
// only after every thread has passed the next call's barrier.
QS_HD long long block_max_key(long long v, long long* red, int j) {
  v = warp_max_key(v);
  long long* half = red + (j & 1) * TELEM_WARPS;
  if ((threadIdx.x & 31) == 0) half[threadIdx.x >> 5] = v;
  __syncthreads();
  QS_UNROLL
  for (int w = 0; w < TELEM_WARPS; ++w) v = half[w] > v ? half[w] : v;
  return v;
}

// The k largest (k <= 32) of the keys the warp's lanes hold in ``h``,
// largest first: lane j gets the j-th, KEY_NONE past the last.
template <int N>
QS_HD long long warp_topk(const long long (&h)[N], int k) {
  const int lane = threadIdx.x & 31;
  long long bound = KEY_TOP, mine = KEY_NONE;
  for (int j = 0; j < k; ++j) {
    long long best = KEY_NONE;
    QS_UNROLL
    for (int i = 0; i < N; ++i)
      if (h[i] < bound && h[i] > best) best = h[i];
    best = warp_max_key(best);
    if (best == KEY_NONE) break;  // the same on every lane
    if (lane == j) mine = best;
    bound = best;
  }
  return mine;
}

// One add per distinct counter a warp adds to (``at`` < 0: none).
QS_HD void warp_count(int* counts, int at) {
  const unsigned peers = __match_any_sync(WARP_ALL, at);
  if (at >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&counts[at], __popc(peers));
}

// The cells of a flat (n,) array that ``hit`` counts, over the grid.
template <typename F>
QS_HD void sweep(int* counter, long long n, F hit) {
  const long long stride = (long long)gridDim.x * TELEM_BLOCK;
  unsigned c = 0;
  for (long long i = (long long)blockIdx.x * TELEM_BLOCK + threadIdx.x; i < n;
       i += stride)
    c += hit(i);
  c = __reduce_add_sync(WARP_ALL, c);
  if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(counter, (int)c);
}

__global__ void telem_kernel(State s, const int32_t* read_count, int n_slots,
                             const int32_t* kv_ent_index, int n_ents, int k,
                             int flags, int32_t* out, long long* cand,
                             int32_t* counts, unsigned* ticket) {
  __shared__ int head[TELEM_HEAD];
  __shared__ long long red[TELEM_BLOCK];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = blockIdx.x * TELEM_BLOCK + t;
  if (t < TELEM_HEAD) head[t] = 0;
  __syncthreads();
  long long key = KEY_NONE;
  int bucket = -1, state = -1, stalled = -1;
  if (g < s.G) {
    const bool live = s.live[g];
    const int32_t committed = s.committed[g];
    const int32_t lag = live ? imax(wsub(s.last_index[g], committed), 0) : 0;
    if (live) {
      bucket = lag == 0 ? 0 : imin(32 - __clz(lag), TELEM_BUCKETS - 1);
      const int ns = s.node_state[g];
      if (ns >= 0 && ns < TELEM_STATES) state = TELEM_BUCKETS + ns;
      // the previous fold's watermark, read before this fold writes it
      if (lag > 0 && committed == s.telem_prev_committed[g])
        stalled = TELEM_STALLED;
    }
    key = topk_key(live ? lag : -1, g);
    s.telem_prev_committed[g] = committed;
  }
  warp_count(head, bucket);
  warp_count(head, state);
  warp_count(head, stalled);
  if (flags & F_COUNT_READS)
    sweep(&head[TELEM_READS], (long long)s.G * n_slots,
          [&](long long i) { return read_count[i] > 0; });
  if (flags & F_COUNT_KV)
    sweep(&head[TELEM_KV], (long long)s.G * n_ents,
          [&](long long i) { return kv_ent_index[i] >= 0; });
  // the block's top k: a block holds at most TELEM_BLOCK rows
  long long* bcand = cand + (size_t)blockIdx.x * k;
  if (k <= TELEM_WARP_K) {
    const long long own[1] = {key};
    red[t] = warp_topk(own, k);
    __syncthreads();
    if (warp == 0) {
      long long col[TELEM_WARPS];
      QS_UNROLL
      for (int w = 0; w < TELEM_WARPS; ++w) col[w] = red[w * 32 + lane];
      const long long best = warp_topk(col, k);
      if (lane < k) bcand[lane] = best;
    }
  } else {
    const int rounds = imin(k, TELEM_BLOCK);
    long long bound = KEY_TOP;
    for (int j = 0; j < rounds; ++j) {
      const long long best = block_max_key(key < bound ? key : KEY_NONE, red, j);
      if (t == 0) bcand[j] = best;
      bound = best;
    }
    for (int j = rounds + t; j < k; j += TELEM_BLOCK) bcand[j] = KEY_NONE;
  }
  __syncthreads();  // the block's counters are all in
  if (t < TELEM_HEAD) counts[(size_t)blockIdx.x * TELEM_HEAD + t] = head[t];
  // the last block to finish reads every block's scratch
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t < TELEM_HEAD) head[t] = 0;
  __syncthreads();
  // the merge's keys first, so their loads and the counters' overlap:
  // each thread holds its first TELEM_CHUNK keys in registers and reads
  // any past those from L2 every round
  const long long n = (long long)gridDim.x * k;
  long long h[TELEM_CHUNK];
  QS_UNROLL
  for (int i = 0; i < TELEM_CHUNK; ++i) {
    const long long at = (long long)i * TELEM_BLOCK + t;
    h[i] = at < n ? __ldcg(cand + at) : KEY_NONE;
  }
  // thread t < 240 sums counter t % 24 of every tenth block: coalesced
  constexpr int SPAN = TELEM_BLOCK / TELEM_HEAD * TELEM_HEAD;
  if (t < SPAN) {
    int sum = 0;
    for (long long i = t; i < (long long)gridDim.x * TELEM_HEAD; i += SPAN)
      sum += __ldcg(counts + i);
    atomicAdd(&head[t % TELEM_HEAD], sum);
  }
  // then k rounds of the block's largest key below the last one taken
  long long bound = KEY_TOP;
  for (int j = 0; j < k; ++j) {
    long long best = KEY_NONE;
    QS_UNROLL
    for (int i = 0; i < TELEM_CHUNK; ++i)
      if (h[i] < bound && h[i] > best) best = h[i];
    for (long long i = (long long)TELEM_CHUNK * TELEM_BLOCK + t; i < n; i += TELEM_BLOCK) {
      const long long c = __ldcg(cand + i);
      if (c < bound && c > best) best = c;
    }
    best = block_max_key(best, red, j);
    if (t == 0) {
      const int32_t lag = key_lag(best);
      out[TELEM_HEAD + j] = lag >= 0 ? key_row(best) : -1;
      out[TELEM_HEAD + k + j] = lag;
    }
    bound = best;
  }
  __syncthreads();
  if (t < TELEM_HEAD) out[t] = head[t];
  if (t == 0) *ticket = 0;  // the next fold on this stream starts from 0
}

}  // namespace qs

// ``k`` is the top-K width already clamped to G by the caller; ``cand``
// holds at least max(1, ceil(G / TELEM_BLOCK)) * k keys and ``counts``
// that many blocks x TELEM_HEAD counters; ``ticket`` is 0, and the fold
// leaves it 0.
extern "C" int qs_telem(const qs::State* s, const int32_t* read_count,
                        int n_slots, const int32_t* kv_ent_index, int n_ents,
                        int k, int32_t* out, long long* cand, int n_cand,
                        int32_t* counts, int n_counts, unsigned* ticket,
                        int flags, void* stream) {
  const qs::State st = *s;
  const cudaStream_t cs = (cudaStream_t)stream;
  if (k < 0 || k > st.G) return (int)cudaErrorInvalidValue;
  // G = 0 still runs one block: it writes the zero counters
  const int grid = st.G == 0 ? 1 : (st.G + qs::TELEM_BLOCK - 1) / qs::TELEM_BLOCK;
  if ((long long)grid * k > n_cand || (long long)grid * qs::TELEM_HEAD > n_counts)
    return (int)cudaErrorInvalidValue;
  QS_LAUNCH_COOP(qs::telem_kernel, grid, qs::TELEM_BLOCK, cs, st, read_count,
                 n_slots, kv_ent_index, n_ents, k, flags, out, cand, counts,
                 ticket);
  return (int)cudaGetLastError();
}
