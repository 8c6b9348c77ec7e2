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
// Design.  Two launches after a cudaMemsetAsync of the (24 + 2K,) int32
// output block, all on the caller's stream:
//   1. one thread per row.  The counters go to shared memory with
//      atomicAdd, then one global atomicAdd per counter and block:
//      integer sums are exact in any order.  The bucket is the exact
//      integer min(32 - clz(lag), 15) (lag 0 -> 0), never a float log2.
//      Each block then picks its own top K by the 64-bit key
//      (lag << 32 | (INT32_MAX - row)), larger first, so a larger lag
//      wins and a tie goes to the lower row: K rounds of a shared-memory
//      max reduction, each taking the largest key below the last one
//      taken (keys are unique), into a (blocks, K) scratch buffer.
//   2. one block merges the blocks' candidates the same way, K rounds of
//      "largest key below the last", and writes topk_row / topk_lag.
// The global top K lies within the union of the blocks' top K, so the
// merge is exact.
//
// Bound on the H100.  At 100,000 groups x 5 slots with the occupancy
// sweeps off the fold must read live, node_state, last_index, committed
// and telem_prev_committed (14 B a row) and write the watermark cells
// that change: about 1.4-1.8 MB, ~0.5 us at 3.35 TB/s.  The two launches'
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

// The largest ``v`` over the block; every thread calls it.
QS_HD long long block_max(long long v, long long* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = TELEM_BLOCK / 2; s > 0; s >>= 1) {
    if (t < s && red[t + s] > red[t]) red[t] = red[t + s];
    __syncthreads();
  }
  const long long out = red[0];
  __syncthreads();  // red is rewritten by the next call
  return out;
}

__global__ void telem_rows_kernel(State s, const int32_t* read_count,
                                  int n_slots, const int32_t* kv_ent_index,
                                  int n_ents, int k, int flags, int32_t* out,
                                  long long* cand) {
  __shared__ int counts[TELEM_HEAD];
  __shared__ long long red[TELEM_BLOCK];
  const int t = threadIdx.x;
  const int g = blockIdx.x * TELEM_BLOCK + t;
  if (t < TELEM_HEAD) counts[t] = 0;
  __syncthreads();
  long long key = KEY_NONE;
  if (g < s.G) {
    const bool live = s.live[g];
    const int32_t committed = s.committed[g];
    const int32_t lag = live ? imax(wsub(s.last_index[g], committed), 0) : 0;
    if (live) {
      const int bucket =
          lag == 0 ? 0 : imin(32 - __clz(lag), TELEM_BUCKETS - 1);
      atomicAdd(&counts[bucket], 1);
      const int ns = s.node_state[g];
      if (ns >= 0 && ns < TELEM_STATES)
        atomicAdd(&counts[TELEM_BUCKETS + ns], 1);
      // the previous fold's watermark, read before this fold writes it
      if (lag > 0 && committed == s.telem_prev_committed[g])
        atomicAdd(&counts[TELEM_STALLED], 1);
    }
    if (flags & F_COUNT_READS) {
      int n = 0;
      for (int i = 0; i < n_slots; ++i)
        n += read_count[(size_t)g * n_slots + i] > 0;
      if (n) atomicAdd(&counts[TELEM_READS], n);
    }
    if (flags & F_COUNT_KV) {
      int n = 0;
      for (int i = 0; i < n_ents; ++i)
        n += kv_ent_index[(size_t)g * n_ents + i] >= 0;
      if (n) atomicAdd(&counts[TELEM_KV], n);
    }
    key = topk_key(live ? lag : -1, g);
    s.telem_prev_committed[g] = committed;
  }
  __syncthreads();
  if (t < TELEM_HEAD && counts[t] != 0) atomicAdd(&out[t], counts[t]);
  // a block holds at most TELEM_BLOCK rows: later rounds find none
  const int rounds = imin(k, TELEM_BLOCK);
  long long bound = KEY_TOP;
  for (int j = 0; j < rounds; ++j) {
    const long long best = block_max(key < bound ? key : KEY_NONE, red);
    if (t == 0) cand[(size_t)blockIdx.x * k + j] = best;
    bound = best;
  }
  for (int j = rounds + t; j < k; j += TELEM_BLOCK)
    cand[(size_t)blockIdx.x * k + j] = KEY_NONE;
}

__global__ void telem_topk_kernel(const long long* cand, int n_cand, int k,
                                  int32_t* out) {
  __shared__ long long red[TELEM_BLOCK];
  const int t = threadIdx.x;
  long long bound = KEY_TOP;
  for (int j = 0; j < k; ++j) {
    long long v = KEY_NONE;
    for (int i = t; i < n_cand; i += TELEM_BLOCK) {
      const long long c = cand[i];
      if (c < bound && c > v) v = c;
    }
    const long long best = block_max(v, red);
    if (t == 0) {
      const int32_t lag = key_lag(best);
      out[TELEM_HEAD + j] = lag >= 0 ? key_row(best) : -1;
      out[TELEM_HEAD + k + j] = lag;
    }
    bound = best;
  }
}

}  // namespace qs

// ``k`` is the top-K width already clamped to G by the caller; ``cand``
// holds at least ceil(G / TELEM_BLOCK) * k keys.
extern "C" int qs_telem(const qs::State* s, const int32_t* read_count,
                        int n_slots, const int32_t* kv_ent_index, int n_ents,
                        int k, int32_t* out, long long* cand, int n_cand,
                        int flags, void* stream) {
  const qs::State st = *s;
  const cudaStream_t cs = (cudaStream_t)stream;
  if (k < 0 || k > st.G) return (int)cudaErrorInvalidValue;
  const int grid = (st.G + qs::TELEM_BLOCK - 1) / qs::TELEM_BLOCK;
  if ((long long)grid * k > n_cand) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * (size_t)(qs::TELEM_HEAD + 2 * k), cs);
  if (e != cudaSuccess || grid == 0) return (int)e;
  QS_LAUNCH_COOP(qs::telem_rows_kernel, grid, qs::TELEM_BLOCK, cs, st,
                 read_count, n_slots, kv_ent_index, n_ents, k, flags, out,
                 cand);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess || k == 0) return (int)e1;
  QS_LAUNCH_COOP(qs::telem_topk_kernel, 1, qs::TELEM_BLOCK, cs, cand,
                 grid * k, k, out);
  return (int)cudaGetLastError();
}
