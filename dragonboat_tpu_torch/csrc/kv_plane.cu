// The device state machine (devsm) on Hopper: stage -> apply -> read.
//
// Replaces dragonboat_tpu/ops/kernels.py _kv_plane (:402) in the has_kv
// branches of quorum_step_dense_impl (:765-777) and
// quorum_multiround_impl (:1184-1193, the carry from (0, -1, 0) at
// :1213-1219), with _apply_recycle's reset_kv (:974-992).
//
// Design.  The reference runs the plane inside the step's jit program,
// after the tail.  Here it is a kernel of its own, launched after K1 or
// K3 on the same stream: K3's READS instances already hold 128
// registers, and a row's entry buffer (E x index, key, value) would not
// fit beside them, while a template flag would double K1's and K3's
// instances again.  The split is exact because the plane reads one field
// of the step, the row's committed watermark after each round's tail
// (after that round's recycle, which zeroes it), and writes only the kv
// fields, which no other part of a round reads; the tick leaves
// committed alone and the fold runs after this kernel.  So:
//
// * after K1 the kernel runs one round at the state's committed
//   (``commits`` is the state's own (G,) watermark);
// * after K3, which stores each round's post-tail watermark into a
//   (K, G) trace, it runs the block's K rounds per row on the trace; a
//   row that K3's (K, G) churn map recycles at round k is reset before
//   round k's stage (KV_RESET), as _apply_recycle runs before the
//   round's plane;
// * the purge alone (purge_kv on a kv-free block) resets every row that
//   the churn map names in any round: nothing reads the kv fields in
//   between, so once at the end is exact.
//
// A segment of lanes per row.  Each row gets L lanes of a warp, L the
// power of two at or above max(E, R) (at most 32), so a warp holds 32 / L
// rows.  Lane i of a segment keeps entry slot i (index, key, value) and,
// for i < R, read slot i's capture in registers across the launch's
// rounds, so every load of the entry buffer and of the round's (G, E) and
// (G, R) planes is contiguous across the lanes, and is made a round
// ahead.  A round is a handful of warp operations: a ballot of the
// ready entries (their popcount is the row's applied count); where the
// warp has one, the ready lanes with a key in [0, V) tag themselves
// (segment, key), every other lane takes a tag of its own, and
// __match_any_sync names each lane's peers.  Each lane then walks its
// peers in slot order by shuffles, as many steps as the warp's largest
// group (one or two at the main path's widths), keeping the largest
// index, the unsigned sum of the values at it (it wraps like the
// reference's int32 sum) and its first slot, which writes the key.  The
// walk uses the full warp at every step: __reduce_*_sync over each
// lane's own peers mask (a labeled partition) is legal, but the card
// runs the partitions one after another, which made a round cost as much
// as the old kernel's O(E^2) search (PERF.md, section 6).  The value row stays
// in device memory: each winner writes its cell, and after a __syncwarp,
// which orders the warp's writes before its reads, the read lanes gather
// theirs.
// Bit-exact rules of the reference: a key outside [0, V) (jax.nn.one_hot's
// all-zero row) is a ready entry that counts as applied and frees its
// slot but writes nothing, and a read of such a key captures 0; the value
// of a key is the int32 sum (wrapping) of its ready entries at the
// largest index; any negative stage index or read key means none; K3's
// carry keeps a round's capture where its index is >= 0.
//
// Bound on the H100: memory.  Per row it reads the kv state once
// (V + 3E ints, 256 B at V = E = 16), its inputs ((3E + R) ints a round,
// 208 B; 3.3 KB a row at K = 16), the watermark of each round and, with
// resets, the churn map; it writes the kv cells that change and the
// (G, R) x 2 + (G,) egress.  A round is ~100 SASS instructions a warp
// without an apply and ~300 with one (two rows at E = 16), so the kernel
// sits between the two limits: on random buffers at 65,536 x K = 16 it
// takes 2.3x its byte bound, and ~1.5x with no apply at all, 48
// registers giving 40 warps an SM.  A shared-memory ring by cp.async,
// deeper register prefetch, running 64-bit offsets and register caps for
// 6 or 8 blocks an SM were each slower on the H100 (PERF.md, section 6).
#include "quorum.cuh"

#define QS_MAX_KV_ENTS 32
#define QS_MAX_KV_READS 8
#define QS_MAX_KV_SLOTS 1024

namespace qs {

// The device state machine's pointers, in the ctypes Structure's order
// (ops/_build.py CKv): the state's (G, V) values and (G, E) entry buffer;
// one launch's (K, G, E) stage planes and (K, G, R) read keys; the (K, G)
// watermark of each round; K3's (K, G) churn map (row -> record, -1 =
// none) or null; the (G, R) x 2 and (G,) egress; the widths.
struct Kv {
  int32_t* value;
  int32_t* ent_index;
  int32_t* ent_key;
  int32_t* ent_val;
  const int32_t* in_idx;
  const int32_t* in_key;
  const int32_t* in_val;
  const int32_t* read_key;
  const int32_t* commits;
  const int32_t* churn_map;
  int32_t* read_val;
  int32_t* read_idx;
  int32_t* applied;
  int32_t G, V, E, R, K;
};

// Launch flags (ops/kernels.py passes the same bits).
constexpr int KV_PLANE = 1;  // stage, apply and read (else the purge alone)
constexpr int KV_CARRY = 2;  // K3's carry of the captures (else one round)
constexpr int KV_RESET = 4;  // a row the churn map names is reset

// A lane's place: its row's segment of 2^shift lanes.
struct KvLane {
  int g;          // the row
  int i;          // the lane within the segment: entry slot and read slot
  int lane;       // the lane within the warp
  unsigned seg;   // the segment's lanes, as ballot bits
  bool row;       // g < G; a lane past the last row takes part idly
};

QS_HD KvLane kv_lane(int G, int shift) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  KvLane l;
  l.lane = threadIdx.x & 31;
  l.row = (t >> shift) < G;
  l.g = l.row ? (int)(t >> shift) : 0;
  l.i = (int)(t & ((1 << shift) - 1));
  const unsigned width = shift == 5 ? WARP_ALL : (1u << (1 << shift)) - 1;
  l.seg = width << (l.lane & ~((1 << shift) - 1));
  return l;
}

// Whether the whole warp of this thread lies past the last row: such a
// warp leaves at once, every lane together.
QS_HD bool kv_warp_idle(int G, int shift) {
  const long long t = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31u);
  return (t >> shift) >= G;
}

// One round's inputs of a lane: the row's watermark and churn cell (the
// same address across the segment), its entry slot's stage and its read
// slot's key.
struct KvIn {
  int32_t c, churn, idx, key, val, rk;
};

QS_HD KvIn kv_in(const Kv& kv, int k, const KvLane& l, bool ent, bool rd,
                 bool reset) {
  KvIn in{-1, -1, -1, 0, 0, -1};
  const size_t cell = (size_t)k * kv.G + l.g;
  if (l.row) {
    in.c = kv.commits[cell];
    if (reset) in.churn = kv.churn_map[cell];
  }
  if (ent) {
    const size_t at = cell * kv.E + l.i;
    in.idx = kv.in_idx[at];
    in.key = kv.in_key[at];
    in.val = kv.in_val[at];
  }
  if (rd) in.rk = kv.read_key[cell * kv.R + l.i];
  return in;
}

// purge_kv on a block that runs no plane: reset every recycled row.  The
// segment's lanes test the K churn cells a stride of L apart, then clear
// their entry slots and the value row a stride of L apart.
__global__ void kv_purge_kernel(Kv kv, int shift) {
  if (kv_warp_idle(kv.G, shift)) return;
  const KvLane l = kv_lane(kv.G, shift);
  const int L = 1 << shift;
  bool hit = false;
  for (int k = l.i; l.row && k < kv.K; k += L)
    hit = hit || kv.churn_map[(size_t)k * kv.G + l.g] >= 0;
  if (!(__ballot_sync(WARP_ALL, hit) & l.seg) || !l.row) return;
  for (int j = l.i; j < kv.V; j += L) kv.value[(size_t)l.g * kv.V + j] = 0;
  if (l.i < kv.E) {
    const size_t at = (size_t)l.g * kv.E + l.i;
    kv.ent_index[at] = -1;
    kv.ent_key[at] = 0;
    kv.ent_val[at] = 0;
  }
}

__global__ void kv_plane_kernel(Kv kv, int shift, bool carry, bool reset) {
  if (kv_warp_idle(kv.G, shift)) return;
  const KvLane l = kv_lane(kv.G, shift);
  const int L = 1 << shift, V = kv.V;
  const bool ent = l.row && l.i < kv.E;
  const bool rd = l.row && l.i < kv.R;
  const size_t slot = (size_t)l.g * kv.E + l.i;
  int32_t idx = -1, key = 0, val = 0;
  if (ent) {
    idx = kv.ent_index[slot];
    key = kv.ent_key[slot];
    val = kv.ent_val[slot];
  }
  bool staged = false, freed = false;  // what to store back
  int32_t rv = 0, ri = -1;
  uint32_t applied = 0;
  int32_t* vrow = kv.value + (size_t)l.g * V;
  // a tag no other lane takes: the lane's own, for a lane that writes no key
  const unsigned alone = 0x80000000u | (unsigned)l.lane;
  // the round's inputs are loaded a round ahead
  KvIn next = kv_in(kv, 0, l, ent, rd, reset);
  for (int k = 0; k < kv.K; ++k) {
    const KvIn in = next;
    if (k + 1 < kv.K) next = kv_in(kv, k + 1, l, ent, rd, reset);
    if (reset) {  // the fresh tenant: empty, before the round's stage
      const bool hit = l.row && in.churn >= 0;
      if (__any_sync(WARP_ALL, hit)) {
        __syncwarp();  // the last round's reads of the row come first
        if (hit) {
          idx = -1;
          key = 0;
          val = 0;
          staged = true;
          for (int j = l.i; j < V; j += L) vrow[j] = 0;
        }
        __syncwarp();
      }
    }
    // stage: a non-negative index overwrites its buffer slot
    if (ent && in.idx >= 0) {
      idx = in.idx;
      key = in.key;
      val = in.val;
      staged = true;
    }
    // apply every buffered entry at or below the round's watermark
    const bool ready = ent && idx >= 0 && idx <= in.c;
    const unsigned ready_bits = __ballot_sync(WARP_ALL, ready);
    applied += __popc(ready_bits & l.seg);
    if (ready_bits != 0) {
      __syncwarp();  // the last round's reads come before this round's writes
      // per key the ready entries at its largest index win, summed; the
      // first of them (the lowest slot) writes the key
      const bool writes = ready && key >= 0 && key < V;
      const unsigned tag =
          writes ? ((unsigned)(l.lane >> shift) << 10) | (unsigned)key : alone;
      const unsigned peers = __match_any_sync(WARP_ALL, tag);
      // one step a peer, in slot order, each a shuffle from that peer:
      // as many steps as the warp's largest group, every lane in each
      int32_t top = -1;
      unsigned sum = 0;
      int first = l.lane;
      unsigned rest = peers;
      const unsigned steps = __reduce_max_sync(WARP_ALL, (unsigned)__popc(peers));
      for (unsigned n = 0; n < steps; ++n) {
        const bool take = rest != 0;
        const int src = take ? __ffs(rest) - 1 : l.lane;
        rest &= rest - 1;
        const int32_t pi = __shfl_sync(WARP_ALL, idx, src);
        const unsigned pv = __shfl_sync(WARP_ALL, (unsigned)val, src);
        if (take && pi > top) {
          top = pi;
          sum = pv;
          first = src;
        } else if (take && pi == top) {
          sum += pv;
        }
      }
      if (writes && l.lane == first) vrow[key] = (int32_t)sum;
      if (ready) {
        idx = -1;  // applied slots free
        freed = true;
      }
      __syncwarp();  // the winners' writes come before the reads
    }
    // reads: the post-apply value and the watermark it reflects
    if (rd) {
      const int32_t v = in.rk >= 0 && in.rk < V ? vrow[in.rk] : 0;
      const int32_t at_idx = in.rk >= 0 ? in.c : -1;
      if (!carry || at_idx >= 0) {
        rv = v;
        ri = at_idx;
      }
    }
  }
  if (ent && (staged || freed)) {
    kv.ent_index[slot] = idx;
    if (staged) {
      kv.ent_key[slot] = key;
      kv.ent_val[slot] = val;
    }
  }
  if (rd) {
    kv.read_val[(size_t)l.g * kv.R + l.i] = rv;
    kv.read_idx[(size_t)l.g * kv.R + l.i] = ri;
  }
  if (l.row && l.i == 0) kv.applied[l.g] = (int32_t)applied;
}

// log2 of a row's lanes: the power of two at or above max(E, R)
inline int kv_shift(int e, int r) {
  const int n = e > r ? e : r;
  int shift = 0;
  while ((1 << shift) < n) ++shift;
  return shift;
}

}  // namespace qs

extern "C" int qs_kv_plane(const qs::Kv* k, int flags, void* stream) {
  const qs::Kv kv = *k;
  const cudaStream_t cs = (cudaStream_t)stream;
  if (kv.E < 1 || kv.E > QS_MAX_KV_ENTS || kv.V < 1 || kv.V > QS_MAX_KV_SLOTS ||
      kv.K < 1)
    return (int)cudaErrorInvalidValue;
  const bool reset = flags & qs::KV_RESET;
  if (reset && kv.churn_map == nullptr) return (int)cudaErrorInvalidValue;
  if (kv.G == 0) return 0;
  const bool plane = flags & qs::KV_PLANE;
  if (plane && (kv.R < 1 || kv.R > QS_MAX_KV_READS || kv.in_idx == nullptr ||
                kv.commits == nullptr || kv.read_val == nullptr))
    return (int)cudaErrorInvalidValue;
  const int shift = qs::kv_shift(kv.E, plane ? kv.R : 1);
  const int grid = qs::grid_for((long long)kv.G << shift);
  if (plane) {
    QS_LAUNCH_COOP(qs::kv_plane_kernel, grid, qs::BLOCK, cs, kv, shift,
                   (bool)(flags & qs::KV_CARRY), reset);
  } else if (reset) {
    QS_LAUNCH_COOP(qs::kv_purge_kernel, grid, qs::BLOCK, cs, kv, shift);
  }
  return (int)cudaGetLastError();
}
