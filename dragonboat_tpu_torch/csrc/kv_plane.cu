// The device state machine (devsm) on Hopper: stage -> apply -> read.
//
// Replaces dragonboat_tpu/ops/kernels.py _kv_plane (:402) in the has_kv
// branches of quorum_step_dense_impl (:765-777) and
// quorum_multiround_impl (:1184-1193, the carry from (0, -1, 0) at
// :1213-1219), with _apply_recycle's reset_kv (:974-992).
//
// Design.  The reference runs the plane inside the step's jit program,
// after the tail.  Here it is a kernel of its own, launched after K1 or
// K3 on the same stream: K3's READS instances already hold 162
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
// One thread per row.  The row's E entries and R read captures live in
// registers for the launch's rounds (E and R are launch arguments with
// caps, like the read plane's S); the value row stays in device memory:
// each ready key's winner is written once a round, and the reads gather
// after the apply, from the same thread.  Bit-exact rules of the
// reference: a key outside [0, V) (jax.nn.one_hot's all-zero row) is a
// ready entry that counts as applied and frees its slot but writes
// nothing, and a read of such a key captures 0; the value of a key is
// the int32 sum (wrapping) of its ready entries at the largest index;
// any negative stage index or read key means none; K3's carry keeps a
// round's capture where its index is >= 0.
//
// Bound on the H100: memory.  Per row it reads the kv state once
// (V + 3E ints, 256 B at V = E = 16), its inputs ((3E + R) ints a round,
// 208 B; 3.3 KB a row at K = 16), the watermark of each round and, with
// resets, the churn map; it writes the kv cells that change and the
// (G, R) x 2 + (G,) egress.  The winner search is O(E^2) compares a
// round, below the byte bound at these widths.
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

QS_HD void kv_clear_row(const Kv& kv, int g) {
  int32_t* vrow = kv.value + (size_t)g * kv.V;
  for (int j = 0; j < kv.V; ++j) vrow[j] = 0;
  const size_t at = (size_t)g * kv.E;
  for (int i = 0; i < kv.E; ++i) {
    kv.ent_index[at + i] = -1;
    kv.ent_key[at + i] = 0;
    kv.ent_val[at + i] = 0;
  }
}

// purge_kv on a block that runs no plane: reset every recycled row.
__global__ void kv_purge_kernel(Kv kv) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= kv.G) return;
  bool hit = false;
  for (int k = 0; k < kv.K; ++k) hit = hit || kv.churn_map[(size_t)k * kv.G + g] >= 0;
  if (hit) kv_clear_row(kv, g);
}

__global__ void kv_plane_kernel(Kv kv, bool carry, bool reset) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= kv.G) return;
  const int E = kv.E, R = kv.R, V = kv.V;
  int32_t idx[QS_MAX_KV_ENTS], key[QS_MAX_KV_ENTS], val[QS_MAX_KV_ENTS];
  const size_t base = (size_t)g * E;
  QS_UNROLL
  for (int i = 0; i < QS_MAX_KV_ENTS; ++i) {
    idx[i] = i < E ? kv.ent_index[base + i] : -1;
    key[i] = i < E ? kv.ent_key[base + i] : 0;
    val[i] = i < E ? kv.ent_val[base + i] : 0;
  }
  int32_t rv[QS_MAX_KV_READS], ri[QS_MAX_KV_READS];
  QS_UNROLL
  for (int j = 0; j < QS_MAX_KV_READS; ++j) {
    rv[j] = 0;
    ri[j] = -1;
  }
  int32_t applied = 0;
  int32_t* vrow = kv.value + (size_t)g * V;
  for (int k = 0; k < kv.K; ++k) {
    const size_t row = (size_t)k * kv.G + g;
    if (reset && kv.churn_map[row] >= 0) {  // the fresh tenant: empty
      QS_UNROLL
      for (int i = 0; i < QS_MAX_KV_ENTS; ++i) {
        idx[i] = -1;
        key[i] = 0;
        val[i] = 0;
      }
      for (int j = 0; j < V; ++j) vrow[j] = 0;
    }
    // stage: a non-negative index overwrites its buffer slot
    const size_t at = row * E;
    QS_UNROLL
    for (int i = 0; i < QS_MAX_KV_ENTS; ++i) {
      if (i < E) {
        const int32_t si = kv.in_idx[at + i];
        if (si >= 0) {
          idx[i] = si;
          key[i] = kv.in_key[at + i];
          val[i] = kv.in_val[at + i];
        }
      }
    }
    // apply every buffered entry at or below the round's watermark
    const int32_t c = kv.commits[row];
    uint32_t ready = 0;
    QS_UNROLL
    for (int i = 0; i < QS_MAX_KV_ENTS; ++i)
      if (i < E && idx[i] >= 0 && idx[i] <= c) ready |= 1u << i;
    applied = wadd(applied, __popc(ready));
    if (ready != 0) {
      // per key the ready entries at its largest index win, summed; the
      // first of them (lowest slot) writes the key
      QS_UNROLL
      for (int i = 0; i < QS_MAX_KV_ENTS; ++i) {
        const int32_t ki = key[i];
        if (((ready >> i) & 1u) && ki >= 0 && ki < V) {
          bool first = true;
          int32_t sum = 0;
          QS_UNROLL
          for (int j = 0; j < QS_MAX_KV_ENTS; ++j) {
            if (((ready >> j) & 1u) && key[j] == ki) {
              if (idx[j] > idx[i] || (idx[j] == idx[i] && j < i)) first = false;
              if (idx[j] == idx[i]) sum = wadd(sum, val[j]);
            }
          }
          if (first) vrow[ki] = sum;
        }
      }
      QS_UNROLL
      for (int i = 0; i < QS_MAX_KV_ENTS; ++i)
        if ((ready >> i) & 1u) idx[i] = -1;  // applied slots free
    }
    // reads: the post-apply value and the watermark it reflects
    const size_t rat = row * R;
    QS_UNROLL
    for (int j = 0; j < QS_MAX_KV_READS; ++j) {
      if (j < R) {
        const int32_t rk = kv.read_key[rat + j];
        const int32_t v = rk >= 0 && rk < V ? vrow[rk] : 0;
        const int32_t at_idx = rk >= 0 ? c : -1;
        if (!carry) {
          rv[j] = v;
          ri[j] = at_idx;
        } else if (at_idx >= 0) {
          rv[j] = v;
          ri[j] = at_idx;
        }
      }
    }
  }
  QS_UNROLL
  for (int i = 0; i < QS_MAX_KV_ENTS; ++i) {
    if (i < E) {
      kv.ent_index[base + i] = idx[i];
      kv.ent_key[base + i] = key[i];
      kv.ent_val[base + i] = val[i];
    }
  }
  QS_UNROLL
  for (int j = 0; j < QS_MAX_KV_READS; ++j) {
    if (j < R) {
      kv.read_val[(size_t)g * R + j] = rv[j];
      kv.read_idx[(size_t)g * R + j] = ri[j];
    }
  }
  kv.applied[g] = applied;
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
  if (flags & qs::KV_PLANE) {
    if (kv.R < 1 || kv.R > QS_MAX_KV_READS || kv.in_idx == nullptr ||
        kv.commits == nullptr || kv.read_val == nullptr)
      return (int)cudaErrorInvalidValue;
    auto kern = qs::kv_plane_kernel;
    QS_LAUNCH(kern, qs::grid_for(kv.G), qs::BLOCK, cs, kv,
              (bool)(flags & qs::KV_CARRY), reset);
  } else if (reset) {
    auto kern = qs::kv_purge_kernel;
    QS_LAUNCH(kern, qs::grid_for(kv.G), qs::BLOCK, cs, kv);
  }
  return (int)cudaGetLastError();
}
