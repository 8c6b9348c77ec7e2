// K2: the sparse quorum_step on Hopper, one source and two launches.
//
// Replaces dragonboat_tpu/ops/kernels.py quorum_step_impl (:520) with its
// tail _finish_step (:619, with the has_hier branch :640-650 as the HIER
// instances of the row launch) and tick_step (:472).  The event launch does
// the scatter-max of the acks with atomicMax on int32 match and plain
// byte stores of ``true`` into active and the (G,) contacted scratch
// (idempotent, so no atomics are needed); the row launch is K1's tail,
// on a block's rows staged through shared memory (see quorum.cuh).  Two
// stream operations: the row launch may start while the events run
// (programmatic dependent launch; it waits for them before it reads what
// they write), and ``contacted`` is never cleared by a launch of its own
// (the row pass leaves it zeroed for the next launch).
// Bound: the row pass reads the state as K1 does (see quorum.cuh); the
// events add 13 B each for acks and 10 B for votes; the writes are the
// flags and the cells the events change (match, active, votes) and those
// the tail changes (next, committed, last_index, the clocks).
#include "quorum.cuh"

extern "C" int qs_sparse(const qs::State* s, const int32_t* ack_g,
                         const int32_t* ack_p, const int32_t* ack_val,
                         const bool* ack_valid, int n_acks,
                         const int32_t* vote_g, const int32_t* vote_p,
                         const int8_t* vote_grant, const bool* vote_valid,
                         int n_votes, bool* contacted, const qs::Flags* f,
                         int flags, void* stream) {
  const qs::State st = *s;
  const qs::Flags fl = *f;
  const cudaStream_t cs = (cudaStream_t)stream;
  const bool track = flags & qs::F_TRACK_CONTACT;
  const bool votes = flags & qs::F_HAS_VOTES;
  if (st.G == 0) return 0;
  const int n_events = votes && n_votes > n_acks ? n_votes : n_acks;
  const int egrid = qs::grid_for(n_events);
  const bool hier = flags & qs::F_HAS_HIER;
  int block = 0;
  const qs::SparseSlab lay = qs::sparse_layout(st.P, hier, block);
  const size_t smem = lay.bytes;
  const int grid = (int)(((long long)st.G + block - 1) / block);
  // the event launch sets bytes of ``contacted`` that only the row launch
  // puts back to 0: nothing that can fail comes between the two
  auto events = [&]() -> int {
    qs::with_bool(track, [&](auto tc) {
      qs::with_bool(votes, [&](auto vc) {
        auto kern = qs::sparse_events_kernel<decltype(tc)::value,
                                             decltype(vc)::value>;
        QS_LAUNCH(kern, egrid, qs::BLOCK, cs, st, ack_g, ack_p, ack_val,
                  ack_valid, n_acks, vote_g, vote_p, vote_grant, vote_valid,
                  n_votes, contacted);
      });
    });
    return (int)cudaGetLastError();
  };
  int err = 0;
  qs::with_p(st.P, [&](auto pc) {
    qs::with_bool(flags & qs::F_DO_TICK, [&](auto tick) {
      qs::with_bool(track, [&](auto tc) {
        qs::with_bool(hier, [&](auto hc) {
          auto kern = qs::sparse_rows_kernel<decltype(pc)::value,
                                             decltype(tick)::value,
                                             decltype(tc)::value,
                                             decltype(hc)::value>;
          err = (int)qs_set_smem(kern, smem);
          if (err != 0) return;
          if (egrid > 0) {
            err = events();
            if (err != 0) return;
            QS_LAUNCH_PDL(kern, grid, block, smem, cs, st, contacted, fl, lay);
          } else {
            QS_LAUNCH_COOP_DYN(kern, grid, block, smem, cs, st, contacted, fl, lay);
          }
        });
      });
    });
  });
  return err != 0 ? err : (int)cudaGetLastError();
}

// K1's (``dense`` != 0) or K2's row-pass slab layout at ``p`` peer slots
// and ``S`` read slots under the launch ``flags`` (F_HAS_VOTES,
// F_HAS_HIER, F_HAS_READS), as the launchers lay it out: returns the rows
// a block stages and puts in out[0..2] the end of the planes' regions,
// the barrier's offset and the shared memory a block takes.  No launch
// calls it; the compiler and timing reports and the tests read it.
extern "C" int qs_slab_layout(int dense, int p, int S, int flags, int* out) {
  const bool hier = flags & qs::F_HAS_HIER;
  int rows = 0;
  if (dense) {
    const qs::DenseSlab l = qs::dense_layout(p, S, flags & qs::F_HAS_VOTES, hier,
                                             flags & qs::F_HAS_READS, rows);
    out[0] = l.end, out[1] = l.bar, out[2] = l.bytes;
  } else {
    const qs::SparseSlab l = qs::sparse_layout(p, hier, rows);
    out[0] = l.end, out[1] = l.bar, out[2] = l.bytes;
  }
  return rows;
}
