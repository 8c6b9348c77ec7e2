// K2: the sparse quorum_step on Hopper, one source and two launches.
//
// Replaces dragonboat_tpu/ops/kernels.py quorum_step_impl (:520) with its
// tail _finish_step (:619, with the has_hier branch :640-650 as the HIER
// instances of the row launch) and tick_step (:472).  The event launch does
// the scatter-max of the acks with atomicMax on int32 match and plain
// byte stores of ``true`` into active and the (G,) contacted scratch
// (idempotent, so no atomics are needed); the row launch is K1's tail.
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
  if (track) {
    const cudaError_t e = cudaMemsetAsync(contacted, 0, (size_t)st.G, cs);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_events = votes && n_votes > n_acks ? n_votes : n_acks;
  const int egrid = qs::grid_for(n_events);
  if (egrid > 0) {
    qs::with_bool(track, [&](auto tc) {
      qs::with_bool(votes, [&](auto vc) {
        auto kern = qs::sparse_events_kernel<decltype(tc)::value,
                                             decltype(vc)::value>;
        QS_LAUNCH(kern, egrid, qs::BLOCK, cs, st, ack_g, ack_p, ack_val,
                  ack_valid, n_acks, vote_g, vote_p, vote_grant, vote_valid,
                  n_votes, contacted);
      });
    });
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  qs::with_p(st.P, [&](auto pc) {
    qs::with_bool(flags & qs::F_DO_TICK, [&](auto tick) {
      qs::with_bool(track, [&](auto tc) {
        qs::with_bool(flags & qs::F_HAS_HIER, [&](auto hier) {
          auto kern = qs::sparse_rows_kernel<decltype(pc)::value,
                                             decltype(tick)::value,
                                             decltype(tc)::value,
                                             decltype(hier)::value>;
          QS_LAUNCH(kern, qs::grid_for(st.G), qs::BLOCK, cs, st, contacted,
                    fl);
        });
      });
    });
  });
  return (int)cudaGetLastError();
}
