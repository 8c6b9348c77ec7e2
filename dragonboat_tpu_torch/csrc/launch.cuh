// Host-side dispatch of K1 (quorum_step_dense) and K3 (quorum_multiround)
// from the launch flags to their template instances.
//
// READS is a parameter of the dispatch, not a branch at run time: the
// K1 and K3 sources instantiate READS = false, and quorum_step_dense_reads.cu
// and quorum_multiround_reads.cu instantiate READS = true.  The read
// plane doubles the instances of both kernels; in sources of their own
// they compile in nvcc processes of their own, all started together
// (ops/_build.py), so the build's wall time is that of its slowest
// source.  That alone left K3's READS source over the build's time
// budget, so track_contact is a launch argument of K1 and K3 (see
// ingest_dense), which halves both kernels' instances.
#pragma once

#include "quorum.cuh"

namespace qs {

template <bool READS>
int launch_dense(const State& st, const int32_t* ack_max, const bool* touched,
                 const int8_t* vote_new, const Reads& rd, const Flags& fl,
                 int flags, cudaStream_t cs) {
  const int grid = grid_for(st.G);
  if (grid == 0) return 0;
  const bool track = flags & F_TRACK_CONTACT;
  with_p(st.P, [&](auto pc) {
    with_bool(flags & F_DO_TICK, [&](auto tick) {
      with_bool(flags & F_HAS_VOTES, [&](auto votes) {
        with_bool(flags & F_HAS_HIER, [&](auto hier) {
          auto kern = dense_kernel<decltype(pc)::value, decltype(tick)::value,
                                   decltype(votes)::value,
                                   decltype(hier)::value, READS>;
          QS_LAUNCH(kern, grid, BLOCK, cs, st, ack_max, touched, vote_new,
                    track, rd, fl);
        });
      });
    });
  });
  return (int)cudaGetLastError();
}

// K3's main launch, after the churn-map pre-pass.
template <bool READS>
int launch_multiround(const State& st, const int32_t* ack,
                      const int8_t* vote_new, const int32_t* churn_map,
                      const int32_t* churn_term, const int32_t* churn_start,
                      const int32_t* churn_last, int n_records,
                      const bool* tick_mask, int n_rounds,
                      int32_t* commit_trace, const Reads& rd, const Flags& fl,
                      int flags, cudaStream_t cs) {
  const bool track = flags & F_TRACK_CONTACT;
  const bool reset_telem = flags & F_RESET_TELEM;
  const bool reset_reads = flags & F_RESET_READS;
  with_p(st.P, [&](auto pc) {
    with_bool(flags & F_DO_TICK, [&](auto tick) {
      with_bool(flags & F_HAS_VOTES, [&](auto votes) {
        with_bool(flags & F_HAS_CHURN, [&](auto cc) {
          with_bool(flags & F_HAS_HIER, [&](auto hier) {
            auto kern =
                multiround_kernel<decltype(pc)::value, decltype(tick)::value,
                                  decltype(votes)::value, decltype(cc)::value,
                                  decltype(hier)::value, READS>;
            QS_LAUNCH(kern, grid_for(st.G), BLOCK, cs, st, ack, vote_new,
                      churn_map, churn_term, churn_start, churn_last,
                      n_records, tick_mask, n_rounds, commit_trace, track,
                      reset_telem, reset_reads, rd, fl);
          });
        });
      });
    });
  });
  return (int)cudaGetLastError();
}

// The READS = true dispatches, each compiled in its own source.
int launch_dense_reads(const State& st, const int32_t* ack_max,
                       const bool* touched, const int8_t* vote_new,
                       const Reads& rd, const Flags& fl, int flags,
                       cudaStream_t cs);
int launch_multiround_reads(const State& st, const int32_t* ack,
                            const int8_t* vote_new, const int32_t* churn_map,
                            const int32_t* churn_term,
                            const int32_t* churn_start,
                            const int32_t* churn_last, int n_records,
                            const bool* tick_mask, int n_rounds,
                            int32_t* commit_trace, const Reads& rd,
                            const Flags& fl, int flags, cudaStream_t cs);

// The read block of a launch that passed none (the plane off, no reset).
inline Reads no_reads() { return Reads{}; }

}  // namespace qs
