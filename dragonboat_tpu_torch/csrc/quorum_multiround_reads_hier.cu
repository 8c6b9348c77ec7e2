// The READS instances of K3 with the hier commit rule (HIER = true); the
// others are in quorum_multiround_reads.cu.  A source of its own so that
// nvcc compiles them in a process of its own (see launch.cuh): the READS
// instances of both HIER values in one source took the build past its
// time budget.
#include "launch.cuh"

int qs::launch_multiround_reads_hier(const State& st, const int32_t* ack,
                                     const int8_t* vote_new,
                                     const int32_t* churn_map,
                                     const int32_t* churn_term,
                                     const int32_t* churn_start,
                                     const int32_t* churn_last,
                                     int n_records, const bool* tick_mask,
                                     int n_rounds, int32_t* commit_trace,
                                     const Reads& rd, const Flags& fl,
                                     int flags, cudaStream_t cs) {
  return launch_multiround_h<true, true>(
      st, ack, vote_new, churn_map, churn_term, churn_start, churn_last,
      n_records, tick_mask, n_rounds, commit_trace, rd, fl, flags, cs);
}
