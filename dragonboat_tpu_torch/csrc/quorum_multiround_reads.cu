// The READS instances of K3 (quorum_multiround with has_reads): per
// round, after the tail and before the masked tick, the read plane on
// the row (dragonboat_tpu/ops/kernels.py :1126-1142, :1179-1183,
// read_confirm :331, _read_plane :362), with the row's S slots and the
// egress accumulators (count sum, index max from -1) in registers for
// the whole block, stored once a row.  A recycle at round k clears the
// slots before round k's stage.  A source of its own so that nvcc
// compiles them beside the other instances (see launch.cuh); the HIER
// instances compile apart, in quorum_multiround_reads_hier.cu.  Bound at
// K = 16, S = 4, P = 5: K3's reads plus 832 B of stage and echo input a
// row, the slots read and written once (52 B each way) and 32 B of egress.
#include "launch.cuh"

int qs::launch_multiround_reads(const State& st, const int32_t* ack,
                                const int8_t* vote_new,
                                const int32_t* churn_map,
                                const int32_t* churn_term,
                                const int32_t* churn_start,
                                const int32_t* churn_last, int n_records,
                                const bool* tick_mask, int n_rounds,
                                int32_t* commit_trace, const Reads& rd,
                                const Flags& fl, int flags, cudaStream_t cs) {
  if (flags & F_HAS_HIER)
    return launch_multiround_reads_hier(st, ack, vote_new, churn_map,
                                        churn_term, churn_start, churn_last,
                                        n_records, tick_mask, n_rounds,
                                        commit_trace, rd, fl, flags, cs);
  return launch_multiround_h<true, false>(
      st, ack, vote_new, churn_map, churn_term, churn_start, churn_last,
      n_records, tick_mask, n_rounds, commit_trace, rd, fl, flags, cs);
}
