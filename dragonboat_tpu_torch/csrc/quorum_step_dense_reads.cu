// The READS instances of K1 (quorum_step_dense with has_reads): the
// dense step, then the read plane on the row — stage, echo ingest,
// confirm, release (dragonboat_tpu/ops/kernels.py :753-764, read_confirm
// :331, _read_plane :362).  A source of its own so that nvcc compiles
// them beside the other instances (see launch.cuh).  Bound: K1's reads
// plus the row's read slots read and written (52 B at S = 4, P = 5), the
// stage and echo inputs (52 B) and the (G, S) egress (32 B).
#include "launch.cuh"

int qs::launch_dense_reads(const State& st, const int32_t* ack_max,
                           const bool* touched, const int8_t* vote_new,
                           const Reads& rd, const Flags& fl, int flags,
                           cudaStream_t cs) {
  return launch_dense<true>(st, ack_max, touched, vote_new, rd, fl, flags, cs);
}
