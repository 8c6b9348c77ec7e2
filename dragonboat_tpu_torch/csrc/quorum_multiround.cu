// K3: quorum_multiround on Hopper — K rounds with in-program churn.
//
// Replaces dragonboat_tpu/ops/kernels.py quorum_multiround_impl (:1021)
// with _apply_recycle (:931, its telem reset under F_RESET_TELEM and its
// read reset under F_RESET_READS) and, per round, the dense ingest and
// tail of K1 (the HIER instances load the hier geometry once per block;
// the READS instances, with the read plane, compile from
// quorum_multiround_reads.cu — see launch.cuh).  A pre-pass turns the
// (K, C) recycle records into a (K, G) row -> record map; the main
// launch then walks the K rounds per row with the row held in
// registers, so the state is read once and written once per block, and
// with each round's inputs brought into a shared-memory ring by cp.async
// two rounds ahead of the round computed (multiround_kernel).  With
// the device state machine on, the launch also stores each round's
// watermark into a (K, G) trace for csrc/kv_plane.cu, which runs after
// it on the same stream (4 B a row and round), and the churn map stays
// alive for that kernel's resets.
// Bound: the (K, G, P) int32 ack block dominates — 160 B per row at
// K = 8, P = 5 — on top of one read and write of the state (see
// quorum.cuh).
#include "launch.cuh"

extern "C" int qs_multiround(const qs::State* s, const int32_t* ack,
                             const int8_t* vote_new, const int32_t* churn_row,
                             const int32_t* churn_term,
                             const int32_t* churn_start,
                             const int32_t* churn_last, int n_records,
                             const bool* tick_mask, int n_rounds,
                             int32_t* churn_map, int32_t* commit_trace,
                             const qs::Reads* reads, const qs::Flags* f,
                             int flags, void* stream) {
  const qs::State st = *s;
  const cudaStream_t cs = (cudaStream_t)stream;
  const bool churn = flags & qs::F_HAS_CHURN;
  const bool has_reads = flags & qs::F_HAS_READS;
  if (st.G == 0) return 0;
  if ((has_reads || (flags & qs::F_RESET_READS)) && reads == nullptr)
    return (int)cudaErrorInvalidValue;
  if (churn) {
    const cudaError_t e = cudaMemsetAsync(
        churn_map, 0xff, sizeof(int32_t) * (size_t)n_rounds * st.G, cs);
    if (e != cudaSuccess) return (int)e;
    const long long n = (long long)n_rounds * n_records;
    if (n > 0) {
      auto kern = qs::churn_map_kernel;
      QS_LAUNCH(kern, qs::grid_for(n), qs::BLOCK, cs, churn_row, n_rounds,
                n_records, st.G, churn_map);
      const cudaError_t e2 = cudaGetLastError();
      if (e2 != cudaSuccess) return (int)e2;
    }
  }
  const qs::Reads rd = reads != nullptr ? *reads : qs::no_reads();
  if (has_reads)
    return qs::launch_multiround_reads(st, ack, vote_new, churn_map,
                                       churn_term, churn_start, churn_last,
                                       n_records, tick_mask, n_rounds,
                                       commit_trace, rd, *f, flags, cs);
  if (flags & qs::F_HAS_HIER)
    return qs::launch_multiround_h<false, true>(
        st, ack, vote_new, churn_map, churn_term, churn_start, churn_last,
        n_records, tick_mask, n_rounds, commit_trace, rd, *f, flags, cs);
  return qs::launch_multiround_h<false, false>(
      st, ack, vote_new, churn_map, churn_term, churn_start, churn_last,
      n_records, tick_mask, n_rounds, commit_trace, rd, *f, flags, cs);
}
