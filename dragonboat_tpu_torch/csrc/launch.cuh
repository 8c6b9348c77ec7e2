// Host-side dispatch of K1 (quorum_step_dense) and K3 (quorum_multiround)
// from the launch flags to their template instances.
//
// READS is a parameter of the dispatch, not a branch at run time: the
// K1 and K3 sources instantiate READS = false, and quorum_step_dense_reads.cu
// and quorum_multiround_reads.cu instantiate READS = true.  The read
// plane doubles the instances of both kernels; in sources of their own
// they compile in nvcc processes of their own, all started together
// (ops/_build.py), so the build's wall time is that of its slowest
// source (K3's READS instances take two, split by HIER).  That alone left K3's READS source over the build's time
// budget, so track_contact is a launch argument of K1 and K3 (see
// ingest_dense), which halves both kernels' instances.
#pragma once

#include "quorum.cuh"

namespace qs {

template <bool READS>
int launch_dense(const State& st, const int32_t* ack_max, const bool* touched,
                 const int8_t* vote_new, const Reads& rd, const Flags& fl,
                 int flags, cudaStream_t cs) {
  if (st.G == 0) return 0;
  const bool track = flags & F_TRACK_CONTACT;
  const bool votes = flags & F_HAS_VOTES, hier = flags & F_HAS_HIER;
  const int S = READS ? rd.S : 0;
  // the row slabs in shared memory (see dense_kernel)
  int block = 0;
  const DenseSlab lay = dense_layout(st.P, S, votes, hier, READS, block);
  const size_t smem = lay.bytes;
  const int grid = (int)(((long long)st.G + block - 1) / block);
  int err = 0;
  with_p(st.P, [&](auto pc) {
    with_bool(flags & F_DO_TICK, [&](auto tick) {
      with_bool(votes, [&](auto vc) {
        with_bool(hier, [&](auto hc) {
          auto kern = dense_kernel<decltype(pc)::value, decltype(tick)::value,
                                   decltype(vc)::value, decltype(hc)::value, READS>;
          err = (int)qs_set_smem(kern, smem);
          if (err != 0) return;
          QS_LAUNCH_COOP_DYN(kern, grid, block, smem, cs, st, ack_max, touched,
                             vote_new, track, rd, fl, lay);
        });
      });
    });
  });
  return err != 0 ? err : (int)cudaGetLastError();
}

// K3's main launch, after the churn-map pre-pass, for one value of the
// HIER flag: the READS instances compile in two sources, one a value,
// since in one they took the build past its time budget.
template <bool READS, bool HIER>
int launch_multiround_h(const State& st, const int32_t* ack,
                        const int8_t* vote_new, const int32_t* churn_map,
                        const int32_t* churn_term, const int32_t* churn_start,
                        const int32_t* churn_last, int n_records,
                        const bool* tick_mask, int n_rounds,
                        int32_t* commit_trace, const Reads& rd,
                        const Flags& fl, int flags, cudaStream_t cs) {
  const bool track = flags & F_TRACK_CONTACT;
  const bool reset_telem = flags & F_RESET_TELEM;
  const bool reset_reads = flags & F_RESET_READS;
  // the ring of round inputs in shared memory (see multiround_kernel):
  // K3_BLOCK rows a block, or half that where the widest rows (generic
  // widths with many read slots) would not fit in an SM's 227 KB
  const K3Layout lay = k3_layout(st.P, READS ? rd.S : 0, flags & F_HAS_VOTES,
                                 flags & F_HAS_CHURN, READS);
  int block = K3_BLOCK;
  if (k3_smem_bytes(lay, block) > 232448) block /= 2;
  const size_t smem = k3_smem_bytes(lay, block);
  const int grid = (int)(((long long)st.G + block - 1) / block);
  int err = 0;
  with_p(st.P, [&](auto pc) {
    with_bool(flags & F_DO_TICK, [&](auto tick) {
      with_bool(flags & F_HAS_VOTES, [&](auto votes) {
        with_bool(flags & F_HAS_CHURN, [&](auto cc) {
          auto kern =
              multiround_kernel<decltype(pc)::value, decltype(tick)::value,
                                decltype(votes)::value, decltype(cc)::value,
                                HIER, READS>;
          err = (int)qs_set_smem(kern, smem);
          if (err != 0) return;
          QS_LAUNCH_DYN(kern, grid, block, smem, cs, st, ack, vote_new,
                        churn_map, churn_term, churn_start, churn_last,
                        n_records, tick_mask, n_rounds, commit_trace, track,
                        reset_telem, reset_reads, rd, fl);
        });
      });
    });
  });
  return err != 0 ? err : (int)cudaGetLastError();
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
int launch_multiround_reads_hier(const State& st, const int32_t* ack,
                                 const int8_t* vote_new,
                                 const int32_t* churn_map,
                                 const int32_t* churn_term,
                                 const int32_t* churn_start,
                                 const int32_t* churn_last, int n_records,
                                 const bool* tick_mask, int n_rounds,
                                 int32_t* commit_trace, const Reads& rd,
                                 const Flags& fl, int flags, cudaStream_t cs);

// The read block of a launch that passed none (the plane off, no reset).
inline Reads no_reads() { return Reads{}; }

}  // namespace qs
