// K3: quorum_multiround on Hopper — K rounds with in-program churn.
//
// Replaces dragonboat_tpu/ops/kernels.py quorum_multiround_impl (:1021)
// with _apply_recycle (:931, its telem reset under F_RESET_TELEM) and,
// per round, the dense ingest and tail of K1 (the HIER instances load
// the hier geometry once per block).  A pre-pass turns the (K, C) recycle records into a (K, G)
// row -> record map; the main launch then walks the K rounds per row with
// the row held in registers, so the state is read once and written once
// per block.  Bound: the (K, G, P) int32 ack block dominates — 160 B per
// row at K = 8, P = 5 — on top of one read and write of the state (see
// quorum.cuh).
#include "quorum.cuh"

extern "C" int qs_multiround(const qs::State* s, const int32_t* ack,
                             const int8_t* vote_new, const int32_t* churn_row,
                             const int32_t* churn_term,
                             const int32_t* churn_start,
                             const int32_t* churn_last, int n_records,
                             const bool* tick_mask, int n_rounds,
                             int32_t* churn_map, const qs::Flags* f,
                             int flags, void* stream) {
  const qs::State st = *s;
  const qs::Flags fl = *f;
  const cudaStream_t cs = (cudaStream_t)stream;
  const bool churn = flags & qs::F_HAS_CHURN;
  const bool reset_telem = flags & qs::F_RESET_TELEM;
  if (st.G == 0) return 0;
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
  qs::with_p(st.P, [&](auto pc) {
    qs::with_bool(flags & qs::F_DO_TICK, [&](auto tick) {
      qs::with_bool(flags & qs::F_TRACK_CONTACT, [&](auto track) {
        qs::with_bool(flags & qs::F_HAS_VOTES, [&](auto votes) {
          qs::with_bool(churn, [&](auto cc) {
            qs::with_bool(flags & qs::F_HAS_HIER, [&](auto hier) {
              auto kern = qs::multiround_kernel<decltype(pc)::value,
                                                decltype(tick)::value,
                                                decltype(track)::value,
                                                decltype(votes)::value,
                                                decltype(cc)::value,
                                                decltype(hier)::value>;
              QS_LAUNCH(kern, qs::grid_for(st.G), qs::BLOCK, cs, st, ack,
                        vote_new, churn_map, churn_term, churn_start,
                        churn_last, n_records, tick_mask, n_rounds,
                        reset_telem, fl);
            });
          });
        });
      });
    });
  });
  return (int)cudaGetLastError();
}
