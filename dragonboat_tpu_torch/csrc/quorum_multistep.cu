// B13 and B8: R engine rounds in one dispatch on Hopper.
//
// Replaces dragonboat_tpu/ops/kernels.py quorum_multistep_impl (:802, jit
// :865; the lax.scan of quorum_step_impl :520), quorum_multistep_dense_impl
// (:872, jit :924; the scan of quorum_step_dense_impl :686) and bench.py
// _staged_multistep_fn (:131, jit :151; R dense rounds whose acks are made
// on the device).  One thread a group row, the row in registers across
// the R rounds, so the state is read once and written once a launch,
// however large R is.
//
// * qs_multistep_dense: multistep_kernel (quorum.cuh) on the (R, G, P)
//   ack_max / touched / vote_new planes, each read once.
// * qs_multistep (sparse): one pre-pass launch scatters every round's
//   events into (R, G, P) scratch planes and an (R, G) contacted plane
//   (as K3's churn_map pre-pass does for its records), then one
//   multistep_kernel launch ingests round k from them with the sparse
//   step's semantics.
// * qs_staged_multistep: staged_kernel (quorum.cuh), a row loop of its
//   own whose ingest reads no input (slots 0 and 1 ack base_index + 1 + k
//   in round k) and which reads what the rounds leave unchanged once,
//   before the loop; base_index and R are launch arguments, and no
//   (R, G, P) block is ever written.
//
// Bound.  Dense: the (R, G, P) planes, 6 B a cell with votes off (9 with
// them), dominate at R = 16 on top of one read and write of the state.
// Sparse: the events (13 B an ack, 10 B a vote) and the state; the
// scratch planes (R·G·P x 6 B, zeroed, scattered, read) are the design's
// own traffic above that bound.  Staged: the only bytes are the state,
// and the per-round integer work makes it bound by the SMs' INT32 issue
// rate at the ladder's R = 256 (chip_smoke.py staged_ops).
#include "quorum.cuh"

namespace {

int launch_rows(const qs::State& st, const int32_t* ack, const bool* touched,
                const int8_t* vote_new, const bool* contacted, int n_rounds,
                bool sparse, const qs::Flags& fl, int flags, cudaStream_t cs) {
  const bool track = flags & qs::F_TRACK_CONTACT;
  qs::with_p(st.P, [&](auto pc) {
    qs::with_bool(flags & qs::F_DO_TICK, [&](auto tick) {
      qs::with_bool(flags & qs::F_HAS_VOTES, [&](auto votes) {
        qs::with_bool(flags & qs::F_HAS_HIER, [&](auto hier) {
          auto kern = qs::multistep_kernel<
              decltype(pc)::value, decltype(tick)::value,
              decltype(votes)::value, decltype(hier)::value>;
          QS_LAUNCH(kern, qs::grid_for(st.G), qs::BLOCK, cs, st, ack, touched,
                    vote_new, contacted, n_rounds, track, sparse, fl);
        });
      });
    });
  });
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qs_multistep_dense(const qs::State* s, const int32_t* ack_max,
                                  const bool* touched, const int8_t* vote_new,
                                  int n_rounds, const qs::Flags* f, int flags,
                                  void* stream) {
  if (n_rounds < 0) return (int)cudaErrorInvalidValue;
  if (s->G == 0) return 0;
  return launch_rows(*s, ack_max, touched, vote_new, nullptr, n_rounds, false,
                     *f, flags, (cudaStream_t)stream);
}

extern "C" int qs_multistep(const qs::State* s, const int32_t* ack_g,
                            const int32_t* ack_p, const int32_t* ack_val,
                            const bool* ack_valid, int n_acks,
                            const int32_t* vote_g, const int32_t* vote_p,
                            const int8_t* vote_grant, const bool* vote_valid,
                            int n_votes, int n_rounds, int32_t* sc_max,
                            bool* sc_touched, int8_t* sc_vote,
                            bool* sc_contacted, const qs::Flags* f, int flags,
                            void* stream) {
  const qs::State st = *s;
  const cudaStream_t cs = (cudaStream_t)stream;
  const bool track = flags & qs::F_TRACK_CONTACT;
  const bool votes = flags & qs::F_HAS_VOTES;
  if (n_rounds < 0 || n_acks < 0 || n_votes < 0)
    return (int)cudaErrorInvalidValue;
  if (st.G == 0) return 0;
  const size_t cells = (size_t)n_rounds * st.G * st.P;
  cudaError_t e = cudaMemsetAsync(sc_max, 0, sizeof(int32_t) * cells, cs);
  if (e == cudaSuccess) e = cudaMemsetAsync(sc_touched, 0, cells, cs);
  if (e == cudaSuccess && votes) e = cudaMemsetAsync(sc_vote, 0xff, cells, cs);
  if (e == cudaSuccess && track)
    e = cudaMemsetAsync(sc_contacted, 0, (size_t)n_rounds * st.G, cs);
  if (e != cudaSuccess) return (int)e;
  const long long acks = (long long)n_rounds * n_acks;
  const long long vts = votes ? (long long)n_rounds * n_votes : 0;
  const long long n_events = vts > acks ? vts : acks;
  if (n_events > 0) {
    qs::with_bool(track, [&](auto tc) {
      qs::with_bool(votes, [&](auto vc) {
        auto kern = qs::multistep_scatter_kernel<decltype(tc)::value,
                                                 decltype(vc)::value>;
        QS_LAUNCH(kern, qs::grid_for(n_events), qs::BLOCK, cs, st.G, st.P,
                  ack_g, ack_p, ack_val, ack_valid, acks, n_acks, vote_g,
                  vote_p, vote_grant, vote_valid, vts, n_votes,
                  (uint32_t*)sc_max, sc_touched, sc_vote, sc_contacted);
      });
    });
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return launch_rows(st, sc_max, sc_touched, votes ? sc_vote : nullptr,
                     sc_contacted, n_rounds, true, *f, flags, cs);
}

extern "C" int qs_staged_multistep(const qs::State* s, int base_index,
                                   int n_rounds, const qs::Flags* f,
                                   int flags, void* stream) {
  (void)flags;  // the reference's flags: ticks on, no contact, no votes
  if (n_rounds < 0) return (int)cudaErrorInvalidValue;
  const qs::State st = *s;
  if (st.G == 0) return 0;
  const int grid = (int)(((long long)st.G + qs::STAGED_BLOCK - 1) / qs::STAGED_BLOCK);
  qs::with_p(st.P, [&](auto pc) {
    auto kern = qs::staged_kernel<decltype(pc)::value>;
    QS_LAUNCH(kern, grid, qs::STAGED_BLOCK, (cudaStream_t)stream, st, n_rounds,
              base_index, *f);
  });
  return (int)cudaGetLastError();
}
