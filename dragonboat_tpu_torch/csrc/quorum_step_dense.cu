// K1: quorum_step_dense on Hopper, one in-place launch.
//
// Replaces dragonboat_tpu/ops/kernels.py quorum_step_dense_impl (:686)
// with its tail _finish_step (:619, the has_hier branch :640-650 as the
// HIER instances, which also read near and sub_quorum: 9 B a row at
// P = 5) and tick_step (:472).  Bound and
// design: see quorum.cuh — one thread per group row, the row in
// registers, one read of each state field it uses (124 B per row with
// its inputs at P = 5, ticks on and votes off) and one write of each
// field it may change.
#include "quorum.cuh"

extern "C" int qs_dense(const qs::State* s, const int32_t* ack_max,
                        const bool* touched, const int8_t* vote_new,
                        const qs::Flags* f, int flags, void* stream) {
  const qs::State st = *s;
  const qs::Flags fl = *f;
  const cudaStream_t cs = (cudaStream_t)stream;
  const int grid = qs::grid_for(st.G);
  if (grid == 0) return 0;
  qs::with_p(st.P, [&](auto pc) {
    qs::with_bool(flags & qs::F_DO_TICK, [&](auto tick) {
      qs::with_bool(flags & qs::F_TRACK_CONTACT, [&](auto track) {
        qs::with_bool(flags & qs::F_HAS_VOTES, [&](auto votes) {
          qs::with_bool(flags & qs::F_HAS_HIER, [&](auto hier) {
            auto kern = qs::dense_kernel<decltype(pc)::value,
                                         decltype(tick)::value,
                                         decltype(track)::value,
                                         decltype(votes)::value,
                                         decltype(hier)::value>;
            QS_LAUNCH(kern, grid, qs::BLOCK, cs, st, ack_max, touched,
                      vote_new, fl);
          });
        });
      });
    });
  });
  return (int)cudaGetLastError();
}

extern "C" const char* qs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
