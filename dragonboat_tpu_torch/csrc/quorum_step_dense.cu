// K1: quorum_step_dense on Hopper, one in-place launch.
//
// Replaces dragonboat_tpu/ops/kernels.py quorum_step_dense_impl (:686)
// with its tail _finish_step (:619, the has_hier branch :640-650 as the
// HIER instances, which also read near and sub_quorum: 9 B a row at
// P = 5) and tick_step (:472); the has_reads branch (:753-764, the read
// plane read_confirm :331 / _read_plane :362) is the READS instances,
// compiled from quorum_step_dense_reads.cu (see launch.cuh).  Bound and
// design: see quorum.cuh — one thread per group row, the row in
// registers, one read of each state field it uses (124 B per row with
// its inputs at P = 5, ticks on and votes off) and one write of each
// field it may change; a block's rows of every per-peer plane staged
// through shared memory, moved whole by the TMA unit's bulk copies
// (dense_kernel).
#include "launch.cuh"

extern "C" int qs_dense(const qs::State* s, const int32_t* ack_max,
                        const bool* touched, const int8_t* vote_new,
                        const qs::Reads* reads, const qs::Flags* f, int flags,
                        void* stream) {
  const cudaStream_t cs = (cudaStream_t)stream;
  if (flags & qs::F_HAS_READS) {
    if (reads == nullptr) return (int)cudaErrorInvalidValue;
    return qs::launch_dense_reads(*s, ack_max, touched, vote_new, *reads, *f,
                                  flags, cs);
  }
  return qs::launch_dense<false>(*s, ack_max, touched, vote_new,
                                 qs::no_reads(), *f, flags, cs);
}

extern "C" const char* qs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
