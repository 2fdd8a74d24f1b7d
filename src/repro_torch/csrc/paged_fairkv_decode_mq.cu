// paged_fairkv_decode_mq: multi-query (speculative-verify) decode attention
// over block pools through a block table, with int8 / fp8 pools
// dequantized in the loop; written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_pallas_mq` (src/repro/kernels/
// paged_fairkv_decode.py, body `_mq_kernel`), the 5-D branch of
// `paged_fairkv_decode_pallas`.  It instantiates the kernel body in
// paged_decode.cuh for every chunk width up to QMAX queries per warp, one
// translation unit per width (paged_fairkv_decode_mq_w1.cu .. _w5.cu,
// compiled in parallel and linked into this library); this one picks the
// width.  Its Q = 1 instantiation is the single-query kernel's
// (paged_fairkv_decode.cu).  The header notes the semantics, the design and
// what bounds it.
#include "paged_decode.cuh"

extern "C" {

// fp32 scratch (floats) one launch needs, and its arrival counters (ints)
long long paged_fairkv_decode_mq_scratch_floats(int B, int S, int Q, int G, int Dh,
                                                int capacity) {
  return paged::scratch_floats(B, S, Q, G, Dh, capacity);
}

long long paged_fairkv_decode_mq_counters(int B, int S, int Q, int capacity) {
  return paged::counters(B, S, Q, capacity);
}

// the parts for each chunk width (paged_fairkv_decode_mq_w<QW>.cu)
int paged_fairkv_decode_mq_launch_w1(PAGED_MQ_PARAMS);
int paged_fairkv_decode_mq_launch_w2(PAGED_MQ_PARAMS);
int paged_fairkv_decode_mq_launch_w3(PAGED_MQ_PARAMS);
int paged_fairkv_decode_mq_launch_w4(PAGED_MQ_PARAMS);
int paged_fairkv_decode_mq_launch_w5(PAGED_MQ_PARAMS);

// q (B, S, Q, G, Dh), out likewise; Q * G <= MAX_QUERY_ROWS.  q_lens may
// be null (every row has Q valid queries); otherwise as
// paged_fairkv_decode_launch, with counters holding
// paged_fairkv_decode_mq_counters ints.
int paged_fairkv_decode_mq_launch(PAGED_MQ_PARAMS) {
  if (Q < 1) return cudaErrorInvalidValue;
  switch (paged::chunk_width(Q)) {
    case 1: return paged_fairkv_decode_mq_launch_w1(PAGED_MQ_ARGS);
    case 2: return paged_fairkv_decode_mq_launch_w2(PAGED_MQ_ARGS);
    case 3: return paged_fairkv_decode_mq_launch_w3(PAGED_MQ_ARGS);
    case 4: return paged_fairkv_decode_mq_launch_w4(PAGED_MQ_ARGS);
    case 5: return paged_fairkv_decode_mq_launch_w5(PAGED_MQ_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

const char* paged_fairkv_decode_mq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
