// paged_fairkv_decode_mq: multi-query (speculative-verify) decode attention
// over block pools through a block table, with int8 / fp8 pools
// dequantized in the loop; written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_pallas_mq` (src/repro/kernels/
// paged_fairkv_decode.py, body `_mq_kernel`), the 5-D branch of
// `paged_fairkv_decode_pallas`.  It instantiates the kernel body in
// paged_decode.cuh for every chunk width up to QMAX queries per warp; its
// Q = 1 instantiation is the single-query kernel's
// (paged_fairkv_decode.cu).  The header notes the semantics, the design and
// what bounds it.
#include "paged_decode.cuh"

extern "C" {

// fp32 scratch (floats) one launch needs, and its arrival counters (ints)
long long paged_fairkv_decode_mq_scratch_floats(int B, int S, int Q, int G, int Dh) {
  return paged::scratch_floats(B, S, Q, G, Dh);
}

int paged_fairkv_decode_mq_counters(int B, int S, int Q) {
  return S * B * paged::n_chunks(Q);
}

// q (B, S, Q, G, Dh), out likewise; Q * G <= MAX_QUERY_ROWS.  q_lens may
// be null (every row has Q valid queries); otherwise as
// paged_fairkv_decode_launch, with counters holding
// paged_fairkv_decode_mq_counters ints.
int paged_fairkv_decode_mq_launch(const void* q, const void* k_pool, const void* v_pool,
                                  const int* pos_pool, const int* table,
                                  const int* lengths, const int* q_pos,
                                  const int* q_lens, const float* k_scale,
                                  const float* v_scale, const int* kinds, void* out,
                                  float* scratch, int* counters,
                                  int B, int S, int Q, int G, int M, int bs, int Dh,
                                  int capacity, float attn_cap, int window, int q_dtype,
                                  int pool_dtype, void* stream) {
  const paged::Args a{q, k_pool, v_pool, pos_pool, table, lengths, q_pos, q_lens,
                      k_scale, v_scale, kinds, out, scratch, counters,
                      B, S, Q, M, bs, Dh, capacity, attn_cap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q < 1) return cudaErrorInvalidValue;
  switch (paged::chunk_width(Q)) {
    case 1: return paged::dispatch<true, 1>(G, a, q_dtype, pool_dtype, st);
    case 2: return paged::dispatch<true, 2>(G, a, q_dtype, pool_dtype, st);
    case 3: return paged::dispatch<true, 3>(G, a, q_dtype, pool_dtype, st);
    case 4: return paged::dispatch<true, 4>(G, a, q_dtype, pool_dtype, st);
    case 5: return paged::dispatch<true, 5>(G, a, q_dtype, pool_dtype, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* paged_fairkv_decode_mq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
