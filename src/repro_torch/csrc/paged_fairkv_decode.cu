// paged_fairkv_decode: single-query decode attention over block pools
// through a block table, with int8 / fp8 pools dequantized in the loop;
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_fairkv_decode_pallas` (src/repro/kernels/
// paged_fairkv_decode.py, body `_kernel`, dequant `_dequant`), 4-D form.
// It is the Q = 1 instantiation of the kernel body in paged_decode.cuh,
// which the multi-query kernel (paged_fairkv_decode_mq.cu) shares; the
// header notes the semantics, the design and what bounds it.
#include "paged_decode.cuh"

extern "C" {

// fp32 scratch (floats) one launch needs
long long paged_fairkv_decode_scratch_floats(int B, int S, int G, int Dh, int capacity) {
  return paged::scratch_floats(B, S, 1, G, Dh, capacity);
}

// arrival counters (ints) one launch needs
long long paged_fairkv_decode_counters(int B, int S, int capacity) {
  return paged::counters(B, S, 1, capacity);
}

// q (B, S, G, Dh), out likewise.  q_dtype: 0 = float32, 1 = bfloat16.
// pool_dtype: 0 = float32, 1 = bfloat16 (must equal q_dtype), 2 = int8
// codes (k_scale, v_scale and kinds are then read; kinds may be null for
// all-int8).  q_pos is read only when window > 0.  Lengths are clamped to
// capacity (<= M * bs).  scratch holds paged_fairkv_decode_scratch_floats
// floats; counters holds paged_fairkv_decode_counters ints that are 0
// before the launch (the launch
// leaves them 0).  Returns cudaGetLastError() after the launch (0 =
// launched).
int paged_fairkv_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                               const int* pos_pool, const int* table,
                               const int* lengths, const int* q_pos,
                               const float* k_scale, const float* v_scale,
                               const int* kinds, void* out, float* scratch, int* counters,
                               int B, int S, int G, int M, int bs, int Dh, int capacity,
                               float attn_cap, int window, int q_dtype,
                               int pool_dtype, void* stream) {
  const paged::Args a{q, k_pool, v_pool, pos_pool, table, lengths, q_pos, nullptr,
                      k_scale, v_scale, kinds, out, scratch, counters,
                      B, S, 1, M, bs, Dh, capacity, attn_cap, window};
  return paged::dispatch<false, 1>(G, a, q_dtype, pool_dtype, static_cast<cudaStream_t>(stream));
}

const char* paged_fairkv_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
