// paged_fairkv_decode_mq: multi-query (speculative-verify) decode attention
// over block pools through a block table, with int8 / fp8 pools dequantized
// in the loop; written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_pallas_mq` (src/repro/kernels/
// paged_fairkv_decode.py, body `_mq_kernel`), the 5-D branch of
// `paged_fairkv_decode_pallas`.  Semantics are those of
// `paged_fairkv_decode_ref` with a 5-D q (`fairkv_decode_mq_ref`,
// src/repro_torch/kernels/ref.py): column c of (slot s, row b) lives at
// offset c % bs of pool block table[s, b, c / bs] (entries <= 0 resolve to
// the null block 0); query i of row b, with qn = q_lens[b] valid queries,
// sees the first min(len - (qn - 1 - i), len) columns (lanes i >= qn are
// garbage the caller discards and clamp to len); softcap cap*tanh(x/cap)
// before the mask; sliding window pos > q_pos[b] + i - window; fp32 online
// softmax; a query with no valid column, and every query of a (slot, row)
// of length 0, gives exact zeros.  Quantized pools hold int8 codes with one
// fp32 scale per block and a kind per slot (0 = int8 value, 1 = fp8-e4m3
// bit pattern), fp8 NaN patterns read as 0.
//
// What bounds it on this card: bytes.  Each retained entry's K and V rows
// (512 B in bf16 at Dh = 128) feed 4 * Q * G * Dh operations, about 20 per
// byte at Q = 5, G = 4, far below the ~295 operations per byte at which an
// H100's tensor cores, not its HBM, would be the limit.  So the design
// reads each retained K/V row once for the whole (Q, G) query tile:
//   - one thread block per (s, b) walks its own block-table row and reads
//     exactly `len` columns; a pair of length 0 writes zeros and exits;
//   - the Q*G x Dh query tile is staged once in shared memory as fp32;
//   - each warp takes every NWARPS-th column (a lane holds Dh/32 elements of
//     the K and V row); a column no query may see is skipped before its
//     loads; for each (query, group) row the score is reduced with warp
//     shuffles and the row's online-softmax state updated;
//   - registers: the Q*G rows' running max and sum stay in registers (the
//     row loop is unrolled to MAX_ROWS with a guard, so indices are
//     compile-time), while the Q*G x Dh accumulators live in shared memory,
//     one region per warp, each lane touching only its own Dh/32 columns
//     (no cross-lane hazard, no bank conflict).  Holding them in registers
//     would take Q*G*Dh/32 = 80 fp32 registers at Q = 5, G = 4 on top of the
//     rest;
//   - the warps' partial states merge through shared memory at the end.
// At Q = 1 every floating-point operation is the single-query kernel's
// (csrc/paged_fairkv_decode.cu), in the same order, so the two agree
// bitwise.  Known limits, left for later work: a warp keeps one row load in
// flight (latency-bound, as the single-query kernel), and S*B pairs may be
// fewer blocks than the card's 132 SMs (split-K would fill it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int MAXJ = 4;       // Dh <= 128: lane owns d = lane + 32 * j, j < MAXJ
constexpr int MAX_ROWS = 40;  // Q * G query rows per (slot, row)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// int8 code -> fp32 value before the block scale: the code itself (kind 0)
// or the e4m3 number whose bit pattern it is (kind 1), NaN read as 0
__device__ __forceinline__ float code_to_f(int8_t c, int kind) {
  if (kind == 1) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(static_cast<uint8_t>(c)), __NV_E4M3);
    const float f = __half2float(__half(h));
    return f != f ? 0.f : f;
  }
  return static_cast<float>(c);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// TQ: query/output type (float, bf16).  TKV: pool element type (float,
// bf16, or int8 codes; the quantized path reads scales and kinds).  G: query
// heads per kv head.  Q (queries per row) is a runtime value, Q * G <=
// MAX_ROWS.
template <typename TQ, typename TKV, int G>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_mq_kernel(const TQ* __restrict__ q,           // (B, S, Q, G, Dh)
                       const TKV* __restrict__ k_pool,     // (N, bs, Dh)
                       const TKV* __restrict__ v_pool,     // (N, bs, Dh)
                       const int* __restrict__ pos_pool,   // (N, bs)
                       const int* __restrict__ table,      // (S, B, M)
                       const int* __restrict__ lengths,    // (S, B)
                       const int* __restrict__ q_pos,      // (B,) or null
                       const int* __restrict__ q_lens,     // (B,) or null (= Q)
                       const float* __restrict__ k_scale,  // (N,) or null
                       const float* __restrict__ v_scale,  // (N,) or null
                       const int* __restrict__ kinds,      // (S,) or null
                       TQ* __restrict__ out,               // (B, S, Q, G, Dh)
                       int B, int S, int Q, int M, int bs, int Dh,
                       float scale, float attn_cap, int window) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  extern __shared__ float smem[];
  const int sb = blockIdx.x;  // s * B + b
  const int s = sb / B;
  const int b = sb - s * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lengths[sb];
  const int QG = Q * G;
  const size_t qo = (static_cast<size_t>(b) * S + s) * QG * Dh;
  TQ* o = out + qo;
  if (len <= 0) {  // unowned or empty (slot, row): exact zeros, no traffic
    for (int i = threadIdx.x; i < QG * Dh; i += blockDim.x) store(o + i, 0.f);
    return;
  }
  float* q_s = smem;                       // QG * Dh
  float* acc_s = q_s + QG * Dh;            // NWARPS * QG * Dh
  float* ml_s = acc_s + NWARPS * QG * Dh;  // NWARPS * QG * 2
  for (int i = threadIdx.x; i < QG * Dh; i += blockDim.x) q_s[i] = to_f(q[qo + i]);
  float* acc_w = acc_s + warp * QG * Dh;  // this warp's accumulators
  for (int r = 0; r < QG; ++r) {
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = lane + 32 * j;
      if (d < Dh) acc_w[r * Dh + d] = 0.f;
    }
  }
  __syncthreads();

  float m[MAX_ROWS], l[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  const int* trow = table + static_cast<size_t>(sb) * M;
  const int qp = window > 0 ? q_pos[b] : 0;
  const int qn = q_lens != nullptr ? q_lens[b] : Q;
  const int kind = (QUANT && kinds != nullptr) ? kinds[s] : 0;
  // query i sees columns c < min(len - (qn - 1 - i), len); query 0 the
  // fewest, the last valid query and the garbage lanes all of them
  const int lim0 = min(len - (qn - 1), len);

  for (int c = warp; c < len; c += NWARPS) {
    const int blk = c / bs;
    const int id = max(trow[blk], 0);  // <= 0: the null block
    const size_t row = static_cast<size_t>(id) * bs + (c - blk * bs);
    // masks: uniform across the warp (one column per warp).  The causal
    // limit admits a suffix of the queries, i > c - lim0; the window
    // (pos > qp + i - window) a prefix, i < wlim.  A column no query sees
    // is skipped before its loads.
    int wlim = Q;
    if (window > 0) wlim = min(max(pos_pool[row] - qp + window, 0), Q);
    if (max(c - lim0 + 1, 0) >= wlim) continue;
    float ksc = 1.f, vsc = 1.f;
    if (QUANT) {
      ksc = k_scale[id];
      vsc = v_scale[id];
    }
    float kr[MAXJ], vr[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = lane + 32 * j;
      kr[j] = vr[j] = 0.f;
      if (d < Dh) {
        if constexpr (QUANT) {
          kr[j] = code_to_f(static_cast<int8_t>(k_pool[row * Dh + d]), kind) * ksc;
          vr[j] = code_to_f(static_cast<int8_t>(v_pool[row * Dh + d]), kind) * vsc;
        } else {
          kr[j] = to_f(k_pool[row * Dh + d]);
          vr[j] = to_f(v_pool[row * Dh + d]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r >= QG) break;
      const int i = r / G;  // query index of the row (G is compile-time)
      // causal limit within the window: c < len - (qn - 1 - i), clamped
      if (i >= wlim || c >= min(lim0 + i, len)) continue;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int d = lane + 32 * j;
        if (d < Dh) part += q_s[r * Dh + d] * kr[j];
      }
      float sc = warp_sum(part) * scale;
      if (attn_cap > 0.f) sc = attn_cap * tanhf(sc / attn_cap);
      const float mn = fmaxf(m[r], sc);
      const float corr = expf(m[r] - mn);
      const float p = expf(sc - mn);
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int d = lane + 32 * j;
        if (d < Dh) acc_w[r * Dh + d] = acc_w[r * Dh + d] * corr + p * vr[j];
      }
      m[r] = mn;
    }
  }

  // merge the NWARPS partial softmax states
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r >= QG) break;
      ml_s[(warp * QG + r) * 2] = m[r];
      ml_s[(warp * QG + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < QG * Dh; i += blockDim.x) {
    const int r = i / Dh;
    float mx = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, ml_s[(w * QG + r) * 2]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      // a warp that saw no valid column has l = 0 and acc = 0: no weight
      const float f = expf(ml_s[(w * QG + r) * 2] - mx);
      lsum += ml_s[(w * QG + r) * 2 + 1] * f;
      a += acc_s[w * QG * Dh + i] * f;
    }
    store(o + i, lsum > 0.f ? a / lsum : 0.f);
  }
}

struct Args {
  const void* q; const void* k_pool; const void* v_pool; const int* pos_pool;
  const int* table; const int* lengths; const int* q_pos; const int* q_lens;
  const float* k_scale; const float* v_scale; const int* kinds; void* out;
  int B, S, Q, M, bs, Dh; float attn_cap; int window;
};

template <typename TQ, typename TKV, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int qg = a.Q * G;
  const size_t smem =
      static_cast<size_t>(qg * a.Dh + NWARPS * qg * a.Dh + NWARPS * qg * 2) * sizeof(float);
  auto kernel = paged_decode_mq_kernel<TQ, TKV, G>;
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(a.Dh));
  kernel<<<a.S * a.B, NWARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.pos_pool, a.table, a.lengths, a.q_pos,
      a.q_lens, a.k_scale, a.v_scale, a.kinds, static_cast<TQ*>(a.out),
      a.B, a.S, a.Q, a.M, a.bs, a.Dh, scale, a.attn_cap, a.window);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: return launch<TQ, TKV, 1>(a, st);
    case 2: return launch<TQ, TKV, 2>(a, st);
    case 4: return launch<TQ, TKV, 4>(a, st);
    case 8: return launch<TQ, TKV, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16 (q and out).  pool_dtype: 0 = float32,
// 1 = bfloat16 (must equal q_dtype), 2 = int8 codes (k_scale, v_scale and
// kinds are then read; kinds may be null for all-int8).  q_pos is read only
// when window > 0; q_lens may be null (every row has Q valid queries).
// Q * G must not exceed MAX_ROWS.  Returns cudaGetLastError() after the
// launch (0 = launched).
int paged_fairkv_decode_mq_launch(const void* q, const void* k_pool, const void* v_pool,
                                  const int* pos_pool, const int* table,
                                  const int* lengths, const int* q_pos,
                                  const int* q_lens, const float* k_scale,
                                  const float* v_scale, const int* kinds, void* out,
                                  int B, int S, int Q, int G, int M, int bs, int Dh,
                                  float attn_cap, int window, int q_dtype,
                                  int pool_dtype, void* stream) {
  if (Dh < 1 || Dh > 32 * MAXJ || B < 1 || S < 1 || Q < 1 || G < 1
      || Q * G > MAX_ROWS || M < 1 || bs < 1)
    return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, pos_pool, table, lengths, q_pos, q_lens, k_scale,
               v_scale, kinds, out, B, S, Q, M, bs, Dh, attn_cap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 2) {
    if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
    if (q_dtype == 0) return dispatch_g<float, int8_t>(G, a, st);
    if (q_dtype == 1) return dispatch_g<__nv_bfloat16, int8_t>(G, a, st);
    return cudaErrorInvalidValue;
  }
  if (pool_dtype != q_dtype) return cudaErrorInvalidValue;
  if (q_dtype == 0) return dispatch_g<float, float>(G, a, st);
  if (q_dtype == 1) return dispatch_g<__nv_bfloat16, __nv_bfloat16>(G, a, st);
  return cudaErrorInvalidValue;
}

const char* paged_fairkv_decode_mq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
