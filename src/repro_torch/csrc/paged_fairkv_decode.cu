// paged_fairkv_decode: decode attention over block pools through a block
// table, with int8 / fp8 pools dequantized in the loop; written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_fairkv_decode_pallas` (src/repro/kernels/
// paged_fairkv_decode.py, body `_kernel`, dequant `_dequant`), single-query
// form.  Semantics are those of `paged_fairkv_decode_ref`
// (src/repro_torch/kernels/ref.py): column c of (slot s, row b) lives at
// offset c % bs of pool block table[s, b, c / bs] (entries <= 0 resolve to
// the null block 0); the G query heads of q[b, s] attend over the first
// lengths[s, b] columns; optional softcap cap*tanh(x/cap) before the mask;
// optional sliding window pos > q_pos - window on the pool's absolute
// positions; fp32 online softmax; a (slot, row) of length 0, or with every
// entry masked, gives exact zeros.  Quantized pools hold int8 codes with one
// fp32 scale per block and a kind per slot (0 = int8 value, 1 = fp8-e4m3
// bit pattern): value = decode(code) * scale[block], fp8 NaN patterns read
// as 0.  The unquantized path takes no scale operands.
//
// What bounds it on this card: bytes.  Each retained entry's K and V rows
// are read once and used for G dot products, far below the ~295 FLOP/byte
// at which an H100's tensor cores, not its HBM, would be the limit; int8
// pools halve the bytes and add 8 bytes of scale per block.  So the design
// keeps the bytes moved equal to the allocated bytes and nothing more:
//   - one thread block per (s, b) walks its own block-table row; a pair of
//     length 0 (unowned, retired or empty) writes zeros and exits, the
//     others read exactly `len` columns, so traffic follows the allocated
//     blocks (on the TPU the index map clamped past-length grid steps);
//   - the G x Dh query tile is staged once in shared memory as fp32;
//   - each warp takes every NWARPS-th column: a lane holds Dh/32 elements
//     of the K and V row (consecutive lanes on consecutive addresses), the
//     G scores are reduced with warp shuffles, and the running (m, l, acc)
//     stay in fp32 registers; the warps' partial states merge through
//     shared memory at the end.
// Known limits, left for later work: a warp keeps one row load in flight
// (latency-bound, as the slot kernel), and S*B pairs may be fewer blocks
// than the card's 132 SMs (split-K would fill it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int MAXJ = 4;  // Dh <= 128: lane owns d = lane + 32 * j, j < MAXJ
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
// bf16, or int8 codes; the quantized path reads scales and kinds).
template <typename TQ, typename TKV, int G>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const TQ* __restrict__ q,           // (B, S, G, Dh)
                    const TKV* __restrict__ k_pool,     // (N, bs, Dh)
                    const TKV* __restrict__ v_pool,     // (N, bs, Dh)
                    const int* __restrict__ pos_pool,   // (N, bs)
                    const int* __restrict__ table,      // (S, B, M)
                    const int* __restrict__ lengths,    // (S, B)
                    const int* __restrict__ q_pos,      // (B,) or null
                    const float* __restrict__ k_scale,  // (N,) or null
                    const float* __restrict__ v_scale,  // (N,) or null
                    const int* __restrict__ kinds,      // (S,) or null
                    TQ* __restrict__ out,               // (B, S, G, Dh)
                    int B, int S, int M, int bs, int Dh,
                    float scale, float attn_cap, int window) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  extern __shared__ float smem[];
  const int sb = blockIdx.x;  // s * B + b
  const int s = sb / B;
  const int b = sb - s * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lengths[sb];
  const size_t qo = (static_cast<size_t>(b) * S + s) * G * Dh;
  TQ* o = out + qo;
  if (len <= 0) {  // unowned or empty (slot, row): exact zeros, no traffic
    for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) store(o + i, 0.f);
    return;
  }
  float* q_s = smem;                      // G * Dh
  float* acc_s = q_s + G * Dh;            // NWARPS * G * Dh
  float* ml_s = acc_s + NWARPS * G * Dh;  // NWARPS * G * 2
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) q_s[i] = to_f(q[qo + i]);
  __syncthreads();

  float m[G], l[G], acc[G][MAXJ];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[g][j] = 0.f;
  }
  const int* trow = table + static_cast<size_t>(sb) * M;
  const int qp = window > 0 ? q_pos[b] : 0;
  const int kind = (QUANT && kinds != nullptr) ? kinds[s] : 0;

  for (int c = warp; c < len; c += NWARPS) {
    const int blk = c / bs;
    const int id = max(trow[blk], 0);  // <= 0: the null block
    const size_t row = static_cast<size_t>(id) * bs + (c - blk * bs);
    // window mask: uniform across the warp (one column per warp)
    if (window > 0 && !(pos_pool[row] > qp - window)) continue;
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
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int d = lane + 32 * j;
        if (d < Dh) part += q_s[g * Dh + d] * kr[j];
      }
      float sc = warp_sum(part) * scale;
      if (attn_cap > 0.f) sc = attn_cap * tanhf(sc / attn_cap);
      const float mn = fmaxf(m[g], sc);
      const float corr = expf(m[g] - mn);
      const float p = expf(sc - mn);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) acc[g][j] = acc[g][j] * corr + p * vr[j];
      m[g] = mn;
    }
  }

  // merge the NWARPS partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = lane + 32 * j;
      if (d < Dh) acc_s[(warp * G + g) * Dh + d] = acc[g][j];
    }
    if (lane == 0) {
      ml_s[(warp * G + g) * 2] = m[g];
      ml_s[(warp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    const int g = i / Dh;
    float mx = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, ml_s[(w * G + g) * 2]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      // a warp that saw no valid column has l = 0 and acc = 0: no weight
      const float f = expf(ml_s[(w * G + g) * 2] - mx);
      lsum += ml_s[(w * G + g) * 2 + 1] * f;
      a += acc_s[w * G * Dh + i] * f;
    }
    store(o + i, lsum > 0.f ? a / lsum : 0.f);
  }
}

struct Args {
  const void* q; const void* k_pool; const void* v_pool; const int* pos_pool;
  const int* table; const int* lengths; const int* q_pos;
  const float* k_scale; const float* v_scale; const int* kinds; void* out;
  int B, S, M, bs, Dh; float attn_cap; int window;
};

template <typename TQ, typename TKV, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(G * a.Dh + NWARPS * G * a.Dh + NWARPS * G * 2) * sizeof(float);
  const float scale = 1.0f / sqrtf(static_cast<float>(a.Dh));
  paged_decode_kernel<TQ, TKV, G><<<a.S * a.B, NWARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.pos_pool, a.table, a.lengths, a.q_pos,
      a.k_scale, a.v_scale, a.kinds, static_cast<TQ*>(a.out),
      a.B, a.S, a.M, a.bs, a.Dh, scale, a.attn_cap, a.window);
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
// when window > 0.  Returns cudaGetLastError() after the launch (0 =
// launched).
int paged_fairkv_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                               const int* pos_pool, const int* table,
                               const int* lengths, const int* q_pos,
                               const float* k_scale, const float* v_scale,
                               const int* kinds, void* out,
                               int B, int S, int G, int M, int bs, int Dh,
                               float attn_cap, int window, int q_dtype,
                               int pool_dtype, void* stream) {
  if (Dh < 1 || Dh > 32 * MAXJ || B < 1 || S < 1 || M < 1 || bs < 1)
    return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, pos_pool, table, lengths, q_pos, k_scale,
               v_scale, kinds, out, B, S, M, bs, Dh, attn_cap, window};
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

const char* paged_fairkv_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
