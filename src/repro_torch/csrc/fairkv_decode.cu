// fairkv_decode: slot-layout decode attention with per-(slot, row) lengths,
// the FairKV decode hot loop, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `fairkv_decode_pallas` (src/repro/kernels/
// fairkv_decode.py, body `_kernel`).  Semantics are those of
// `fairkv_decode_ref` (src/repro_torch/kernels/ref.py): per (slot s, row b)
// the G query heads of q[b, s] attend over the first lengths[s, b] entries of
// k/v[s, b]; optional softcap cap*tanh(x/cap) before the mask; optional
// sliding window k_pos > q_pos - window; fp32 online softmax; a (slot, row)
// with length 0, or with every entry masked, gives exact zeros.
//
// What bounds it on this card: bytes.  Each retained entry is read once
// (K and V rows of Dh elements) and used for only G dot products, about
// G/itemsize FLOP per byte, far below the ~295 FLOP/byte where an H100's
// tensor cores, not its HBM, would be the limit.  So the design keeps the
// bytes moved equal to the retained bytes and nothing more:
//   - one thread block per (s, b); a block whose length is 0 writes zeros
//     and exits, and the others loop over exactly `len` entries, so device
//     memory traffic is proportional to Σ lengths (the quantity FairKV
//     balances across shards; on the TPU this came from clamping the K/V
//     index map);
//   - the G x Dh query tile is staged once in shared memory as fp32;
//   - each warp takes every NWARPS-th entry: a lane holds Dh/32 elements of
//     the K and V row (consecutive lanes read consecutive addresses), the G
//     scores are reduced with warp shuffles, and the running (m, l, acc) of
//     the online softmax stay in fp32 registers;
//   - the NWARPS partial softmax states are merged through shared memory at
//     the end (a split over entries inside the block).
// Known limit, left for later work: at S*B = 128 (slot, row) pairs there are
// fewer blocks than the card's 132 SMs, and half of them are unowned pairs
// that exit at once; splitting long rows over several blocks (split-K)
// would fill the card.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NWARPS = 8;
constexpr int MAXJ = 4;  // Dh <= 128: lane owns d = lane + 32 * j, j < MAXJ
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int G>
__global__ void __launch_bounds__(NWARPS * 32)
fairkv_decode_kernel(const T* __restrict__ q,        // (B, S, G, Dh)
                     const T* __restrict__ k,        // (S, B, C, Dh)
                     const T* __restrict__ v,        // (S, B, C, Dh)
                     const int* __restrict__ lengths,  // (S, B)
                     const int* __restrict__ k_pos,    // (S, B, C) or null
                     const int* __restrict__ q_pos,    // (B,) or null
                     T* __restrict__ out,            // (B, S, G, Dh)
                     int B, int S, int C, int Dh,
                     float scale, float attn_cap, int window) {
  extern __shared__ float smem[];
  const int sb = blockIdx.x;  // s * B + b
  const int s = sb / B;
  const int b = sb - s * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lengths[sb];
  const size_t qo = (static_cast<size_t>(b) * S + s) * G * Dh;
  T* o = out + qo;
  if (len <= 0) {  // unowned (slot, row): exact zeros, no K/V traffic
    for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) store(o + i, 0.f);
    return;
  }
  float* q_s = smem;                        // G * Dh
  float* acc_s = q_s + G * Dh;              // NWARPS * G * Dh
  float* ml_s = acc_s + NWARPS * G * Dh;    // NWARPS * G * 2
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
  const size_t row0 = static_cast<size_t>(sb) * C;
  const T* kb = k + row0 * Dh;
  const T* vb = v + row0 * Dh;
  const int qp = window > 0 ? q_pos[b] : 0;

  for (int c = warp; c < len; c += NWARPS) {
    // window mask: uniform across the warp (one entry per warp)
    if (window > 0 && !(k_pos[row0 + c] > qp - window)) continue;
    float kr[MAXJ], vr[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = lane + 32 * j;
      kr[j] = d < Dh ? to_f(kb[static_cast<size_t>(c) * Dh + d]) : 0.f;
      vr[j] = d < Dh ? to_f(vb[static_cast<size_t>(c) * Dh + d]) : 0.f;
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
      // a warp that saw no valid entry has l = 0 and acc = 0: no weight
      const float f = expf(ml_s[(w * G + g) * 2] - mx);
      lsum += ml_s[(w * G + g) * 2 + 1] * f;
      a += acc_s[w * G * Dh + i] * f;
    }
    store(o + i, lsum > 0.f ? a / lsum : 0.f);
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, const int* k_pos, const int* q_pos,
                   void* out, int B, int S, int C, int Dh, float attn_cap,
                   int window, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(G * Dh + NWARPS * G * Dh + NWARPS * G * 2) * sizeof(float);
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));
  fairkv_decode_kernel<T, G><<<S * B, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, k_pos, q_pos, static_cast<T*>(out), B, S, C, Dh, scale, attn_cap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const int* lengths, const int* k_pos, const int* q_pos,
                       void* out, int B, int S, int C, int Dh, float attn_cap,
                       int window, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, 1>(q, k, v, lengths, k_pos, q_pos, out, B, S, C, Dh, attn_cap, window, st);
    case 2: return launch<T, 2>(q, k, v, lengths, k_pos, q_pos, out, B, S, C, Dh, attn_cap, window, st);
    case 4: return launch<T, 4>(q, k, v, lengths, k_pos, q_pos, out, B, S, C, Dh, attn_cap, window, st);
    case 8: return launch<T, 8>(q, k, v, lengths, k_pos, q_pos, out, B, S, C, Dh, attn_cap, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  k_pos / q_pos are read only when
// window > 0.  Returns cudaGetLastError() after the launch (0 = launched).
int fairkv_decode_launch(const void* q, const void* k, const void* v,
                         const int* lengths, const int* k_pos, const int* q_pos,
                         void* out, int B, int S, int G, int C, int Dh,
                         float attn_cap, int window, int dtype, void* stream) {
  if (Dh < 1 || Dh > 32 * MAXJ || B < 1 || S < 1 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_g<float>(G, q, k, v, lengths, k_pos, q_pos, out, B, S, C, Dh, attn_cap, window, st);
  if (dtype == 1)
    return dispatch_g<__nv_bfloat16>(G, q, k, v, lengths, k_pos, q_pos, out, B, S, C, Dh, attn_cap, window, st);
  return cudaErrorInvalidValue;
}

const char* fairkv_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
