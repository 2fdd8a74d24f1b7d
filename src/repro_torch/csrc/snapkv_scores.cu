// snapkv_scores: SnapKV observation-window importance, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `snapkv_scores_pallas` (src/repro/kernels/
// snapkv_select.py, body `_kernel`).  Semantics are those of
// `snapkv_scores_ref` (src/repro_torch/kernels/ref.py):
//
//     imp[b, h, t] = Σ_{w, g} softmax_T(q[b, w, h*G+g] · k[b, :, h] / √Dh)_t
//
// with optional softcap cap*tanh(x/cap) and the causal mask
// k_pos[b, t] <= obs_pos[b, w], fp32 throughout.  Query rows r = w*G + g
// (R = W*G of them per (b, h)).
//
// What bounds it on this card: each key row is used by all R = W*G queries
// of its (b, h) (128 at W=32, G=4), i.e. R FLOP per byte of bf16 K, below
// the ~295 FLOP/byte of the bf16 tensor cores, so a tensor-core version
// would be bound by reading K once.  This version computes on the fp32 CUDA
// cores (67 TFLOP/s), where the score FLOPs, not the bytes, set the floor,
// and the softmax needs two sweeps over T.  The TPU kernel
// carried the (m, l) statistics in scratch from one sequential grid step to
// the next; blocks on Hopper run in parallel with no order, so the two
// phases are two launches:
//   pass 1: one block per (b, h).  The R x Dh query tile sits in shared
//           memory as fp32 (64 KB at W=32, G=4, Dh=128, above the 48 KB
//           default, so the launch raises the dynamic shared-memory limit).
//           The block streams K once in tiles of TT keys, computes the R x TT
//           score tile with a 16 x 16 thread grid (each thread 8 rows x 4
//           keys, register-blocked over Dh), and keeps each row's running
//           (max m, sum l) of exp in fp32; (m, l) go to a scratch buffer.
//   pass 2: one block per (b, h, key tile).  It recomputes its score tile
//           and writes the fp32 column sums Σ_r exp(s - m_r) / l_r.
// The tile products run on the CUDA cores in fp32 (no tensor cores), which
// keeps the arithmetic close to the fp32 reference; it is the first thing a
// faster version would change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TT = 64;        // keys per tile (16 thread columns x 4)
constexpr int RT = 128;       // query rows per chunk (16 thread rows x 8)
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// the 16 lanes sharing a thread row (tx = 0..15) are one half of a warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Smem {
  float* q;      // Rpad x ld
  float* k;      // TT x ld
  int* opos;     // W
  int* kpos;     // TT
  float* red;    // 16 x TT (pass 2)
};

__host__ __device__ inline size_t smem_bytes(int Rpad, int Dh, int W) {
  const int ld = Dh + 1;  // pad rows: column reads by 16 rows hit 16 banks
  return (static_cast<size_t>(Rpad) * ld + static_cast<size_t>(TT) * ld + 16 * TT) * sizeof(float)
         + (static_cast<size_t>(W) + TT) * sizeof(int);
}

__device__ inline Smem carve(float* base, int Rpad, int Dh, int W) {
  const int ld = Dh + 1;
  Smem s;
  s.q = base;
  s.k = s.q + static_cast<size_t>(Rpad) * ld;
  s.red = s.k + static_cast<size_t>(TT) * ld;
  s.opos = reinterpret_cast<int*>(s.red + 16 * TT);
  s.kpos = s.opos + W;
  return s;
}

// stage the (b, h) query tile (rows r = w*G + g, zero rows up to Rpad) and
// the observation positions
template <typename T>
__device__ void load_q(const Smem& sm, const T* __restrict__ q, const int* __restrict__ obs_pos,
                       int b, int h, int W, int Hq, int G, int Dh, int R, int Rpad) {
  const int ld = Dh + 1;
  for (int i = threadIdx.x; i < Rpad * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    float x = 0.f;
    if (r < R) {
      const int w = r / G, g = r - w * G;
      x = to_f(q[((static_cast<size_t>(b) * W + w) * Hq + h * G + g) * Dh + d]);
    }
    sm.q[r * ld + d] = x;
  }
  for (int i = threadIdx.x; i < W; i += blockDim.x) sm.opos[i] = obs_pos[b * W + i];
}

template <typename T>
__device__ void load_k(const Smem& sm, const T* __restrict__ k, const int* __restrict__ k_pos,
                       int b, int h, int t0, int T_len, int Hkv, int Dh) {
  const int ld = Dh + 1;
  for (int i = threadIdx.x; i < TT * Dh; i += blockDim.x) {
    const int tt = i / Dh, d = i - tt * Dh;
    const int t = t0 + tt;
    sm.k[tt * ld + d] =
        t < T_len ? to_f(k[((static_cast<size_t>(b) * T_len + t) * Hkv + h) * Dh + d]) : 0.f;
  }
  for (int i = threadIdx.x; i < TT; i += blockDim.x) {
    const int t = t0 + i;
    sm.kpos[i] = t < T_len ? k_pos[static_cast<size_t>(b) * T_len + t] : 0;
  }
}

// s[i][j] = scaled, capped score of row r0 + ty + 16 i against key tx + 16 j
// of the staged tile; valid[i][j] = the causal / extent mask
__device__ __forceinline__ void tile_scores(const Smem& sm, float s[8][4], bool valid[8][4],
                                            int r0, int t0, int R, int G, int T_len, int Dh,
                                            float scale, float attn_cap) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ld = Dh + 1;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  const float* qrow = sm.q + (r0 + ty) * ld;
  const float* krow = sm.k + tx * ld;
  for (int d = 0; d < Dh; ++d) {
    float qv[8], kv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = qrow[16 * i * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = krow[16 * j * ld + d];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ty + 16 * i;
    const int op = r < R ? sm.opos[r / G] : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tt = tx + 16 * j;
      float x = s[i][j] * scale;
      if (attn_cap > 0.f) x = attn_cap * tanhf(x / attn_cap);
      s[i][j] = x;
      valid[i][j] = r < R && t0 + tt < T_len && sm.kpos[tt] <= op;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
snapkv_lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const int* __restrict__ obs_pos, const int* __restrict__ k_pos,
                  float* __restrict__ ml,  // (B, Hkv, R, 2)
                  int W, int Hq, int Hkv, int T_len, int Dh, int G,
                  float scale, float attn_cap) {
  extern __shared__ float smem_raw[];
  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int R = W * G, Rpad = (R + RT - 1) / RT * RT;
  const Smem sm = carve(smem_raw, Rpad, Dh, W);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_q(sm, q, obs_pos, b, h, W, Hq, G, Dh, R, Rpad);
  for (int r0 = 0; r0 < R; r0 += RT) {
    float m[8], l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) { m[i] = NEG_INF; l[i] = 0.f; }
    for (int t0 = 0; t0 < T_len; t0 += TT) {
      __syncthreads();  // previous tile fully consumed (and q staged)
      load_k(sm, k, k_pos, b, h, t0, T_len, Hkv, Dh);
      __syncthreads();
      float s[8][4];
      bool valid[8][4];
      tile_scores(sm, s, valid, r0, t0, R, G, T_len, Dh, scale, attn_cap);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float tmax = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) if (valid[i][j]) tmax = fmaxf(tmax, s[i][j]);
        const float mn = fmaxf(m[i], half_max(tmax));
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) if (valid[i][j]) psum += expf(s[i][j] - mn);
        l[i] = l[i] * expf(m[i] - mn) + half_sum(psum);
        m[i] = mn;
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + ty + 16 * i;
        if (r < R) {
          ml[(static_cast<size_t>(bh) * R + r) * 2] = m[i];
          ml[(static_cast<size_t>(bh) * R + r) * 2 + 1] = l[i];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
snapkv_emit_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const int* __restrict__ obs_pos, const int* __restrict__ k_pos,
                   const float* __restrict__ ml, float* __restrict__ out,  // (B, Hkv, T)
                   int W, int Hq, int Hkv, int T_len, int Dh, int G,
                   float scale, float attn_cap) {
  extern __shared__ float smem_raw[];
  const int t0 = blockIdx.x * TT;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int R = W * G, Rpad = (R + RT - 1) / RT * RT;
  const Smem sm = carve(smem_raw, Rpad, Dh, W);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_q(sm, q, obs_pos, b, h, W, Hq, G, Dh, R, Rpad);
  load_k(sm, k, k_pos, b, h, t0, T_len, Hkv, Dh);
  __syncthreads();
  float col[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = 0; r0 < R; r0 += RT) {
    float s[8][4];
    bool valid[8][4];
    tile_scores(sm, s, valid, r0, t0, R, G, T_len, Dh, scale, attn_cap);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r >= R) continue;
      const float m = ml[(static_cast<size_t>(bh) * R + r) * 2];
      const float l = ml[(static_cast<size_t>(bh) * R + r) * 2 + 1];
      const float inv = 1.f / (l > 0.f ? l : 1.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) if (valid[i][j]) col[j] += expf(s[i][j] - m) * inv;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) sm.red[ty * TT + tx + 16 * j] = col[j];
  __syncthreads();
  for (int tt = threadIdx.x; tt < TT; tt += blockDim.x) {
    float acc = 0.f;
    for (int y = 0; y < 16; ++y) acc += sm.red[y * TT + tt];
    if (t0 + tt < T_len) out[static_cast<size_t>(bh) * T_len + t0 + tt] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const int* obs_pos, const int* k_pos,
                   float* ml, float* out, int B, int W, int Hq, int Hkv, int T_len,
                   int Dh, float attn_cap, cudaStream_t st) {
  const int G = Hq / Hkv, R = W * G, Rpad = (R + RT - 1) / RT * RT;
  const size_t smem = smem_bytes(Rpad, Dh, W);
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));
  cudaError_t e = cudaFuncSetAttribute(snapkv_lse_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(snapkv_emit_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  snapkv_lse_kernel<T><<<B * Hkv, NTHREADS, smem, st>>>(
      qt, kt, obs_pos, k_pos, ml, W, Hq, Hkv, T_len, Dh, G, scale, attn_cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + TT - 1) / TT, B * Hkv);
  snapkv_emit_kernel<T><<<grid, NTHREADS, smem, st>>>(
      qt, kt, obs_pos, k_pos, ml, out, W, Hq, Hkv, T_len, Dh, G, scale, attn_cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of either pass needs (bytes).
long long snapkv_scores_smem_bytes(int W, int G, int Dh) {
  const int R = W * G, Rpad = (R + RT - 1) / RT * RT;
  return static_cast<long long>(smem_bytes(Rpad, Dh, W));
}

// dtype: 0 = float32, 1 = bfloat16 (q and k).  ml is (B, Hkv, W*G, 2) fp32
// scratch, out is (B, Hkv, T) fp32.  Returns cudaGetLastError() after the
// two launches (0 = both launched).
int snapkv_scores_launch(const void* q, const void* k, const int* obs_pos, const int* k_pos,
                         float* ml, float* out, int B, int W, int Hq, int Hkv, int T_len,
                         int Dh, float attn_cap, int dtype, void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || Hq % Hkv != 0 || T_len < 1 || Dh < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, obs_pos, k_pos, ml, out, B, W, Hq, Hkv, T_len, Dh, attn_cap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, obs_pos, k_pos, ml, out, B, W, Hq, Hkv, T_len, Dh,
                                 attn_cap, st);
  return cudaErrorInvalidValue;
}

const char* snapkv_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
