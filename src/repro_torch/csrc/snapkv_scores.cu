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
// the ~295 FLOP/byte of the bf16 tensor cores, so with the products on the
// tensor cores reading K bounds it; on the fp32 CUDA cores (67 TFLOP/s)
// the score FLOPs would set a floor six times higher, and one exponential
// per (row, key) in each pass costs about as much as the products.  The
// first version ran the products on the CUDA cores, with one block per
// (b, h) in pass 1 (8 blocks at B = 1) and a staging loop that waited on
// each load.  The softmax over T needs its row statistics before the
// column sums, and blocks on Hopper run in no order (the TPU kernel carried
// (m, l) in scratch from one sequential grid step to the next), so the work
// is two launches over one grid (B*Hkv, nsplit), each block a contiguous
// range of 64-key tiles, nsplit chosen for about two blocks per SM (one
// key tile per block at B = 1, T = 2048):
//   pass 1 (snapkv_kernel<T, false>): each block keeps its rows' running
//       (max m, sum l) over its key range and writes them to scratch
//       (B, Hkv, R, nsplit, 2);
//   pass 2 (snapkv_kernel<T, true>): each block merges its rows' nsplit
//       partials (a fixed shuffle tree, so the result is deterministic),
//       recomputes its score tiles and writes the column sums
//       Σ_r exp(s - m_r) / l_r, reduced with shuffles inside the fragment
//       layout and then across warps through shared memory in a fixed
//       order.
// In both, a block stages a chunk of 128 query rows in shared memory once
// and streams K through a 3-stage ring, all with cp.async copies; two
// blocks fit on an SM (at most 128 registers).  Each of the 8 warps owns
// 16 rows.  bf16 inputs (the main path) form each 16 x 64 score tile on
// the tensor cores with mma.sync.m16n8k16 (bf16 products are exact in fp32
// and summed in fp32), the query fragments held in registers for the whole
// key range and the key fragments read with ldmatrix; fp32 inputs keep
// fp32 products on the CUDA cores (TF32 would lose the fp32 bar), in the
// same fragment layout, so both share the softmax epilogues.  Those work
// in base-2 units (scores times log2 e, one ex2.approx per probability;
// the statistics never leave the kernel), and a masked score becomes
// -1e30, whose ex2 against any finite max is 0.  R > 128 loops over row
// chunks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int TT = 64;        // keys per tile (8 mma n-tiles of 8)
constexpr int RT = 128;       // query rows per chunk (8 warps x 16)
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NST = 3;        // K ring stages
constexpr int MAXKS = 8;      // Dh <= 128: at most 8 k-steps of 16
constexpr int TARGET_BLOCKS = 2 * 132;  // about two blocks per SM
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// padded row length (elements) of the staged q and K tiles: rows start 16
// bytes apart and the fragment reads of 8 rows hit 32 distinct banks
template <typename T>
__host__ __device__ inline int ld_of(int Dh) {
  return sizeof(T) == 2 ? round_up(Dh, 16) + 8 : round_up(Dh, 32) + 4;
}

struct Layout {
  size_t ring, opos, mrow, inv, red, total;
};
// q chunk (RT x ld) | ring NST x (K tile TT x ld, k_pos TT) | obs_pos (W) |
// merged m, 1/l per row (RT each) | column partials (NWARPS x TT)
template <typename T>
__host__ __device__ inline Layout layout(int Dh, int W) {
  const size_t ld = ld_of<T>(Dh);
  Layout s;
  s.ring = align16(RT * ld * sizeof(T));
  const size_t slot = align16(TT * ld * sizeof(T)) + TT * sizeof(int);
  s.opos = s.ring + NST * slot;
  s.mrow = s.opos + align16(static_cast<size_t>(W) * sizeof(int));
  s.inv = s.mrow + RT * sizeof(float);
  s.red = s.inv + RT * sizeof(float);
  s.total = s.red + NWARPS * TT * sizeof(float);
  return s;
}

template <typename T>
__host__ __device__ inline size_t slot_bytes(int Dh) {
  return align16(TT * static_cast<size_t>(ld_of<T>(Dh)) * sizeof(T)) + TT * sizeof(int);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

struct Params {
  int W, Hq, Hkv, T_len, Dh, G, tps, vec;
  float scale, attn_cap;
};

// copy key tile `tile` of (b, h) into ring slot `slot`: K rows (zeros past
// T and in the padding columns) and their positions
template <typename T>
__device__ __forceinline__ void issue_tile(unsigned char* ring, const T* __restrict__ k,
                                           const int* __restrict__ k_pos, int b, int h,
                                           int tile, int slot, const Params& p) {
  const int ld = ld_of<T>(p.Dh);
  unsigned char* base = ring + slot * slot_bytes<T>(p.Dh);
  T* ks = reinterpret_cast<T*>(base);
  int* kps = reinterpret_cast<int*>(base + align16(TT * static_cast<size_t>(ld) * sizeof(T)));
  const int t0 = tile * TT;
  const int DhP = sizeof(T) == 2 ? round_up(p.Dh, 16) : p.Dh;  // mma k-steps read DhP
  if (p.vec) {
    constexpr int EPC = 16 / sizeof(T);
    const int cpr = DhP / EPC;
    auto copy = [&](int key, int col) {
      const int t = t0 + key;
      const bool in = t < p.T_len && col < p.Dh;
      const T* src = in ? k + ((static_cast<size_t>(b) * p.T_len + t) * p.Hkv + h) * p.Dh + col : k;
      hk::cp_async16_zfill(ks + key * ld + col, src, in ? 16 : 0);
    };
    if (NTHREADS % cpr == 0) {  // each thread keeps one chunk column
      const int col = static_cast<int>(threadIdx.x) % cpr * EPC, step = NTHREADS / cpr;
      for (int key = threadIdx.x / cpr; key < TT; key += step) copy(key, col);
    } else {
      for (int i = threadIdx.x; i < TT * cpr; i += blockDim.x)
        copy(i / cpr, i % cpr * EPC);
    }
    for (int i = threadIdx.x; i < TT; i += blockDim.x) {
      const int t = t0 + i;
      const bool in = t < p.T_len;
      if (in)
        hk::cp_async4_zfill(kps + i, k_pos + static_cast<size_t>(b) * p.T_len + t, 4);
      else
        kps[i] = INT_MAX;  // past T: no observation position reaches it
    }
  } else {  // rows not 16-byte aligned: plain loads (visible after the next barrier)
    for (int i = threadIdx.x; i < TT * DhP; i += blockDim.x) {
      const int key = i / DhP, d = i - key * DhP;
      const int t = t0 + key;
      ks[key * ld + d] = t < p.T_len && d < p.Dh
          ? k[((static_cast<size_t>(b) * p.T_len + t) * p.Hkv + h) * p.Dh + d] : zero<T>();
    }
    for (int i = threadIdx.x; i < TT; i += blockDim.x) {
      const int t = t0 + i;
      kps[i] = t < p.T_len ? k_pos[static_cast<size_t>(b) * p.T_len + t] : INT_MAX;
    }
  }
}

// acc[nt][e] += q row (warp*16 + lane/4 + 8*(e/2)) · key (nt*8 + 2*(lane%4) + e%2)
// of the staged chunk and key tile (the mma accumulator layout)
__device__ __forceinline__ void tile_product(float (&acc)[8][4], const uint32_t (&af)[MAXKS][4],
                                             const float* /*q_s*/, const __nv_bfloat16* ks,
                                             int ld, int nks) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lanes 8i .. 8i+7 address the rows of matrix i = (n-tile
  // nt + i/2, k half i%2), which land in the B fragments of two n-tiles
  const int mi = lane >> 3;
  const __nv_bfloat16* kbase = ks + ((mi >> 1) * 8 + (lane & 7)) * ld + (mi & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < MAXKS; ++kk) {
    if (kk >= nks) break;
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bf[4];
      hk::ldmatrix_x4(bf, kbase + nt * 8 * ld + kk * 16);
      hk::mma_bf16_16816(acc[nt], af[kk], bf[0], bf[1]);
      hk::mma_bf16_16816(acc[nt + 1], af[kk], bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ void tile_product(float (&acc)[8][4], const uint32_t (&)[MAXKS][4],
                                             const float* q_s, const float* ks, int ld, int Dh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const float* qa = q_s + (warp * 16 + gid) * ld;
  const float* qb = qa + 8 * ld;
  const float* kr = ks + (tig * 2) * ld;
#pragma unroll 2
  for (int d = 0; d < Dh; ++d) {
    const float a = qa[d], c = qb[d];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float k0 = kr[(nt * 8) * ld + d], k1 = kr[(nt * 8 + 1) * ld + d];
      acc[nt][0] += a * k0;
      acc[nt][1] += a * k1;
      acc[nt][2] += c * k0;
      acc[nt][3] += c * k1;
    }
  }
}

template <typename T, bool EMIT>
__global__ void __launch_bounds__(NTHREADS, 2)
snapkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const int* __restrict__ obs_pos, const int* __restrict__ k_pos,
              float* __restrict__ part,  // (B*Hkv, R, nsplit, 2): written, then read
              float* __restrict__ out,   // (B*Hkv, T) (emit)
              Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int R = p.W * p.G;
  const int ntiles = (p.T_len + TT - 1) / TT;
  const int tile0 = split * p.tps;
  const int tile1 = min(tile0 + p.tps, ntiles);
  const int ld = ld_of<T>(p.Dh);
  const Layout L = layout<T>(p.Dh, p.W);
  T* q_s = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + L.ring;
  int* opos_s = reinterpret_cast<int*>(smem + L.opos);
  float* mrow_s = reinterpret_cast<float*>(smem + L.mrow);
  float* inv_s = reinterpret_cast<float*>(smem + L.inv);
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int DhP = sizeof(T) == 2 ? round_up(p.Dh, 16) : p.Dh;

  for (int i = threadIdx.x; i < p.W; i += blockDim.x) opos_s[i] = obs_pos[b * p.W + i];
  for (int r0 = 0; r0 < R; r0 += RT) {
    __syncthreads();  // the previous chunk is done with q_s, the ring and red_s
    // stage the chunk's query rows (zeros past R and in the padding): the
    // oldest cp.async group, then the first key tiles
    {
      const int epc = p.vec ? 16 / static_cast<int>(sizeof(T)) : 1;  // elements per copy
      const int cpr = DhP / epc;
      auto stage = [&](int rr, int d) {
        const int r = r0 + rr;
        const bool in = r < R && d < p.Dh;
        const T* src = q;
        if (in) {
          const int w = r / p.G, g = r - w * p.G;
          src = q + ((static_cast<size_t>(b) * p.W + w) * p.Hq + h * p.G + g) * p.Dh + d;
        }
        if (p.vec)
          hk::cp_async16_zfill(q_s + rr * ld + d, src, in ? 16 : 0);
        else
          q_s[rr * ld + d] = in ? *src : zero<T>();
      };
      if (NTHREADS % cpr == 0) {  // each thread keeps one chunk column
        const int d = static_cast<int>(threadIdx.x) % cpr * epc, step = NTHREADS / cpr;
        for (int rr = threadIdx.x / cpr; rr < RT; rr += step) stage(rr, d);
      } else {
        for (int i = threadIdx.x; i < RT * cpr; i += blockDim.x) stage(i / cpr, i % cpr * epc);
      }
    }
    hk::cp_async_commit();
#pragma unroll
    for (int st = 0; st < NST - 1; ++st) {
      if (tile0 + st < tile1) issue_tile(ring, k, k_pos, b, h, tile0 + st, st, p);
      hk::cp_async_commit();
    }
    if (EMIT) {
      // merge the rows' nsplit partials: warp w takes rows w*16 .. w*16+15,
      // lane s splits s, s+32, ...; max then rescaled sum, each reduced by
      // a fixed shuffle tree (deterministic)
      const float* prow = part + (static_cast<size_t>(bh) * R + r0 + warp * 16) * nsplit * 2;
      float mx[16], sm[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) { mx[i] = NEG_INF; sm[i] = 0.f; }
      for (int s2 = lane; s2 < nsplit; s2 += 32)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (r0 + warp * 16 + i < R) mx[i] = fmaxf(mx[i], prow[(i * nsplit + s2) * 2]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
      for (int s2 = lane; s2 < nsplit; s2 += 32)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (r0 + warp * 16 + i < R) {
            const float* ps = prow + (i * nsplit + s2) * 2;
            sm[i] += ps[1] * hk::ex2(ps[0] - mx[i]);
          }
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sm[i] += __shfl_xor_sync(0xffffffffu, sm[i], o);
      if (lane < 16) {
        float m = NEG_INF, l = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (i == lane) { m = mx[i]; l = sm[i]; }
        mrow_s[warp * 16 + lane] = m;
        inv_s[warp * 16 + lane] = l > 0.f ? 1.f / l : 0.f;
      }
    }
    hk::cp_async_wait<NST - 1>();  // the query rows have landed
    __syncthreads();

    const int ra = r0 + warp * 16 + gid, rb = ra + 8;  // this thread's two rows
    // rows past R see no key
    const int opa = ra < R ? opos_s[ra / p.G] : INT_MIN;
    const int opb = rb < R ? opos_s[rb / p.G] : INT_MIN;
    uint32_t af[MAXKS][4];
    if constexpr (sizeof(T) == 2) {  // query fragments stay in registers
#pragma unroll
      for (int kk = 0; kk < MAXKS; ++kk) {
        if (kk * 16 >= DhP) break;
        const T* qa = q_s + (warp * 16 + gid) * ld + kk * 16 + tig * 2;
        af[kk][0] = *reinterpret_cast<const uint32_t*>(qa);
        af[kk][1] = *reinterpret_cast<const uint32_t*>(qa + 8 * ld);
        af[kk][2] = *reinterpret_cast<const uint32_t*>(qa + 8);
        af[kk][3] = *reinterpret_cast<const uint32_t*>(qa + 8 * ld + 8);
      }
    }
    float ma = NEG_INF, la = 0.f, mb = NEG_INF, lb = 0.f;  // pass 1 row state
    float mra = 0.f, iva = 0.f, mrb = 0.f, ivb = 0.f;      // emit: merged row stats
    if (EMIT) {
      mra = mrow_s[warp * 16 + gid];
      iva = inv_s[warp * 16 + gid];
      mrb = mrow_s[warp * 16 + gid + 8];
      ivb = inv_s[warp * 16 + gid + 8];
    }

    for (int t = tile0; t < tile1; ++t) {
      hk::cp_async_wait<NST - 2>();
      __syncthreads();  // tile t landed for every thread; tile t-1 consumed
      if (t + NST - 1 < tile1) issue_tile(ring, k, k_pos, b, h, t + NST - 1,
                                          (t - tile0 + NST - 1) % NST, p);
      hk::cp_async_commit();
      const unsigned char* base = ring + ((t - tile0) % NST) * slot_bytes<T>(p.Dh);
      const T* ks = reinterpret_cast<const T*>(base);
      const int* kps = reinterpret_cast<const int*>(
          base + align16(TT * static_cast<size_t>(ld) * sizeof(T)));
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      // every warp runs the product (rows past R are zeros and masked
      // below): a warp-dependent branch around mma.sync would make the
      // compiler wrap it in convergence barriers
      if constexpr (sizeof(T) == 2)
        tile_product(acc, af, nullptr, ks, ld, DhP / 16);
      else
        tile_product(acc, af, q_s, ks, ld, p.Dh);
      // scale and cap, in base-2 units (one ex2 per probability); a masked
      // score becomes NEG_INF, whose ex2 against any finite max is 0
      int kp[8][2];  // positions of this thread's 16 keys (INT_MAX past T)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        kp[nt][0] = kps[nt * 8 + tig * 2];
        kp[nt][1] = kps[nt * 8 + tig * 2 + 1];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = acc[nt][e] * p.scale;
          if (p.attn_cap > 0.f) x = p.attn_cap * tanhf(x / p.attn_cap);
          acc[nt][e] = kp[nt][e & 1] <= (e < 2 ? opa : opb) ? x * LOG2E : NEG_INF;
        }
      if (!EMIT) {  // online (m, l) of rows ra, rb over this tile
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float tmax = NEG_INF;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            tmax = fmaxf(tmax, fmaxf(acc[nt][2 * half], acc[nt][2 * half + 1]));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          float& m = half ? mb : ma;
          float& l = half ? lb : la;
          const float mn = fmaxf(m, tmax);
          float psum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            psum += hk::ex2(acc[nt][2 * half] - mn) + hk::ex2(acc[nt][2 * half + 1] - mn);
          psum += __shfl_xor_sync(0xffffffffu, psum, 1);
          psum += __shfl_xor_sync(0xffffffffu, psum, 2);
          // no valid score yet: every term above was ex2(0) of two NEG_INFs
          if (mn == NEG_INF) psum = 0.f;
          l = l * hk::ex2(m - mn) + psum;
          m = mn;
        }
      } else {  // column sums of this tile over the chunk's rows
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // a row with no valid score at all has inv = 0
            float c = hk::ex2(acc[nt][e] - mra) * iva + hk::ex2(acc[nt][e + 2] - mrb) * ivb;
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
            if (gid == 0) red_s[warp * TT + nt * 8 + tig * 2 + e] = c;
          }
        __syncthreads();
        if (threadIdx.x < TT) {
          const int tt = t * TT + threadIdx.x;
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < NWARPS; ++w) sum += red_s[w * TT + threadIdx.x];
          if (tt < p.T_len) {
            float* dst = out + static_cast<size_t>(bh) * p.T_len + tt;
            *dst = r0 == 0 ? sum : *dst + sum;  // this thread wrote it for chunk r0 - RT
          }
        }
      }
    }
    hk::cp_async_wait_all();
    if (!EMIT && tig == 0) {
      float* pr = part + (static_cast<size_t>(bh) * R * nsplit + split) * 2;
      if (ra < R) { pr[ra * nsplit * 2] = ma; pr[ra * nsplit * 2 + 1] = la; }
      if (rb < R) { pr[rb * nsplit * 2] = mb; pr[rb * nsplit * 2 + 1] = lb; }
    }
  }
}

// key tiles per block (tps) and blocks per (b, h) (splits): about
// TARGET_BLOCKS blocks in all, at least one tile each, no empty split
inline void split_plan(int B, int Hkv, int T_len, int* tps, int* splits) {
  const int ntiles = (T_len + TT - 1) / TT;
  int want = TARGET_BLOCKS / (B * Hkv);
  want = want < 1 ? 1 : (want > ntiles ? ntiles : want);
  *tps = (ntiles + want - 1) / want;
  *splits = (ntiles + *tps - 1) / *tps;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const int* obs_pos, const int* k_pos,
                   float* part, float* out, int B, int W, int Hq, int Hkv, int T_len,
                   int Dh, float attn_cap, cudaStream_t st) {
  int tps, splits;
  split_plan(B, Hkv, T_len, &tps, &splits);
  const size_t smem = layout<T>(Dh, W).total;
  const int vec = (Dh * static_cast<int>(sizeof(T))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const Params p{W, Hq, Hkv, T_len, Dh, Hq / Hkv, tps, vec,
                 1.0f / sqrtf(static_cast<float>(Dh)), attn_cap};
  cudaError_t e = cudaFuncSetAttribute(snapkv_kernel<T, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(snapkv_kernel<T, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const dim3 grid(B * Hkv, splits);
  snapkv_kernel<T, false><<<grid, NTHREADS, smem, st>>>(qt, kt, obs_pos, k_pos, part, out, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  snapkv_kernel<T, true><<<grid, NTHREADS, smem, st>>>(qt, kt, obs_pos, k_pos, part, out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Key-range splits of both passes (the grid's second dimension).
int snapkv_scores_splits(int B, int Hkv, int T_len) {
  int tps, splits;
  split_plan(B, Hkv, T_len, &tps, &splits);
  return splits;
}

// Dynamic shared memory one block of either pass needs (bytes).
long long snapkv_scores_smem_bytes(int W, int Dh, int dtype) {
  return static_cast<long long>(dtype == 0 ? layout<float>(Dh, W).total
                                           : layout<__nv_bfloat16>(Dh, W).total);
}

// dtype: 0 = float32, 1 = bfloat16 (q and k).  part is fp32 scratch of
// (B, Hkv, W*G, snapkv_scores_splits(B, Hkv, T), 2); out is (B, Hkv, T)
// fp32.  Returns cudaGetLastError() after the two launches (0 = both
// launched).
int snapkv_scores_launch(const void* q, const void* k, const int* obs_pos, const int* k_pos,
                         float* part, float* out, int B, int W, int Hq, int Hkv, int T_len,
                         int Dh, float attn_cap, int dtype, void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || Hq % Hkv != 0 || T_len < 1 || Dh < 1 || Dh > 16 * MAXKS)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, obs_pos, k_pos, part, out, B, W, Hq, Hkv, T_len, Dh, attn_cap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, obs_pos, k_pos, part, out, B, W, Hq, Hkv, T_len, Dh,
                                 attn_cap, st);
  return cudaErrorInvalidValue;
}

const char* snapkv_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
