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
// tensor cores, not its HBM, would be the limit.  Two things kept the
// first version far from that bound: each warp had one K/V row load in
// flight (3.35 TB/s x ~0.8 us of latency needs ~2.7 MB in flight, it had
// ~0.26 MB), and each entry's online-softmax step waited on its own dot
// product, shuffle tree and two expf.  The design:
//   - bytes moved = retained bytes: a (slot, row) of length 0 writes zeros
//     and exits, the others read exactly `len` entries (the quantity FairKV
//     balances across shards);
//   - K and V reach shared memory through 16-byte cp.async copies, in
//     stages of 32 entries, through a ring of 5 stages, so each block has
//     four stages (64 KB at bf16, Dh = 128) in flight while it works on
//     the fifth; the ring's 80 KB also keep an SM at two blocks, which
//     spreads the long (slot, row) pairs over more SMs;
//   - head dims up to 128, and 256: a lane owns J = 4 elements of a row
//     up to Dh = 128 (a FULL variant for 128 folds the lane guards away)
//     and J = 8 at Dh = 256 (FULL only: ptxas spilled the generic-Dh
//     variants of J = 8, and no configuration has a head dim between).
//     At J = 8 a stage holds 16 entries, so a stage's bytes, the ring's
//     80 KB (bf16) and the two blocks per SM stay those of Dh = 128, and a
//     warp scores 4 entries per batch, so its key registers (NB x J
//     floats) stay 32 (160 KB of ring at fp32: one block per SM);
//   - G blocks per (slot, row), 8 warps each, so every warp carries exactly
//     one (column class, head) chain: 128 (slot, row) pairs give 512 blocks
//     at G = 4.  A G that does not divide 8 (5 and 7) splits the classes
//     as G = 8 does, one class per block, and the warps of heads G .. 7
//     load no q and write no state: the K/V stream, the whole cost, is
//     that of G = 8, and each live head's chain is unchanged.  Each block
//     writes its partial softmax states to scratch;
//     the last block of the pair to finish (a per-pair atomic counter after
//     __threadfence, reset for the next launch) merges them, so one launch
//     suffices;
//   - the kernel is bound by instruction issue once the bytes arrive in
//     time, so a warp takes its entries in batches of 8: first the 8 dot
//     products, whose 8 xor trees share their shuffles (warp_sum_batch),
//     then the running max over the batch, then all 16 expf at once, then
//     the sequential (l, acc) updates, which are single fma chains; the
//     control flow around the shuffles is block-uniform, so the compiler
//     puts no convergence barrier between them;
//   - nothing waits on a global load inside a loop: q is read into
//     registers while the first stage is in flight, and the merge reads the
//     8 classes' states of an output element with independent loads;
//   - every (slot, row, head) gets the same floating-point operations in
//     the same order as in the paged kernel (paged_fairkv_decode.cu), so the
//     two agree bitwise on the same cache contents: column class c mod 8 is
//     one online-softmax chain (entries in increasing c; lane d = lane +
//     32 j partial dot products, the xor-shuffle tree, * scale, softcap,
//     then mn = fmaxf(m, s), corr = expf(m - mn), p = expf(s - mn),
//     l = l*corr + p, acc = acc*corr + p*v), and the 8 classes merge in
//     order 0..7 with the paged kernel's formula.  Splitting moves whole
//     chains to other warps and blocks; batching reorders independent
//     instructions, the shared shuffle trees add the same pairs, and an
//     entry that is not applied becomes an exact no-op update; none of
//     these changes a value.
//
// The partial variant (template flag PARTIAL, entry point
// fairkv_decode_partial_launch) is split-S decode's kernel: the cache's
// columns are split over ranks, each rank runs this kernel on its shard,
// and the ranks' results merge outside it (merge_partials in
// src/repro_torch/kernels/ref.py).  It is the same kernel up to the last
// store: the same chains and the same 8-class merge, which then writes the
// normalised fp32 output o (not rounded to q's dtype) and the pair's
// log-sum-exp lse = mx + log(lsum) per head, fp32; a (slot, row) with no
// valid entry writes o = 0 and lse = -inf.  PARTIAL is a template flag so
// that the full-output instantiations compile exactly as before.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int MAXJ = 8;   // Dh = 256: lane owns d = lane + 32 * j, j < J <= MAXJ
constexpr int NCLS = 8;   // column classes c mod 8
constexpr int NST = 5;    // ring stages
constexpr float NEG_INF = -1e30f;
// per lane width J (4: Dh <= 128, 8: Dh = 256): block entries per ring
// stage (a stage is 32 x 128 elements of K and of V either way), and
// entries a warp scores before it updates its state (NB x J key registers)
template <int J> __host__ __device__ constexpr int stage_entries() { return 128 / J; }
template <int J> __host__ __device__ constexpr int batch_entries() { return 32 / J; }
// the group a G splits the column classes as: G itself when it divides 8,
// else 8 with heads G .. 7 masked (G = 5: hymba-1.5b, 7: llava-next-34b)
__host__ __device__ constexpr int padded_group(int G) { return G <= 2 ? G : (G <= 4 ? 4 : 8); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// warp_sum of N partial sums at once (N a power of two, at most 8), with
// the same additions as N separate xor trees: at each offset o a lane adds
// its partner's value to its own (a + b = b + a, so both lanes of a pair
// hold the same bits), but while several entries are left each lane keeps
// only half of them and trades the other half; then every entry's sum is
// broadcast from a lane that holds it: 2 N + 4 - log2(N) shuffles (17 at
// N = 8) where separate trees take 5 N (40).
template <int N>
__device__ __forceinline__ void warp_sum_batch(float (&x)[N]) {
  const int lane = threadIdx.x & 31;
  float v[N];
#pragma unroll
  for (int u = 0; u < N; ++u) v[u] = x[u];
#pragma unroll
  for (int o = 16, n = N; o > 0; o >>= 1) {
    if (n > 1) {
      const int h = n / 2;
      const bool hi = lane & o;
#pragma unroll
      for (int u = 0; u < h; ++u) {
        const float keep = hi ? v[u + h] : v[u];
        const float give = hi ? v[u] : v[u + h];
        v[u] = keep + __shfl_xor_sync(0xffffffffu, give, o);
      }
      n = h;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  // entry u is held by the lanes whose bits 4, 3, ... spell u's bits
  // from the highest down
#pragma unroll
  for (int u = 0; u < N; ++u) {
    int src = 0;
#pragma unroll
    for (int o = 16, n = N; n > 1; o >>= 1, n >>= 1)
      if (u & (n >> 1)) src |= o;
    x[u] = __shfl_sync(0xffffffffu, v[0], src);
  }
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// dynamic shared memory: merge (m, l) | flag | ring
struct Layout {
  size_t flag, region, total;
};
template <typename T, int J>
__host__ __device__ inline Layout layout(int G, int Dh) {
  Layout s;
  s.flag = align16(static_cast<size_t>(NCLS) * G * 2 * sizeof(float));
  s.region = s.flag + 16;
  s.total = s.region + static_cast<size_t>(NST) * 2 * stage_entries<J>() * Dh * sizeof(T);
  return s;
}

// copy ring stage `st` (block entries st*ES ..) of the block's classes into
// ring slot `slot`: block entry e is column ((e >> LCPB) << 3) + cls0 +
// (e & (2^LCPB - 1)) of the pair; columns at or past len are not copied
template <typename T, int LCPB, int ES>
__device__ __forceinline__ void issue_stage(T* ring, const T* __restrict__ kb,
                                            const T* __restrict__ vb, int st, int slot,
                                            int cls0, int len, int Dh, bool vec) {
  T* ks = ring + static_cast<size_t>(slot) * 2 * ES * Dh;
  T* vs = ks + ES * Dh;
  const int e0 = st * ES;
  constexpr int cmask = (1 << LCPB) - 1;
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
    const int cpr = Dh / EPC;            // chunks per row
    const int n = ES * cpr;
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
      const bool isv = i >= n;
      const int ii = isv ? i - n : i;
      const int le = ii / cpr, ch = ii - le * cpr;
      const int e = e0 + le;
      const int c = ((e >> LCPB) << 3) + cls0 + (e & cmask);
      if (c < len)
        hk::cp_async16((isv ? vs : ks) + le * Dh + ch * EPC,
                       (isv ? vb : kb) + static_cast<size_t>(c) * Dh + ch * EPC);
    }
  } else {  // rows not 16-byte aligned: plain loads (visible after the next barrier)
    for (int i = threadIdx.x; i < ES * Dh; i += blockDim.x) {
      const int le = i / Dh, d = i - le * Dh;
      const int e = e0 + le;
      const int c = ((e >> LCPB) << 3) + cls0 + (e & cmask);
      if (c < len) {
        ks[i] = kb[static_cast<size_t>(c) * Dh + d];
        vs[i] = vb[static_cast<size_t>(c) * Dh + d];
      }
    }
  }
}

template <typename T, int G, int J, bool FULL, bool PARTIAL>
__global__ void __launch_bounds__(NWARPS * 32)
fairkv_decode_kernel(const T* __restrict__ q,          // (B, S, G, Dh)
                     const T* __restrict__ k,          // (S, B, C, Dh)
                     const T* __restrict__ v,          // (S, B, C, Dh)
                     const int* __restrict__ lengths,  // (S, B)
                     const int* __restrict__ k_pos,    // (S, B, C) or null
                     const int* __restrict__ q_pos,    // (B,) or null
                     T* __restrict__ out,              // (B, S, G, Dh); null if PARTIAL
                     float* __restrict__ part_o,       // PARTIAL: (B, S, G, Dh) fp32
                     float* __restrict__ part_lse,     // PARTIAL: (B, S, G) fp32
                     float* __restrict__ acc_scr,      // (S*B, NCLS, G, Dh)
                     float* __restrict__ ml_scr,       // (S*B, NCLS, G, 2)
                     int* __restrict__ counters,       // (S*B,), zero between launches
                     int B, int S, int C, int Dh_in,
                     float scale, float attn_cap, int window, int vec) {
  // GP blocks per (slot, row); block `part` takes classes cls0 .. cls0 +
  // CPB - 1, and warp w the chain (class cls0 + w % CPB, head w / CPB);
  // heads G .. GP - 1 of a padded group are masked (no q load, no state)
  constexpr int GP = padded_group(G);
  constexpr int CPB = NCLS / GP;
  constexpr int LCPB = GP == 1 ? 3 : (GP == 2 ? 2 : (GP == 4 ? 1 : 0));
  constexpr int ES = stage_entries<J>();
  constexpr int NB = batch_entries<J>();
  constexpr int PER = ES / CPB;           // a chain's entries in one stage
  constexpr int NBU = PER < NB ? PER : NB;
  const int Dh = FULL ? 32 * J : Dh_in;  // FULL: Dh = 32 J, the lane guards fold away
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = blockIdx.x;  // s * B + b
  const int part = blockIdx.y;
  const int s = sb / B;
  const int b = sb - s * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lengths[sb];
  const size_t qo = (static_cast<size_t>(b) * S + s) * G * Dh;
  T* o = out + qo;
  float* po = PARTIAL ? part_o + qo : nullptr;
  float* plse = PARTIAL ? part_lse + (static_cast<size_t>(b) * S + s) * G : nullptr;
  if (len <= 0) {  // unowned (slot, row): exact zeros, no K/V traffic
    if (part == 0) {
      if constexpr (PARTIAL) {
        for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) po[i] = 0.f;
        for (int i = threadIdx.x; i < G; i += blockDim.x) plse[i] = neg_inf();
      } else {
        for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) store(o + i, 0.f);
      }
    }
    return;
  }
  const int cls0 = part * CPB;
  const int lw = warp % CPB;
  const int cls = cls0 + lw;
  const int g = warp / CPB;
  const bool live = g < G;  // a masked head's warp streams K/V with the block

  const Layout L = layout<T, J>(G, Dh);
  float* ml_s = reinterpret_cast<float*>(smem);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  T* ring = reinterpret_cast<T*>(smem + L.region);

  const size_t row0 = static_cast<size_t>(sb) * C;
  const T* kb = k + row0 * Dh;
  const T* vb = v + row0 * Dh;
  const int ngroups = (len + NCLS - 1) / NCLS;
  const int ntiles = (ngroups * CPB + ES - 1) / ES;
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < ntiles) issue_stage<T, LCPB, ES>(ring, kb, vb, st, st, cls0, len, Dh, vec != 0);
    hk::cp_async_commit();
  }
  float qv[J];  // this warp's query head (its loads overlap the first stage's)
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int d = lane + 32 * j;
    qv[j] = live && d < Dh ? to_f(q[qo + g * Dh + d]) : 0.f;
  }
  float m = NEG_INF, l = 0.f, acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;
  const int qp = window > 0 ? q_pos[b] : 0;

  // The control flow around the shuffles depends only on block-uniform
  // values (t, ntiles), so the compiler needs no convergence barriers there
  // and can interleave a batch's dot products and shuffle trees; entries
  // past len or masked are scored but not applied.
  for (int t = 0; t < ntiles; ++t) {
    hk::cp_async_wait<NST - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; stage t-1 consumed
    if (t + NST - 1 < ntiles)
      issue_stage<T, LCPB, ES>(ring, kb, vb, t + NST - 1, (t + NST - 1) % NST, cls0, len, Dh,
                               vec != 0);
    hk::cp_async_commit();
    const T* ks = ring + static_cast<size_t>(t % NST) * 2 * ES * Dh;
    const T* vs = ks + ES * Dh;
    const int gbase = t * PER;  // group (c / 8) of the stage's first entry
#pragma unroll 1
    for (int i0 = 0; i0 < PER; i0 += NBU) {
      // scores of the batch (the paged kernel's expressions), in
      // straight-line stages so the 8 entries' loads, products and shuffle
      // trees interleave
      float kr[NBU][J], sc[NBU];
#pragma unroll
      for (int u = 0; u < NBU; ++u) {
        const int le = ((i0 + u) << LCPB) + lw;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int d = lane + 32 * j;
          kr[u][j] = d < Dh ? to_f(ks[le * Dh + d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < NBU; ++u) {
        float part_sum = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int d = lane + 32 * j;
          if (d < Dh) part_sum += qv[j] * kr[u][j];
        }
        sc[u] = part_sum;
      }
      warp_sum_batch(sc);
#pragma unroll
      for (int u = 0; u < NBU; ++u) sc[u] *= scale;
      if (attn_cap > 0.f) {
#pragma unroll
        for (int u = 0; u < NBU; ++u) sc[u] = attn_cap * tanhf(sc[u] / attn_cap);
      }
      // valid entries: a prefix of the batch (c < len), minus the window
      const int c0 = ((gbase + i0) << 3) + cls;
      const int nv = min(max((len - c0 + NCLS - 1) / NCLS, 0), NBU);
      unsigned vm = (1u << nv) - 1u;
      if (window > 0) {
#pragma unroll
        for (int u = 0; u < NBU; ++u)
          if (u < nv && !(k_pos[row0 + c0 + NCLS * u] > qp - window)) vm &= ~(1u << u);
      }
      // the running max through the batch, then every expf at once, then
      // the (l, acc) updates in entry order
      float mprev[NBU], mnew[NBU];
#pragma unroll
      for (int u = 0; u < NBU; ++u) {
        mprev[u] = m;
        if (vm >> u & 1u) m = fmaxf(m, sc[u]);
        mnew[u] = m;
      }
      // an entry that is not applied gets corr = 1, p = +0 and v = -0: then
      // l*1 + 0 = l (l is never -0) and acc*1 + (+0)(-0) = acc + (-0) = acc
      // for every acc, so the updates need no branch and the compiler
      // computes all 16 expf first; a full batch skips the selects
      float corr[NBU], p[NBU];
#pragma unroll
      for (int u = 0; u < NBU; ++u) {
        corr[u] = expf(mprev[u] - mnew[u]);
        p[u] = expf(sc[u] - mnew[u]);
      }
      if (vm == (1u << NBU) - 1u) {
#pragma unroll
        for (int u = 0; u < NBU; ++u) {
          const int le = ((i0 + u) << LCPB) + lw;
          float vr[J];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int d = lane + 32 * j;
            vr[j] = d < Dh ? to_f(vs[le * Dh + d]) : 0.f;
          }
          l = l * corr[u] + p[u];
#pragma unroll
          for (int j = 0; j < J; ++j) acc[j] = acc[j] * corr[u] + p[u] * vr[j];
        }
      } else {
#pragma unroll
        for (int u = 0; u < NBU; ++u) {
          const bool ok = vm >> u & 1u;
          const int le = ((i0 + u) << LCPB) + lw;
          const float cu = ok ? corr[u] : 1.f;
          const float pu = ok ? p[u] : 0.f;
          float vr[J];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int d = lane + 32 * j;
            vr[j] = !ok ? -0.f : (d < Dh ? to_f(vs[le * Dh + d]) : 0.f);
          }
          l = l * cu + pu;
#pragma unroll
          for (int j = 0; j < J; ++j) acc[j] = acc[j] * cu + pu * vr[j];
        }
      }
    }
  }
  hk::cp_async_wait_all();

  // every block writes its chains' states to scratch; the pair's last block
  // (all of them at G = 1) merges from there
  float* acc_dst = acc_scr + static_cast<size_t>(sb) * NCLS * G * Dh;
  float* ml_dst = ml_scr + static_cast<size_t>(sb) * NCLS * G * 2;
  if (live) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int d = lane + 32 * j;
      if (d < Dh) acc_dst[(cls * G + g) * Dh + d] = acc[j];
    }
    if (lane == 0) {
      ml_dst[(cls * G + g) * 2] = m;
      ml_dst[(cls * G + g) * 2 + 1] = l;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counters + sb, 1) == GP - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (threadIdx.x == 0) counters[sb] = 0;  // ready for the next launch
  for (int i = threadIdx.x; i < NCLS * G * 2; i += blockDim.x) ml_s[i] = __ldcg(ml_dst + i);
  __syncthreads();

  // merge the 8 classes in order (the paged kernel's formula)
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    const int gi = i / Dh;
    float mx = NEG_INF;
    for (int w = 0; w < NCLS; ++w) mx = fmaxf(mx, ml_s[(w * G + gi) * 2]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < NCLS; ++w) {
      // a class that saw no valid entry has l = 0 and acc = 0: no weight
      const float f = expf(ml_s[(w * G + gi) * 2] - mx);
      lsum += ml_s[(w * G + gi) * 2 + 1] * f;
      a += __ldcg(acc_dst + w * G * Dh + i) * f;
    }
    if constexpr (PARTIAL) {
      po[i] = lsum > 0.f ? a / lsum : 0.f;
    } else {
      store(o + i, lsum > 0.f ? a / lsum : 0.f);
    }
  }
  // each head's log-sum-exp, from the same (m, l) states; the loops stay
  // rolled (unrolled, ptxas spilled the G = 4, Dh < 128 instantiations)
  if constexpr (PARTIAL) {
    for (int gi = threadIdx.x; gi < G; gi += blockDim.x) {
      float mx = NEG_INF;
#pragma unroll 1
      for (int w = 0; w < NCLS; ++w) mx = fmaxf(mx, ml_s[(w * G + gi) * 2]);
      float lsum = 0.f;
#pragma unroll 1
      for (int w = 0; w < NCLS; ++w)
        lsum += ml_s[(w * G + gi) * 2 + 1] * expf(ml_s[(w * G + gi) * 2] - mx);
      plse[gi] = lsum > 0.f ? mx + logf(lsum) : neg_inf();
    }
  }
}

struct Args {
  const void* q; const void* k; const void* v; const int* lengths; const int* k_pos;
  const int* q_pos; void* out; float* part_o; float* part_lse; float* scratch; int* counters;
  int B, S, C, Dh; float attn_cap; int window;
};

template <typename T, int G, int J, bool FULL, bool PARTIAL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = fairkv_decode_kernel<T, G, J, FULL, PARTIAL>;
  static bool opted_in = false;  // the ring needs more than the 48 KB default
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(layout<T, J>(G, 32 * J).total));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(a.Dh));
  const int vec = (a.Dh * static_cast<int>(sizeof(T))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  float* ml_scr = a.scratch + static_cast<size_t>(a.S) * a.B * NCLS * G * a.Dh;
  const dim3 grid(a.S * a.B, padded_group(G));
  kernel<<<grid, NWARPS * 32, layout<T, J>(G, a.Dh).total, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lengths, a.k_pos, a.q_pos, static_cast<T*>(a.out), a.part_o, a.part_lse, a.scratch,
      ml_scr, a.counters,
      a.B, a.S, a.C, a.Dh, scale, a.attn_cap, a.window, vec);
  return cudaGetLastError();
}

template <typename T, int J, bool FULL, bool PARTIAL>
cudaError_t dispatch_j(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, 1, J, FULL, PARTIAL>(a, st);
    case 2: return launch<T, 2, J, FULL, PARTIAL>(a, st);
    case 4: return launch<T, 4, J, FULL, PARTIAL>(a, st);
    case 5: return launch<T, 5, J, FULL, PARTIAL>(a, st);
    case 7: return launch<T, 7, J, FULL, PARTIAL>(a, st);
    case 8: return launch<T, 8, J, FULL, PARTIAL>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// Dh = 256: J = 8; Dh = 128: J = 4, FULL; below: J = 4 with lane guards
template <typename T, bool PARTIAL>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t st) {
  if (a.Dh == 256) return dispatch_j<T, 8, true, PARTIAL>(G, a, st);
  return a.Dh == 128 ? dispatch_j<T, 4, true, PARTIAL>(G, a, st)
                     : dispatch_j<T, 4, false, PARTIAL>(G, a, st);
}

template <bool PARTIAL>
int dispatch(const Args& a, int G, int dtype, void* stream) {
  if (a.Dh < 1 || (a.Dh > 128 && a.Dh != 32 * MAXJ) || a.B < 1 || a.S < 1 || a.C < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_g<float, PARTIAL>(G, a, st);
  if (dtype == 1) return dispatch_g<__nv_bfloat16, PARTIAL>(G, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// fp32 scratch (floats) one launch needs: each (slot, row)'s 8 class
// states, (acc, m, l) per head
long long fairkv_decode_scratch_floats(int B, int S, int G, int Dh) {
  return static_cast<long long>(S) * B * NCLS * G * (Dh + 2);
}

// dtype: 0 = float32, 1 = bfloat16.  k_pos / q_pos are read only when
// window > 0.  scratch holds fairkv_decode_scratch_floats floats; counters
// holds S*B ints that are 0 before the launch (the launch leaves them 0).
// Returns cudaGetLastError() after the launch (0 = launched).
int fairkv_decode_launch(const void* q, const void* k, const void* v,
                         const int* lengths, const int* k_pos, const int* q_pos,
                         void* out, float* scratch, int* counters,
                         int B, int S, int G, int C, int Dh,
                         float attn_cap, int window, int dtype, void* stream) {
  const Args a{q, k, v, lengths, k_pos, q_pos, out, nullptr, nullptr, scratch, counters,
               B, S, C, Dh, attn_cap, window};
  return dispatch<false>(a, G, dtype, stream);
}

// The partial variant (split-S decode): the same inputs, scratch and
// counters; writes o (B, S, G, Dh) fp32 and lse (B, S, G) fp32 in place of
// out (header comment).
int fairkv_decode_partial_launch(const void* q, const void* k, const void* v,
                                 const int* lengths, const int* k_pos, const int* q_pos,
                                 float* o, float* lse, float* scratch, int* counters,
                                 int B, int S, int G, int C, int Dh,
                                 float attn_cap, int window, int dtype, void* stream) {
  const Args a{q, k, v, lengths, k_pos, q_pos, nullptr, o, lse, scratch, counters,
               B, S, C, Dh, attn_cap, window};
  return dispatch<true>(a, G, dtype, stream);
}

const char* fairkv_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
