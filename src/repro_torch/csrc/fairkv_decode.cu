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
// tensor cores, not its HBM, would be the limit.  Reaching that bound takes
// enough bytes in flight (3.35 TB/s x ~0.8 us of latency is ~2.7 MB) spread
// over enough SMs, and an issue rate that keeps up once they arrive.  The
// design:
//   - bytes moved = retained bytes: a (slot, row) of length 0 writes zeros
//     and exits, the others read exactly the `len` entries the window keeps
//     (the quantity FairKV balances across shards);
//   - K and V reach shared memory through 16-byte cp.async copies, in
//     stages of 32 entries (64 at Dh = 64) through a ring of 5 stages (3
//     at Dh = 256), so each block has 64 KB (bf16) in flight while it
//     works on the next stage; the ring's 80 KB (96 KB at Dh = 256) keep
//     an SM at two blocks;
//   - a (slot, row)'s columns split into segments of SEG = 4096 columns,
//     fixed boundaries that depend on the column index alone (never on B,
//     S, the grid or the SM count, so a pair's result depends on its own
//     contents only: batch-invariant, and graphed equals eager).  The grid
//     is (S*B, padded G, ceil(C / SEG)): the short caches of the main path
//     (C <= 1600) are one segment, and a long context at B 1 (C 131,136:
//     33 segments) fills the card (one block per pair and head group would
//     be 16 blocks on 132 SMs).  A block whose segment starts at or past
//     the pair's length
//     exits at once, writes nothing and is not waited for.  There an H100
//     streams at ~2.9 TB/s while every slot holds a block, and the last
//     wave is what is left (464 working blocks in 264 slots at lengths of
//     100k to 131k);
//   - G blocks per (slot, row) and segment, 8 warps each, so every warp
//     carries exactly one (column class, head) chain of its segment: 128
//     (slot, row) pairs give 512 blocks at G = 4.  A G that does not
//     divide 8 (5 and 7) splits the classes as G = 8 does, one class per
//     block, and the warps of heads G .. 7 load no q, score nothing and
//     write no state: they copy K/V with the block, whose stream is that of
//     G = 8, and each live head's chain is unchanged.  Each block writes
//     its partial softmax states to scratch; the last of a segment's GP
//     blocks to finish (an atomic counter after __threadfence, reset for
//     the next launch) merges the segment's 8 classes, and past one
//     segment the last of the pair's segments merges theirs, so one launch
//     suffices and the final merge reads one state a segment, not eight
//     (one block reading all 8 x 33 states was the tail at C 131,136);
//   - with a window, each block first copies its segment's positions into
//     shared memory (cp.async, 4 bytes an entry), then streams only the
//     stages between the first and the last stage holding an entry the
//     window keeps, and copies no K/V row of an entry it excludes: a
//     segment the window masks entirely moves its positions only (at
//     long_500k's window layers, 4096 of 131,072 columns are kept);
//   - head dims up to 128, and 256: a lane owns J elements of a row,
//     d = lane + 32 j: J = 2 at Dh = 64, J = 4 at Dh = 128 (both FULL: the
//     lane guards fold away) and below 128 (with guards), J = 8 at Dh = 256
//     (FULL only: ptxas spilled the generic-Dh variants of J = 8, and no
//     configuration has a head dim between).  J = 2 at 64 takes the same
//     products in the same order as J = 4 with guards, in half the
//     instructions (the guarded lanes made Dh 64 slower than Dh 128).  A
//     warp scores 8 entries per batch;
//   - the kernel is bound by instruction issue once the bytes arrive in
//     time, so a warp takes its entries in batches: first the dot
//     products, whose xor trees share their shuffles (warp_sum_batch) and
//     leave lane l with entry l % batch alone; that lane computes the
//     entry's softcap (a division and a tanhf) and its two expf once for
//     the warp (on every lane, they are a third of a long-context entry's
//     instructions) and hands them on by shuffles;
//     then the sequential (l, acc) updates, which are single fma chains;
//     the control flow around the shuffles is uniform (block-uniform, but
//     for a masked head's warp, which skips its batches whole), so the
//     compiler puts no convergence barrier between them;
//   - nothing waits on a global load inside a loop: q is read into
//     registers while the first stages are in flight, positions come with
//     the segment before its first stage, and a merge reads the states of
//     an output element with independent loads; its per-head values (the
//     max, each state's weight, the weights' sum) are computed once a head.
//
// The bitwise rule.  Every (slot, row, head) gets the same floating-point
// operations in the same order as in the paged kernel (paged_decode.cuh),
// so the two agree bitwise on the same cache contents: in each segment,
// column class c mod 8 is one online-softmax chain (entries in increasing
// c; lane d = lane + 32 j partial products, the xor-shuffle tree, * scale,
// softcap, then mn = fmaxf(m, s), corr = expf(m - mn), p = expf(s - mn),
// l = l*corr + p, acc = acc*corr + p*v).  A segment's 8 classes merge in
// order 0..7 (mx = their max m, f = expf(m - mx), lsum = sum l f, a = sum
// acc f); one segment's output is a / lsum.  Past one segment, the
// segments below the length merge in order the same way (mx = their max,
// g = expf(mx_s - mx), lsum = lsum_0 g_0 then + lsum_s g_s, a = a_0 g_0
// then + a_s g_s: a first product, which keeps a -0, where an fma onto +0
// would not, so one segment through this path gives its own values).  SEG
// and that merge's term (colseg::fold) are defined once, in
// col_segments.cuh, for both kernels.  The chain is written with rounding
// intrinsics (__fmaf_rn, __fmul_rn, ...), which the compiler never
// contracts, in the form the paged body uses.  Splitting moves whole
// chains to other warps and blocks; batching reorders independent
// instructions, the shared shuffle trees add the same pairs, an entry's
// softcap and expf computed on one lane and shuffled to the others are the
// values each lane would compute, a stage the
// window masks entirely is a run of no-op updates that is skipped, and an
// entry that is not applied (past len, outside the window, its K/V never
// copied) becomes an exact no-op update; none of these changes a value.
// At a length of at most SEG there is one segment and one merge level:
// every value is that of the same kernel without segments.
//
// The partial variant (template flag PARTIAL, entry point
// fairkv_decode_partial_launch) is split-S decode's kernel: the cache's
// columns are split over ranks, each rank runs this kernel on its shard,
// and the ranks' results merge outside it (merge_partials in
// src/repro_torch/kernels/ref.py).  It is the same kernel up to the last
// store: the same chains and the same merge, which then writes the
// normalised fp32 output o (not rounded to q's dtype) and the pair's
// log-sum-exp lse = mx + log(lsum) per head, fp32; a (slot, row) with no
// valid entry writes o = 0 and lse = -inf.  PARTIAL is a template flag so
// that the full-output instantiations compile without its stores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "col_segments.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int MAXJ = 8;   // Dh = 256: lane owns d = lane + 32 * j, j < J <= MAXJ
constexpr int NCLS = 8;   // column classes c mod 8
constexpr int MAXG = 8;   // query heads per kv head
constexpr float NEG_INF = -1e30f;
// per lane width J (2: Dh = 64, 4: Dh <= 128, 8: Dh = 256): block entries
// per ring stage (32 x 128 elements of K and of V below 256) and ring
// stages; at Dh = 256 a stage of 32 entries gives each warp a full batch
// of 8 where 16 gave it 4, and three such stages keep the ring's bytes in
// flight (64 KB a block) and two blocks an SM
template <int J> __host__ __device__ constexpr int stage_entries() { return J == 8 ? 32 : 128 / J; }
template <int J> __host__ __device__ constexpr int n_stages() { return J == 8 ? 3 : 5; }
constexpr int NB = 8;  // entries a warp scores before it updates its state
using colseg::SEG;         // columns per segment (col_segments.cuh)
using colseg::n_segments;
static_assert(SEG % (NCLS * stage_entries<2>()) == 0 && SEG % (NCLS * stage_entries<8>()) == 0,
              "a segment is whole stages of every class");
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
// only half of them and trades the other half; then lane l takes the sum
// of entry l % N from a lane that holds it: N + 5 - log2(N) shuffles (10
// at N = 8) where separate trees take 5 N (40).
template <int N>
__device__ __forceinline__ float warp_sum_batch(const float (&x)[N]) {
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
  const int u = lane & (N - 1);
  int src = 0;
#pragma unroll
  for (int o = 16, n = N; n > 1; o >>= 1, n >>= 1)
    if (u & (n >> 1)) src |= o;
  return __shfl_sync(0xffffffffu, v[0], src);
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// dynamic shared memory: merge (m, l) of a segment's classes or of the
// segments, per head |
// flag, the live stage range and each head's (mx, lsum) | ring | (window)
// the segment's positions
struct Layout {
  size_t flag, region, pos, total;
};
template <typename T, int J>
__host__ __device__ inline Layout layout(int G, int Dh, int nseg, bool window) {
  Layout s;
  s.flag = align16(static_cast<size_t>(nseg > NCLS ? nseg : NCLS) * G * 2 * sizeof(float));
  s.region = s.flag + 16 + 2 * MAXG * sizeof(float);
  s.pos = s.region + static_cast<size_t>(n_stages<J>()) * 2 * stage_entries<J>() * Dh * sizeof(T);
  s.total = s.pos + (window ? SEG / padded_group(G) * sizeof(int) : 0);  // the block's entries
  return s;
}

// block entry e of the block's classes is column ((e >> LCPB) << 3) + cls0
// + (e & (2^LCPB - 1)) of its segment
template <int LCPB>
__device__ __forceinline__ int column(int e, int cls0) {
  return ((e >> LCPB) << 3) + cls0 + (e & ((1 << LCPB) - 1));
}

// copy ring stage `st` (block entries st*ES ..) of the block's classes into
// ring slot `slot`; kb / vb point at the segment's first column, and
// columns at or past slen, or (pos_s given) whose position is at most thr,
// are not copied
template <typename T, int LCPB, int ES>
__device__ __forceinline__ void issue_stage(T* ring, const T* __restrict__ kb,
                                            const T* __restrict__ vb, const int* pos_s,
                                            int thr, int st, int slot, int cls0, int slen,
                                            int Dh, bool vec) {
  T* ks = ring + static_cast<size_t>(slot) * 2 * ES * Dh;
  T* vs = ks + ES * Dh;
  const int e0 = st * ES;
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
    const int cpr = Dh / EPC;            // chunks per row
    const int n = ES * cpr;
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
      const bool isv = i >= n;
      const int ii = isv ? i - n : i;
      const int le = ii / cpr, ch = ii - le * cpr;
      const int c = column<LCPB>(e0 + le, cls0);
      if (c < slen && (pos_s == nullptr || pos_s[e0 + le] > thr))
        hk::cp_async16((isv ? vs : ks) + le * Dh + ch * EPC,
                       (isv ? vb : kb) + static_cast<size_t>(c) * Dh + ch * EPC);
    }
  } else {  // rows not 16-byte aligned: plain loads (visible after the next barrier)
    for (int i = threadIdx.x; i < ES * Dh; i += blockDim.x) {
      const int le = i / Dh, d = i - le * Dh;
      const int c = column<LCPB>(e0 + le, cls0);
      if (c < slen && (pos_s == nullptr || pos_s[e0 + le] > thr)) {
        ks[i] = kb[static_cast<size_t>(c) * Dh + d];
        vs[i] = vb[static_cast<size_t>(c) * Dh + d];
      }
    }
  }
}

template <typename T, int G, int J, bool FULL, bool PARTIAL>
__global__ void __launch_bounds__(NWARPS * 32, 2)
fairkv_decode_kernel(const T* __restrict__ q,          // (B, S, G, Dh)
                     const T* __restrict__ k,          // (S, B, C, Dh)
                     const T* __restrict__ v,          // (S, B, C, Dh)
                     const int* __restrict__ lengths,  // (S, B)
                     const int* __restrict__ k_pos,    // (S, B, C) or null
                     const int* __restrict__ q_pos,    // (B,) or null
                     T* __restrict__ out,              // (B, S, G, Dh); null if PARTIAL
                     float* __restrict__ part_o,       // PARTIAL: (B, S, G, Dh) fp32
                     float* __restrict__ part_lse,     // PARTIAL: (B, S, G) fp32
                     float* __restrict__ acc_scr,      // (S*B, nseg, NCLS, G, Dh)
                     float* __restrict__ ml_scr,       // (S*B, nseg, NCLS, G, 2)
                     int* __restrict__ counters,       // fairkv_decode_counters, zero between launches
                     int B, int S, int C, int Dh_in,
                     float scale, float attn_cap, int window, int vec) {
  // GP blocks per (slot, row) and segment; block `part` takes classes
  // cls0 .. cls0 + CPB - 1, and warp w the chain (class cls0 + w % CPB,
  // head w / CPB); heads G .. GP - 1 of a padded group are masked (no q
  // load, no state)
  constexpr int GP = padded_group(G);
  constexpr int CPB = NCLS / GP;
  constexpr int LCPB = GP == 1 ? 3 : (GP == 2 ? 2 : (GP == 4 ? 1 : 0));
  constexpr int ES = stage_entries<J>();
  constexpr int PER = ES / CPB;           // a chain's entries in one stage
  constexpr int NBU = PER < NB ? PER : NB;
  constexpr int NST = n_stages<J>();
  const int Dh = FULL ? 32 * J : Dh_in;  // FULL: Dh = 32 J, the lane guards fold away
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = blockIdx.x;  // s * B + b
  const int part = blockIdx.y;
  const int seg = blockIdx.z;
  const int nsegs = gridDim.z;  // n_segments(C): the scratch's segments per pair
  const int s = sb / B;
  const int b = sb - s * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(lengths[sb], C);  // the plain version's arange(C) < len
  const size_t qo = (static_cast<size_t>(b) * S + s) * G * Dh;
  T* o = out + qo;
  float* po = PARTIAL ? part_o + qo : nullptr;
  float* plse = PARTIAL ? part_lse + (static_cast<size_t>(b) * S + s) * G : nullptr;
  if (len <= 0) {  // unowned (slot, row): exact zeros, no K/V traffic
    if (part == 0 && seg == 0) {
      if constexpr (PARTIAL) {
        for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) po[i] = 0.f;
        for (int i = threadIdx.x; i < G; i += blockDim.x) plse[i] = neg_inf();
      } else {
        for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) store(o + i, 0.f);
      }
    }
    return;
  }
  const int seg0 = seg * SEG;
  if (seg0 >= len) return;  // past the pair's length: no state, not waited for
  const int nseg = n_segments(len);        // the pair's segments that hold columns
  const int slen = min(len - seg0, SEG);   // this segment's columns
  const int cls0 = part * CPB;
  const int lw = warp % CPB;
  const int cls = cls0 + lw;
  const int g = warp / CPB;
  const bool live = g < G;  // a masked head's warp streams K/V with the block

  const Layout L = layout<T, J>(G, Dh, nsegs, window > 0);
  float* ml_s = reinterpret_cast<float*>(smem);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  T* ring = reinterpret_cast<T*>(smem + L.region);

  const size_t row0 = static_cast<size_t>(sb) * C + seg0;
  const T* kb = k + row0 * Dh;
  const T* vb = v + row0 * Dh;
  const int ngroups = (slen + NCLS - 1) / NCLS;
  const int ntiles = (ngroups * CPB + ES - 1) / ES;
  const int qp = window > 0 ? q_pos[b] : 0;
  const int thr = qp - window;  // the window keeps positions > thr
  // the stages to stream: all, or (window) those from the first to the
  // last holding an entry the window keeps
  int t_lo = 0, t_hi = ntiles;
  const int* pos_s = nullptr;
  if (window > 0) {
    int* pos_w = reinterpret_cast<int*>(smem + L.pos);
    if (threadIdx.x == 0) {
      flag[1] = ntiles;
      flag[2] = 0;
    }
    for (int e = threadIdx.x; e < ntiles * ES; e += blockDim.x) {
      const int c = column<LCPB>(e, cls0);
      if (c < slen) hk::cp_async4_zfill(pos_w + e, k_pos + row0 + c, 4);
    }
    hk::cp_async_commit();
    hk::cp_async_wait_all();
    __syncthreads();
    int lo = ntiles, hi = 0;
    for (int e = threadIdx.x; e < ntiles * ES; e += blockDim.x) {
      if (column<LCPB>(e, cls0) < slen && pos_w[e] > thr) {
        lo = min(lo, e / ES);
        hi = max(hi, e / ES + 1);
      }
    }
    if (lo < hi) {
      atomicMin(flag + 1, lo);
      atomicMax(flag + 2, hi);
    }
    __syncthreads();
    t_lo = flag[1];
    t_hi = max(flag[2], t_lo);
    pos_s = pos_w;
  }
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (t_lo + st < t_hi)
      issue_stage<T, LCPB, ES>(ring, kb, vb, pos_s, thr, t_lo + st, st, cls0, slen, Dh,
                               vec != 0);
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
  const bool capped = attn_cap > 0.f;
  const float a_sc = capped ? attn_cap : scale;  // the score is a_sc * x

  // The control flow around the shuffles depends only on block-uniform
  // values (t, t_hi), so the compiler needs no convergence barriers there
  // and can interleave a batch's dot products and shuffle trees; entries
  // past len or masked are scored but not applied.
  for (int t = t_lo; t < t_hi; ++t) {
    hk::cp_async_wait<NST - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; stage t-1 consumed
    if (t + NST - 1 < t_hi)
      issue_stage<T, LCPB, ES>(ring, kb, vb, pos_s, thr, t + NST - 1, (t - t_lo + NST - 1) % NST,
                               cls0, slen, Dh, vec != 0);
    hk::cp_async_commit();
    const T* ks = ring + static_cast<size_t>((t - t_lo) % NST) * 2 * ES * Dh;
    const T* vs = ks + ES * Dh;
    const int gbase = t * PER;  // group (c / 8, in the segment) of the stage's first entry
    // (a masked head's warp only streams: its loop is empty)
#pragma unroll 1
    for (int i0 = 0; i0 < (G == GP || live ? PER : 0); i0 += NBU) {
      // scores of the batch (the paged body's expressions), in
      // straight-line stages so the entries' loads, products and shuffle
      // trees interleave; lane l then holds entry e = l % NBU alone and
      // computes its softcap, x = tanh(x * scale / cap), and its score
      // s = a * x (a = scale or cap) once for the warp
      float kr[NBU][J], x[NBU];
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
          if (d < Dh) part_sum = __fmaf_rn(qv[j], kr[u][j], part_sum);
        }
        x[u] = part_sum;
      }
      const int e = lane & (NBU - 1);
      float xe = warp_sum_batch(x);
      if (capped) xe = tanhf(__fdiv_rn(__fmul_rn(xe, scale), attn_cap));
      const float se = __fmul_rn(a_sc, xe);
      // valid entries: a prefix of the batch (c < slen), minus the window
      const int c0 = ((gbase + i0) << 3) + cls;
      const int nv = min(max((slen - c0 + NCLS - 1) / NCLS, 0), NBU);
      unsigned vm = (1u << nv) - 1u;
      if (window > 0) {
#pragma unroll
        for (int u = 0; u < NBU; ++u)
          if (u < nv && !(pos_s[t * ES + ((i0 + u) << LCPB) + lw] > thr)) vm &= ~(1u << u);
      }
      // the running max through the batch on every lane, then each lane
      // the two expf of its entry, handed to every lane; an entry that is
      // not applied gets corr = 1, p = +0 and v = -0: then l*1 + 0 = l (l
      // is never -0) and acc*1 + (+0)(-0) = acc + (-0) = acc for every acc,
      // so the updates need no branch; a full batch skips the selects
      float mprev_e = m, mnew_e = m;
#pragma unroll
      for (int u = 0; u < NBU; ++u) {
        const float mprev = m;
        const float su = __shfl_sync(0xffffffffu, se, u);
        if (vm >> u & 1u) m = fmaxf(m, su);
        if (u == e) {
          mprev_e = mprev;
          mnew_e = m;
        }
      }
      const float corr_e = expf(__fsub_rn(mprev_e, mnew_e));
      const float p_e = expf(__fsub_rn(se, mnew_e));
      float corr[NBU], p[NBU];
#pragma unroll
      for (int u = 0; u < NBU; ++u) {
        corr[u] = __shfl_sync(0xffffffffu, corr_e, u);
        p[u] = __shfl_sync(0xffffffffu, p_e, u);
      }
      if (vm == (1u << NBU) - 1u) {
#pragma unroll
        for (int u = 0; u < NBU; ++u) {
          const int le = ((i0 + u) << LCPB) + lw;
          l = __fmaf_rn(l, corr[u], p[u]);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int d = lane + 32 * j;
            const float vj = d < Dh ? to_f(vs[le * Dh + d]) : 0.f;
            acc[j] = __fmaf_rn(acc[j], corr[u], __fmul_rn(p[u], vj));
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < NBU; ++u) {
          const bool ok = vm >> u & 1u;
          const int le = ((i0 + u) << LCPB) + lw;
          const float cu = ok ? corr[u] : 1.f;
          const float pu = ok ? p[u] : 0.f;
          l = __fmaf_rn(l, cu, pu);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int d = lane + 32 * j;
            const float vj = !ok ? -0.f : (d < Dh ? to_f(vs[le * Dh + d]) : 0.f);
            acc[j] = __fmaf_rn(acc[j], cu, __fmul_rn(pu, vj));
          }
        }
      }
    }
  }
  hk::cp_async_wait_all();

  // every block writes its chains' states to scratch.  One segment: the
  // pair's last block (all of them at G = 1) merges the 8 classes and
  // writes the output.  More: each segment's last block merges its 8
  // classes into the segment's (mx, lsum, a), and the pair's last such
  // block merges the segments in order (the header's merge).
  const size_t pair = static_cast<size_t>(sb) * nsegs;
  float* acc_pair = acc_scr + pair * NCLS * G * Dh;
  float* ml_pair = ml_scr + pair * NCLS * G * 2;
  if (live) {
    const int r = (seg * NCLS + cls) * G + g;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int d = lane + 32 * j;
      if (d < Dh) acc_pair[r * Dh + d] = acc[j];
    }
    if (lane == 0) {
      ml_pair[r * 2] = m;
      ml_pair[r * 2 + 1] = l;
    }
  }
  const bool split = nseg > 1;
  int* arrive = split ? counters + gridDim.x + static_cast<size_t>(sb) * nsegs + seg
                      : counters + sb;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(arrive, 1) == GP - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (threadIdx.x == 0) *arrive = 0;  // ready for the next launch

  // the segment's 8 classes: per head mx = the max of their m, each class's
  // weight f = expf(m - mx) (in place of m), lsum = the sum of l f in class
  // order (by one thread a head), and per element a = the sum of acc f in
  // class order
  float* head_s = reinterpret_cast<float*>(smem + L.flag) + 4;  // mx, lsum per head
  float* acc_seg = acc_pair + static_cast<size_t>(seg) * NCLS * G * Dh;
  float* ml_seg = ml_pair + static_cast<size_t>(seg) * NCLS * G * 2;
  for (int i = threadIdx.x; i < NCLS * G * 2; i += blockDim.x) ml_s[i] = __ldcg(ml_seg + i);
  __syncthreads();
  if (threadIdx.x < G) {
    const int gi = threadIdx.x;
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < NCLS; ++c) mx = fmaxf(mx, ml_s[(c * G + gi) * 2]);
    float lsum = 0.f;  // a class that saw no valid entry has l = 0: no weight
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      const float f = expf(ml_s[(c * G + gi) * 2] - mx);
      ml_s[(c * G + gi) * 2] = f;
      lsum = __fmaf_rn(ml_s[(c * G + gi) * 2 + 1], f, lsum);
    }
    head_s[gi] = mx;
    head_s[G + gi] = lsum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    const int gi = i / Dh;
    float a = 0.f;  // a class that saw no valid entry has acc = 0
#pragma unroll
    for (int c = 0; c < NCLS; ++c)
      a = __fmaf_rn(__ldcg(acc_seg + static_cast<size_t>(c) * G * Dh + i), ml_s[(c * G + gi) * 2],
                    a);
    if (split) {
      acc_seg[i] = a;  // over class 0's acc: the segment's state
    } else {
      const float lsum = head_s[G + gi];
      if constexpr (PARTIAL) {
        po[i] = lsum > 0.f ? a / lsum : 0.f;
      } else {
        store(o + i, lsum > 0.f ? a / lsum : 0.f);
      }
    }
  }
  if (!split) {
    if constexpr (PARTIAL) {  // each head's log-sum-exp
      for (int gi = threadIdx.x; gi < G; gi += blockDim.x) {
        const float lsum = head_s[G + gi];
        plse[gi] = lsum > 0.f ? head_s[gi] + logf(lsum) : neg_inf();
      }
    }
    return;
  }
  for (int gi = threadIdx.x; gi < G; gi += blockDim.x) {  // over class 0's (m, l)
    ml_seg[gi * 2] = head_s[gi];
    ml_seg[gi * 2 + 1] = head_s[G + gi];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counters + sb, 1) == nseg - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (threadIdx.x == 0) counters[sb] = 0;

  // the segments in order: per head mx = the max of their mx, each
  // segment's weight g = expf(mx_s - mx) (in place of mx_s), lsum = lsum_0 g_0
  // then + lsum_s g_s, and per element a = a_0 g_0 then + a_s g_s
  // (colseg::fold)
  for (int i = threadIdx.x; i < nseg * G * 2; i += blockDim.x) {
    const int sg = i / (G * 2);
    ml_s[i] = __ldcg(ml_pair + static_cast<size_t>(sg) * NCLS * G * 2 + (i - sg * G * 2));
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int gi = threadIdx.x;
    float mx = NEG_INF;
    for (int sg = 0; sg < nseg; ++sg) mx = fmaxf(mx, ml_s[(sg * G + gi) * 2]);
    float lsum = 0.f;
    for (int sg = 0; sg < nseg; ++sg) {
      const float gw = expf(ml_s[(sg * G + gi) * 2] - mx);
      ml_s[(sg * G + gi) * 2] = gw;
      lsum = colseg::fold(sg, ml_s[(sg * G + gi) * 2 + 1], gw, lsum);
    }
    if constexpr (PARTIAL) plse[gi] = lsum > 0.f ? mx + logf(lsum) : neg_inf();
    head_s[G + gi] = lsum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    const int gi = i / Dh;
    float a = colseg::fold(0, __ldcg(acc_pair + i), ml_s[gi * 2], 0.f);
#pragma unroll 8  // eight segments' loads in flight; the sum keeps their order
    for (int sg = 1; sg < nseg; ++sg)
      a = colseg::fold(sg, __ldcg(acc_pair + static_cast<size_t>(sg) * NCLS * G * Dh + i),
                       ml_s[(sg * G + gi) * 2], a);
    const float lsum = head_s[G + gi];
    if constexpr (PARTIAL) {
      po[i] = lsum > 0.f ? a / lsum : 0.f;
    } else {
      store(o + i, lsum > 0.f ? a / lsum : 0.f);
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
  const int nseg = n_segments(a.C);
  const size_t smem = layout<T, J>(G, a.Dh, nseg, a.window > 0).total;
  static size_t opted = 48 * 1024;  // above 48 KB only as opted-in dynamic shared memory
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(a.Dh));
  const int vec = (a.Dh * static_cast<int>(sizeof(T))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  float* ml_scr = a.scratch + static_cast<size_t>(a.S) * a.B * nseg * NCLS * G * a.Dh;
  const dim3 grid(a.S * a.B, padded_group(G), nseg);
  kernel<<<grid, NWARPS * 32, smem, stream>>>(
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

// Dh = 256: J = 8; Dh = 128: J = 4, FULL; Dh = 64: J = 2, FULL; else J = 4
// with lane guards (the same products in the same order as J = 2 at 64)
template <typename T, bool PARTIAL>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t st) {
  if (a.Dh == 256) return dispatch_j<T, 8, true, PARTIAL>(G, a, st);
  if (a.Dh == 128) return dispatch_j<T, 4, true, PARTIAL>(G, a, st);
  if (a.Dh == 64) return dispatch_j<T, 2, true, PARTIAL>(G, a, st);
  return dispatch_j<T, 4, false, PARTIAL>(G, a, st);
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

// fp32 scratch (floats) one launch needs: each (slot, row)'s states of
// every (segment, class), (acc, m, l) per head
long long fairkv_decode_scratch_floats(int B, int S, int G, int Dh, int C) {
  return static_cast<long long>(S) * B * n_segments(C) * NCLS * G * (Dh + 2);
}

// columns per segment of the split over the cache's columns
int fairkv_decode_segment_columns() { return SEG; }

// arrival counters (ints) one launch needs: one per (slot, row), and past
// one segment also one per (slot, row, segment)
long long fairkv_decode_counters(int B, int S, int C) {
  const int n = n_segments(C);
  return static_cast<long long>(S) * B * (n > 1 ? 1 + n : 1);
}

// dtype: 0 = float32, 1 = bfloat16.  k_pos / q_pos are read only when
// window > 0.  scratch holds fairkv_decode_scratch_floats floats; counters
// holds fairkv_decode_counters ints that are 0 before the launch (the
// launch leaves them 0).
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
