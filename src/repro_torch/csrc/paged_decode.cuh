// Paged decode attention over block pools through a block table, one
// kernel body for both entry points: the single-query kernel
// (paged_fairkv_decode.cu, Q = 1) and the multi-query speculative-verify
// kernel (paged_fairkv_decode_mq.cu).  Written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels `paged_fairkv_decode_pallas` (src/repro/kernels/
// paged_fairkv_decode.py, body `_kernel`, dequant `_dequant`) and
// `_paged_decode_pallas_mq` (same file, body `_mq_kernel`).  Semantics are
// those of `paged_fairkv_decode_ref` (src/repro_torch/kernels/ref.py):
// column c of (slot s, row b) lives at offset c % bs of pool block
// table[s, b, c / bs] (entries <= 0 resolve to the null block 0); query i of
// row b, with qn = q_lens[b] valid queries (qn = Q without q_lens), sees the
// first min(len - (qn - 1 - i), len) columns (lanes i >= qn are garbage the
// caller discards and clamp to len); softcap cap*tanh(x/cap) before the
// mask; sliding window pos > q_pos[b] + i - window on the pool's absolute
// positions; fp32 online softmax; a query with no valid column, and every
// query of a (slot, row) of length 0, gives exact zeros.  Quantized pools
// hold int8 codes with one fp32 scale per block and a kind per slot (0 =
// int8 value, 1 = fp8-e4m3 bit pattern): value = decode(code) * scale,
// fp8 NaN patterns read as 0.  The unquantized path takes no scales.
//
// What bounds it on this card: bytes.  Each retained entry's K and V rows
// (512 B in bf16 at Dh = 128) feed 4 Q G Dh operations, about 20 per byte
// at Q = 5, G = 4, far below the ~295 per byte at which an H100's tensor
// cores, not its HBM, would be the limit.  The design is the slot kernel's
// (fairkv_decode.cu), fed through the block table:
//   - bytes moved = retained bytes: a (slot, row) of length 0 writes zeros
//     and moves no K/V bytes; the others copy only the columns that some
//     query of the block sees;
//   - the slot kernel's split over the cache's columns: segments of SEG =
//     4096 columns (col_segments.cuh, with the segments' merge term, so
//     the two kernels cannot drift), boundaries on the column index
//     alone; the grid's third dimension carries (query chunk, segment),
//     and a block whose segment starts at or past the columns its chunk
//     sees exits at once, writes nothing and is not waited for.  Every
//     capacity of the main path and decode_32k (<= 1600 columns) is one
//     segment;
//   - each block stages the table entries its segment touches in shared
//     memory once (at most SEG / bs + 1, so a long capacity needs no long
//     table row there); K and V rows reach shared memory through 16-byte
//     cp.async copies from pool row id * bs + c % bs (16 codes per copy
//     for int8 / fp8 pools), in stages of 8 entries through a ring of 8
//     stages; each entry's two block scales and (with a window) its
//     position arrive beside it by 4-byte copies; rows that are not
//     16-byte aligned take plain loads;
//   - G blocks per (slot, row) and query chunk, 8 warps each: block `part`
//     takes column classes part * 8/G .. + 8/G - 1 of all G heads, and
//     every warp one (class, head) chain for the QW queries of its chunk,
//     with their (m, l, acc) in registers; the single-query kernel also
//     takes G = 5 and 7 as the slot kernel does: split as G = 8, the warps
//     of heads G .. 7 masked (no q load, no state written); each K and V row is read from
//     shared memory once per warp for all QW queries.  Q > QMAX queries
//     split over the grid's third dimension into chunks of at most QMAX
//     (each chunk re-reads K/V, from L2);
//   - a warp scores its entries in batches: the dot products of the batch,
//     each query's xor trees sharing their shuffles (warp_sum_batch), the
//     running max over the batch, every expf at once, then the (l, acc) fma
//     chains; an entry a query does not see is an exact no-op update, and
//     the control flow around the shuffles is block-uniform;
//   - each block writes its chains' states to scratch; the last of a
//     segment's blocks to arrive (an atomic counter after __threadfence,
//     reset for the next launch) merges the segment's 8 classes, and past
//     one segment the last of the (slot, row, chunk)'s segments merges
//     theirs (the slot kernel's two levels), so one launch suffices; the
//     block's segment record waits in shared memory through the loop,
//     whose registers the widest chunks use to the last of 128;
//   - head dims up to 128, and 256: a lane owns J = 4 elements of a row
//     up to Dh = 128 and J = 8 at 256 (FULL only), the slot kernel's
//     split, so the two still reduce in the same order.  At J = 8 a warp's q and acc for its
//     QW G rows double, so it scores half as many entries per batch, and
//     with two or more queries per warp it is budgeted one block per SM
//     (255 registers) rather than spill; a ring stage keeps its 8 entries
//     (one per column class at G = 1), so the ring's bytes double (64 KB
//     at bf16).
// Every (slot, row, query, head) gets the same floating-point operations in
// the same order as the slot kernel's (slot, row, head): column class
// c mod 8 is one online-softmax chain (entries in increasing c; lane d =
// lane + 32 j partial products, the xor-shuffle tree, * scale, softcap,
// mn = fmaxf(m, s), corr = expf(m - mn), p = expf(s - mn), l = l*corr + p,
// acc = acc*corr + p*v) within each segment, a segment's classes merge in
// order 0..7, and past one segment the segments below the query's own
// limit merge in order as the slot kernel merges them (a segment past the
// limit would add exact zeros, but an fma of -0 and +0 can turn -0 into
// +0, so they are left out; one segment through that path gives its own
// values).  So the single-query kernel equals the slot kernel bitwise over an
// identity table, the multi-query kernel at Q = 1 equals the single-query
// kernel, and query i of the multi-query kernel equals the single-query
// kernel at lengths min(len - (qn - 1 - i), len) and q_pos + i.  The chain is written
// with rounding intrinsics (__fmaf_rn, __fmul_rn, __fsub_rn, __fdiv_rn),
// which the compiler never contracts, in the form the slot kernel compiles
// to (s = scale * x rounded before s - mn; acc = fma(acc, corr, p*v)): a
// plain `a*b + c` is fused or not depending on the code around it, which
// made the first version of this body differ from the slot kernel.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "col_segments.cuh"

namespace paged {
namespace {  // internal linkage: each library keeps its own instantiations


constexpr int NWARPS = 8;
constexpr int MAXJ = 8;             // Dh = 256: lane owns d = lane + 32 * j, j < J <= MAXJ
constexpr int NCLS = 8;             // column classes c mod 8
constexpr int ES = 8;               // block entries per ring stage
constexpr int NST = 8;              // ring stages
constexpr int QMAX = 5;             // queries per warp (a chunk of the grid)
constexpr int MAX_QUERY_ROWS = 40;  // Q * G
constexpr float NEG_INF = -1e30f;
using colseg::SEG;                  // columns per segment: the slot kernel's (col_segments.cuh)
using colseg::n_segments;
static_assert(SEG % (NCLS * ES) == 0, "a segment is whole stages of every class");

// the group a G splits the column classes as: G itself when it divides 8,
// else 8 with heads G .. 7 masked (the slot kernel's rule)
__host__ __device__ constexpr int padded_group(int G) { return G <= 2 ? G : (G <= 4 ? 4 : 8); }

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

// one pool element as fp32: plain, or decoded code times the block scale
__device__ __forceinline__ float pool_f(float x, int, float) { return x; }
__device__ __forceinline__ float pool_f(__nv_bfloat16 x, int, float) { return to_f(x); }
__device__ __forceinline__ float pool_f(int8_t x, int kind, float sc) {
  return __fmul_rn(code_to_f(x, kind), sc);
}

// warp_sum of N partial sums at once (N a power of two, at most 8), with
// the same additions as N separate xor trees (offsets 16, 8, 4, 2, 1): at
// each offset a lane adds its partner's value to its own, but while
// several entries are left each lane keeps only half of them and trades
// the other half; then every entry's sum is broadcast from a lane that
// holds it.  (The slot kernel's function, fairkv_decode.cu.)
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

// query chunks: Q queries split into n_chunks(Q) chunks of chunk_width(Q)
// (the last may hold fewer)
__host__ __device__ inline int n_chunks(int Q) { return (Q + QMAX - 1) / QMAX; }
__host__ __device__ inline int chunk_width(int Q) {
  const int n = n_chunks(Q);
  return (Q + n - 1) / n;
}

// fp32 scratch (floats) one launch needs: each (slot, row, chunk)'s states
// of every (segment, class), (acc, m, l) per (query, head)
inline long long scratch_floats(int B, int S, int Q, int G, int Dh, int capacity) {
  return static_cast<long long>(S) * B * n_chunks(Q) * n_segments(capacity) * NCLS *
         chunk_width(Q) * G * (Dh + 2);
}

// arrival counters (ints) one launch needs: one per (slot, row, chunk),
// and past one segment also one per (slot, row, chunk, segment)
inline long long counters(int B, int S, int Q, int capacity) {
  const int n = n_segments(capacity);
  return static_cast<long long>(S) * B * n_chunks(Q) * (n > 1 ? 1 + n : 1);
}

// entries of a block's staged table row: the blocks one segment's columns
// can touch
__host__ __device__ inline int table_entries(int capacity, int bs) {
  return min((capacity + bs - 1) / bs, (SEG + bs - 1) / bs + 1);
}

// one ring stage: K rows | V rows | (quantized) K and V block scales |
// positions, each part 16-byte aligned
struct Stage {
  size_t v, ksc, vsc, pos, bytes;
};
template <typename TKV>
__host__ __device__ inline Stage stage_layout(int Dh) {
  Stage s;
  const size_t rows = align16(static_cast<size_t>(ES) * Dh * sizeof(TKV));
  s.v = rows;
  s.ksc = 2 * rows;
  s.vsc = s.ksc + (sizeof(TKV) == 1 ? ES * sizeof(float) : 0);
  s.pos = s.vsc + (sizeof(TKV) == 1 ? ES * sizeof(float) : 0);
  s.bytes = s.pos + ES * sizeof(int);
  return s;
}

// dynamic shared memory: merge (m, l) of a segment's classes or of the
// segments, per row |
// flag and the block's segment record | the segment's table entries | ring
struct Layout {
  size_t flag, table, ring, total;
};
template <typename TKV>
__host__ __device__ inline Layout layout(int rows, int n_blk, int Dh, int nseg) {
  Layout s;
  s.flag = align16(static_cast<size_t>(nseg > NCLS ? nseg : NCLS) * rows * 2 * sizeof(float));
  s.table = s.flag + 32;
  s.ring = s.table + align16(static_cast<size_t>(n_blk) * sizeof(int));
  s.total = s.ring + NST * stage_layout<TKV>(Dh).bytes;
  return s;
}

// block entry e of the block's classes is column ((e >> LCPB) << 3) + cls0
// + (e & (2^LCPB - 1)) of its segment
template <int LCPB>
__device__ __forceinline__ int column(int e, int cls0) {
  return ((e >> LCPB) << 3) + cls0 + (e & ((1 << LCPB) - 1));
}

// pool row of column c of a segment through its staged table entries:
// `off` is the segment's first column less the first staged block's
__device__ __forceinline__ size_t pool_row(const int* tbl_s, int c, int off, int bs,
                                           int bs_shift) {
  const int cc = c + off;
  const int blk = bs_shift >= 0 ? cc >> bs_shift : cc / bs;
  return static_cast<size_t>(tbl_s[blk]) * bs + (cc - blk * bs);
}

// copy ring stage `st` (block entries st*ES .. of a segment) into ring slot
// `slot`; the segment's columns at or past slen are not copied
template <typename TKV, int LCPB>
__device__ __forceinline__ void issue_stage(unsigned char* ring, const Stage& SL,
                                            const TKV* __restrict__ k_pool,
                                            const TKV* __restrict__ v_pool,
                                            const int* __restrict__ pos_pool,
                                            const float* __restrict__ k_scale,
                                            const float* __restrict__ v_scale,
                                            const int* tbl_s, int off, int st, int slot,
                                            int cls0, int slen, int bs, int bs_shift, int Dh,
                                            bool vec, bool want_pos) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  unsigned char* base = ring + static_cast<size_t>(slot) * SL.bytes;
  TKV* ks = reinterpret_cast<TKV*>(base);
  TKV* vs = reinterpret_cast<TKV*>(base + SL.v);
  const int e0 = st * ES;
  if (QUANT || want_pos) {  // per-entry block scales and positions
    for (int i = threadIdx.x; i < ES; i += blockDim.x) {
      const int c = column<LCPB>(e0 + i, cls0);
      if (c < slen) {
        const int cc = c + off;
        const int blk = bs_shift >= 0 ? cc >> bs_shift : cc / bs;
        const int id = tbl_s[blk];
        if (QUANT) {
          hk::cp_async4_zfill(reinterpret_cast<float*>(base + SL.ksc) + i, k_scale + id, 4);
          hk::cp_async4_zfill(reinterpret_cast<float*>(base + SL.vsc) + i, v_scale + id, 4);
        }
        if (want_pos)
          hk::cp_async4_zfill(reinterpret_cast<int*>(base + SL.pos) + i,
                              pos_pool + static_cast<size_t>(id) * bs + (cc - blk * bs), 4);
      }
    }
  }
  if (vec) {
    constexpr int EPC = 16 / sizeof(TKV);  // elements per 16-byte chunk
    const int cpr = Dh / EPC;              // chunks per row
    const int n = ES * cpr;
    for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
      const bool isv = i >= n;
      const int ii = isv ? i - n : i;
      const int le = ii / cpr, ch = ii - le * cpr;
      const int c = column<LCPB>(e0 + le, cls0);
      if (c < slen)
        hk::cp_async16((isv ? vs : ks) + le * Dh + ch * EPC,
                       (isv ? v_pool : k_pool) + pool_row(tbl_s, c, off, bs, bs_shift) * Dh
                           + ch * EPC);
    }
  } else {  // rows not 16-byte aligned: plain loads (visible after the next barrier)
    for (int i = threadIdx.x; i < ES * Dh; i += blockDim.x) {
      const int le = i / Dh, d = i - le * Dh;
      const int c = column<LCPB>(e0 + le, cls0);
      if (c < slen) {
        const size_t row = pool_row(tbl_s, c, off, bs, bs_shift);
        ks[i] = k_pool[row * Dh + d];
        vs[i] = v_pool[row * Dh + d];
      }
    }
  }
}

// The kernel body.  TQ: query / output type (float, bf16).  TKV: pool
// element type (float, bf16, or int8 codes, which reads scales and kinds).
// G: query heads per kv head.  QW: queries per warp (the chunk width).
// J: elements of a row per lane (4: Dh <= 128, 8: Dh = 256).  FULL: Dh = 32 J.
template <typename TQ, typename TKV, int G, int QW, int J, bool FULL>
__device__ __forceinline__ void
decode_body(const TQ* __restrict__ q,           // (B, S, Q, G, Dh)
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
            float* __restrict__ acc_scr,        // (S*B*nch, nseg, NCLS, QW*G, Dh)
            float* __restrict__ ml_scr,         // (S*B*nch, nseg, NCLS, QW*G, 2)
            int* __restrict__ counters,         // paged::counters, zero between launches
            int B, int S, int Q, int M, int bs, int bs_shift, int capacity,
            int Dh_in, float scale, float attn_cap, int window, int vec) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int GP = padded_group(G);  // heads G .. GP - 1 are masked
  constexpr int CPB = NCLS / GP;       // classes per block
  constexpr int LCPB = GP == 1 ? 3 : (GP == 2 ? 2 : (GP == 4 ? 1 : 0));
  constexpr int PER = ES / CPB;  // a chain's entries in one stage
  // entries a warp scores before it updates: fewer as QW grows, so the
  // (query, entry) states fit in the registers without spilling (the
  // quantized and the generic-Dh paths hold more state); half at J = 8
  constexpr int NB = J == 4 ? (QW <= 2 ? 8 : (QW == 3 || !(QUANT || !FULL)) ? 4 : 2)
                            : (QW <= 2 ? 4 : 2);
  constexpr int NBU = PER < NB ? PER : NB;
  constexpr int R = QW * G;              // (query, head) rows of a chunk
  const int Dh = FULL ? 32 * J : Dh_in;  // FULL: the lane guards fold away
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = blockIdx.x;  // s * B + b
  const int part = blockIdx.y;
  const int nsegs = n_segments(capacity);  // the scratch's segments per (slot, row, chunk)
  const int chunk = blockIdx.z / nsegs;    // z = chunk * nsegs + segment
  const int seg = blockIdx.z - chunk * nsegs;
  const int s = sb / B;
  const int b = sb - s * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = chunk * QW;
  const int nq = min(QW, Q - q0);  // queries of this chunk
  const int len = min(lengths[sb], capacity);
  const int qn = q_lens != nullptr ? q_lens[b] : Q;
  // query i sees columns c < min(lim0 + i, len); the chunk's last query
  // the most of them
  const int lim0 = min(len - (qn - 1), len);
  const int len_c = max(min(lim0 + q0 + nq - 1, len), 0);
  const size_t qrow0 = (static_cast<size_t>(b) * S + s) * Q + q0;  // chunk's first query
  TQ* o = out + qrow0 * G * Dh;
  if (len_c <= 0) {  // no query of the chunk sees a column: exact zeros, no K/V traffic
    if (part == 0 && seg == 0)
      for (int i = threadIdx.x; i < nq * G * Dh; i += blockDim.x) store(o + i, 0.f);
    return;
  }
  const int seg0 = seg * SEG;
  if (seg0 >= len_c) return;  // past the chunk's columns: no state, not waited for
  const int nseg = n_segments(len_c);        // the chunk's segments that hold columns
  const int slen = min(len_c - seg0, SEG);    // this segment's columns
  const int kind = (QUANT && kinds != nullptr) ? kinds[s] : 0;
  const int qp = window > 0 ? q_pos[b] : 0;
  const int cls0 = part * CPB;
  const int lw = warp % CPB;
  const int cls = cls0 + lw;
  const int g = warp / CPB;
  const bool live = g < G;  // a masked head's warp streams K/V with the block

  const int blk0 = seg0 / bs;  // the segment's first table block
  const int n_blk = (seg0 + slen - 1) / bs + 1 - blk0;
  const int off = seg0 - blk0 * bs;
  const Layout L = layout<TKV>(R, table_entries(capacity, bs), Dh, nsegs);
  const Stage SL = stage_layout<TKV>(Dh);
  float* ml_s = reinterpret_cast<float*>(smem);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  int* tbl_s = reinterpret_cast<int*>(smem + L.table);
  unsigned char* ring = smem + L.ring;
  const int* trow = table + static_cast<size_t>(sb) * M;
  for (int i = threadIdx.x; i < n_blk; i += blockDim.x) tbl_s[i] = max(trow[blk0 + i], 0);
  // the segment's record, read back where it is used, so that its
  // registers are free in the loop (the widest chunks use 128)
  if (threadIdx.x == 0) {
    flag[1] = off;
    flag[2] = seg;
    flag[3] = nseg;
    flag[4] = chunk;
    flag[5] = nsegs;
  }
  __syncthreads();

  const int ngroups = (slen + NCLS - 1) / NCLS;
  const int ntiles = (ngroups * CPB + ES - 1) / ES;
  const bool want_pos = window > 0;
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < ntiles)
      issue_stage<TKV, LCPB>(ring, SL, k_pool, v_pool, pos_pool, k_scale, v_scale, tbl_s,
                             flag[1], st, st, cls0, slen, bs, bs_shift, Dh, vec != 0, want_pos);
    hk::cp_async_commit();
  }
  // this warp's queries (an idle width repeats the chunk's last query; its
  // results are not written): query q0 + qw(i) sees the segment's columns
  // c < min(limq + qw(i), lens) inside its window, pos > thrq + qw(i) (limq
  // and lens counted from the segment's first column); the q loads overlap
  // the first stages' copies
  const int limq = lim0 + q0 - seg0, lens = len - seg0, thrq = qp + q0 - window;
  auto qw = [nq](int i) { return min(i, nq - 1); };
  float qv[QW][J];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int d = lane + 32 * j;
      qv[i][j] = live && d < Dh ? to_f(q[((qrow0 + qw(i)) * G + g) * Dh + d]) : 0.f;
    }
  }
  float m[QW], l[QW], acc[QW][J];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  }

  // The control flow around the shuffles depends only on block-uniform
  // values (t, ntiles); entries past a query's limit or outside its window
  // are scored but not applied.
  for (int t = 0; t < ntiles; ++t) {
    hk::cp_async_wait<NST - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; stage t-1 consumed
    if (t + NST - 1 < ntiles)
      issue_stage<TKV, LCPB>(ring, SL, k_pool, v_pool, pos_pool, k_scale, v_scale, tbl_s,
                             flag[1], t + NST - 1, (t + NST - 1) % NST, cls0, slen, bs,
                             bs_shift, Dh, vec != 0, want_pos);
    hk::cp_async_commit();
    const unsigned char* base = ring + static_cast<size_t>(t % NST) * SL.bytes;
    const TKV* ks = reinterpret_cast<const TKV*>(base);
    const TKV* vs = reinterpret_cast<const TKV*>(base + SL.v);
    const float* kss = reinterpret_cast<const float*>(base + SL.ksc);
    const float* vss = reinterpret_cast<const float*>(base + SL.vsc);
    const int* pss = reinterpret_cast<const int*>(base + SL.pos);
    const int gbase = t * PER;  // group (c / 8, in the segment) of the stage's first entry
#pragma unroll 1
    for (int i0 = 0; i0 < PER; i0 += NBU) {
      // scores of the batch, in straight-line stages so the entries'
      // loads, products and shuffle trees interleave: x = the dot product
      // (no softcap) or tanh(x * scale / cap), and the score s = a * x
      // with a = scale or cap
      float kr[NBU][J], x[QW][NBU];
#pragma unroll
      for (int u = 0; u < NBU; ++u) {
        const int le = ((i0 + u) << LCPB) + lw;
        const float ksc = QUANT ? kss[le] : 1.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int d = lane + 32 * j;
          kr[u][j] = d < Dh ? pool_f(ks[le * Dh + d], kind, ksc) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < QW; ++i) {
#pragma unroll
        for (int u = 0; u < NBU; ++u) {
          float part_sum = 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int d = lane + 32 * j;
            if (d < Dh) part_sum = __fmaf_rn(qv[i][j], kr[u][j], part_sum);
          }
          x[i][u] = part_sum;
        }
        warp_sum_batch(x[i]);
      }
      const bool capped = attn_cap > 0.f;
      if (capped) {
#pragma unroll
        for (int i = 0; i < QW; ++i)
#pragma unroll
          for (int u = 0; u < NBU; ++u)
            x[i][u] = tanhf(__fdiv_rn(__fmul_rn(x[i][u], scale), attn_cap));
      }
      const float a = capped ? attn_cap : scale;
      // entries each query applies: a prefix of the batch (c < its limit),
      // minus the window
      const int c0 = ((gbase + i0) << 3) + cls;
      unsigned vm[QW];
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        const int lim = min(limq + qw(i), lens);
        const int nv = min(max((lim - c0 + NCLS - 1) / NCLS, 0), NBU);
        vm[i] = (1u << nv) - 1u;
      }
      if (want_pos) {
#pragma unroll
        for (int u = 0; u < NBU; ++u) {
          const int pos = pss[((i0 + u) << LCPB) + lw];
#pragma unroll
          for (int i = 0; i < QW; ++i)
            if (!(pos > thrq + qw(i))) vm[i] &= ~(1u << u);
        }
      }
      // the running max through the batch, then every expf at once; an
      // entry that is not applied gets corr = 1, p = +0 and v = -0: then
      // l*1 + 0 = l (l is never -0) and acc*1 + (+0)(-0) = acc for every
      // acc, so the updates need no branch; a full batch skips the selects
      float corr[QW][NBU], p[QW][NBU];
      bool full = true;
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        full = full && vm[i] == (1u << NBU) - 1u;
#pragma unroll
        for (int u = 0; u < NBU; ++u) {
          const float mprev = m[i];
          if (vm[i] >> u & 1u) m[i] = fmaxf(m[i], __fmul_rn(a, x[i][u]));
          corr[i][u] = expf(__fsub_rn(mprev, m[i]));
          p[i][u] = expf(__fsub_rn(__fmul_rn(a, x[i][u]), m[i]));
        }
      }
      // the (l, acc) updates in entry order, once without the selects for a
      // batch every query applies in full
      auto update = [&](auto all_applied) {
#pragma unroll
        for (int u = 0; u < NBU; ++u) {
          const int le = ((i0 + u) << LCPB) + lw;
          const float vsc = QUANT ? vss[le] : 1.f;
          float vr[J];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int d = lane + 32 * j;
            vr[j] = d < Dh ? pool_f(vs[le * Dh + d], kind, vsc) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < QW; ++i) {
            const bool ok = decltype(all_applied)::value || (vm[i] >> u & 1u);
            const float cu = ok ? corr[i][u] : 1.f;
            const float pu = ok ? p[i][u] : 0.f;
            l[i] = __fmaf_rn(l[i], cu, pu);
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const float vj = ok ? vr[j] : -0.f;
              acc[i][j] = __fmaf_rn(acc[i][j], cu, __fmul_rn(pu, vj));
            }
          }
        }
      };
      if (full)
        update(std::true_type{});
      else
        update(std::false_type{});
    }
  }
  hk::cp_async_wait_all();

  // every block writes its chains' states to scratch; the last block of
  // the (slot, row, chunk) merges from there
  const int seg_w = flag[2], nseg_w = flag[3], nsegs_w = flag[5];
  const int seg0_w = seg_w * SEG;
  const size_t pc = static_cast<size_t>(sb) * (gridDim.z / nsegs_w) + flag[4];
  float* acc_dst = acc_scr + pc * nsegs_w * NCLS * R * Dh;
  float* ml_dst = ml_scr + pc * nsegs_w * NCLS * R * 2;
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    if (live && i < nq) {
      const int r = (seg_w * NCLS + cls) * R + i * G + g;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int d = lane + 32 * j;
        if (d < Dh) acc_dst[r * Dh + d] = acc[i][j];
      }
      if (lane == 0) {
        ml_dst[r * 2] = m[i];
        ml_dst[r * 2 + 1] = l[i];
      }
    }
  }
  // One segment: the chunk's last block merges the 8 classes and writes
  // the output.  More: each segment's last block merges its 8 classes into
  // the segment's (mx, lsum, a) per row, and the chunk's last such block
  // merges the segments in order (the slot kernel's merge).
  const bool split = nseg_w > 1;
  const size_t n_pc = static_cast<size_t>(gridDim.x) * (gridDim.z / nsegs_w);
  int* arrive = split ? counters + n_pc + pc * nsegs_w + seg_w : counters + pc;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(arrive, 1) == GP - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (threadIdx.x == 0) *arrive = 0;  // ready for the next launch
  const int rn = nq * G;  // rows to write
  float* acc_seg = acc_dst + static_cast<size_t>(seg_w) * NCLS * R * Dh;
  float* ml_seg = ml_dst + static_cast<size_t>(seg_w) * NCLS * R * 2;
  for (int i = threadIdx.x; i < NCLS * rn * 2; i += blockDim.x) {
    const int w = i / (rn * 2), k = i - w * rn * 2;
    ml_s[w * R * 2 + k] = __ldcg(ml_seg + w * R * 2 + k);
  }
  __syncthreads();

  // the segment's 8 classes in order: per row mx, lsum = the sum of l f
  // and a = the sum of acc f, f = expf(m - mx)
  for (int i = threadIdx.x; i < rn * Dh; i += blockDim.x) {
    const int r = i / Dh;
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < NCLS; ++c) mx = fmaxf(mx, ml_s[(c * R + r) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      // a class that saw no valid entry has l = 0 and acc = 0: no weight
      const float f = expf(ml_s[(c * R + r) * 2] - mx);
      lsum = __fmaf_rn(ml_s[(c * R + r) * 2 + 1], f, lsum);
      a = __fmaf_rn(__ldcg(acc_seg + static_cast<size_t>(c) * R * Dh + i), f, a);
    }
    if (!split) {
      store(o + i, lsum > 0.f ? a / lsum : 0.f);
    } else {  // over class 0's state: the segment's
      acc_seg[i] = a;
      if (i - r * Dh == 0) {
        ml_seg[r * 2] = mx;
        ml_seg[r * 2 + 1] = lsum;
      }
    }
  }
  if (!split) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counters + pc, 1) == nseg_w - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (threadIdx.x == 0) counters[pc] = 0;
  for (int i = threadIdx.x; i < nseg_w * rn * 2; i += blockDim.x) {
    const int sg = i / (rn * 2), k = i - sg * rn * 2;
    ml_s[sg * R * 2 + k] = __ldcg(ml_dst + static_cast<size_t>(sg) * NCLS * R * 2 + k);
  }
  __syncthreads();

  // the segments in order, over those below the query's limit (so query i
  // merges what the single-query kernel merges at its length): mx = the
  // max of their mx, g = expf(mx_s - mx), lsum = lsum_0 g_0 then + lsum_s
  // g_s, a = a_0 g_0 then + a_s g_s
  for (int i = threadIdx.x; i < rn * Dh; i += blockDim.x) {
    const int r = i / Dh;
    const int lim = min(limq + seg0_w + r / G, lens + seg0_w);
    const int nseg_r = n_segments(lim);
    float mx = NEG_INF;
    for (int sg = 0; sg < nseg_r; ++sg) mx = fmaxf(mx, ml_s[(sg * R + r) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll 8  // eight segments' loads in flight; the sums keep their order
    for (int sg = 0; sg < nseg_r; ++sg) {
      const float gw = expf(ml_s[(sg * R + r) * 2] - mx);
      const float ls = ml_s[(sg * R + r) * 2 + 1];
      const float as = __ldcg(acc_dst + static_cast<size_t>(sg) * NCLS * R * Dh + i);
      lsum = colseg::fold(sg, ls, gw, lsum);
      a = colseg::fold(sg, as, gw, a);
    }
    store(o + i, lsum > 0.f ? a / lsum : 0.f);
  }
}

struct Args {
  const void* q; const void* k_pool; const void* v_pool; const int* pos_pool;
  const int* table; const int* lengths; const int* q_pos; const int* q_lens;
  const float* k_scale; const float* v_scale; const int* kinds; void* out;
  float* scratch; int* counters;
  int B, S, Q, M, bs, Dh, capacity; float attn_cap; int window;
};

// The entry points launch the body under two names, so a profile tells them
// apart; the multi-query kernel at Q = 1 runs the body's instantiation that
// the single-query kernel runs.
template <typename TQ, typename TKV>
using KernelFn = void (*)(const TQ*, const TKV*, const TKV*, const int*, const int*,
                          const int*, const int*, const int*, const float*, const float*,
                          const int*, TQ*, float*, float*, int*, int, int, int, int, int, int,
                          int, int, float, float, int, int);

// Blocks per SM the registers are budgeted for: two (128 registers a
// thread), but one where a warp's state does not fit in 128 registers:
// quantized pools at a generic Dh with 4-5 queries per warp, and J = 8
// (Dh > 128) with two or more queries per warp.
template <typename TKV, int QW, int J, bool FULL>
constexpr int min_blocks() {
  return (sizeof(TKV) == 1 && !FULL && QW >= 4) || (J == 8 && QW >= 2) ? 1 : 2;
}

template <typename TQ, typename TKV, int G, int QW, int J, bool FULL, typename... A>
__global__ void __launch_bounds__(NWARPS * 32, (min_blocks<TKV, QW, J, FULL>()))
paged_decode_kernel(A... args) {
  decode_body<TQ, TKV, G, QW, J, FULL>(args...);
}

template <typename TQ, typename TKV, int G, int QW, int J, bool FULL, typename... A>
__global__ void __launch_bounds__(NWARPS * 32, (min_blocks<TKV, QW, J, FULL>()))
paged_decode_mq_kernel(A... args) {
  decode_body<TQ, TKV, G, QW, J, FULL>(args...);
}

template <bool MQ, typename TQ, typename TKV, int G, int QW, int J, bool FULL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  KernelFn<TQ, TKV> kernel;
  if constexpr (MQ)
    kernel = paged_decode_mq_kernel<TQ, TKV, G, QW, J, FULL>;
  else
    kernel = paged_decode_kernel<TQ, TKV, G, QW, J, FULL>;
  const int nseg = n_segments(a.capacity);
  const size_t smem = layout<TKV>(QW * G, table_entries(a.capacity, a.bs), a.Dh, nseg).total;
  static size_t opted = 48 * 1024;  // above 48 KB only as opted-in dynamic shared memory
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(a.Dh));
  const int vec = (a.Dh * static_cast<int>(sizeof(TKV))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.k_pool) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.v_pool) % 16 == 0;
  const int bs_shift = (a.bs & (a.bs - 1)) == 0 ? __builtin_ctz(a.bs) : -1;
  const int nch = n_chunks(a.Q);
  float* ml_scr =
      a.scratch + static_cast<size_t>(a.S) * a.B * nch * nseg * NCLS * QW * G * a.Dh;
  const dim3 grid(a.S * a.B, padded_group(G), nch * nseg);
  kernel<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.pos_pool, a.table, a.lengths, a.q_pos, a.q_lens,
      a.k_scale, a.v_scale, a.kinds, static_cast<TQ*>(a.out), a.scratch, ml_scr, a.counters,
      a.B, a.S, a.Q, a.M, a.bs, bs_shift, a.capacity, a.Dh, scale, a.attn_cap, a.window, vec);
  return cudaGetLastError();
}

template <bool MQ, typename TQ, typename TKV, int QW, int J, bool FULL>
cudaError_t dispatch_j(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: return launch<MQ, TQ, TKV, 1, QW, J, FULL>(a, st);
    case 2: return launch<MQ, TQ, TKV, 2, QW, J, FULL>(a, st);
    case 4: return launch<MQ, TQ, TKV, 4, QW, J, FULL>(a, st);
    case 8: return launch<MQ, TQ, TKV, 8, QW, J, FULL>(a, st);
    default: break;
  }
  // G = 5, 7 (padded to 8): the single-query kernel only, so the
  // multi-query library keeps its instantiations
  if constexpr (!MQ) {
    if (G == 5) return launch<MQ, TQ, TKV, 5, QW, J, FULL>(a, st);
    if (G == 7) return launch<MQ, TQ, TKV, 7, QW, J, FULL>(a, st);
  }
  return cudaErrorInvalidValue;
}

// the slot kernel's variants: Dh = 256: J = 8; Dh = 128: J = 4, FULL;
// below: J = 4 with lane guards
template <bool MQ, typename TQ, typename TKV, int QW>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t st) {
  if (a.Dh == 256) return dispatch_j<MQ, TQ, TKV, QW, 8, true>(G, a, st);
  return a.Dh == 128 ? dispatch_j<MQ, TQ, TKV, QW, 4, true>(G, a, st)
                     : dispatch_j<MQ, TQ, TKV, QW, 4, false>(G, a, st);
}

// q_dtype: 0 = float32, 1 = bfloat16 (q and out).  pool_dtype: 0 = float32,
// 1 = bfloat16 (must equal q_dtype), 2 = int8 codes (k_scale, v_scale and
// kinds are then read; kinds may be null for all-int8)
// MQ: the multi-query entry point's kernel name
template <bool MQ, int QW>
cudaError_t dispatch(int G, const Args& a, int q_dtype, int pool_dtype, cudaStream_t st) {
  if (a.Dh < 1 || (a.Dh > 128 && a.Dh != 32 * MAXJ) || a.B < 1 || a.S < 1 || a.Q < 1 || a.Q * G > MAX_QUERY_ROWS
      || a.M < 1 || a.bs < 1 || a.capacity < 1 || a.capacity > a.M * a.bs)
    return cudaErrorInvalidValue;
  if (pool_dtype == 2) {
    if (a.k_scale == nullptr || a.v_scale == nullptr) return cudaErrorInvalidValue;
    if (q_dtype == 0) return dispatch_g<MQ, float, int8_t, QW>(G, a, st);
    if (q_dtype == 1) return dispatch_g<MQ, __nv_bfloat16, int8_t, QW>(G, a, st);
    return cudaErrorInvalidValue;
  }
  if (pool_dtype != q_dtype) return cudaErrorInvalidValue;
  if (q_dtype == 0) return dispatch_g<MQ, float, float, QW>(G, a, st);
  if (q_dtype == 1) return dispatch_g<MQ, __nv_bfloat16, __nv_bfloat16, QW>(G, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paged

// The multi-query launcher's C signature (paged_fairkv_decode_mq.cu), and
// its part for one chunk width QW: paged_fairkv_decode_mq_w<QW>.cu each
// define one, so the multi-query library's instantiations compile as
// parallel translation units.
#define PAGED_MQ_PARAMS                                                                    \
  const void *q, const void *k_pool, const void *v_pool, const int *pos_pool,             \
      const int *table, const int *lengths, const int *q_pos, const int *q_lens,          \
      const float *k_scale, const float *v_scale, const int *kinds, void *out,            \
      float *scratch, int *counters, int B, int S, int Q, int G, int M, int bs, int Dh,   \
      int capacity, float attn_cap, int window, int q_dtype, int pool_dtype, void *stream
#define PAGED_MQ_ARGS                                                                      \
  q, k_pool, v_pool, pos_pool, table, lengths, q_pos, q_lens, k_scale, v_scale, kinds,    \
      out, scratch, counters, B, S, Q, G, M, bs, Dh, capacity, attn_cap, window, q_dtype, \
      pool_dtype, stream
#define PAGED_MQ_PART(QW)                                                                  \
  extern "C" int paged_fairkv_decode_mq_launch_w##QW(PAGED_MQ_PARAMS) {                    \
    const paged::Args a{q, k_pool, v_pool, pos_pool, table, lengths, q_pos, q_lens,       \
                        k_scale, v_scale, kinds, out, scratch, counters,                  \
                        B, S, Q, M, bs, Dh, capacity, attn_cap, window};                  \
    return paged::dispatch<true, QW>(G, a, q_dtype, pool_dtype,                           \
                                     static_cast<cudaStream_t>(stream));                  \
  }
