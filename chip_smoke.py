#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on past its own):

1. print the card's name and power limit (nvidia-smi);
2. build the four CUDA kernels from `src/repro_torch/csrc` with nvcc (one
   process per source, started together) and print the build seconds and,
   for every kernel instantiation, ptxas's registers, stack and spill (a
   stack frame or a spill fails the run);
3. hold each kernel against its plain PyTorch version on the card over a
   shape sweep plus the main path's shapes: fp32 and bf16, ragged lengths,
   an all-zero slot, window and softcap; for the paged kernels also int8,
   fp8 and mixed-kind pools, G in {1, 2, 4, 8}, null-block tables and
   partial last blocks; for the multi-query (speculative-verify) kernel Q
   in {1, 3, 5} with ragged q_lens, and at Q = 1 bitwise equality with the
   single-query paged kernel; the slot kernel also bitwise against the
   paged kernel over an identity block table (lengths up to 1600), and the
   score kernel at B = 1 with T tails off its 64-key tile and W*G from 32
   to 256, and at the chunked-prefill shape (B = 1, 512 keys at positions
   from 0 to 1536, padded last chunks; tolerances stated at each check);
   then the paged kernels' bitwise contracts: every query of the multi-query kernel equals the
   single-query kernel at its causal length and q_pos + i (Q 1 to 40, the
   query chunks included), and both kernels are unchanged on pools whose
   blocks are relabelled through the table;
4. check the port's CUDA path against its own CPU path on minitron-8b smoke
   (same weights, fp32): identical tokens and lengths, close logits; then
   speculative `run_trace` (full-depth and 1-layer drafts) against the
   card's plain paged run and the CPU's spec run: identical tokens;
5. the main path at full width: minitron-8b (32 layers, d_model 4096, 32/8
   heads, vocab 256000) in bf16 with random weights from a seed, 8 shards x 2
   slots, Ada-SnapKV (budget 256 -> capacity 576), B=8 prompts of T=2048
   tokens, 32 new tokens: `measure_profile`, then `generate` under sha,
   fairkv_nodp and fairkv_dp.  Launch counters are zeroed just before and
   read just after each phase; asserts the launch counts, plan-invariant
   retained lengths and a bf16 logit bound; prints timings, plan metrics,
   memory; then one torch.profiler pass over decode steps;
6. one-shot `generate` on the paged backend (fairkv_dp, block size 16):
   bf16 pools next to the slot run (lengths bitwise, logit gap under the
   bf16 bound, 32 paged-kernel launches per step, no slot-kernel launch),
   then int8 and fp8 pools against the bf16 pools (logit cosine, argmax
   agreement; bars in QUANT_BARS); one profiled step per pool format
   (device time, `prepare_decode` host time);
7. continuous batching: a 24-request Poisson trace (prompts 512-2048
   tokens, 16-64 new tokens) through `Engine.run_trace` with 8 rows and
   online replanning, on the slot backend, bf16 pools, int8 pools and an
   undersized fp8 pool that must preempt; every request must finish, every
   pool end empty, and the slot and bf16-pool runs give identical tokens
   and replan decisions; then self-speculative decoding on the same trace:
   (e) an 8-layer draft with adaptive depth, (f) the full-depth self-draft
   (acceptance >= 0.90) on bf16 pools, (g) (e)'s draft on int8 pools;
   (e) against the bf16 run: logit gap under the bf16 bound while the
   tokens agree and every divergence a near-tie; one profiler pass over
   continuous decode ticks and one over speculative ticks;
8. chunked prefill and prefix reuse (bf16 pools, chunks of 512 tokens,
   8 rows) on phase 7's arrivals with prompts of 1536-2048 tokens, 75% of
   them starting with one of two 1024-token templates: (h) policy "none",
   chunking only, and (i) with sharing: identical tokens for all 24
   requests, prefix hits, refcount > 1 while requests are live, fewer
   peak blocks per layer, an empty pool after flushing the index; (j)
   copy-on-write when a donor's ring wraps into its shared prefix, the
   late sharer's tokens equal to an unshared engine's; (k) Ada-SnapKV
   with sharing beside phase 7's bf16 configuration on the same trace
   (peak blocks, TTFT, tokens/s, share of equal tokens);
9. CUDA graphs against eager execution at full width.  Every phase above
   runs its decode, propose, verify and chunk steps as CUDA graphs
   (`repro_torch.exec.local`; prefill stays eager); each continuous run
   captures them in `Engine.warmup` and fails if its trace captures again
   (graphs are keyed by the storage they run on, so a replan, splice or
   retirement that allocated new tensors would show as a capture).  This
   phase runs eagerly: one-shot fairkv_dp (phase 5's tokens and lengths,
   the logit gap printed and bounded), (b) (tokens and replan decisions),
   (e) (tokens and acceptance) and (i) (tokens, hits, copy-on-write), each
   on its whole trace, and prints host-clocked and device time per
   one-shot step, continuous tick, speculative tick and chunk step,
   graphed and eager (a pass with no device time fails);
10. time each kernel, its plain version and the PyTorch library call where
   one exists on the main path's own inputs (device time from CUDA events,
   median of 25 runs after warmup, L2 flushed before each run; snapkv
   also at B = 1 and at the chunk shape) beside the least time the card
   could take, and print them as one JSON line; the host time per call of
   kernels 1 and 2;
11. after the timings, so that kernel 1 is timed on the main path's own
   cache: the decode step's ops by input shapes under torch.profiler (one
   eager step on the main engine, which fails if it copies a slot weight:
   the einsum relayout that was the 7.2 ms elementwise kernel); then one
   engine serving one-shot and continuous at once (slot backend, 8
   scheduler rows, so the one-shot state and the scheduler's have one
   layout): generate, a one-shot replan, generate, `warmup`, then the
   first 4 requests of phase 7's trace with a generate after tick 4.
   Graphed and eager engines driven alike give the same one-shot tokens
   and logits and the same trace tokens; the first generate gives phase
   5's tokens; the graphed engine captures one decode graph per live
   state and nothing more;
12. (runs after phase 9 and before the timings, so its launches are in the
   kernel table) the six compression policies at phase 5's width: one-shot
   B = 8, T = 2048, 32 new tokens under streaming_llm, snapkv, pyramidkv,
   h2o, ada_snapkv and headkv (also with phase 5's measured profile as
   head_importance), each under sha and fairkv_dp (CH = 4) planned from the
   policy's own measured profile; bars: lengths bitwise plan-invariant,
   balanced policies keep exactly min(budget_l, T, C) per head,
   `layer_keep_bound` >= the realized sum of keep per layer and row, phase
   5's logit bound; prints the retained sum per layer, the per-shard load
   max/mean under both plans, plan efficiency, the graphed step's host and
   device time and kernel 1's time per step.  Then phase 7's (b) under
   headkv with obs on and off (identical tokens, no capture during the
   trace read from stepfn_compiles_total, Prometheus text and Chrome trace
   that parse; the tick medians) and (c)'s int8 pools with
   `plan_kv_dtypes` overrides (every request finishes, the pool ends empty);
13. `python -m repro_torch.launch.serve --arch minitron-8b --continuous
   --policy headkv --cache-backend paged` in a subprocess at full width
   with a few requests, metrics and trace written under chiprun_out/: exit
   0, both files parse;
14. last line: {"ok": true, "device": {...}}.

Without CUDA, or run from a directory that does not hold the repository's
`src/repro_torch`, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# main-path configuration (phase 5)
ARCH = "minitron-8b"
N_SHARDS, SLOTS_PER_SHARD = 8, 2
B, T, GEN = 8, 2048, 32
BUDGET, ALPHA, OBS, POOL, SINK, MARGIN = 256, 2.0, 32, 7, 4, 64
PLANNERS = (("sha", 0), ("fairkv_nodp", 0), ("fairkv_dp", 4))
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores

FP32_TOL = 1e-4  # fp32 kernel vs fp32 plain version: only the summation order differs
BF16_ULP = 2.0 ** -7  # one bf16 rounding step, relative (8-bit significand)
# paged kernel vs its plain version: the reference's own bars for its TPU
# kernel (tests/test_paged_kernel.py) — 1e-5 absolute with fp32 outputs
# (fp32 and int8/fp8 pools alike: both sides dequantize to the same fp32
# values), 0.03 absolute with bf16 outputs (one bf16 rounding of a value
# of magnitude up to ~4).  bf16 outputs must also meet the slot kernel's
# tighter bar, FP32_TOL + BF16_ULP |plain|: both sides accumulate in fp32
# and round once to bf16, so they differ by at most one bf16 step.
PAGED_FP32_TOL = 1e-5
PAGED_BF16_TOL = 0.03
BLOCK = 16  # paged block size of the continuous runs


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(report: str):
    """[(kernel function, registers, stack bytes, spill store bytes, spill
    load bytes)] from an ``nvcc -Xptxas -v`` report, names demangled with
    cu++filt where the toolkit has it."""
    import re
    import shutil
    rows, name, props = [], None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, props = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *(props or (0, 0, 0))))
            name = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and Path(filt).exists():
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows), text=True,
                             capture_output=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            rows = [(_short_name(o), *r[1:]) for o, r in zip(out, rows)]
    return rows


def _short_name(demangled: str) -> str:
    """`void ns::(anonymous namespace)::kern<float, 4, true, float const*, ...>(float
    const*, ...)` -> `kern<float, 4, true>`."""
    name = demangled.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    name = name.removeprefix("void ")
    end = name.find(">(")
    name = name[:end + 1] if end >= 0 else name.split("(")[0]
    head, lt, tail = name.partition("<")
    if lt:  # drop a trailing pack of parameter types: kern<float, 4, true, float const*, ...>
        args = tail[:-1].split(", ")
        n = next((i for i, a in enumerate(args) if "*" in a), len(args))
        tail = ", ".join(args[:n]) + ">"
    return head.split("::")[-1] + lt + tail


def build_kernels():
    """Build every kernel library (one nvcc per source, in parallel) and
    print the build time and, per kernel instantiation, ptxas's registers,
    stack and spill; fails if any instantiation spills or uses a stack."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    dt = time.perf_counter() - t0
    log(f"[build] {len(reports)} kernel libraries built in {dt:.1f} s "
        f"(sources: {', '.join(build.KERNELS)})")
    for name, rep in reports.items():
        rows = ptxas_summary(rep)
        for fn, regs, stack, st, ld in rows:
            log(f"[ptxas {name}] {fn}: {regs} registers, {stack} B stack, "
                f"{st}/{ld} B spill stores/loads")
        if rows:
            log(f"[ptxas {name}] {len(rows)} instantiations: registers "
                f"{min(r[1] for r in rows)}-{max(r[1] for r in rows)}, max stack "
                f"{max(r[2] for r in rows)} B, max spill {max(r[3] + r[4] for r in rows)} B")
        bad = [r for r in rows if r[2] or r[3] or r[4]]
        if bad:
            fail(f"{name}: ptxas reports stack or spill in {len(bad)} instantiations "
                 f"(first: {bad[0]})")
    for name in build.KERNELS:
        build.load(name)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _cmp(name, out, ref, tol_abs, tol_rel=0.0):
    import torch
    torch.cuda.synchronize()
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        fail(f"{name}: non-finite kernel output")
    err = (o - r).abs()
    bound = tol_abs + tol_rel * r.abs()
    if not bool((err <= bound).all()):
        fail(f"{name}: max |kernel - plain| = {err.max().item():.3e} exceeds "
             f"{tol_abs:g} + {tol_rel:g}|plain|")
    return err.max().item()


def _cmp_paged(name, out, ref):
    """The paged kernel's bars (PAGED_*_TOL, one bf16 step); max abs err."""
    import torch
    if out.dtype == torch.float32:
        return _cmp(name, out, ref, PAGED_FP32_TOL)
    _cmp(name, out, ref, FP32_TOL, BF16_ULP)
    return _cmp(name, out, ref, PAGED_BF16_TOL)


def decode_inputs(gen, Bq, S, G, Dh, C, dtype, empty_slot=False, lengths=None):
    import torch
    dev = "cuda"
    q = torch.randn((Bq, S, G, Dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((S, Bq, C, Dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((S, Bq, C, Dh), generator=gen, device=dev).to(dtype)
    if lengths is None:
        lengths = torch.randint(0 if empty_slot else 1, C + 1, (S, Bq),
                                generator=gen, device=dev, dtype=torch.int32)
    if empty_slot:
        lengths[0] = 0
    k_pos = torch.arange(C, dtype=torch.int32, device=dev).expand(S, Bq, C).contiguous()
    q_pos = torch.full((Bq,), C + 7, dtype=torch.int32, device=dev)
    return q, k, v, lengths, k_pos, q_pos


# (slot, row) lengths from one entry to C = 1600: partial and whole groups
# of 8 column classes, one to 13 ring stages of the slot kernel's blocks
SPLIT_LENGTHS = (1, 7, 32, 33, 128, 129, 577, 1000, 1599, 1600)


def check_decode(gen):
    """fairkv_decode against fairkv_decode_ref (tolerance below) and, on
    every case, bitwise against paged_fairkv_decode_cuda over the same
    cache laid out as pools with an identity block table."""
    import torch
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.kernels.ref import fairkv_decode_ref
    from repro_torch.paging.testing import slot_layer_as_pool
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(4, 8, 8, 64, 256), (2, 16, 1, 128, 200), (3, 5, 4, 32, 96),
              (1, 16, 8, 128, 1600), (2, 4, 2, 16, 64),
              (B, N_SHARDS * SLOTS_PER_SHARD, 4, 128, C_main), (2, 5, 4, 128, 1600)]
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        # bf16: both sides compute in fp32 from the same bf16 values and
        # round once to bf16, so they may differ by one bf16 step
        tol_rel = 0.0 if dtype == torch.float32 else BF16_ULP
        for (Bq, S, G, Dh, C) in shapes:
            lengths = None
            if C == 1600 and S * Bq == len(SPLIT_LENGTHS):
                lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32,
                                       device="cuda").reshape(S, Bq)
            for window, cap, empty in ((0, 0.0, False), (0, 0.0, True),
                                       (C // 3, 0.0, False), (0, 50.0, True)):
                ln_in = None if lengths is None else lengths.clone()
                q, k, v, ln, kp, qp = decode_inputs(gen, Bq, S, G, Dh, C, dtype, empty,
                                                    lengths=ln_in)
                out = fairkv_decode_cuda(q, k, v, ln, cap, k_pos=kp, q_pos=qp,
                                         window=window)
                ref = fairkv_decode_ref(q, k, v, ln, cap, k_pos=kp, q_pos=qp,
                                        window=window)
                tag = f"fairkv_decode {dtype} {(Bq, S, G, Dh, C)} w={window} cap={cap}"
                worst = max(worst, _cmp(tag, out, ref, FP32_TOL, tol_rel))
                if empty and out[:, 0].abs().max().item() != 0.0:
                    fail(f"{tag}: the all-zero slot's output is not exactly 0")
                kpool, vpool, ppool, tbl = slot_layer_as_pool(k, v, kp, BLOCK)
                paged = paged_fairkv_decode_cuda(q, kpool, vpool, ppool, tbl, ln, C, cap,
                                                 q_pos=qp, window=window)
                if not torch.equal(out, paged):
                    d = (out.float() - paged.float()).abs().max().item()
                    fail(f"{tag}: differs from paged_fairkv_decode_cuda over an identity "
                         f"block table (max |diff| {d:.3e}); the two must agree bitwise")
                n += 1
    log(f"[check] fairkv_decode: {n} cases vs plain, max abs err {worst:.3e} "
        f"(tol {FP32_TOL:g} fp32; + one bf16 step {BF16_ULP:g}|plain| for bf16); "
        f"all {n} bitwise equal to paged_fairkv_decode_cuda over an identity block table "
        f"(lengths 1 to 1600)")


def scores_inputs(gen, Bq, W, Hq, Hkv, Dh, Tk, dtype):
    import torch
    dev = "cuda"
    q = torch.randn((Bq, W, Hq, Dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((Bq, Tk, Hkv, Dh), generator=gen, device=dev).to(dtype)
    kpos = torch.arange(Tk, dtype=torch.int32, device=dev).expand(Bq, Tk).contiguous()
    opos = torch.arange(Tk - W, Tk, dtype=torch.int32, device=dev).expand(Bq, W).contiguous()
    return q, k, opos, kpos


def check_scores(gen):
    import torch
    from repro_torch.kernels.ref import snapkv_scores_ref
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    # the main shape; B = 1 (the continuous scheduler's admission prefills)
    # with T tails that are not multiples of the 64-key tile; G = 1, 2, 8
    # at W = 32 (R = 32 ... 256 query rows); Dh 32, 64, 128
    shapes = [(2, 8, 8, 2, 64, 256), (1, 4, 4, 4, 32, 100), (2, 16, 8, 8, 64, 128),
              (B, OBS, 32, 8, 128, T)]
    shapes += [(1, OBS, 32, 8, 128, Tk) for Tk in (63, 1000, 2047, 2048)]
    shapes += [(1, OBS, 8 * G, 8, 128, 1000) for G in (1, 2, 8)]
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (Bq, W, Hq, Hkv, Dh, Tk) in shapes:
            for cap in (0.0, 50.0):
                q, k, opos, kpos = scores_inputs(gen, Bq, W, Hq, Hkv, Dh, Tk, dtype)
                out = snapkv_scores_cuda(q, k, opos, kpos, cap)
                ref = snapkv_scores_ref(q, k, opos, kpos, cap)
                tag = f"snapkv_scores {dtype} {(Bq, W, Hq, Hkv, Dh, Tk)} cap={cap}"
                # fp32 outputs from identical inputs: only the order of the
                # exp sums differs; entries are sums of up to W*G probabilities
                worst = max(worst, _cmp(tag, out, ref, FP32_TOL, 1e-5))
                mass = out.sum(dim=-1)
                G = Hq // Hkv
                if not torch.allclose(mass, torch.full_like(mass, W * G), rtol=1e-4):
                    fail(f"{tag}: mass per (b, h) is not W*G = {W * G}")
                n += 1
    log(f"[check] snapkv_scores: {n} cases vs plain, max abs err {worst:.3e} "
        f"(tol {FP32_TOL:g} + 1e-5|plain|), mass W*G per (b, h) conserved")
    check_scores_chunk(gen)


def chunk_scores_inputs(gen, W, Hq, Hkv, Dh, Ck, start, valid, dtype):
    """Kernel 2's inputs at the chunked-prefill shape, as `_chunk_attention`
    builds them: B = 1, the chunk's Ck keys at absolute positions
    start .. start + Ck - 1 (keys past ``valid`` are the padding of a last
    chunk), and the last min(W, Ck) valid queries (indices clipped at 0,
    so a chunk with fewer than W valid tokens repeats its first query)."""
    import torch
    q_all = torch.randn((1, Ck, Hq, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, Ck, Hkv, Dh), generator=gen, device="cuda").to(dtype)
    kpos = (start + torch.arange(Ck, dtype=torch.int32, device="cuda"))[None].contiguous()
    ix = torch.clamp(valid - W + torch.arange(W, device="cuda"), 0, Ck - 1)
    return q_all[:, ix].contiguous(), k, kpos[:, ix].contiguous(), kpos


def check_scores_chunk(gen):
    """Kernel 2 at the chunked-prefill shape (B = 1, W = OBS queries, Ck =
    CHUNK keys at positions from ``start``): full chunks at start 0 and
    1024, a padded last chunk (valid 300 < Ck) and one with fewer valid
    tokens than W (valid 20); against the plain version (tolerance as in
    `check_scores`), the W*G mass kept, and the padding keys scored
    exactly 0 (every query precedes them)."""
    import torch
    from repro_torch.kernels.ref import snapkv_scores_ref
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for start, valid in ((0, CHUNK), (1024, CHUNK), (1024, 300), (1536, 20)):
            for cap in (0.0, 50.0):
                q, k, opos, kpos = chunk_scores_inputs(gen, OBS, 32, 8, 128, CHUNK, start,
                                                       valid, dtype)
                out = snapkv_scores_cuda(q, k, opos, kpos, cap)
                ref = snapkv_scores_ref(q, k, opos, kpos, cap)
                tag = f"snapkv_scores chunk {dtype} start={start} valid={valid} cap={cap}"
                worst = max(worst, _cmp(tag, out, ref, FP32_TOL, 1e-5))
                mass = out.sum(dim=-1)
                if not torch.allclose(mass, torch.full_like(mass, OBS * 4), rtol=1e-4):
                    fail(f"{tag}: mass per (b, h) is not W*G = {OBS * 4}")
                if valid < CHUNK and bool((out[..., valid:] != 0).any()):
                    fail(f"{tag}: padding keys past valid scored non-zero")
                n += 1
    log(f"[check] snapkv_scores at the chunk shape (B=1, W={OBS}, Hq=32, Hkv=8, Dh=128, "
        f"T={CHUNK}, start 0 / 1024 / 1536, valid {CHUNK} / 300 / 20): {n} cases vs plain, "
        f"max abs err {worst:.3e} (tol {FP32_TOL:g} + 1e-5|plain|), mass W*G conserved, "
        f"padding keys exactly 0")


def check_paged():
    """paged_fairkv_decode against paged_fairkv_decode_ref on the card:
    bf16 / fp32 pools, int8, fp8 and mixed kinds (fp32 and bf16 queries),
    G in {1, 2, 4, 8}, ragged lengths with empty (all-null) table rows,
    partial last blocks, an all-zero-length layer, window + softcap, fp8
    NaN codes inside the valid range (read as 0 by both), and the main
    path's shape (S=16, B=8, G=4, Dh=128, C=576, bs=16)."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.kernels.ref import paged_fairkv_decode_ref
    rng = np.random.default_rng(SEED)
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(3, 2, 1, 64, 96, 16), (4, 3, 2, 32, 200, 8), (2, 2, 8, 64, 256, 32),
              (3, 2, 4, 128, 100, 64), (N_SHARDS * SLOTS_PER_SHARD, B, 4, 128, C_main, BLOCK)]
    worst = {}  # (pools, output dtype) -> max abs err
    n = 0
    for (S, Bq, G, Dh, C, bs) in shapes:
        for window, cap in ((0, 0.0), (C // 3, 0.0), (0, 30.0), (C // 2, 30.0)):
            for mode in ("fp32", "bf16", "int8", "fp8", "mixed"):
                for q_dt in ((torch.float32, torch.bfloat16) if mode in ("int8", "fp8", "mixed")
                             else (torch.float32 if mode == "fp32" else torch.bfloat16,)):
                    lengths = np.zeros((S, Bq), np.int32) if n % 17 == 5 else None
                    kp, vp, pp, tbl, ln, qkw = _paged_case(rng, mode, S, Bq, C, bs, Dh,
                                                           lengths)
                    q = torch.from_numpy(rng.normal(size=(Bq, S, G, Dh)).astype(np.float32)
                                         ).to("cuda", q_dt)
                    qpos = torch.full((Bq,), C + 7, dtype=torch.int32, device="cuda")
                    out = paged_fairkv_decode_cuda(q, kp, vp, pp, tbl, ln, C, cap,
                                                   q_pos=qpos, window=window, **qkw)
                    ref = paged_fairkv_decode_ref(q, kp, vp, pp, tbl, ln, C, cap,
                                                  q_pos=qpos, window=window, **qkw)
                    tag = (f"paged_fairkv_decode {mode} q={q_dt} {(S, Bq, G, Dh, C, bs)} "
                           f"w={window} cap={cap}")
                    key = (mode, str(q_dt).replace("torch.", ""))
                    worst[key] = max(worst.get(key, 0.0), _cmp_paged(tag, out, ref))
                    empty = (ln == 0).T  # (B, S)
                    if bool(empty.any()) and out[empty].abs().max().item() != 0.0:
                        fail(f"{tag}: a (slot, row) of length 0 is not exactly 0")
                    n += 1
    log(f"[check] paged_fairkv_decode: {n} cases vs plain (tol {PAGED_FP32_TOL:g} with "
        f"fp32 outputs; {PAGED_BF16_TOL:g} and {FP32_TOL:g} + {BF16_ULP:g}|plain| with "
        f"bf16); max abs err by (pools, q): "
        + ", ".join(f"{p}/{q} {e:.3e}" for (p, q), e in sorted(worst.items())))


def _paged_case(rng, mode, S, Bq, C, bs, Dh, lengths=None):
    """One layer for the paged kernels' checks: (k, v, pos, table, lengths,
    quantization kwargs); int8 / fp8 / mixed pools get fp8 NaN codes
    planted in valid columns of their fp8 slots (both sides read 0)."""
    import numpy as np
    import torch
    from repro_torch.paging.testing import make_paged_layer, quantize_paged_layer
    pool_dt = torch.bfloat16 if mode == "bf16" else torch.float32
    kp, vp, pp, tbl, ln = make_paged_layer(rng, S, Bq, C, bs, Dh, dtype=pool_dt,
                                           lengths=lengths, device="cuda")
    kw = {}
    if mode in ("int8", "fp8", "mixed"):
        kinds = {"int8": np.zeros(S), "fp8": np.ones(S),
                 "mixed": np.arange(S) % 2}[mode].astype(np.int32)
        kinds = torch.from_numpy(kinds).to("cuda")
        kp, vp, ks, vs = quantize_paged_layer(kp, vp, tbl, kinds)
        if mode != "int8":
            fp8_blocks = tbl[kinds.bool()][..., 0]
            fp8_blocks = fp8_blocks[fp8_blocks > 0]
            kp[fp8_blocks, 0, :4] = 0x7F
            vp[fp8_blocks, 0, 4:8] = -1  # 0xFF
        kw = dict(k_scale=ks, v_scale=vs, kinds=kinds)
    return kp, vp, pp, tbl, ln, kw


def check_paged_mq():
    """paged_fairkv_decode_mq against paged_fairkv_decode_ref with a 5-D q
    on the card: Q in {1, 3, 5} with ragged q_lens (garbage lanes past
    them), G in {1, 4, 8}, fp32 / bf16 / int8 / fp8 / mixed pools (fp32 and
    bf16 queries on the quantized ones), ragged lengths with empty pairs
    and lengths under the window (queries with no visible entry), null
    tables, partial last blocks, window + softcap, and the full-width shape
    (S=16, B=8, G=4, Dh=128, C=576, bs=16).  Tolerance: fp32 outputs within
    FP32_TOL, bf16 outputs within one bf16 step (FP32_TOL + BF16_ULP|plain|).
    At Q = 1 the kernel must equal `paged_fairkv_decode_cuda` bitwise."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    from repro_torch.kernels.ref import paged_fairkv_decode_ref
    rng = np.random.default_rng(SEED + 2)
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(3, 2, 1, 64, 96, 16), (4, 3, 4, 32, 200, 8), (2, 2, 8, 64, 64, 32),
              (N_SHARDS * SLOTS_PER_SHARD, B, 4, 128, C_main, BLOCK)]
    worst, n, n_bitwise = {}, 0, 0
    for (S, Bq, G, Dh, C, bs) in shapes:
        for Q in (1, 3, 5):
            for window, cap in ((0, 0.0), (C // 3, 30.0)):
                for mode in ("fp32", "bf16", "int8", "fp8", "mixed"):
                    for q_dt in ((torch.float32, torch.bfloat16)
                                 if mode in ("int8", "fp8", "mixed")
                                 else (torch.float32 if mode == "fp32" else torch.bfloat16,)):
                        lengths = np.zeros((S, Bq), np.int32) if n % 23 == 7 else None
                        kp, vp, pp, tbl, ln, kw = _paged_case(rng, mode, S, Bq, C, bs, Dh,
                                                              lengths)
                        q = torch.from_numpy(rng.normal(size=(Bq, S, Q, G, Dh)).astype(
                            np.float32)).to("cuda", q_dt)
                        q_lens = torch.from_numpy(rng.integers(1, Q + 1, size=Bq).astype(
                            np.int32)).to("cuda")
                        qpos = torch.full((Bq,), C + 7, dtype=torch.int32, device="cuda")
                        args = (q, kp, vp, pp, tbl, ln, C, cap)
                        out = paged_fairkv_decode_mq_cuda(*args, q_pos=qpos, window=window,
                                                          q_lens=q_lens, **kw)
                        ref = paged_fairkv_decode_ref(*args, q_pos=qpos, window=window,
                                                      q_lens=q_lens, **kw)
                        tag = (f"paged_fairkv_decode_mq {mode} q={q_dt} Q={Q} "
                               f"{(S, Bq, G, Dh, C, bs)} w={window} cap={cap}")
                        rel = 0.0 if q_dt == torch.float32 else BF16_ULP
                        key = (mode, str(q_dt).replace("torch.", ""))
                        worst[key] = max(worst.get(key, 0.0), _cmp(tag, out, ref, FP32_TOL, rel))
                        lnT = ln.T[:, :, None].long()  # (B, S, 1)
                        limit = torch.minimum(lnT - (q_lens.long()[:, None, None] - 1
                                                     - torch.arange(Q, device="cuda")), lnT)
                        dead = limit <= 0  # queries that see no entry
                        if bool(dead.any()) and out[dead].abs().max().item() != 0.0:
                            fail(f"{tag}: a query with no visible entry is not exactly 0")
                        if Q == 1:
                            single = paged_fairkv_decode_cuda(q[:, :, 0].contiguous(), kp, vp,
                                                              pp, tbl, ln, C, cap, q_pos=qpos,
                                                              window=window, **kw)
                            if not torch.equal(single, out[:, :, 0]):
                                fail(f"{tag}: Q = 1 differs from paged_fairkv_decode_cuda")
                            n_bitwise += 1
                        n += 1
    log(f"[check] paged_fairkv_decode_mq: {n} cases vs plain (tol {FP32_TOL:g} with fp32 "
        f"outputs, {FP32_TOL:g} + {BF16_ULP:g}|plain| with bf16); {n_bitwise} Q = 1 cases "
        f"bitwise equal to paged_fairkv_decode_cuda; max abs err by (pools, q): "
        + ", ".join(f"{p}/{q} {e:.3e}" for (p, q), e in sorted(worst.items())))


def _single_per_query(q, kp, vp, pp, tbl, ln, C, cap, qpos, window, q_lens, kw):
    """paged_fairkv_decode_cuda once per query i of a 5-D q, at the query's
    causal lengths and q_pos + i: what the multi-query kernel's query i
    must equal bitwise."""
    import torch
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.paging.testing import query_lengths
    return torch.stack([paged_fairkv_decode_cuda(q[:, :, i].contiguous(), kp, vp, pp, tbl,
                                                 query_lengths(ln, q_lens, i), C, cap,
                                                 q_pos=qpos + i, window=window, **kw)
                        for i in range(q.shape[2])], dim=2)


def check_paged_contracts():
    """The bitwise contracts of the paged kernels on the card, with zero
    mismatches allowed:

    - query i of paged_fairkv_decode_mq equals paged_fairkv_decode at
      lengths min(len - (qn - 1 - i), len) clamped at 0 and q_pos + i, for
      fp32 / bf16 / int8 / fp8 / mixed pools, with and without window and
      softcap, at Q from 1 to 40 (queries split into chunks: G = 1 at
      Q = 9 and 40, G = 2 at Q = 7) and at the main path's shape;
    - both kernels on pools whose blocks are relabelled, through the
      remapped table, equal their output on the original layer."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    from repro_torch.paging.testing import relabel_pool_blocks
    rng = np.random.default_rng(SEED + 3)
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(3, 2, 1, 64, 96, 16, (1, 5, 9, 40)), (4, 3, 4, 32, 200, 8, (3, 5)),
              (2, 2, 8, 64, 64, 32, (5,)), (2, 3, 2, 128, 300, 16, (7,)),
              (N_SHARDS * SLOTS_PER_SHARD, B, 4, 128, C_main, BLOCK, (5,))]
    n_query = n_perm = 0
    for (S, Bq, G, Dh, C, bs, Qs) in shapes:
        for mode in ("fp32", "bf16", "int8", "fp8", "mixed"):
            for window, cap in ((0, 0.0), (C // 3, 30.0)):
                q_dt = (torch.bfloat16 if mode == "bf16" or (mode != "fp32" and window)
                        else torch.float32)
                kp, vp, pp, tbl, ln, kw = _paged_case(rng, mode, S, Bq, C, bs, Dh)
                qpos = torch.full((Bq,), C + 7, dtype=torch.int32, device="cuda")
                perm = None
                for Q in Qs:
                    tag = (f"paged contracts {mode} q={q_dt} Q={Q} {(S, Bq, G, Dh, C, bs)} "
                           f"w={window} cap={cap}")
                    q = torch.from_numpy(rng.normal(size=(Bq, S, Q, G, Dh)).astype(
                        np.float32)).to("cuda", q_dt)
                    q_lens = torch.from_numpy(rng.integers(1, Q + 1, size=Bq).astype(
                        np.int32)).to("cuda")
                    q_lens[0] = Q
                    args = (q, kp, vp, pp, tbl, ln, C, cap)
                    out = paged_fairkv_decode_mq_cuda(*args, q_pos=qpos, window=window,
                                                      q_lens=q_lens, **kw)
                    single = _single_per_query(q, kp, vp, pp, tbl, ln, C, cap, qpos, window,
                                               q_lens, kw)
                    torch.cuda.synchronize()
                    if not torch.equal(out, single):
                        bad = (out != single).flatten(3).any(-1).nonzero()[0].tolist()
                        fail(f"{tag}: query {bad[2]} of (b, s) = {tuple(bad[:2])} differs from "
                             f"paged_fairkv_decode at its causal length and position")
                    n_query += 1
                    if Q in (1, 5) and mode in ("fp32", "bf16", "int8", "mixed"):
                        if perm is None:
                            keys = [k for k in ("k_scale", "v_scale") if k in kw]
                            *layer, scales = relabel_pool_blocks(
                                kp, vp, pp, tbl, [kw[k] for k in keys], seed=SEED + n_perm)
                            perm = (*layer, dict(kw, **dict(zip(keys, scales))))
                        kp2, vp2, pp2, tbl2, kw2 = perm
                        out2 = paged_fairkv_decode_mq_cuda(q, kp2, vp2, pp2, tbl2, ln, C, cap,
                                                           q_pos=qpos, window=window,
                                                           q_lens=q_lens, **kw2)
                        q3 = q[:, :, -1].contiguous()
                        one = paged_fairkv_decode_cuda(q3, kp, vp, pp, tbl, ln, C, cap,
                                                       q_pos=qpos, window=window, **kw)
                        one2 = paged_fairkv_decode_cuda(q3, kp2, vp2, pp2, tbl2, ln, C, cap,
                                                        q_pos=qpos, window=window, **kw2)
                        torch.cuda.synchronize()
                        if not (torch.equal(out, out2) and torch.equal(one, one2)):
                            fail(f"{tag}: the kernels differ on relabelled pool blocks")
                        n_perm += 1
    log(f"[check] paged contracts: {n_query} multi-query cases, every query bitwise equal to "
        f"paged_fairkv_decode at its causal length and position (Q 1 to 40, G 1 to 8, all pool "
        f"kinds, window and softcap); {n_perm} cases of both kernels bitwise unchanged on "
        f"relabelled pool blocks")


# ---------------------------------------------------------------------------
# phase 4: CUDA port vs CPU port at smoke size
# ---------------------------------------------------------------------------


def smoke_parity():
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.api import CompressionConfig, Engine, EngineConfig, PlannerConfig
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, 256, size=(2, 96)).astype(np.int32)
    res = {}
    for dev in ("cpu", "cuda"):
        cfg = EngineConfig.smoke(
            ARCH, n_shards=8, device=dev,
            compression=CompressionConfig(policy="ada_snapkv", budget=24,
                                          alpha_max=2.0, obs_window=8, sink=2,
                                          decode_margin=8),
            planner=PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=2))
        params = None
        if dev == "cuda":
            params = interop.to_torch(interop.to_numpy(res["cpu_params"]), "cuda")
        eng = Engine.build(cfg, params=params)
        res[dev] = eng.generate(toks, 8)
        if dev == "cpu":
            res["cpu_params"] = eng.params
    a, b = res["cpu"], res["cuda"]
    d = float(np.abs(a.logits - b.logits).max())
    # fp32 both sides; the card sums in another order than the CPU
    if not (np.array_equal(a.tokens, b.tokens) and np.array_equal(a.lengths, b.lengths)
            and d < 1e-3):
        fail(f"smoke parity: tokens equal {np.array_equal(a.tokens, b.tokens)}, "
             f"lengths equal {np.array_equal(a.lengths, b.lengths)}, max |dlogits| {d:.3e}")
    log(f"[smoke] {ARCH} smoke, fairkv_dp: CUDA port == CPU port tokens and "
        f"lengths; max |logits diff| {d:.3e} (tol 1e-3, fp32)")
    del res
    gc.collect()
    torch.cuda.empty_cache()


def smoke_spec_parity():
    """Speculative `run_trace` on paged fp32 pools at smoke size (the
    reference's speculative-test setup: no compression, block size 8, 4
    rows), full-depth and 1-layer drafts: on the card each gives the plain
    paged run's tokens and the same spec run's tokens on the CPU; the mq
    kernel carries every verify (n_layers launches per tick), the paged
    kernel every draft step (draft layers x max_k per tick)."""
    from repro_torch import interop
    from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                                 PlannerConfig, SchedulerConfig, SpeculationConfig,
                                 synthesize_requests)
    rows, max_k = 4, 3
    params = {}
    tokens = {}
    for dev in ("cpu", "cuda"):
        for name, spec in (("plain", SpeculationConfig()),
                           ("full draft", SpeculationConfig(enabled=True, max_k=max_k)),
                           ("1-layer draft", SpeculationConfig(enabled=True, max_k=max_k,
                                                               draft_layers=1))):
            cfg = EngineConfig.smoke(
                ARCH, n_shards=4, max_seq_len=38, device=dev,
                compression=CompressionConfig(policy="none", budget=64, capacity=64,
                                              alpha_max=1.0, obs_window=8, sink=2,
                                              decode_margin=8),
                planner=PlannerConfig(mode="fairkv_dp", extra_copies=6, batch_cap=rows),
                scheduler=SchedulerConfig(max_rows=rows, enable_replan=False),
                cache_backend="paged", paging=PagingConfig(block_size=8),
                speculation=spec)
            if "cpu" not in params:
                params["cpu"] = Engine.build(cfg).params
                params["cuda"] = interop.to_torch(interop.to_numpy(params["cpu"]), "cuda")
            eng = Engine.build(cfg, params=params[dev])
            reqs = synthesize_requests(6, 0.5, cfg.model.vocab_size, min_prompt=8,
                                       max_prompt=20, max_new_tokens=10, seed=3)
            out, got = _count(lambda: eng.run_trace(reqs, max_steps=400))
            if out["finished"] != 6 or eng.scheduler.backend.pool.blocks_in_use() != 0:
                fail(f"smoke spec {name} on {dev}: {out['finished']}/6 finished, "
                     f"{eng.scheduler.backend.pool.blocks_in_use()} blocks left")
            tokens[dev, name] = [r.generated for r in reqs]
            if dev == "cuda" and spec.enabled:
                nL, ticks = cfg.model.n_layers, out["decode_ticks"]
                d = spec.draft_layers or nL
                if (got["paged_fairkv_decode_mq"] != nL * ticks
                        or got["paged_fairkv_decode"] != d * max_k * ticks):
                    fail(f"smoke spec {name}: launches {got}, expected mq {nL} x {ticks}, "
                         f"paged {d} x {max_k} x {ticks}")
            log(f"[smoke] spec {dev:4s} {name:13s}: {out['decode_ticks']} ticks, "
                f"acceptance {out['acceptance']}")
    for name in ("full draft", "1-layer draft"):
        if tokens["cuda", name] != tokens["cuda", "plain"]:
            fail(f"smoke spec {name}: card tokens differ from the card's plain paged run")
        if tokens["cuda", name] != tokens["cpu", name]:
            fail(f"smoke spec {name}: card tokens differ from the CPU spec run")
    log("[smoke] speculative run_trace (full and 1-layer drafts): card tokens == card plain "
        "paged tokens == CPU spec tokens (fp32)")


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------


def planner(mode, ch):
    from repro_torch.api import PlannerConfig
    return PlannerConfig(mode=mode, extra_copies=ch, slots_per_shard=SLOTS_PER_SHARD,
                         batch_cap=B)


def main_config():
    """minitron-8b at full width in bf16 on the card, Ada-SnapKV budget 256
    (capacity 576), 8 shards x 2 slots; planner sha (callers replace it)."""
    from repro_torch.api import CompressionConfig, EngineConfig
    return EngineConfig.for_arch(
        ARCH, n_shards=N_SHARDS, dtype="bfloat16", max_seq_len=T + GEN,
        seed=SEED, device="cuda",
        compression=CompressionConfig(policy="ada_snapkv", budget=BUDGET,
                                      alpha_max=ALPHA, obs_window=OBS, pool=POOL,
                                      sink=SINK, decode_margin=MARGIN),
        planner=planner("sha", 0))


def main_path():
    import numpy as np
    import torch
    from repro_torch.api import Engine
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import build
    from repro_torch.training.data import SyntheticLM

    cfg = main_config()
    m = cfg.model
    log(f"[main] {m.name}: {m.n_layers} layers (full depth), d_model {m.d_model}, "
        f"{m.n_heads}/{m.n_kv_heads} heads, head_dim {m.head_dim}, d_ff {m.d_ff}, "
        f"vocab {m.vocab_size}, bf16; S={N_SHARDS * SLOTS_PER_SHARD} slots, "
        f"capacity {cfg.compression.static_capacity()}, B={B}, T={T}, {GEN} new tokens")
    data = SyntheticLM(m, InputShape("chip_smoke", T, B, "prefill"))
    prompts = data.get_batch(0)["tokens"]
    sample = data.get_batch(123)["tokens"]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe = Engine.build(cfg)
    torch.cuda.synchronize()
    log(f"[main] weights initialised on the card in {time.perf_counter() - t0:.1f} s")
    params = probe.params

    build.reset_launches()
    profile = probe.measure_profile(sample)
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    if build.LAUNCHES["snapkv_scores"] != m.n_layers:
        fail(f"measure_profile launched snapkv_scores {build.LAUNCHES['snapkv_scores']} "
             f"times, expected {m.n_layers}")

    results = {}
    eng = None
    for mode, ch in PLANNERS:
        # free the previous engine's slot weights and cache first; the
        # original-layout weights are shared
        eng = None
        gc.collect()
        torch.cuda.empty_cache()
        eng = Engine.build(cfg.replace(planner=planner(mode, ch)), params=params,
                           profile=profile)
        before = dict(build.LAUNCHES)
        teacher = None if mode == "sha" else results["sha"].tokens[:, :GEN]
        res = eng.generate(prompts, GEN, teacher_tokens=teacher)
        got = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
        if got["fairkv_decode"] != m.n_layers * GEN:
            fail(f"{mode}: fairkv_decode launched {got['fairkv_decode']} times, "
                 f"expected n_layers x {GEN} = {m.n_layers * GEN}")
        if got["snapkv_scores"] != m.n_layers:
            fail(f"{mode}: snapkv_scores launched {got['snapkv_scores']} times, "
                 f"expected n_layers = {m.n_layers}")
        if res.logits.shape != (B, GEN + 1, m.padded_vocab) or not np.isfinite(res.logits).all():
            fail(f"{mode}: logits of shape {res.logits.shape} or not finite")
        results[mode] = res
        step_ms = 1e3 * statistics.median(res.step_s)
        # the highest percentile with at least 10 of the steps beyond it
        q = max(50.0, 100.0 * (1.0 - 10.0 / len(res.step_s)))
        tail_ms = 1e3 * float(np.percentile(res.step_s, q))
        log(f"[main] {mode:12s} prefill {res.prefill_s:.3f} s | decode median "
            f"{step_ms:.2f} ms/step, p{q:.0f} {tail_ms:.2f} ms (n={len(res.step_s)}) | "
            f"{B / (step_ms / 1e3):.1f} tokens/s | "
            f"E={res.efficiency:.4f} makespan={res.makespan:.1f} | "
            f"replicas {int((eng.plan.as_arrays()['slot_head'] >= 0).sum())}")
    launches = dict(build.LAUNCHES)
    log(f"[main] launches over the slot one-shot path (measure_profile + 3 x generate): "
        f"{launches}")
    if launches["paged_fairkv_decode"] != 0:
        fail("the slot backend launched the paged kernel")

    lens = [results[mode].lengths for mode, _ in PLANNERS]
    if not all(np.array_equal(lens[0], x) for x in lens[1:]):
        fail("realized lengths differ across planners")
    log("[main] realized lengths (L, Hkv, B) bitwise equal across sha / fairkv_nodp / fairkv_dp")
    ref_l = results["sha"].logits
    # bound from bf16 rounding: the plans compute the same function, and each
    # of the n_layers residual updates is rounded to bf16 (relative step
    # 2^-8) in an order that depends on the slot layout; propagated through
    # the normed read-out that bounds the logit gap by n_layers * 2^-8 of the
    # largest logit.  Both runs are fed the same tokens (teacher forcing).
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(ref_l).max())
    for mode in ("fairkv_nodp", "fairkv_dp"):
        d = float(np.abs(results[mode].logits - ref_l).max())
        same = float((results[mode].tokens == results["sha"].tokens).mean())
        log(f"[main] max |logits_sha - logits_{mode}| = {d:.4f} (bound {tol:.4f}); "
            f"argmax tokens equal to sha's at {100 * same:.1f}% of positions")
        if not d < tol:
            fail(f"plan invariance: {mode} logits differ by {d} >= {tol}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] torch.cuda.max_memory_allocated = {peak / 2**30:.2f} GiB")

    share = profile_decode(eng, statistics.median(results["fairkv_dp"].step_s))
    profile_prefill(eng, prompts)
    mode_rows = {mode: {"prefill_s": r.prefill_s,
                        "decode_ms_median": 1e3 * statistics.median(r.step_s),
                        "efficiency": r.efficiency, "makespan": r.makespan}
                 for mode, r in results.items()}
    log("[main] summary " + json.dumps({"planners": mode_rows,
                                         "max_memory_allocated": peak,
                                         "kernel_share_of_decode": share}))
    ctx = {"cfg": cfg.replace(planner=planner("fairkv_dp", 4)), "params": params,
           "profile": profile, "prompts": prompts, "slot_dp": results["fairkv_dp"],
           "teacher": results["sha"].tokens[:, :GEN]}
    return eng, launches, ctx


# (step kind, "graphs" | "eager") -> (host-clocked ms, device ms) per step,
# filled by the profiling passes, printed by phase 9 (graphs_vs_eager)
TIMES = {}


def _device_profile(fn, ours_keys=("fairkv_decode_kernel", "snapkv_")):
    """Run ``fn`` under torch.profiler; returns (wall s, total device us,
    device us of the kernels whose names contain one of ``ours_keys``, top
    kernels [(name, us)])."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    total = ours = 0.0
    kernels = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = ev.self_device_time_total
            total += us
            kernels.append((ev.key[:70], us))
            if any(k in ev.key for k in ours_keys):
                ours += us
    kernels.sort(key=lambda kv: -kv[1])
    return wall, total, ours, kernels[:6]


def profile_decode(eng, step_s, steps=4, label="graphs"):
    """One torch.profiler pass over a few decode steps (and one over a
    prefill): the kernels' share of device time, the top device kernels,
    and the device's busy share of the wall time (under the profiler, and
    against ``step_s``, the un-profiled median step).  ``label`` names the
    executor (CUDA graphs or eager) in `TIMES`."""
    box = {"state": eng.state}

    def decode():
        for _ in range(steps):
            box["state"], _ = eng.executor.decode(eng.sp, box["state"], eng.pa)

    wall, total, ours, top = _device_profile(decode)
    eng.state = box["state"]
    if total <= 0:
        log("[profile] torch.profiler recorded no device time: share not measured")
        return None
    share = ours / total
    TIMES[("one-shot step", label)] = (1e3 * step_s, total / 1e3 / steps)
    log(f"[profile] {label}: {steps} decode steps: device busy {total / 1e3:.2f} ms of "
        f"{wall * 1e3:.2f} ms wall ({100 * total / 1e6 / wall:.1f}%); "
        f"fairkv_decode kernel {ours / 1e3:.3f} ms = {100 * share:.2f}% of device time; "
        f"device time per step {total / 1e3 / steps:.2f} ms = "
        f"{100 * total / 1e6 / steps / step_s:.1f}% of the un-profiled median step "
        f"({step_s * 1e3:.2f} ms)")
    for name, us in top:
        log(f"[profile]   decode top kernel {us / 1e3 / steps:8.3f} ms/step  {name}")
    return share


def profile_prefill(eng, prompts):
    """One torch.profiler pass over a prefill (its state is discarded)."""
    import torch
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=eng.device)}
    wall, total, ours, top = _device_profile(
        lambda: eng.executor.prefill(eng.sp, batch, eng.pa))
    if total <= 0:
        log("[profile] torch.profiler recorded no device time for prefill")
        return
    log(f"[profile] prefill: device busy {total / 1e3:.2f} ms of {wall * 1e3:.2f} ms "
        f"wall; snapkv_scores kernels {ours / 1e3:.3f} ms = {100 * ours / total:.2f}%")
    for name, us in top:
        log(f"[profile]   prefill top kernel {us / 1e3:9.3f} ms  {name}")


# ---------------------------------------------------------------------------
# phase 6: the paged backend, one-shot (bf16 pools next to the slot run,
# then int8 and fp8 pools against the bf16 pools)
# ---------------------------------------------------------------------------

# int8 / fp8 pools against bf16 pools, both teacher-forced on the same
# tokens (32 steps x 8 rows = 256 positions + the prefill's 8).  The bars
# sit about 8-10x the measured 1 - cosine (1.2e-4 int8, 2.1e-4 fp8 on an
# H100, PERF.md) and 6-10 points under the measured argmax agreement
# (96.6% / 95.1%), which is itself near the floor of bf16 rounding alone
# (the bf16 plans agree on ~97.5% of argmax tokens: random-weight logits
# are nearly flat).  e4m3 (relative step 1/16) is coarser than int8
# (1/254 of the block's amax), so its bars are looser.  ``min_gap`` is the
# other side: the logits must differ from the bf16 pools', or the pools
# were not quantized.
QUANT_BARS = {"int8": {"cosine": 0.999, "argmax": 0.90, "min_gap": 1e-3},
              "fp8": {"cosine": 0.998, "argmax": 0.85, "min_gap": 1e-3}}


def _count(fn):
    """Run ``fn`` with the launch counters zeroed just before; returns
    (result, launches during the run)."""
    from repro_torch.kernels import build
    build.reset_launches()
    out = fn()
    return out, dict(build.LAUNCHES)


def _layer0(cache):
    """Layer 0 of a paged cache, cloned (the kernel's own inputs)."""
    t = {"k_pool": cache.k_pool[0], "v_pool": cache.v_pool[0],
         "pos_pool": cache.pos_pool[0], "table": cache.block_table[0],
         "lengths": cache.lengths[0], "positions": cache.positions}
    if cache.k_scale is not None:
        t["k_scale"], t["v_scale"] = cache.k_scale[0], cache.v_scale[0]
    return {k: v.clone() for k, v in t.items()}


def paged_oneshot(ctx):
    """`Engine.generate` with ``cache_backend="paged"`` at full width:
    bf16 pools at worst-case size next to the slot run of the same plan
    (lengths bitwise, logit gap under the bf16 bound, the paged kernel on
    every layer of every step and the slot kernel never), then int8 and
    fp8 pools against the bf16 pools (QUANT_BARS)."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig
    m = ctx["cfg"].model
    out = {"launches": {}}
    ref = None
    for kv in ("fp32", "int8", "fp8"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = ctx["cfg"].replace(cache_backend="paged",
                                 paging=PagingConfig(block_size=BLOCK, kv_dtype=kv))
        eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
        res, got = _count(lambda: eng.generate(ctx["prompts"], GEN,
                                               teacher_tokens=ctx["teacher"]))
        name = "bf16" if kv == "fp32" else kv
        mem = eng.memory_stats()
        log(f"[paged] one-shot {name} pools: prefill {res.prefill_s:.3f} s | decode median "
            f"{1e3 * statistics.median(res.step_s):.2f} ms/step | blocks in use "
            f"{mem['blocks_in_use']} of {mem['blocks_total']} ({mem['cache_bytes']} B vs "
            f"{mem['slot_equivalent_bytes']} B slot-equivalent) | launches {got}")
        if got["paged_fairkv_decode"] != m.n_layers * GEN or got["fairkv_decode"] != 0:
            fail(f"paged {name}: paged_fairkv_decode launched {got['paged_fairkv_decode']} "
                 f"times (expected {m.n_layers} x {GEN}), fairkv_decode "
                 f"{got['fairkv_decode']} (expected 0)")
        if not np.isfinite(res.logits).all():
            fail(f"paged {name}: non-finite logits")
        for k, v in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out[name] = _layer0(eng.state.cache)
        profile_paged_step(eng, name)
        if kv == "fp32":
            slot = ctx["slot_dp"]
            if not np.array_equal(res.lengths, slot.lengths):
                fail("paged vs slot: retained lengths differ")
            tol = m.n_layers * 2.0 ** -8 * float(np.abs(slot.logits).max())
            d = float(np.abs(res.logits - slot.logits).max())
            same = float((res.tokens == slot.tokens).mean())
            log(f"[paged] bf16 pools vs slot cache (fairkv_dp, teacher-forced): lengths "
                f"bitwise equal; max |logit gap| {d:.4f} (bound {tol:.4f}); argmax equal "
                f"at {100 * same:.1f}% of positions")
            if not d < tol:
                fail(f"paged vs slot: logit gap {d} >= {tol}")
            ref = res
        else:
            a = torch.from_numpy(res.logits).double().reshape(-1, res.logits.shape[-1])
            b = torch.from_numpy(ref.logits).double().reshape(-1, ref.logits.shape[-1])
            cos = float(torch.nn.functional.cosine_similarity(a, b, dim=-1).mean())
            agree = float((res.tokens == ref.tokens).mean())
            gap = float(np.abs(res.logits - ref.logits).max())
            bars = QUANT_BARS[kv]
            log(f"[paged] {kv} pools vs bf16 pools (teacher-forced): mean logit cosine "
                f"{cos:.6f} (bar {bars['cosine']}), argmax agreement {100 * agree:.1f}% "
                f"(bar {100 * bars['argmax']:.0f}%), max |logit gap| {gap:.4f} "
                f"(must exceed {bars['min_gap']:g})")
            if cos < bars["cosine"] or agree < bars["argmax"]:
                fail(f"{kv} pools below their quality bars")
            if gap <= bars["min_gap"]:
                fail(f"{kv} pools give the bf16 pools' logits: not quantized")
        del eng, res
    return out


def profile_paged_step(eng, name, steps=2):
    """Where a one-shot paged step's time goes (bf16, int8 or fp8 pools):
    the host time of `prepare_decode` and, under torch.profiler, the
    device time per step of the graphed decode step and its top kernels."""
    import torch
    prep = []

    def step():
        t0 = time.perf_counter()
        state = eng.backend.prepare_decode(eng.state, None)
        prep.append(time.perf_counter() - t0)
        eng.state, _ = eng.executor.decode(eng.sp, state, eng.pa)

    with torch.inference_mode():
        wall, total, ours, top = _device_profile(lambda: [step() for _ in range(steps)],
                                                 ours_keys=("paged_decode_kernel",))
    if total <= 0:
        log(f"[profile] torch.profiler recorded no device time for the {name} paged step")
        return
    log(f"[profile] one-shot paged step, {name} pools: device {total / 1e3 / steps:.2f} ms per "
        f"step ({100 * total / 1e6 / wall:.1f}% of the profiled wall); prepare_decode "
        f"{1e3 * statistics.mean(prep):.2f} ms host per step; paged_fairkv_decode "
        f"{ours / 1e3 / steps:.3f} ms per step")
    for kname, us in top[:4]:
        log(f"[profile]   {name} step top kernel {us / 1e3 / steps:8.3f} ms/step  {kname}")


# ---------------------------------------------------------------------------
# phase 7: continuous batching at full width
# ---------------------------------------------------------------------------

N_REQ, RATE, PROMPT_MIN, PROMPT_MAX, NEW_MIN, NEW_MAX, MAX_ROWS = 24, 0.25, 512, 2048, 16, 64, 8
# undersized pool of run (d), in admission charges of the largest request.
# Admission charges a request its prefill bound plus one growth block per
# head, about 30 blocks per layer more than a request realizes at prefill,
# and that slack covers most of a request's own 16-64-token growth; so on
# this trace a dry pool is rare and depends on how the growth of
# concurrent requests lines up.  3.6 preempts 6 times (a sweep of sizes on
# this trace, PERF.md); the trace and the realized lengths are
# deterministic, so a run that does not preempt means admission changed.
UNDERSIZE = 3.6


def make_trace(vocab):
    """24 requests from `synthesize_requests` (seed 0): Poisson arrivals,
    prompts of 512-2048 tokens; 16-64 new tokens each, drawn from a numpy
    generator of the same seed."""
    import numpy as np
    from repro_torch.api import synthesize_requests
    reqs = synthesize_requests(N_REQ, RATE, vocab, min_prompt=PROMPT_MIN,
                               max_prompt=PROMPT_MAX, max_new_tokens=NEW_MAX, seed=SEED)
    gen = np.random.default_rng(SEED).integers(NEW_MIN, NEW_MAX + 1, size=N_REQ)
    for r, g in zip(reqs, gen):
        r.max_new_tokens = int(g)
    return reqs


def eager_executor(cfg):
    """A `LocalExecutor` that runs every step eagerly (no CUDA graph): the
    comparison phase 9 holds the graphs to."""
    from repro_torch.exec.local import LocalExecutor
    return LocalExecutor(cfg.model, cfg.compression, paging=cfg.paging, device="cuda",
                         graphs=False)


def continuous_run(ctx, name, backend, kv, n_blocks=0, spec=None, logits=False,
                   changes=None, reqs=None, eager=False, head_importance=None, inspect=None):
    """One trace through `Engine.run_trace` (8 rows, replanning on with
    `SchedulerConfig`'s defaults) with the launch counters zeroed just
    before and read just after; checks that every request finished with
    all its tokens, the launch counts, and (paged) an empty, consistent
    pool at the end (after flushing the prefix index, when there is one).
    ``spec`` (a `SpeculationConfig`) turns speculation on; ``logits``
    keeps each token's logits; ``changes`` are further `EngineConfig`
    fields (compression, planner, scheduler, prefix, ...) and ``reqs`` a
    trace other than `make_trace`'s.  With sharing on, the largest block
    refcount seen while requests are live is recorded after every tick.
    The steps run as CUDA graphs, captured by `Engine.warmup` before the
    counted run; the trace must capture nothing more (replans, splices,
    retirements and copy-on-write write into the captured tensors).
    ``eager`` runs every step eagerly instead.  ``head_importance`` goes to
    `Engine.build` (the ``headkv`` policy's weights); ``inspect(eng,
    after_warmup)`` is called after the checks with the engine and the
    ``stepfn_compiles_total`` counts read just after warmup.  Returns
    (launches, summary)."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig, SchedulerConfig, SpeculationConfig
    m = ctx["cfg"].model
    spec = spec or SpeculationConfig()
    gc.collect()
    torch.cuda.empty_cache()
    fields = dict(cache_backend=backend,
                  scheduler=SchedulerConfig(max_rows=MAX_ROWS, collect_logits=logits),
                  paging=PagingConfig(block_size=BLOCK, kv_dtype=kv, n_blocks=n_blocks),
                  speculation=spec)
    cfg = ctx["cfg"].replace(**{**fields, **(changes or {})})
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"],
                       head_importance=head_importance)
    if eager:
        eng.executor = eager_executor(cfg)
    reqs = make_trace(m.vocab_size) if reqs is None else reqs
    n_req = len(reqs)
    chunk = cfg.prefix.chunk_tokens
    if chunk and min(r.prompt_len for r in reqs) <= chunk:
        fail(f"{name}: every prompt must be longer than one chunk ({chunk} tokens)")
    sched = eng._ensure_scheduler()
    max_ref = [0]
    if sched.prefix is not None:
        tick = sched.step

        def watched():
            ev = tick()
            if sched.active:
                max_ref[0] = max(max_ref[0], int(sched.backend.pool.refcount[:, 1:].max()))
            return ev
        sched.step = watched
    ex = eng.executor
    t_warm = time.perf_counter()
    eng.warmup()
    t_warm = time.perf_counter() - t_warm
    captured = dict(ex.step_traces)
    compiles_warm = {k: eng.obs.metrics.counter_value("stepfn_compiles_total", kind=k,
                                                      executor="local")
                     for k in ex.step_traces}
    # one capture per distinct step shape: the decode step, the chunk step
    # when chunking, propose and verify when speculating; prefill is eager
    shapes = {"prefill": 0, "decode": 1, "prefill_chunk": int(bool(chunk)),
              "propose": int(spec.enabled), "verify": int(spec.enabled)}
    if not eager and captured != shapes:
        fail(f"{name}: warmup captured {captured}, expected one graph per step shape {shapes}")
    torch.cuda.reset_peak_memory_stats()
    summary, got = _count(lambda: eng.run_trace(reqs, max_steps=5000))
    ticks = summary["decode_ticks"]
    if ex.step_traces != captured:
        fail(f"{name}: the trace captured again: {ex.step_traces} after warmup's {captured}")
    admissions = n_req + summary["preemptions"]
    lat = summary["latency"]
    step_ms = 1e3 * np.asarray(sched.step_s)
    acc = sum(1 for e in summary["replan_log"] if e["accepted"])
    rej = len(summary["replan_log"]) - acc
    in_use = summary["memory"].get("blocks_in_use", 0)
    peak_blocks = summary["memory"].get("peak_blocks_in_use_per_layer", 0)
    host_ms = {k: 1e3 * float(np.median(getattr(sched, k))) if getattr(sched, k) else None
               for k in ("prepare_s", "propose_s", "verify_s", "chunk_s")}
    held, stats = 0, eng.prefix_stats()
    if sched.prefix is not None:  # blocks only the index holds, then none
        held = sched.backend.pool.blocks_in_use()
        sched.prefix.flush()
    log(f"[cont] {name:10s} finished {summary['finished']}/{n_req} | tokens "
        f"{summary['generated_tokens']} | steps {summary['steps']} (decode ticks {ticks}) | "
        f"preemptions {summary['preemptions']} | replans accepted {acc} rejected {rej} | "
        f"step median {np.median(step_ms):.2f} ms p90 {np.percentile(step_ms, 90):.2f} ms | "
        f"TTFT p50 {lat.get('p50_ttft_s', float('nan')):.3f} s p99 "
        f"{lat.get('p99_ttft_s', float('nan')):.3f} s | {summary['tokens_per_s']:.1f} tokens/s | "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
        + (f"pool {n_blocks or 'worst-case'} blocks/layer, peak in use {peak_blocks}/layer, "
           f"in use at the end {in_use} | " if backend == "paged" else "")
        + (f"chunks {len(sched.chunk_s)} of {chunk} tokens, host ms median "
           f"{host_ms['chunk_s']:.2f} | cow copies {sched.backend.cow_copies} | "
           if chunk else "")
        + (f"prefix index {stats}, max refcount while live {max_ref[0]}, "
           f"{held} blocks held by the index at the end | " if stats else "")
        + (f"acceptance {summary['acceptance']:.4f} ({summary['spec_accepted']}/"
           f"{summary['spec_proposed']}) | host ms per tick (median): prepare "
           f"{host_ms['prepare_s']:.2f}, propose {host_ms['propose_s']:.2f}, verify "
           f"{host_ms['verify_s']:.2f} | " if spec.enabled else "")
        + f"launches {got} | "
        + ("eager executor" if eager else
           f"CUDA graphs captured by warmup ({t_warm:.2f} s) {captured}, replays "
           f"{ex.replays}"))
    if summary["finished"] != n_req or any(not r.is_finished or r.cancelled for r in reqs):
        fail(f"{name}: {summary['finished']} of {n_req} requests finished")
    if summary["generated_tokens"] != sum(r.max_new_tokens for r in reqs):
        fail(f"{name}: generated {summary['generated_tokens']} tokens, expected "
             f"{sum(r.max_new_tokens for r in reqs)}")
    decode_kernel = "paged_fairkv_decode" if backend == "paged" else "fairkv_decode"
    other = "fairkv_decode" if backend == "paged" else "paged_fairkv_decode"
    expect = {decode_kernel: m.n_layers * ticks, other: 0, "paged_fairkv_decode_mq": 0}
    if spec.enabled:
        # every tick: max_k draft steps over the draft layers (paged kernel),
        # then one verify over every layer (multi-query kernel)
        d = spec.draft_layers or m.n_layers
        expect.update(paged_fairkv_decode=d * spec.max_k * ticks,
                      paged_fairkv_decode_mq=m.n_layers * ticks)
    if any(got[k] != v for k, v in expect.items()):
        fail(f"{name}: launches {got}, expected {expect} ({ticks} ticks)")
    # one launch per layer of every prefill, or of every chunk when chunked
    prefills = len(sched.chunk_s) if chunk else admissions
    if got["snapkv_scores"] != m.n_layers * prefills:
        fail(f"{name}: snapkv_scores launched {got['snapkv_scores']} times, expected "
             f"{m.n_layers} x {prefills} {'chunks' if chunk else 'prefills'}")
    if backend == "paged":
        pool = sched.backend.pool
        pool.check_invariants()
        if pool.blocks_in_use() != 0:
            fail(f"{name}: {pool.blocks_in_use()} blocks still in use at the end")
        log(f"[cont] {name}: BlockPool.check_invariants() passed; 0 blocks in use")
    out = {k: summary[k] for k in ("steps", "decode_ticks", "wall_s", "finished",
                                   "generated_tokens", "replans", "preemptions",
                                   "tokens_per_s", "acceptance")}
    out.update(step_ms_median=float(np.median(step_ms)),
               step_ms_p90=float(np.percentile(step_ms, 90)),
               ttft_s_p50=lat.get("p50_ttft_s"), ttft_s_p99=lat.get("p99_ttft_s"),
               replans_accepted=acc, replans_rejected=rej,
               peak_memory=torch.cuda.max_memory_allocated(), peak_blocks=peak_blocks,
               n_blocks=n_blocks, tokens=[list(r.generated) for r in reqs],
               replan_decisions=[e["accepted"] for e in summary["replan_log"]],
               chunks=len(sched.chunk_s), prefix=stats, max_refcount=max_ref[0],
               index_blocks_at_end=held, cow_copies=getattr(sched.backend, "cow_copies", 0),
               hit_tokens=[r.prefix_hit_tokens for r in reqs],
               captures=captured, eager=eager,
               **{f"{k[:-2]}_ms_median": v for k, v in host_ms.items()})
    if logits:
        out["logits"] = [np.stack(r.logits) for r in reqs]
    if inspect is not None:
        inspect(eng, compiles_warm)
    return got, out


def undersized_blocks(ctx, factor: float) -> int:
    """Pool size (blocks per layer) of an undersized run: ``factor`` times
    the admission charge of the largest request, and never below the
    worst case of a single request (which `never_fits` requires)."""
    from repro_torch.api import PagingConfig
    from repro_torch.paging.backend import PagedBackend
    probe = PagedBackend(ctx["cfg"].model, ctx["cfg"].compression,
                         paging=PagingConfig(block_size=BLOCK))
    admit = int(probe._layer_blocks(PROMPT_MAX, NEW_MAX, False).max())
    worst = int(probe._layer_blocks(PROMPT_MAX, NEW_MAX, True).max())
    return max(int(factor * admit), worst) + 1


# speculative runs of the continuous trace: (e) an 8-layer draft (a quarter
# of the stack) with adaptive depth, (f) the full-depth self-draft, whose
# acceptance would be 1.0 in exact arithmetic; in bf16 the draft's
# single-row projections and the verify's B*Q-row ones may round apart
SPEC_E = dict(enabled=True, max_k=4, draft_layers=8)
SPEC_F = dict(enabled=True, max_k=4, draft_layers=0)
SPEC_F_ACCEPTANCE = 0.90


def near_tie_check(plain, spec, m):
    """(e) against the plain bf16 run (b), both with per-token logits:
    while a request's tokens agree (its first differing position
    included: the history is still the same) the logit gap stays under
    the bf16 bound n_layers * 2^-8 * max|logit|, and at the first
    differing position the plain run's top-2 margin is under it too, so
    every divergence is a near-tie.  Returns (identical requests, max gap,
    bound, margins at the divergences)."""
    import numpy as np
    V = m.vocab_size
    bound = m.n_layers * 2.0 ** -8 * max(float(np.abs(x[:, :V]).max())
                                         for x in plain["logits"])
    same, gap, margins = 0, 0.0, []
    for i in range(N_REQ):
        a, b = plain["tokens"][i], spec["tokens"][i]
        first = next((t for t in range(len(a)) if a[t] != b[t]), None)
        upto = len(a) if first is None else first + 1
        la, lb = plain["logits"][i][:upto, :V], spec["logits"][i][:upto, :V]
        gap = max(gap, float(np.abs(la - lb).max()))
        if first is None:
            same += 1
            continue
        top2 = np.sort(la[first])[-2:]
        margins.append(float(top2[1] - top2[0]))
    if not gap < bound:
        fail(f"spec vs plain bf16: logit gap {gap:.4f} >= bound {bound:.4f} while the "
             f"tokens agree")
    if any(mg >= bound for mg in margins):
        fail(f"spec vs plain bf16: a divergence with top-2 margin {max(margins):.4f} >= "
             f"bound {bound:.4f} is not a near-tie")
    return same, gap, bound, margins


def continuous_runs(ctx):
    """The same trace on (a) the slot backend, (b) bf16 pools at worst-case
    size, (c) int8 pools at worst-case size, (d) fp8 pools sized below the
    realized need (`undersized_blocks`), which must preempt; then
    speculative decoding on (e) bf16 pools with an 8-layer draft, (f) bf16
    pools with the full-depth self-draft and (g) int8 pools with (e)'s
    draft.  Returns (launches, the mq kernel's inputs at a verify tick)."""
    from repro_torch.api import SpeculationConfig
    m = ctx["cfg"].model
    launches, runs = {}, {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for name, backend, kv in (("slot", "slot", "fp32"), ("paged bf16", "paged", "fp32"),
                              ("paged int8", "paged", "int8")):
        got, runs[name] = continuous_run(ctx, name, backend, kv,
                                         logits=name == "paged bf16")
        add(got)
    n_blocks = undersized_blocks(ctx, UNDERSIZE)
    got, runs["paged fp8"] = continuous_run(ctx, "paged fp8", "paged", "fp8", n_blocks)
    add(got)
    if runs["paged fp8"]["preemptions"] < 1:
        fail(f"paged fp8: the undersized pool ({n_blocks} blocks/layer, {UNDERSIZE} "
             f"admission charges) never preempted")
    # the paged kernel gives the slot kernel's outputs bitwise on the same
    # cache contents (PERF.md), so the two traces must agree token for token
    # and take the same replan decisions
    a, b = runs["slot"], runs["paged bf16"]
    same = sum(x == y for x, y in zip(a["tokens"], b["tokens"]))
    log(f"[cont] slot vs paged bf16: {same}/{N_REQ} requests with identical tokens; "
        f"replan decisions {a['replan_decisions']} vs {b['replan_decisions']}")
    if same != N_REQ:
        fail(f"slot vs paged bf16: only {same}/{N_REQ} requests with identical tokens")
    if a["replan_decisions"] != b["replan_decisions"]:
        fail("slot vs paged bf16: the replan decisions differ")

    for name, kv, spec, logits in (("spec d=8", "fp32", SPEC_E, True),
                                   ("spec d=32", "fp32", SPEC_F, False),
                                   ("spec int8", "int8", SPEC_E, False)):
        got, runs[name] = continuous_run(ctx, name, "paged", kv,
                                         spec=SpeculationConfig(**spec), logits=logits)
        add(got)
    plain, e, f, g = (runs[k] for k in ("paged bf16", "spec d=8", "spec d=32", "spec int8"))
    if not f["acceptance"] >= SPEC_F_ACCEPTANCE:
        fail(f"spec d=32 (full-depth self-draft): acceptance {f['acceptance']:.4f} < "
             f"{SPEC_F_ACCEPTANCE}")
    same_e, gap, bound, margins = near_tie_check(plain, e, m)
    same_f = sum(x == y for x, y in zip(plain["tokens"], f["tokens"]))
    same_g = sum(x == y for x, y in zip(runs["paged int8"]["tokens"], g["tokens"]))
    tok_g = sum(sum(p == q for p, q in zip(x, y))
                for x, y in zip(runs["paged int8"]["tokens"], g["tokens"]))
    log(f"[cont] spec d=8 vs paged bf16: {same_e}/{N_REQ} requests identical; max logit gap "
        f"while the tokens agree {gap:.4f} (bound {bound:.4f}); top-2 margins of the plain "
        f"run at the {len(margins)} divergences: "
        + ", ".join(f"{x:.4f}" for x in sorted(margins)) + " (all under the bound)")
    log(f"[cont] spec d=32 vs paged bf16: {same_f}/{N_REQ} requests identical; acceptance "
        f"{f['acceptance']:.4f} (bar {SPEC_F_ACCEPTANCE})")
    log(f"[cont] spec int8 vs paged int8: {same_g}/{N_REQ} requests identical, {tok_g} of "
        f"{sum(len(x) for x in g['tokens'])} tokens at equal positions (reported, not a bar)")
    for name in ("spec d=8", "spec d=32", "spec int8"):
        base = runs["paged int8" if "int8" in name else "paged bf16"]
        log(f"[cont] {name}: {runs[name]['tokens_per_s']:.1f} tokens/s = "
            f"{runs[name]['tokens_per_s'] / base['tokens_per_s']:.3f} x its plain run; "
            f"decode ticks {runs[name]['decode_ticks']} vs {base['decode_ticks']}")
    log("[cont] summary " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk not in ("tokens", "logits")}
         for k, v in runs.items()}))
    ctx["cont_bf16"] = {k: v for k, v in runs["paged bf16"].items()
                        if k not in ("tokens", "logits")}
    # what phase 9 holds the eager runs to
    ctx["graphed"] = {"(b)": {k: runs["paged bf16"][k] for k in ("tokens", "replan_decisions")},
                      "(e)": {k: runs["spec d=8"][k] for k in ("tokens", "acceptance")}}
    del runs, a, b, plain, e, f, g
    gc.collect()
    profile_continuous(ctx)
    mq_inputs = profile_speculative(ctx)
    return launches, mq_inputs


def profile_continuous(ctx, steps=4, eager=False):
    """Where a continuous decode tick's time goes, on paged bf16 pools with
    replanning off (no replan inside the measured ticks): fill all eight
    rows, then a few pure decode ticks un-profiled (with the scheduler's
    own `prepare_decode` host time) and one torch.profiler pass over as
    many more; the requests are cancelled afterwards.  ``eager`` times the
    eager executor instead of the CUDA graphs."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig, SchedulerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ctx["cfg"].replace(
        cache_backend="paged", paging=PagingConfig(block_size=BLOCK),
        scheduler=SchedulerConfig(max_rows=MAX_ROWS, enable_replan=False))
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
    if eager:
        eng.executor = eager_executor(cfg)
    rng = np.random.default_rng(SEED + 7)
    reqs = [eng.submit(rng.integers(0, cfg.model.vocab_size, size=PROMPT_MAX // 2),
                       max_new_tokens=NEW_MAX) for _ in range(MAX_ROWS)]
    sched = eng.scheduler
    while sched.queue:
        eng.step()
    t_plain = time.perf_counter()
    for _ in range(steps):
        eng.step()
    plain_ms = 1e3 * (time.perf_counter() - t_plain) / steps
    spent = sched.prepare_s[-steps:]
    wall, total, ours, top = _device_profile(lambda: [eng.step() for _ in range(steps)],
                                             ours_keys=("paged_decode_kernel",))
    for r in reqs:
        eng.cancel(r.req_id)
    if total <= 0:
        log("[profile] torch.profiler recorded no device time for the continuous ticks")
        return
    label = "eager" if eager else "graphs"
    TIMES[("continuous tick", label)] = (plain_ms, total / 1e3 / steps)
    log(f"[profile] {label}: continuous paged bf16, {MAX_ROWS} live rows: un-profiled tick "
        f"{plain_ms:.2f} ms; prepare_decode {1e3 * float(np.mean(spent)):.3f} ms host per "
        f"tick; profiled {steps} ticks: device busy {total / 1e3:.2f} ms of {wall * 1e3:.2f} ms "
        f"wall ({100 * total / 1e6 / wall:.1f}%), device time per tick {total / 1e3 / steps:.2f} ms "
        f"= {100 * total / 1e6 / steps / (plain_ms / 1e3):.1f}% of the un-profiled tick; "
        f"paged_fairkv_decode {ours / 1e3 / steps:.3f} ms per tick "
        f"({100 * ours / total:.2f}% of device time)")
    for name, us in top:
        log(f"[profile]   tick top kernel {us / 1e3 / steps:8.3f} ms/tick  {name}")


def profile_speculative(ctx, steps=4, eager=False):
    """Where a speculative tick's time goes, with (e)'s speculation on paged
    bf16 pools and replanning off: fill all eight rows, then a few ticks
    un-profiled (with the scheduler's host timers of prepare, propose and
    verify) and one torch.profiler pass over as many more, which gives the
    multi-query kernel's share of device time.  One more tick records the
    multi-query kernel's inputs at layer 0 (Q = max_k + 1 = 5), which phase
    10 times; that tick runs eagerly (a graph replay calls no Python, so
    nothing could record its inputs).  The requests are cancelled
    afterwards.  ``eager`` times the eager executor instead of the CUDA
    graphs and records no inputs."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig, SchedulerConfig, SpeculationConfig
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ctx["cfg"].replace(
        cache_backend="paged", paging=PagingConfig(block_size=BLOCK),
        scheduler=SchedulerConfig(max_rows=MAX_ROWS, enable_replan=False),
        speculation=SpeculationConfig(**SPEC_E))
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
    if eager:
        eng.executor = eager_executor(cfg)
    rng = np.random.default_rng(SEED + 7)
    reqs = [eng.submit(rng.integers(0, cfg.model.vocab_size, size=PROMPT_MAX // 2),
                       max_new_tokens=NEW_MAX) for _ in range(MAX_ROWS)]
    sched = eng.scheduler
    while sched.queue:
        eng.step()
    t_plain = time.perf_counter()
    for _ in range(steps):
        eng.step()
    tick_ms = 1e3 * (time.perf_counter() - t_plain) / steps
    host = {k: 1e3 * float(np.mean(getattr(sched, k)[-steps:]))
            for k in ("prepare_s", "propose_s", "verify_s")}
    wall, total, ours, top = _device_profile(lambda: [eng.step() for _ in range(steps)],
                                             ours_keys=("paged_decode_mq_kernel",))
    label = "eager" if eager else "graphs"
    if total > 0:
        TIMES[("speculative tick", label)] = (tick_ms, total / 1e3 / steps)
    if eager:
        for r in reqs:
            eng.cancel(r.req_id)
        log(f"[profile] eager: speculative tick {tick_ms:.2f} ms un-profiled; host ms per "
            f"tick: prepare {host['prepare_s']:.3f}, propose {host['propose_s']:.2f}, "
            f"verify {host['verify_s']:.2f}; device {total / 1e3 / steps:.2f} ms per tick "
            f"({100 * total / 1e6 / wall:.1f}% busy under the profiler)")
        return None
    seen = {}
    orig = ops.paged_fairkv_decode

    def spy(q, *args, **kw):
        if q.dim() == 5 and not seen:  # the first verify call: layer 0
            seen["args"] = tuple(a.clone() if hasattr(a, "clone") else a
                                 for a in (q,) + args)
            seen["kw"] = {k: v.clone() if hasattr(v, "clone") else v for k, v in kw.items()}
        return orig(q, *args, **kw)

    ops.paged_fairkv_decode = spy
    sched.executor = eager_executor(cfg)
    try:
        eng.step()
    finally:
        ops.paged_fairkv_decode = orig
        sched.executor = eng.executor
    for r in reqs:
        eng.cancel(r.req_id)
    if not seen:
        fail("profile_speculative: no verify call recorded")
    if total <= 0:
        log("[profile] torch.profiler recorded no device time for the speculative ticks")
    else:
        log(f"[profile] graphs: speculative paged bf16 (draft 8 layers, max_k 4), {MAX_ROWS} live "
            f"rows: un-profiled tick {tick_ms:.2f} ms; host ms per tick: prepare "
            f"{host['prepare_s']:.3f}, propose {host['propose_s']:.2f}, verify "
            f"{host['verify_s']:.2f}; profiled {steps} ticks: device busy {total / 1e3:.2f} ms "
            f"of {wall * 1e3:.2f} ms wall ({100 * total / 1e6 / wall:.1f}%), device time per "
            f"tick {total / 1e3 / steps:.2f} ms; paged_fairkv_decode_mq "
            f"{ours / 1e3 / steps:.3f} ms per tick ({100 * ours / total:.2f}% of device time)")
        for name, us in top:
            log(f"[profile]   spec tick top kernel {us / 1e3 / steps:8.3f} ms/tick  {name}")
    return seen


# ---------------------------------------------------------------------------
# phase 8: chunked prefill and prefix reuse at full width
# ---------------------------------------------------------------------------

CHUNK = 512  # chunk_tokens of the chunked runs
PREFIX_LEN, PREFIX_TEMPLATES, SHARED_FRACTION = 1024, 2, 0.75
PREFIX_PROMPT_MIN, PREFIX_PROMPT_MAX = 1536, 2048
# the prefix index's LRU capacity: the two templates' boundaries at 512
# and 1024 tokens, twice over (an unbounded index keeps every finished
# prompt's suffix blocks until the pool runs dry, and holds more blocks
# than sharing saves)
PREFIX_ENTRIES = 8
# (h) / (i): policy "none" at a budget no row outgrows (prompts up to 2048
# plus up to 64 new tokens, under 2048 + 128), so the recency ring never
# wraps and a request's tokens do not depend on the decode phase
NONE_BUDGET, NONE_MARGIN = 2048, 128
# (j): the reference's ring-wrap case (capacity 64 = 32 + 32, a 48-token
# prefix, chunk 16) scaled to chunk 512: capacity 1280 = 768 + 512, so
# the ring covers columns 768..1279 and wraps into the shared 1024-token
# prefix; the donor (prefix + 64 tokens) reaches capacity after 192 new
# tokens, the late request arrives after the wrap and stays below it
COW_BUDGET, COW_MARGIN, COW_SUFFIX, COW_DONOR_GEN, COW_LATE_GEN, COW_LATE_AT = (
    768, 512, 64, 256, 16, 230)


def make_prefix_trace(vocab):
    """Phase 7's 24 Poisson arrivals and new-token draws with shared
    prefixes: prompts of 1536-2048 tokens, 75% of them starting with one
    of two 1024-token templates (`synthesize_requests`, seed 0)."""
    import numpy as np
    from repro_torch.api import synthesize_requests
    reqs = synthesize_requests(N_REQ, RATE, vocab, min_prompt=PREFIX_PROMPT_MIN,
                               max_prompt=PREFIX_PROMPT_MAX, max_new_tokens=NEW_MAX,
                               seed=SEED, prefix_templates=PREFIX_TEMPLATES,
                               prefix_len=PREFIX_LEN, shared_fraction=SHARED_FRACTION)
    gen = np.random.default_rng(SEED).integers(NEW_MIN, NEW_MAX + 1, size=N_REQ)
    for r, g in zip(reqs, gen):
        r.max_new_tokens = int(g)
    return reqs


def _prefix_changes(enabled, budget=NONE_BUDGET, margin=NONE_MARGIN):
    """`EngineConfig` changes of the policy-"none" runs (h), (i), (j):
    fairkv_dp without extra copies, so no head is replicated.  With
    replicas a request's logits depend on the row it lands in (the slot
    of its head's replica sets the order of the o-projection's sum), and
    sharing changes the rows requests land in (hits skip chunks, rows
    free earlier), so tokens could be compared only up to bf16 near-ties."""
    from repro_torch.api import CompressionConfig, PrefixConfig, SchedulerConfig
    return dict(
        compression=CompressionConfig(policy="none", budget=budget, capacity=budget,
                                      obs_window=OBS, pool=POOL, sink=SINK,
                                      decode_margin=margin),
        planner=planner("fairkv_dp", 0),
        scheduler=SchedulerConfig(max_rows=MAX_ROWS, enable_replan=False),
        max_seq_len=PREFIX_PROMPT_MAX + NEW_MAX + COW_DONOR_GEN,
        prefix=PrefixConfig(enabled=enabled, chunk_tokens=CHUNK,
                            max_entries=PREFIX_ENTRIES))


def prefix_runs(ctx):
    """Chunked prefill and shared-prefix reuse through `Engine.run_trace`
    at full width on bf16 pools (block size 16, 8 rows, chunks of 512):
    (h) policy "none", chunking only, and (i) the same with sharing, on
    `make_prefix_trace` (no replanning): (i) must hit, share blocks
    (refcount > 1 while requests are live), give (h)'s tokens for all 24
    requests with a lower peak of blocks per layer, and leave an empty,
    consistent pool after `flush`; (j) copy-on-write: a donor whose ring
    wraps into its registered prefix and a late request that hits after
    the wrap, against the same two requests without sharing; (k) the main
    path's Ada-SnapKV (fairkv_dp with 4 extra copies, replanning on) with
    sharing on the same trace, beside the same trace through phase 7's
    bf16 configuration (monolithic prefill, no sharing).  Returns the
    launches of all runs."""
    import numpy as np
    from repro_torch.api import PrefixConfig, Request
    m = ctx["cfg"].model
    launches, runs = {}, {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for name, enabled in (("(h) chunked", False), ("(i) shared", True)):
        got, runs[name] = continuous_run(ctx, name, "paged", "fp32",
                                         changes=_prefix_changes(enabled),
                                         reqs=make_prefix_trace(m.vocab_size))
        add(got)
    h, i = runs["(h) chunked"], runs["(i) shared"]
    same = sum(a == b for a, b in zip(h["tokens"], i["tokens"]))
    hits = sum(1 for t in i["hit_tokens"] if t)
    log(f"[prefix] (i) vs (h): {same}/{N_REQ} requests with identical tokens; {hits} "
        f"requests hit ({i['prefix']['hits']} hits / {i['prefix']['misses']} misses over "
        f"the admission lookups); max refcount while live {i['max_refcount']}; peak blocks "
        f"per layer {i['peak_blocks']} vs {h['peak_blocks']} "
        f"({100 * (1 - i['peak_blocks'] / h['peak_blocks']):.1f}% fewer); TTFT p50 "
        f"{i['ttft_s_p50']:.3f} vs {h['ttft_s_p50']:.3f} s, p99 {i['ttft_s_p99']:.3f} vs "
        f"{h['ttft_s_p99']:.3f} s; {i['tokens_per_s']:.1f} vs {h['tokens_per_s']:.1f} tokens/s; "
        f"chunks {i['chunks']} vs {h['chunks']}")
    if same != N_REQ:
        fail(f"(i) vs (h): only {same}/{N_REQ} requests with identical tokens")
    ctx["graphed"]["(i)"] = {k: i[k] for k in ("tokens", "prefix", "cow_copies", "hit_tokens")}
    if i["prefix"]["hits"] < 1 or i["max_refcount"] <= 1:
        fail(f"(i): no sharing ({i['prefix']}, max refcount {i['max_refcount']})")
    if not i["peak_blocks"] < h["peak_blocks"]:
        fail(f"(i): peak blocks per layer {i['peak_blocks']} not below (h)'s "
             f"{h['peak_blocks']}")

    # (j) copy-on-write at ring wrap: the reference's case, scaled to chunk 512
    rng = np.random.default_rng(SEED + 11)
    shared = rng.integers(1, m.vocab_size, size=PREFIX_LEN)
    sfx = [rng.integers(1, m.vocab_size, size=COW_SUFFIX) for _ in range(2)]

    def cow_reqs():
        return [Request(req_id=0, prompt=np.concatenate([shared, sfx[0]]).astype(np.int32),
                        arrival_step=0, max_new_tokens=COW_DONOR_GEN),
                Request(req_id=1, prompt=np.concatenate([shared, sfx[1]]).astype(np.int32),
                        arrival_step=COW_LATE_AT, max_new_tokens=COW_LATE_GEN)]

    for name, enabled in (("(j) cow", True), ("(j) plain", False)):
        got, runs[name] = continuous_run(
            ctx, name, "paged", "fp32", reqs=cow_reqs(),
            changes=_prefix_changes(enabled, budget=COW_BUDGET, margin=COW_MARGIN))
        add(got)
    cow, plain = runs["(j) cow"], runs["(j) plain"]
    log(f"[prefix] (j): {cow['cow_copies']} blocks copied on write; the late request hit "
        f"{cow['hit_tokens'][1]} tokens; its tokens equal the unshared engine's: "
        f"{cow['tokens'][1] == plain['tokens'][1]}; the donor's: "
        f"{cow['tokens'][0] == plain['tokens'][0]}")
    if cow["cow_copies"] <= 0 or cow["hit_tokens"][1] != PREFIX_LEN:
        fail(f"(j): {cow['cow_copies']} copies on write, late hit {cow['hit_tokens'][1]}")
    if cow["tokens"][1] != plain["tokens"][1]:
        fail("(j): the late sharer's tokens differ from the unshared engine's")

    # (k) the main path's compression with sharing, beside phase 7's bf16 config
    trace = make_prefix_trace(m.vocab_size)
    got, runs["(k) mono"] = continuous_run(ctx, "(k) mono", "paged", "fp32",
                                           reqs=make_prefix_trace(m.vocab_size))
    add(got)
    got, runs["(k) shared"] = continuous_run(
        ctx, "(k) shared", "paged", "fp32", reqs=trace,
        changes=dict(prefix=PrefixConfig(enabled=True, chunk_tokens=CHUNK,
                                         max_entries=PREFIX_ENTRIES)))
    add(got)
    k0, k = runs["(k) mono"], runs["(k) shared"]
    agree = sum(sum(a == b for a, b in zip(x, y)) for x, y in zip(k0["tokens"], k["tokens"]))
    total = sum(len(x) for x in k0["tokens"])
    b = ctx["cont_bf16"]
    log(f"[prefix] (k) Ada-SnapKV with sharing vs phase 7's bf16 configuration on the same "
        f"trace: peak blocks per layer {k['peak_blocks']} vs {k0['peak_blocks']}; TTFT p50 "
        f"{k['ttft_s_p50']:.3f} vs {k0['ttft_s_p50']:.3f} s, p99 {k['ttft_s_p99']:.3f} vs "
        f"{k0['ttft_s_p99']:.3f} s; {k['tokens_per_s']:.1f} vs {k0['tokens_per_s']:.1f} "
        f"tokens/s; {agree}/{total} tokens at equal positions ({100 * agree / total:.1f}%, "
        f"reported, not a bar); {k['prefix']['hits']} hits; phase 7's bf16 run on its own "
        f"trace: peak {b['peak_blocks']}, TTFT p50 {b['ttft_s_p50']:.3f} s p99 "
        f"{b['ttft_s_p99']:.3f} s, {b['tokens_per_s']:.1f} tokens/s")
    if k["prefix"]["hits"] < 1:
        fail(f"(k): no prefix hit ({k['prefix']})")
    log("[prefix] summary " + json.dumps(
        {k_: {kk: vv for kk, vv in v.items() if kk not in ("tokens", "logits")}
         for k_, v in runs.items()}))
    del runs
    profile_chunk(ctx)
    return launches


def profile_chunk(ctx, eager=False):
    """Where a chunked-prefill step's time goes, in (h)'s configuration: a
    2048-token prompt's four chunks into a fresh B = 1 sub-state, the
    first as warm-up, the second un-profiled (host wall), the last two
    under torch.profiler (device busy share and top kernels).  ``eager``
    times the eager executor instead of the CUDA graph."""
    import numpy as np
    import torch
    from repro_torch.api import Engine
    from repro_torch.serving.engine import init_serve_state
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ctx["cfg"].replace(cache_backend="paged", **_prefix_changes(False))
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
    if eager:
        eng.executor = eager_executor(cfg)
    m = cfg.model
    prompt = np.random.default_rng(SEED + 13).integers(0, m.vocab_size, size=(1, 4 * CHUNK))
    state = init_serve_state(m, eng.pa, 1, cfg.compression, dtype=torch.bfloat16,
                             device="cuda")
    quota = np.full(m.n_layers, CHUNK)  # policy "none" keeps a whole chunk

    def chunk(j):
        nonlocal state
        state, _, _ = eng.executor.prefill_chunk(
            eng.sp, prompt[:, j * CHUNK:(j + 1) * CHUNK], eng.pa, state, [0],
            [j * CHUNK], [CHUNK], quota)

    chunk(0)
    t0 = time.perf_counter()
    chunk(1)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    wall, total, ours, top = _device_profile(lambda: (chunk(2), chunk(3)),
                                             ours_keys=("snapkv_",))
    if total <= 0:
        log("[profile] torch.profiler recorded no device time for the chunk steps")
        return
    label = "eager" if eager else "graphs"
    TIMES[("chunk step", label)] = (plain_ms, total / 2e3)
    log(f"[profile] {label}: chunked prefill, {CHUNK}-token chunks (policy none, capacity "
        f"{cfg.compression.static_capacity()}): un-profiled {plain_ms:.2f} ms per chunk; "
        f"profiled 2 chunks: device busy {total / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall "
        f"({100 * total / 1e6 / wall:.1f}%); snapkv_scores {ours / 2e3:.3f} ms per chunk "
        f"({100 * ours / total:.2f}% of device time)")
    for name, us in top:
        log(f"[profile]   chunk top kernel {us / 2e3:8.3f} ms/chunk  {name}")
    if eager:  # which ops launch those kernels: one more chunk, by op and shapes
        state = init_serve_state(m, eng.pa, 1, cfg.compression, dtype=torch.bfloat16,
                                 device="cuda")
        rows, _ = _ops_by_shape(lambda: chunk(0))
        for op, shapes, us, n in rows[:6]:
            log(f"[attr]   chunk step {us / 1e3:8.3f} ms  {n:4d} calls  {op}  {shapes}")


# ---------------------------------------------------------------------------
# phase 9: CUDA graphs against eager execution at full width
# ---------------------------------------------------------------------------


def _ops_by_shape(fn):
    """Run ``fn`` under torch.profiler with shapes recorded; returns the
    PyTorch ops that launched device work, grouped by op and input shapes:
    [(op, input shapes, self device us, calls)], largest first, and the
    total device us."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
    rows, total = [], 0.0
    for ev in prof.key_averages(group_by_input_shape=True):
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            total += ev.self_device_time_total
        elif ev.self_device_time_total > 0:
            rows.append((ev.key, ev.input_shapes, ev.self_device_time_total, ev.count))
    rows.sort(key=lambda r: -r[2])
    return rows, total


def attribute_elementwise(eng):
    """The decode step's ops by input shapes: one eager decode step on the
    main engine under torch.profiler, device time grouped by op and input
    shapes.  The generic elementwise kernel of 7.2 ms per step was einsum
    copying the slot weights to another layout (PERF.md section 5); fails
    if the step copies a slot weight again (an op whose first input has a
    slot weight's element count)."""
    import math
    layers = eng.sp["layers"]
    ex, eng.executor = eng.executor, eager_executor(eng.cfg)
    try:
        state = eng.state
        eng.executor.decode(eng.sp, state, eng.pa)  # warm
        rows, total = _ops_by_shape(lambda: eng.executor.decode(eng.sp, state, eng.pa))
    finally:
        eng.executor = ex
    log(f"[attr] one eager decode step: {total / 1e3:.3f} ms of device time; top ops by "
        f"input shapes:")
    for op, shapes, us, n in rows[:8]:
        log(f"[attr]   {us / 1e3:8.3f} ms  {n:4d} calls  {op}  {shapes}")
    sizes = {layers[0][k].numel() for k in ("wq_s", "wk_s", "wv_s", "wo_s")}
    copies = [r for r in rows if r[0] in ("aten::copy_", "aten::clone", "aten::contiguous")
              and r[1] and math.prod(r[1][0]) in sizes]
    if copies:
        fail(f"the decode step copies a slot weight: {copies}")
    return {"step_device_ms": total / 1e3}


def graphs_vs_eager(ctx):
    """Phase 9: every phase so far ran its steps as CUDA graphs; here the
    main ones run again eagerly and must agree.

    - one-shot fairkv_dp (B = 8, T = 2048, 32 new tokens, teacher-forced
      on sha's tokens): an eager engine gives phase 5's tokens and
      lengths; the logit gap is printed and bounded by n_layers * 2^-8 *
      max|logit|;
    - continuous (b), bf16 pools with replanning: identical tokens and
      replan decisions, the pool empty at the end (`continuous_run`);
    - speculative (e): identical tokens and acceptance;
    - chunked + shared (i): identical tokens, hits and copy-on-write count;
    - host-clocked and device time per one-shot step, continuous tick,
      speculative tick and chunk step, graphed and eager (the profiling
      passes of phases 5-8 timed the graphs; their eager twins run here).

    No eager comparison is cut to a prefix of its trace."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, SpeculationConfig
    m = ctx["cfg"].model
    out = {}

    # one-shot: eager against phase 5's graphed fairkv_dp run
    gc.collect()
    torch.cuda.empty_cache()
    graphed = ctx["slot_dp"]
    eng = Engine.build(ctx["cfg"], params=ctx["params"], profile=ctx["profile"])
    eng.executor = eager_executor(eng.cfg)
    res = eng.generate(ctx["prompts"], GEN, teacher_tokens=ctx["teacher"])
    gap = float(np.abs(res.logits - graphed.logits).max())
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(graphed.logits).max())
    same = bool(np.array_equal(res.tokens, graphed.tokens))
    log(f"[graphs] one-shot fairkv_dp: eager vs CUDA graphs: tokens identical {same}, lengths "
        f"identical {bool(np.array_equal(res.lengths, graphed.lengths))}, max |logit gap| "
        f"{gap:.6f} (bound {tol:.4f})")
    if not same or not np.array_equal(res.lengths, graphed.lengths):
        fail("one-shot: the eager engine's tokens or lengths differ from the graphed engine's")
    if not gap < tol:
        fail(f"one-shot: logit gap {gap} >= {tol}")
    profile_decode(eng, statistics.median(res.step_s), label="eager")
    del eng
    out["oneshot_logit_gap"] = gap

    # continuous (b), speculative (e), chunked + shared (i), eagerly
    g = ctx["graphed"]
    _, b = continuous_run(ctx, "(b) eager", "paged", "fp32", eager=True)
    same = sum(x == y for x, y in zip(b["tokens"], g["(b)"]["tokens"]))
    log(f"[graphs] (b) eager vs graphs: {same}/{N_REQ} requests with identical tokens; replan "
        f"decisions {b['replan_decisions']} vs {g['(b)']['replan_decisions']}")
    if same != N_REQ or b["replan_decisions"] != g["(b)"]["replan_decisions"]:
        fail("(b): the eager run's tokens or replan decisions differ from the graphs'")
    _, e = continuous_run(ctx, "(e) eager", "paged", "fp32", eager=True,
                          spec=SpeculationConfig(**SPEC_E))
    same = sum(x == y for x, y in zip(e["tokens"], g["(e)"]["tokens"]))
    log(f"[graphs] (e) eager vs graphs: {same}/{N_REQ} requests with identical tokens; "
        f"acceptance {e['acceptance']} vs {g['(e)']['acceptance']}")
    if same != N_REQ or e["acceptance"] != g["(e)"]["acceptance"]:
        fail("(e): the eager run's tokens or acceptance differ from the graphs'")
    _, i = continuous_run(ctx, "(i) eager", "paged", "fp32", eager=True,
                          changes=_prefix_changes(True), reqs=make_prefix_trace(m.vocab_size))
    same = sum(x == y for x, y in zip(i["tokens"], g["(i)"]["tokens"]))
    gi = g["(i)"]
    log(f"[graphs] (i) eager vs graphs: {same}/{N_REQ} requests with identical tokens; "
        f"prefix {i['prefix']} vs {gi['prefix']}; cow copies {i['cow_copies']} vs "
        f"{gi['cow_copies']}")
    if (same != N_REQ or i["prefix"] != gi["prefix"] or i["cow_copies"] != gi["cow_copies"]
            or i["hit_tokens"] != gi["hit_tokens"]):
        fail("(i): the eager run's tokens, hits or copy-on-write differ from the graphs'")
    out["eager_runs"] = {k: {kk: v[kk] for kk in ("step_ms_median", "tokens_per_s",
                                                  "ttft_s_p50", "chunk_ms_median",
                                                  "propose_ms_median", "verify_ms_median")}
                         for k, v in (("(b)", b), ("(e)", e), ("(i)", i))}

    profile_continuous(ctx, eager=True)
    profile_speculative(ctx, eager=True)
    profile_chunk(ctx, eager=True)
    for kind in ("one-shot step", "continuous tick", "speculative tick", "chunk step"):
        cells = []
        for label in ("graphs", "eager"):
            if (kind, label) not in TIMES:
                fail(f"no {label} time for the {kind}: its profiler pass recorded no "
                     f"device time")
            host, dev = TIMES[(kind, label)]
            cells.append(f"{label}: host-clocked {host:.2f} ms, device {dev:.2f} ms "
                         f"({100 * dev / host:.1f}% busy)")
        log(f"[graphs] {kind:17s} " + " | ".join(cells))
    out["times"] = {f"{k} ({lab})": v for (k, lab), v in TIMES.items()}
    log("[graphs] summary " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 12: the six compression policies at full width
# ---------------------------------------------------------------------------

# policy runs of phase 12: (label, policy, with head_importance)
POLICY_RUNS = (("streaming_llm", "streaming_llm", False), ("snapkv", "snapkv", False),
               ("pyramidkv", "pyramidkv", False), ("h2o", "h2o", False),
               ("ada_snapkv", "ada_snapkv", False), ("headkv", "headkv", False),
               ("headkv+imp", "headkv", True))


def _policy_config(ctx, policy, mode, ch):
    import dataclasses
    return ctx["cfg"].replace(
        compression=dataclasses.replace(ctx["cfg"].compression, policy=policy),
        planner=planner(mode, ch))


def _step_times(eng, steps=3):
    """Device ms per graphed decode step and kernel 1's device ms per step,
    from one torch.profiler pass over ``steps`` more steps."""
    box = {"state": eng.state}

    def decode():
        for _ in range(steps):
            box["state"], _ = eng.executor.decode(eng.sp, box["state"], eng.pa)

    _, total, ours, _ = _device_profile(decode, ours_keys=("fairkv_decode_kernel",))
    eng.state = box["state"]
    if total <= 0:
        fail("phase 12: torch.profiler recorded no device time for the decode steps")
    return total / 1e3 / steps, ours / 1e3 / steps


def policy_runs(ctx):
    """Phase 12: one-shot B = 8, T = 2048, 32 new tokens under each of the
    six policies (headkv also with phase 5's measured profile as
    ``head_importance``), under sha and fairkv_dp (CH = 4); each fairkv_dp
    plan is built from the policy's own measured profile (a sample batch),
    and fairkv_dp is teacher-forced on sha's tokens.  Bars per policy:
    retained lengths bitwise plan-invariant; balanced policies keep exactly
    min(budget_l, T, C) per head; `layer_keep_bound` >= the realized
    sum of keep of every layer and row; the logit gap of phase 5.  Prints
    per policy the retained sum per layer, the per-shard load max/mean
    (Eq. 4) under both plans, plan efficiency E, the graphed step's host
    and device time and kernel 1's device time per step.  Then phase 7's
    (b) configuration under headkv with obs on and off (identical tokens,
    no capture during either trace, Prometheus text and Chrome trace that
    parse, host-clocked tick medians), and (c)'s int8 pools with
    `plan_kv_dtypes` overrides.  Returns the launches of the phase."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, ObsConfig, PagingConfig, plan_kv_dtypes
    from repro_torch.compression.policies import BALANCED, _pyramid_budget, layer_keep_bound
    from repro_torch.configs.base import InputShape
    from repro_torch.core.profiles import profile_from_lengths
    from repro_torch.kernels import build
    from repro_torch.training.data import SyntheticLM

    m = ctx["cfg"].model
    L, H = m.n_layers, m.n_kv_heads
    data = SyntheticLM(m, InputShape("chip_smoke", T, B, "prefill"))
    sample = data.get_batch(123)["tokens"]
    prompts = ctx["prompts"]
    launches = {k: 0 for k in build.LAUNCHES}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    rows = {}
    for label, policy, with_imp in POLICY_RUNS:
        imp = ctx["profile"] if with_imp else None
        res, plans = {}, {}
        profile = eng = None
        for mode, ch in (("sha", 0), ("fairkv_dp", 4)):
            eng = None  # free the previous engine's slot weights and cache first
            gc.collect()
            torch.cuda.empty_cache()
            eng = Engine.build(_policy_config(ctx, policy, mode, ch), params=ctx["params"],
                               profile=ctx["profile"] if profile is None else profile,
                               head_importance=imp)
            if profile is None:  # the policy's own offline statistic
                profile, got = _count(lambda: eng.measure_profile(sample))
                add(got)
            teacher = None if mode == "sha" else res["sha"].tokens[:, :GEN]
            r, got = _count(lambda: eng.generate(prompts, GEN, teacher_tokens=teacher))
            add(got)
            if got["fairkv_decode"] != L * GEN or got["snapkv_scores"] != L:
                fail(f"{label} {mode}: launches {got}, expected {L * GEN} fairkv_decode and "
                     f"{L} snapkv_scores")
            if not np.isfinite(r.logits).all():
                fail(f"{label} {mode}: logits not finite")
            res[mode], plans[mode] = r, eng.plan
        sha, dp = res["sha"], res["fairkv_dp"]
        if not np.array_equal(sha.lengths, dp.lengths):
            fail(f"{label}: retained lengths differ between sha and fairkv_dp")
        lens = dp.lengths  # (L, Hkv, B)
        C = eng.cfg.compression.static_capacity()
        if policy in BALANCED:
            for layer in range(L):
                b = (_pyramid_budget(eng.cfg.compression, layer, L) if policy == "pyramidkv"
                     else BUDGET)
                if not (lens[layer] == min(b, T, C)).all():
                    fail(f"{label}: layer {layer} keeps {np.unique(lens[layer])}, expected "
                         f"exactly min({b}, {T}, {C})")
        per_layer = lens.sum(axis=1)  # (L, B)
        bounds = np.asarray([layer_keep_bound(policy, eng.cfg.compression, T, H, layer, L)
                             for layer in range(L)])
        if not (per_layer <= bounds[:, None]).all():
            worst = int((per_layer - bounds[:, None]).max())
            fail(f"{label}: a layer keeps {worst} tokens more than layer_keep_bound")
        tol = L * 2.0 ** -8 * float(np.abs(sha.logits).max())
        gap = float(np.abs(dp.logits - sha.logits).max())
        if not gap < tol:
            fail(f"{label}: fairkv_dp logits differ from sha's by {gap} >= {tol}")
        realized = profile_from_lengths(lens.astype(np.float64))
        load = {}
        for mode, plan in plans.items():
            per_shard = plan.per_shard_load(realized)
            load[mode] = float(per_shard.max() / per_shard.mean())
        dev_ms, k1_ms = _step_times(eng)
        host_ms = 1e3 * statistics.median(dp.step_s)
        rows[label] = {
            "retained_per_layer": per_layer.sum(axis=1).astype(int).tolist(),
            "retained_min_mean_max": [int(lens.min()), float(lens.mean()), int(lens.max())],
            "load_max_over_mean": load, "efficiency": {"sha": sha.efficiency,
                                                       "fairkv_dp": dp.efficiency},
            "step_ms_host": host_ms, "step_ms_device": dev_ms, "kernel1_ms_per_step": k1_ms,
            "prefill_s": dp.prefill_s, "logit_gap": gap, "logit_bound": tol,
            "keep_bound_slack_min": int((bounds[:, None] - per_layer).min())}
        log(f"[policy] {label:13s} retained per layer sum {per_layer.sum():8d} "
            f"(per-head min/mean/max {lens.min()}/{lens.mean():.1f}/{lens.max()}) | "
            f"load max/mean sha {load['sha']:.4f} fairkv_dp {load['fairkv_dp']:.4f} | "
            f"E sha {sha.efficiency:.4f} fairkv_dp {dp.efficiency:.4f} | step host "
            f"{host_ms:.2f} ms device {dev_ms:.2f} ms, kernel 1 {k1_ms:.4f} ms/step | "
            f"logit gap {gap:.4f} (bound {tol:.4f}) | keep bound slack >= "
            f"{rows[label]['keep_bound_slack_min']}")
        log(f"[policy] {label:13s} retained per layer: {rows[label]['retained_per_layer']}")
        eng = None
    log("[policy] summary " + json.dumps(rows))

    # phase 7's (b) under headkv, obs on and off
    import dataclasses
    comp = dataclasses.replace(ctx["cfg"].compression, policy="headkv")
    seen = {}

    def check_obs(eng, compiles_warm):
        seen["compiles"] = {k: eng.obs.metrics.counter_value(
            "stepfn_compiles_total", kind=k, executor="local") for k in compiles_warm}
        seen["warm"] = compiles_warm
        seen["prom"] = eng.metrics_prometheus()
        seen["trace"] = eng.trace_export()
        seen["families"] = sorted(eng.metrics())

    runs = {}
    for name, enabled in (("headkv obs on", True), ("headkv obs off", False)):
        seen.clear()
        got, runs[name] = continuous_run(
            ctx, name, "paged", "fp32", head_importance=ctx["profile"], inspect=check_obs,
            changes={"compression": comp, "obs": ObsConfig(enabled=enabled)})
        add(got)
        if enabled:
            if seen["compiles"] != seen["warm"] or sum(seen["warm"].values()) < 1:
                fail(f"{name}: stepfn_compiles_total {seen['compiles']} after the trace, "
                     f"{seen['warm']} after warmup")
            lines = [ln for ln in seen["prom"].splitlines() if not ln.startswith("#")]
            for ln in lines:
                float(ln.rsplit(" ", 1)[1])
            events = json.loads(seen["trace"])["traceEvents"]
            names = {e["name"] for e in events}
            if not {"admit", "decode_tick", "stepfn_decode", "retire"} <= names:
                fail(f"{name}: trace events {sorted(names)}")
            log(f"[policy] {name}: {len(lines)} Prometheus series, {len(events)} trace "
                f"events, families {seen['families']}; stepfn_compiles_total "
                f"{seen['compiles']} after the trace = after warmup")
    on, off = runs["headkv obs on"], runs["headkv obs off"]
    same = sum(x == y for x, y in zip(on["tokens"], off["tokens"]))
    log(f"[policy] headkv (b) obs on vs off: {same}/{N_REQ} requests identical; tick median "
        f"{on['step_ms_median']:.2f} vs {off['step_ms_median']:.2f} ms (host clock); "
        f"tokens/s {on['tokens_per_s']:.1f} vs {off['tokens_per_s']:.1f}")
    if same != N_REQ:
        fail(f"headkv obs on vs off: only {same}/{N_REQ} requests identical")

    # (c)'s int8 pools with per-head fp8 overrides from the measured profile
    overrides = plan_kv_dtypes(ctx["profile"])
    got, mixed = continuous_run(
        ctx, "int8+fp8 plan", "paged", "int8",
        changes={"paging": PagingConfig(block_size=BLOCK, kv_dtype="int8",
                                        kv_dtype_overrides=overrides)})
    add(got)
    log(f"[policy] (c) int8 with plan_kv_dtypes overrides: {len(overrides)} of {L * H} "
        f"(layer, head) cells in fp8; {mixed['finished']}/{N_REQ} finished, "
        f"tokens/s {mixed['tokens_per_s']:.1f}, tick median {mixed['step_ms_median']:.2f} ms")
    log("[policy] continuous summary " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk not in ("tokens", "logits")}
         for k, v in {**runs, "int8+fp8 plan": mixed}.items()}))
    log(f"[policy] launches over phase 12: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the serving CLI at full width
# ---------------------------------------------------------------------------


def cli_run():
    """Phase 13: ``python -m repro_torch.launch.serve`` at full width in a
    subprocess (continuous, headkv, paged pools, a few requests), writing
    its Prometheus metrics and Chrome trace under chiprun_out/.  Bars: exit
    0, and both files parse."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    metrics, trace = out_dir / "serve_metrics.prom", out_dir / "serve_trace.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--continuous",
           "--policy", "headkv", "--cache-backend", "paged", "--budget", str(BUDGET),
           "--requests", "6", "--rows", "4", "--rate", "0.5", "--min-prompt", "512",
           "--max-prompt", "1024", "--gen", "16", "--shards", str(N_SHARDS),
           "--metrics-out", str(metrics), "--trace-out", str(trace)]
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    tail = "\n".join(proc.stdout.splitlines()[-8:])
    log(f"[cli] {' '.join(cmd[1:])}: exit {proc.returncode} in {wall:.1f} s\n{tail}")
    if proc.returncode != 0:
        fail(f"the serving CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [ln for ln in metrics.read_text().splitlines() if not ln.startswith("#")]
    for ln in lines:
        float(ln.rsplit(" ", 1)[1])
    events = json.loads(trace.read_text())["traceEvents"]
    if not lines or not events:
        fail("the serving CLI wrote an empty metrics or trace file")
    log(f"[cli] {metrics.name}: {len(lines)} series; {trace.name}: {len(events)} events")


# ---------------------------------------------------------------------------
# phase 10: timings on the main path's inputs
# ---------------------------------------------------------------------------


def time_ms(fn, flush, iters=25, warmup=5):
    """Median device time of ``fn`` in ms (CUDA events), L2 flushed before
    each run.  A ~1 ms device sleep sits between the flush and the start
    event, so the host has enqueued all of ``fn`` before the device reaches
    the start event: the time is the device's, without the wrapper's host
    time (which `host_us` reports)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def host_us(fn, n=100):
    """Host time per call of ``fn`` in us: ``n`` calls enqueued back to
    back (the device's work is not waited for)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def _scores_bound(q, k, opos, kpos):
    """(bytes, FLOP, bound ms) of snapkv_scores on these inputs: q and K
    read once, the positions, the fp32 output written once; the score
    contraction's FLOP at the bf16 tensor-core peak."""
    Bq, W, Hq, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    nbytes = (k.numel() + q.numel()) * k.element_size() + (opos.numel() + kpos.numel()) * 4 \
        + Bq * Hkv * Tk * 4
    flops = 2 * Bq * Hq * W * Tk * Dh
    return nbytes, flops, 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def time_kernels(engine, launches, paged, mq_inputs, prefix):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    from repro_torch.kernels.ref import fairkv_decode_ref, snapkv_scores_ref
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    m = engine.cfg.model
    rows = []

    # kernel 1 on layer 0 of the fairkv_dp engine's cache after decode
    cache = engine.state.cache
    k, v, ln = cache.k[0], cache.v[0], cache.lengths[0]
    S, Bq, C, Dh = k.shape
    G = m.q_per_kv
    q = torch.randn((Bq, S, G, Dh), generator=gen, device="cuda").to(k.dtype)
    out = fairkv_decode_cuda(q, k, v, ln)
    ref = fairkv_decode_ref(q, k, v, ln)
    err = _cmp("fairkv_decode (main-path cache)", out, ref, FP32_TOL, BF16_ULP)
    qs = q.permute(1, 0, 2, 3).reshape(S * Bq, G, 1, Dh)
    ks = k.reshape(S * Bq, 1, C, Dh)
    vs = v.reshape(S * Bq, 1, C, Dh)
    mask = (torch.arange(C, device="cuda")[None, :] < ln.reshape(-1, 1))[:, None, None, :]
    kern = time_ms(lambda: fairkv_decode_cuda(q, k, v, ln), flush)
    plain = time_ms(lambda: fairkv_decode_ref(q, k, v, ln), flush)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                           enable_gqa=True), flush)
    it = k.element_size()
    n_ret = int(ln.sum().item())
    bytes1 = (n_ret * Dh * 2 * it + 2 * q.numel() * it + ln.numel() * 4)
    flops1 = 4 * n_ret * G * Dh
    bound1 = 1e3 * max(bytes1 / HBM_BYTES_PER_S, flops1 / BF16_FLOP_PER_S)
    rows.append({"name": "fairkv_decode", "route": "cuda",
                 "source": "src/repro_torch/csrc/fairkv_decode.cu",
                 "replaces": "src/repro/kernels/fairkv_decode.py:107",
                 "launches": launches["fairkv_decode"], "max_abs_err": err,
                 "ms": kern, "plain_ms": plain, "bound_ms": bound1,
                 "bound_by": "bytes" if bytes1 / HBM_BYTES_PER_S >= flops1 / BF16_FLOP_PER_S
                 else "operations",
                 "library_ms": lib})
    host_kern = host_us(lambda: fairkv_decode_cuda(q, k, v, ln))
    host_lib = host_us(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                              enable_gqa=True))
    log(f"[time] fairkv_decode at (B={Bq}, S={S}, G={G}, C={C}, Dh={Dh}) bf16, "
        f"sum(lengths)={n_ret}: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
        f"SDPA {lib:.4f} ms, bound {bound1:.4f} ms ({bytes1} B / 3.35 TB/s); host time "
        f"per call: kernel {host_kern:.1f} us, SDPA {host_lib:.1f} us")

    # kernel 2 at prefill's shape: q_obs (B, W, Hq, Dh), k (B, T, Hkv, Dh)
    q2 = torch.randn((B, OBS, m.n_heads, Dh), generator=gen, device="cuda").to(k.dtype)
    k2 = torch.randn((B, T, m.n_kv_heads, Dh), generator=gen, device="cuda").to(k.dtype)
    kpos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T).contiguous()
    opos = kpos[:, T - OBS:].contiguous()
    out2 = snapkv_scores_cuda(q2, k2, opos, kpos)
    ref2 = snapkv_scores_ref(q2, k2, opos, kpos)
    err2 = _cmp("snapkv_scores (main-path shape)", out2, ref2, FP32_TOL, 1e-5)
    kern2 = time_ms(lambda: snapkv_scores_cuda(q2, k2, opos, kpos), flush)
    plain2 = time_ms(lambda: snapkv_scores_ref(q2, k2, opos, kpos), flush)
    bytes2, flops2, bound2 = _scores_bound(q2, k2, opos, kpos)
    rows.append({"name": "snapkv_scores", "route": "cuda",
                 "source": "src/repro_torch/csrc/snapkv_scores.cu",
                 "replaces": "src/repro/kernels/snapkv_select.py:89",
                 "launches": launches["snapkv_scores"], "max_abs_err": err2,
                 "ms": kern2, "plain_ms": plain2, "bound_ms": bound2,
                 "bound_by": "bytes" if bytes2 / HBM_BYTES_PER_S >= flops2 / BF16_FLOP_PER_S
                 else "operations",
                 "library_ms": None})
    log(f"[time] snapkv_scores at (B={B}, W={OBS}, Hq={m.n_heads}, Hkv={m.n_kv_heads}, "
        f"Dh={Dh}, T={T}) bf16: kernel {kern2:.4f} ms, plain {plain2:.4f} ms, "
        f"bound {bound2:.4f} ms (max of {bytes2} B / 3.35 TB/s and {flops2} FLOP / "
        f"989 TFLOP/s; {flops2 / FP32_FLOP_PER_S * 1e3:.4f} ms at the fp32 CUDA-core peak); "
        f"host time per call {host_us(lambda: snapkv_scores_cuda(q2, k2, opos, kpos)):.1f} us")
    # and at B = 1, the continuous scheduler's admission prefill of T tokens
    q1, k1, op1, kp1 = (x[:1].contiguous() for x in (q2, k2, opos, kpos))
    err_b1 = _cmp("snapkv_scores (B=1)", snapkv_scores_cuda(q1, k1, op1, kp1),
                  snapkv_scores_ref(q1, k1, op1, kp1), FP32_TOL, 1e-5)
    kern_b1 = time_ms(lambda: snapkv_scores_cuda(q1, k1, op1, kp1), flush)
    plain_b1 = time_ms(lambda: snapkv_scores_ref(q1, k1, op1, kp1), flush)
    bytes_b1, _, bound_b1 = _scores_bound(q1, k1, op1, kp1)
    rows[-1].update(ms_b1=kern_b1, plain_ms_b1=plain_b1, bound_ms_b1=bound_b1)
    log(f"[time] snapkv_scores at (B=1, W={OBS}, Hq={m.n_heads}, Hkv={m.n_kv_heads}, "
        f"Dh={Dh}, T={T}) bf16: kernel {kern_b1:.4f} ms, plain {plain_b1:.4f} ms, "
        f"bound {bound_b1:.4f} ms ({bytes_b1} B / 3.35 TB/s); max abs err {err_b1:.3e}")
    # and at the chunk shape of chunked prefill: a full chunk of CHUNK keys
    # at positions from 1024, the last OBS queries
    qc, kc, opc, kpc = chunk_scores_inputs(gen, OBS, m.n_heads, m.n_kv_heads, Dh, CHUNK,
                                           1024, CHUNK, k.dtype)
    err_c = _cmp("snapkv_scores (chunk shape)", snapkv_scores_cuda(qc, kc, opc, kpc),
                 snapkv_scores_ref(qc, kc, opc, kpc), FP32_TOL, 1e-5)
    kern_c = time_ms(lambda: snapkv_scores_cuda(qc, kc, opc, kpc), flush)
    plain_c = time_ms(lambda: snapkv_scores_ref(qc, kc, opc, kpc), flush)
    bytes_c, flops_c, bound_c = _scores_bound(qc, kc, opc, kpc)
    rows[-1].update(ms_chunk=kern_c, plain_ms_chunk=plain_c, bound_ms_chunk=bound_c,
                    max_abs_err_chunk=err_c, launches_chunk_phase=prefix["snapkv_scores"])
    log(f"[time] snapkv_scores at the chunk shape (B=1, W={OBS}, Hq={m.n_heads}, "
        f"Hkv={m.n_kv_heads}, Dh={Dh}, T={CHUNK}, positions from 1024) bf16: kernel "
        f"{kern_c:.4f} ms, plain {plain_c:.4f} ms, bound {bound_c:.4f} ms (max of {bytes_c} B "
        f"/ 3.35 TB/s and {flops_c} FLOP / 989 TFLOP/s); max abs err {err_c:.3e}; "
        f"{prefix['snapkv_scores']} launches in the chunked / prefix phase")

    # kernel 3 on layer 0 of the paged caches after the one-shot decode
    # (bf16 pools; int8 pools beside them)
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.kernels.ref import paged_fairkv_decode_ref
    C = int(round(ALPHA * BUDGET)) + MARGIN
    row = {"name": "paged_fairkv_decode", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_fairkv_decode.cu",
           "replaces": "src/repro/kernels/paged_fairkv_decode.py:326",
           "launches": launches["paged_fairkv_decode"], "library_ms": None}
    for name in ("bf16", "int8"):
        t = paged[name]
        tbl, ln = t["table"], t["lengths"]
        S, Bq, M = tbl.shape
        q3 = torch.randn((Bq, S, G, Dh), generator=gen, device="cuda").to(torch.bfloat16)
        kw = {}
        if name == "int8":
            kinds = torch.zeros((S,), dtype=torch.int32, device="cuda")
            kw = dict(k_scale=t["k_scale"], v_scale=t["v_scale"], kinds=kinds)
        args = (q3, t["k_pool"], t["v_pool"], t["pos_pool"], tbl, ln, C)
        out3 = paged_fairkv_decode_cuda(*args, **kw)
        ref3 = paged_fairkv_decode_ref(*args, **kw)
        err3 = _cmp_paged(f"paged_fairkv_decode ({name} pools, main-path cache)", out3, ref3)
        kern3 = time_ms(lambda: paged_fairkv_decode_cuda(*args, **kw), flush)
        plain3 = time_ms(lambda: paged_fairkv_decode_ref(*args, **kw), flush)
        # bytes this data needs: the K and V rows of the retained columns,
        # the table entries and (int8) the two scales of each valid block,
        # q, out, lengths; operations: q.k and p.v per retained column
        n_ret = int(ln.sum().item())
        n_blk = int(((ln + BLOCK - 1) // BLOCK).sum().item())
        it3 = t["k_pool"].element_size()
        bytes3 = (n_ret * Dh * 2 * it3 + n_blk * 4 + (n_blk * 8 if kw else 0)
                  + 2 * q3.numel() * 2 + ln.numel() * 4)
        flops3 = 4 * n_ret * G * Dh
        bound3 = 1e3 * max(bytes3 / HBM_BYTES_PER_S, flops3 / BF16_FLOP_PER_S)
        sfx = "" if name == "bf16" else "_int8"
        row.update({f"max_abs_err{sfx}": err3, f"ms{sfx}": kern3, f"plain_ms{sfx}": plain3,
                    f"bound_ms{sfx}": bound3})
        if name == "bf16":
            row["bound_by"] = ("bytes" if bytes3 / HBM_BYTES_PER_S >= flops3 / BF16_FLOP_PER_S
                               else "operations")
        log(f"[time] paged_fairkv_decode, {name} pools, at (B={Bq}, S={S}, G={G}, Dh={Dh}, "
            f"bs={BLOCK}, M={M}), sum(lengths)={n_ret} in {n_blk} blocks: kernel "
            f"{kern3:.4f} ms, plain {plain3:.4f} ms, bound {bound3:.4f} ms "
            f"({bytes3} B / 3.35 TB/s); no single PyTorch call reads a block table")
    rows.append(row)

    # kernel 4 on the inputs of layer 0 at a verify tick of (e) (Q = 5)
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_mq_cuda
    args, kw = mq_inputs["args"], mq_inputs["kw"]
    q4, tbl, ln = args[0], args[4], args[5]
    Bq, S, Q, G, Dh = q4.shape
    out4 = paged_fairkv_decode_mq_cuda(*args, **kw)
    ref4 = paged_fairkv_decode_ref(*args, **kw)
    err4 = _cmp("paged_fairkv_decode_mq (main-path verify inputs)", out4, ref4,
                FP32_TOL, BF16_ULP)
    kern4 = time_ms(lambda: paged_fairkv_decode_mq_cuda(*args, **kw), flush)
    plain4 = time_ms(lambda: paged_fairkv_decode_ref(*args, **kw), flush)
    # bytes this data needs: the K and V rows of the retained columns (every
    # column below len is visible to the window's last query), the table
    # entries of the valid blocks, q, out, lengths, q_lens; operations:
    # q.k and p.v for each (query, visible column) pair
    n_ret = int(ln.sum().item())
    n_blk = int(((ln + BLOCK - 1) // BLOCK).sum().item())
    it4 = args[1].element_size()
    qn = kw["q_lens"].long()[:, None, None]  # (B, 1, 1)
    lnT = ln.T.long()[:, :, None]  # (B, S, 1)
    vis = torch.clamp(torch.minimum(lnT - (qn - 1 - torch.arange(Q, device="cuda")), lnT),
                      min=0)
    n_vis = int(vis.sum().item())
    bytes4 = (n_ret * Dh * 2 * it4 + n_blk * 4 + 2 * q4.numel() * q4.element_size()
              + ln.numel() * 4 + Bq * 4)
    flops4 = 4 * n_vis * G * Dh
    bound4 = 1e3 * max(bytes4 / HBM_BYTES_PER_S, flops4 / BF16_FLOP_PER_S)
    rows.append({"name": "paged_fairkv_decode_mq", "route": "cuda",
                 "source": "src/repro_torch/csrc/paged_fairkv_decode_mq.cu",
                 "replaces": "src/repro/kernels/paged_fairkv_decode.py:238",
                 "launches": launches["paged_fairkv_decode_mq"], "max_abs_err": err4,
                 "ms": kern4, "plain_ms": plain4, "bound_ms": bound4,
                 "bound_by": "bytes" if bytes4 / HBM_BYTES_PER_S >= flops4 / BF16_FLOP_PER_S
                 else "operations",
                 "library_ms": None})
    log(f"[time] paged_fairkv_decode_mq, bf16 pools, verify inputs of layer 0 at (B={Bq}, "
        f"S={S}, Q={Q}, G={G}, Dh={Dh}, bs={BLOCK}), q_lens {kw['q_lens'].tolist()}, "
        f"sum(lengths)={n_ret} in {n_blk} blocks, {n_vis} visible (query, column) pairs: "
        f"kernel {kern4:.4f} ms, plain {plain4:.4f} ms, bound {bound4:.4f} ms ({bytes4} B / "
        f"3.35 TB/s; {flops4} FLOP); no single PyTorch call reads a block table")
    return rows


# ---------------------------------------------------------------------------
# phase 11: after the timings
# ---------------------------------------------------------------------------


def oneshot_beside_scheduler(ctx):
    """Phase 11: one engine serving one-shot and continuous at once, graphed
    against an eager twin driven alike (fairkv_dp, slot backend, 8
    scheduler rows: the one-shot state and the scheduler's share a layout,
    and each gets a decode graph of its own).  Each engine: generate, a
    one-shot replan to the flipped profile, generate, `warmup`, then the
    first 4 requests of `make_trace` with a generate after tick 4.  Holds
    the graphed engine to the eager one (one-shot tokens, the logit gap
    within phase 5's bf16 bound, trace tokens), the first generate to phase 5's tokens, and the
    captures to one decode graph per live state, unmoved by the replan,
    the ticks and the later generates."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, SchedulerConfig
    from repro_torch.serving.engine import state_layout
    cfg = ctx["cfg"].replace(scheduler=SchedulerConfig(max_rows=B))
    flipped = np.ascontiguousarray(ctx["profile"][:, ::-1])
    runs = {}
    for label in ("graphs", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
        if label == "eager":
            eng.executor = eager_executor(cfg)
        ex = eng.executor
        gen = lambda: eng.generate(ctx["prompts"], GEN, teacher_tokens=ctx["teacher"])  # noqa: E731
        outs = [gen()]
        captured = dict(ex.step_traces)
        eng.replan(profile=flipped)
        outs.append(gen())
        eng.warmup()
        shared = state_layout(eng._live) == state_layout(eng.scheduler.state)
        reqs = make_trace(cfg.model.vocab_size)[:4]
        for ev in eng.stream(reqs):
            if ev.step >= 4 and len(outs) == 2:
                outs.append(gen())
        if not all(r.is_finished for r in reqs):
            fail(f"one-shot beside the scheduler ({label}): a request did not finish")
        runs[label] = dict(outs=outs, reqs=reqs, captured=captured,
                           traces=dict(ex.step_traces), shared=shared)
        del eng, ex
    g, e = runs["graphs"], runs["eager"]
    tol = cfg.model.n_layers * 2.0 ** -8 * float(np.abs(e["outs"][0].logits).max())
    gaps = [float(np.abs(a.logits - b.logits).max()) for a, b in zip(g["outs"], e["outs"])]
    same_oneshot = all(np.array_equal(a.tokens, b.tokens) for a, b in zip(g["outs"], e["outs"]))
    same_trace = sum(a.generated == b.generated for a, b in zip(g["reqs"], e["reqs"]))
    as_phase5 = np.array_equal(g["outs"][0].tokens, ctx["slot_dp"].tokens)
    log(f"[mixed] one engine, one-shot beside continuous: the two states share a layout "
        f"{g['shared']}; graphs vs eager: one-shot tokens identical {same_oneshot}, max "
        f"|logit gap| per generate {gaps} (bound {tol:.4f}), trace "
        f"{same_trace}/4 requests identical; first generate equal to phase 5's {as_phase5}; "
        f"captures after the first generate {g['captured']}, at the end {g['traces']}")
    if not g["shared"]:
        fail("the one-shot and scheduler states differ in layout: the check would not "
             "exercise one executor serving two states of one shape")
    if not same_oneshot or not max(gaps) < tol or same_trace != 4:
        fail("one-shot beside the scheduler: the graphed engine differs from the eager one")
    if not as_phase5:
        fail("one-shot beside the scheduler: the first generate differs from phase 5's")
    if g["captured"]["decode"] != 1 or g["traces"] != dict(g["captured"], decode=2):
        fail(f"captures {g['traces']}, expected {g['captured']} plus the scheduler's decode graph")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} does not hold the repository's src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # fp32 matmuls in full fp32 (the default, stated): TF32 would loosen the
    # fp32 checks to ~1e-3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    log(f"[card] {card}")
    build_kernels()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    check_decode(gen)
    check_scores(gen)
    check_paged()
    check_paged_mq()
    check_paged_contracts()
    smoke_parity()
    smoke_spec_parity()
    engine, launches, ctx = main_path()
    paged = paged_oneshot(ctx)
    cont, mq_inputs = continuous_runs(ctx)
    prefix = prefix_runs(ctx)
    graphs_vs_eager(ctx)
    # phases 12-13 run before the timings, so their launches are in the table
    policies = policy_runs(ctx)
    cli_run()
    # each phase of the main path counts its own launches (zeroed just
    # before, read just after): one-shot slot, one-shot paged, continuous,
    # chunked prefill and prefix reuse, the policies
    for k in launches:
        launches[k] += paged["launches"][k] + cont[k] + prefix[k] + policies[k]
    log(f"[main] launches over the whole main path: {launches} (of them in the chunked / "
        f"prefix phase: {prefix}; in the policy phase: {policies})")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was never launched on the main path")
    for name in ("snapkv_scores", "paged_fairkv_decode"):
        if prefix[name] == 0:
            fail(f"kernel {name} was never launched in the chunked / prefix phase")
    rows = time_kernels(engine, launches, paged, mq_inputs, prefix)
    attribute_elementwise(engine)
    oneshot_beside_scheduler(ctx)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
