#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on past its own):

1. print the card's name and power limit (nvidia-smi);
2. build both CUDA kernels from `src/repro_torch/csrc` with nvcc (one
   process per source, started together) and print the build seconds and
   the ptxas report;
3. hold each kernel against its plain PyTorch version on the card over a
   shape sweep plus the main path's shapes, fp32 and bf16, ragged lengths,
   an all-zero slot, window and softcap (tolerances stated at each check);
4. check the port's CUDA path against its own CPU path on minitron-8b smoke
   (same weights, fp32): identical tokens and lengths, close logits;
5. the main path at full width: minitron-8b (32 layers, d_model 4096, 32/8
   heads, vocab 256000) in bf16 with random weights from a seed, 8 shards x 2
   slots, Ada-SnapKV (budget 256 -> capacity 576), B=8 prompts of T=2048
   tokens, 32 new tokens: `measure_profile`, then `generate` under sha,
   fairkv_nodp and fairkv_dp.  Launch counters are zeroed just before and
   read just after; asserts the launch counts, plan-invariant retained
   lengths and a bf16 logit bound; prints timings, plan metrics, memory;
   then one torch.profiler pass over decode steps for the kernels' share;
6. time each kernel, its plain version and the PyTorch library call where
   one exists on the main path's own inputs (CUDA events, median of 25
   runs after warmup, L2 flushed before each run) beside the least time the
   card could take, and print them as one JSON line;
7. last line: {"ok": true, "device": {...}}.

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


def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    dt = time.perf_counter() - t0
    log(f"[build] {len(reports)} kernel libraries built in {dt:.1f} s "
        f"(sources: {', '.join(build.KERNELS)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
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


def check_decode(gen):
    import torch
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    from repro_torch.kernels.ref import fairkv_decode_ref
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(4, 8, 8, 64, 256), (2, 16, 1, 128, 200), (3, 5, 4, 32, 96),
              (1, 16, 8, 128, 1600), (2, 4, 2, 16, 64),
              (B, N_SHARDS * SLOTS_PER_SHARD, 4, 128, C_main)]
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        # bf16: both sides compute in fp32 from the same bf16 values and
        # round once to bf16, so they may differ by one bf16 step
        tol_rel = 0.0 if dtype == torch.float32 else BF16_ULP
        for (Bq, S, G, Dh, C) in shapes:
            for window, cap, empty in ((0, 0.0, False), (0, 0.0, True),
                                       (C // 3, 0.0, False), (0, 50.0, True)):
                q, k, v, ln, kp, qp = decode_inputs(gen, Bq, S, G, Dh, C, dtype, empty)
                out = fairkv_decode_cuda(q, k, v, ln, cap, k_pos=kp, q_pos=qp,
                                         window=window)
                ref = fairkv_decode_ref(q, k, v, ln, cap, k_pos=kp, q_pos=qp,
                                        window=window)
                tag = f"fairkv_decode {dtype} {(Bq, S, G, Dh, C)} w={window} cap={cap}"
                worst = max(worst, _cmp(tag, out, ref, FP32_TOL, tol_rel))
                if empty and out[:, 0].abs().max().item() != 0.0:
                    fail(f"{tag}: the all-zero slot's output is not exactly 0")
                n += 1
    log(f"[check] fairkv_decode: {n} cases vs plain, max abs err {worst:.3e} "
        f"(tol {FP32_TOL:g} fp32; + one bf16 step {BF16_ULP:g}|plain| for bf16)")


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
    shapes = [(2, 8, 8, 2, 64, 256), (1, 4, 4, 4, 32, 100), (2, 16, 8, 8, 64, 128),
              (B, OBS, 32, 8, 128, T)]
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


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------


def main_path():
    import numpy as np
    import torch
    from repro_torch.api import CompressionConfig, Engine, EngineConfig, PlannerConfig
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import build
    from repro_torch.training.data import SyntheticLM

    def planner(mode, ch):
        return PlannerConfig(mode=mode, extra_copies=ch,
                             slots_per_shard=SLOTS_PER_SHARD, batch_cap=B)

    cfg = EngineConfig.for_arch(
        ARCH, n_shards=N_SHARDS, dtype="bfloat16", max_seq_len=T + GEN,
        seed=SEED, device="cuda",
        compression=CompressionConfig(policy="ada_snapkv", budget=BUDGET,
                                      alpha_max=ALPHA, obs_window=OBS, pool=POOL,
                                      sink=SINK, decode_margin=MARGIN),
        planner=planner("sha", 0))
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
    log(f"[main] launches over the main path (measure_profile + 3 x generate): {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was never launched on the main path")

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
    return eng, launches


def _device_profile(fn):
    """Run ``fn`` under torch.profiler; returns (wall s, total device us,
    our kernels' device us, top kernels [(name, us)])."""
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
            if "fairkv_decode_kernel" in ev.key or "snapkv_" in ev.key:
                ours += us
    kernels.sort(key=lambda kv: -kv[1])
    return wall, total, ours, kernels[:6]


def profile_decode(eng, step_s, steps=4):
    """One torch.profiler pass over a few decode steps (and one over a
    prefill): the kernels' share of device time, the top device kernels,
    and the device's busy share of the wall time (under the profiler, and
    against ``step_s``, the un-profiled median step)."""
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
    log(f"[profile] {steps} decode steps: device busy {total / 1e3:.2f} ms of "
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
# phase 6: timings on the main path's inputs
# ---------------------------------------------------------------------------


def time_ms(fn, flush, iters=25, warmup=5):
    """Median CUDA-event time of ``fn`` in ms; L2 flushed before each run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def time_kernels(engine, launches):
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
    log(f"[time] fairkv_decode at (B={Bq}, S={S}, G={G}, C={C}, Dh={Dh}) bf16, "
        f"sum(lengths)={n_ret}: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
        f"SDPA {lib:.4f} ms, bound {bound1:.4f} ms ({bytes1} B / 3.35 TB/s)")

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
    it2 = k2.element_size()
    bytes2 = k2.numel() * it2 + q2.numel() * it2 + (opos.numel() + kpos.numel()) * 4 \
        + B * m.n_kv_heads * T * 4
    flops2 = 2 * B * m.n_heads * OBS * T * Dh  # the score contraction
    bound2 = 1e3 * max(bytes2 / HBM_BYTES_PER_S, flops2 / BF16_FLOP_PER_S)
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
        f"989 TFLOP/s; {flops2 / FP32_FLOP_PER_S * 1e3:.4f} ms at the fp32 CUDA-core peak)")
    return rows


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
    smoke_parity()
    engine, launches = main_path()
    rows = time_kernels(engine, launches)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
