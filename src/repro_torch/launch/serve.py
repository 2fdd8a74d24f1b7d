"""Serving entry point: ``python -m repro_torch.launch.serve --arch minitron-8b``
(port of ``repro.launch.serve``).

Default (one-shot) mode: `repro_torch.api.Engine.generate` — prefill +
compression (Ada-SnapKV by default) → FairKV plan → slot-layout decode over
a fixed batch.  Prints the prefill time, the median decode step, the
realized per-head budget spread, the plan's efficiency E and the generated
tokens.

``--continuous`` drives the continuous-batching scheduler through the same
facade (`Engine.run_trace`): a Poisson trace of requests (``--rate``
arrivals per decode step, ``--requests`` in all) flows through admission →
interleaved decode → retirement, with online replanning when the realized
per-shard KV imbalance drifts.  Prints per-request latency, p50/p99, the
pool, prefix and speculation census and the replan log, and exits nonzero
when requests do not finish.  SIGINT / SIGTERM drain gracefully (live rows
decode to completion, queued requests are shed, ``--metrics-out`` /
``--trace-out`` are still written).

``--http`` serves the multi-tenant front end (`repro_torch.frontend`) over
the continuous engine: ``POST /v1/generate`` (JSON), ``POST /v1/stream``
(server-sent events), ``GET /metrics`` and ``GET /healthz`` on ``--host`` /
``--port`` (0 picks a free port; the ``serving on`` line names it), with
``--admission slo`` (tenant-fair deficit round robin, ``--quantum`` /
``--quota-cap`` request tokens, SLO shedding, degradation and preemption)
or ``fcfs``.  The engine is warmed up (its steps captured) before the
listener opens.  SIGINT / SIGTERM close the listener, shed the queued
requests, let the live rows decode to the end, print the drain line and
write ``--metrics-out`` / ``--trace-out``.

Everything runs on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the plain PyTorch path.  ``--config`` reads an
`EngineConfig.to_dict` JSON file (the port's or the reference's, its
``frontend`` section included) as the base configuration; explicitly typed
flags override it.

``--executor mesh`` runs the multi-GPU executor: one process per rank,
started by ``torchrun``, on a (data, model) mesh with the model axis taken
from ``--shards`` and the data axis from ``--data``, so ``WORLD_SIZE`` must
equal ``shards * data``.  The ranks meet through torchrun's environment
(``nccl`` with one card per rank on ``--device cuda``, ``gloo`` on
``--device cpu``); only rank 0 prints and writes the exports, and after
the run it prints the decode step's collectives (the reference's audit
line: one all-reduce over ``model`` per attention layer, no all-gather)::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch minitron-8b --smoke --device cpu --executor mesh --shards 2

``--arch`` takes every arch the reference serves: the dense archs
(minitron-8b, gemma2-9b, granite-3-2b, qwen1.5-110b), the MoE archs
(granite-moe-1b-a400m, qwen3-moe-30b-a3b), mamba2-1.3b (SSM) and
hymba-1.5b (hybrid), one-shot and ``--continuous``, and whisper-small
(encoder-decoder: the one-shot batch carries stub frames) and
llava-next-34b (VLM: stub image embeddings ahead of the prompt), one-shot
only (``--continuous`` is refused with the scheduler's error, as the
reference refuses it).  Not here: ``--paged-impl`` (the port picks the
paged decode implementation by device, on purpose).  Weight-only int8 has
no flag here, as in the reference: apply
`repro_torch.serving.quant.quantize_serve_params` to an engine's serve
tree (``engine.sp``) from Python.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from repro_torch.api import (
    PLANNER_MODES,
    CompressionConfig,
    Engine,
    EngineConfig,
    FrontendConfig,
    ObsConfig,
    PagingConfig,
    PlannerConfig,
    PrefixConfig,
    SchedulerConfig,
    SpeculationConfig,
    latency_percentiles,
    list_cache_backends,
    list_engines,
    list_executors,
    list_policies,
    synthesize_requests,
)
from repro_torch.configs import InputShape, list_archs
from repro_torch.training.data import SyntheticLM

# flags of the reference's CLI the port refuses, with the reason
_REFUSED = {
    "paged_impl": ("the port picks the paged decode implementation by device "
                   "(the CUDA kernel on the card, the plain version on the CPU); "
                   "the knob is not ported, on purpose"),
}


def _engine_config(args, max_seq_len: int, batch_cap: int,
                   scheduler: SchedulerConfig = SchedulerConfig()) -> EngineConfig:
    if args.config:
        return _engine_config_from_file(args, max_seq_len, batch_cap, scheduler)
    return EngineConfig.for_arch(
        args.arch, smoke=args.smoke, n_shards=args.shards,
        dtype="float32" if args.smoke else "bfloat16",
        max_seq_len=max_seq_len, device=args.device,
        compression=CompressionConfig(
            policy=args.policy, budget=args.budget, alpha_max=2.0,
            obs_window=8, sink=2, decode_margin=max(8, args.gen)),
        planner=PlannerConfig(mode=args.planner, engine=args.engine,
                              extra_copies=args.copies, batch_cap=batch_cap),
        scheduler=scheduler,
        # --prefix-cache needs block refcounts, --kv-dtype block storage and
        # --speculate provisional-block rollback: all paged-backend
        # features, so the default slot backend is promoted; any other
        # choice still meets EngineConfig's validation
        cache_backend=("paged" if ((args.prefix_cache or args.kv_dtype != "fp32"
                                    or args.speculate > 0)
                                   and args.cache_backend == "slot")
                       else args.cache_backend),
        paging=PagingConfig(block_size=args.block_size, n_blocks=args.pool_blocks,
                            kv_dtype=args.kv_dtype,
                            pool_hbm_bytes=args.pool_hbm_bytes),
        prefix=PrefixConfig(
            enabled=args.prefix_cache,
            chunk_tokens=args.prefill_chunk or (32 if args.prefix_cache else 0),
            max_entries=args.prefix_entries),
        speculation=SpeculationConfig(
            enabled=args.speculate > 0, max_k=max(1, args.speculate),
            draft_layers=args.draft_layers),
        executor=args.executor,
        obs=ObsConfig(enabled=not args.no_obs, print_every=args.obs_print_every),
        frontend=FrontendConfig(host=args.host, port=args.port, admission=args.admission,
                                quantum_tokens=args.quantum,
                                quota_cap_tokens=args.quota_cap))


# explicit CLI flag -> EngineConfig field path, for --config overrides.
# Only flags that map 1:1 onto config fields appear here; trace-shape flags
# (--gen, --rows, ...) drive the workload, not the config.
_CLI_FIELD_MAP = {
    "shards": ("n_shards",),
    "policy": ("compression", "policy"),
    "budget": ("compression", "budget"),
    "planner": ("planner", "mode"),
    "engine": ("planner", "engine"),
    "copies": ("planner", "extra_copies"),
    "cache_backend": ("cache_backend",),
    "block_size": ("paging", "block_size"),
    "pool_blocks": ("paging", "n_blocks"),
    "kv_dtype": ("paging", "kv_dtype"),
    "pool_hbm_bytes": ("paging", "pool_hbm_bytes"),
    "executor": ("executor",),
    "draft_layers": ("speculation", "draft_layers"),
    "device": ("device",),
    "host": ("frontend", "host"),
    "port": ("frontend", "port"),
    "admission": ("frontend", "admission"),
    "quantum": ("frontend", "quantum_tokens"),
    "quota_cap": ("frontend", "quota_cap_tokens"),
}


def _set_path(cfg: EngineConfig, path, value) -> EngineConfig:
    if len(path) == 1:
        return cfg.replace(**{path[0]: value})
    sub = dataclasses.replace(getattr(cfg, path[0]), **{path[1]: value})
    return cfg.replace(**{path[0]: sub})


def _engine_config_from_file(args, max_seq_len: int, batch_cap: int,
                             scheduler: SchedulerConfig) -> EngineConfig:
    """``--config cfg.json``: the file is the base `EngineConfig`
    (`EngineConfig.from_dict`, strict about unknown keys); flags the user
    typed override it, flag defaults do not.  ``--device`` applies always
    (a file written elsewhere must not move the run off the card it was
    asked on), and the workload-derived fields (``max_seq_len``,
    ``planner.batch_cap``, scheduler rows) are raised to what the requested
    trace needs."""
    with open(args.config) as f:
        cfg = EngineConfig.from_dict(json.load(f))
    for dest, path in _CLI_FIELD_MAP.items():
        if dest in args._explicit or dest == "device":
            cfg = _set_path(cfg, path, getattr(args, dest))
    if "speculate" in args._explicit:
        cfg = cfg.replace(speculation=dataclasses.replace(
            cfg.speculation, enabled=args.speculate > 0,
            max_k=max(1, args.speculate)))
    if cfg.speculation.enabled and cfg.cache_backend == "slot":
        cfg = cfg.replace(cache_backend="paged")
    if "no_obs" in args._explicit or "obs_print_every" in args._explicit:
        cfg = cfg.replace(obs=ObsConfig(enabled=not args.no_obs,
                                        print_every=args.obs_print_every))
    # workload-derived floors (never shrink what the file asked for)
    cfg = cfg.replace(max_seq_len=max(cfg.max_seq_len, max_seq_len))
    if cfg.planner.batch_cap is None or cfg.planner.batch_cap < batch_cap:
        cfg = cfg.replace(planner=dataclasses.replace(cfg.planner, batch_cap=batch_cap))
    if scheduler.max_rows > cfg.scheduler.max_rows:
        cfg = cfg.replace(scheduler=dataclasses.replace(
            cfg.scheduler, max_rows=scheduler.max_rows))
    return cfg


def _mesh(args):
    """The (data, model) mesh of ``--executor mesh`` (model = ``--shards``),
    over the process group torchrun's environment describes; None for the
    local executor."""
    if args.executor != "mesh":
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    if not dist.is_initialized():
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl",
                                init_method="env://")
    return make_host_mesh(model=args.shards, data=args.data,
                          device="cpu" if args.device == "cpu" else None)


def _build_engine(args, ecfg: EngineConfig) -> Engine:
    """The engine on the configured executor (mesh: this rank's)."""
    return Engine.build(ecfg, mesh=_mesh(args))


def _collective_audit(eng: Engine) -> None:
    """Print the decode step's collectives per rank (mesh only): one idle
    decode step (no row appends) under the collective counter.  The
    contract made visible: one all-reduce over ``model`` per attention
    layer and no all-gather; weight gathers belong to prefill."""
    if eng.cfg.executor != "mesh":
        return
    import torch

    sched = eng.scheduler if eng._mode == "continuous" else None
    sp, pa = (sched.sp, sched.pa) if sched is not None else (eng.sp, eng.pa)
    state = sched.state if sched is not None else eng.state
    idle = torch.zeros(state.last_tokens.shape, dtype=torch.bool, device=eng.device)
    with torch.inference_mode():
        _, stats = eng.executor.decode_collectives(sp, state, pa, active=idle)
    parts = [f"{group} {kind} x{v['calls']} ({v['bytes'] / 1e3:.1f} kB)"
             for group in ("model", "data") for kind, v in sorted(stats.get(group, {}).items())]
    n_ar = stats.get("model", {}).get("all_reduce", {}).get("calls", 0)
    n_ag = stats.get("model", {}).get("all_gather", {}).get("calls", 0)
    print(f"decode step collectives/rank: {', '.join(parts) or 'none'} | "
          f"{n_ar} all-reduce over model for {eng.cfg.model.n_layers} layers, "
          f"{n_ag} all-gather over model")


def _export_obs(eng: Engine, args) -> None:
    """Write the Prometheus / Chrome-trace exports when paths were given.  On
    a mesh only rank 0 writes: each rank's registry is its own."""
    if eng.mesh is not None and eng.mesh.rank != 0:
        return
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(eng.metrics_prometheus())
        print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write(eng.trace_export())
        print(f"trace -> {args.trace_out} (load in Perfetto / chrome://tracing)")


def _scheduler_config(args) -> SchedulerConfig:
    return SchedulerConfig(
        max_rows=args.rows,
        max_live_tokens=args.max_live_tokens or None,
        replan_window=args.replan_window,
        replan_threshold=args.replan_threshold,
        replan_cooldown=args.replan_cooldown,
        enable_replan=not args.no_replan,
    )


def _install_drain_handlers(eng: Engine):
    """SIGINT/SIGTERM → `Engine.drain` (stop admitting, finish the live
    decodes; queued and unsubmitted requests are shed).  Returns a restore
    callback.  A second signal falls through to the previous handler, so
    Ctrl-C twice still kills a stuck drain."""
    import signal

    prev = {}

    def _drain(signum, frame):
        print(f"\nsignal {signum}: draining (live rows decode to "
              f"completion; queued requests are shed) ...", flush=True)
        eng.drain()
        # restore at once: the next signal interrupts for real
        for sig, h in prev.items():
            signal.signal(sig, h)

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            prev[sig] = signal.signal(sig, _drain)
        except ValueError:  # not the main thread (embedded use)
            pass

    def restore() -> None:
        for sig, h in prev.items():
            try:
                signal.signal(sig, h)
            except ValueError:
                pass

    return restore


def run_continuous(args) -> None:
    """Poisson-trace continuous batching via the facade."""
    min_prompt = args.min_prompt
    tkw = {}
    if args.prefix_templates > 0:
        # shared templates need room for a unique suffix on every prompt
        min_prompt = max(min_prompt, args.prefix_len + 4)
        tkw = dict(prefix_templates=args.prefix_templates,
                   prefix_len=args.prefix_len, shared_fraction=args.shared_fraction)
    max_prompt = max(min_prompt, args.max_prompt)
    scfg = _scheduler_config(args)
    ecfg = _engine_config(args, max_prompt + args.gen + 8, args.rows, scfg)
    eng = _build_engine(args, ecfg)
    reqs = synthesize_requests(args.requests, args.rate, ecfg.model.vocab_size,
                               min_prompt=min_prompt, max_prompt=max_prompt,
                               max_new_tokens=args.gen, seed=args.seed, **tkw)
    print(f"continuous: {len(reqs)} requests, rate {args.rate}/step, "
          f"{args.rows} rows, planner {ecfg.planner.mode}, policy "
          f"{ecfg.compression.policy}, device {ecfg.device}")
    restore = _install_drain_handlers(eng)
    try:
        out = eng.run_trace(reqs, max_steps=args.max_steps)
    finally:
        restore()
        # a drained (signalled) run still writes its exports
        _export_obs(eng, args)
    _collective_audit(eng)
    for r in eng.finished_requests:
        if r.admit_step is None:  # shed by a drain before admission
            continue
        print(f"req {r.req_id}: prompt {r.prompt_len:3d} | arrive "
              f"{r.arrival_step:3d} admit {r.admit_step:3d} finish "
              f"{r.finish_step:3d} | queued {r.queueing_steps():2d} steps | "
              f"{r.n_generated} tokens")
    pct = latency_percentiles([r for r in eng.finished_requests if not r.cancelled])

    def fmt(key: str, scale: float = 1.0, unit: str = "") -> str:
        # an absent key: no request recorded the observable
        v = pct.get(key)
        return "n/a" if v is None else f"{v * scale:.0f}{unit}"

    print(f"steps {out['steps']} | {out['generated_tokens']} tokens in "
          f"{out['wall_s']:.1f}s = {out['tokens_per_s']:.1f} tok/s | "
          f"latency p50 {fmt('p50_steps')} / p99 {fmt('p99_steps')} steps")
    print(f"ttft p50 {fmt('p50_ttft_s', 1e3, ' ms')} / p99 "
          f"{fmt('p99_ttft_s', 1e3, ' ms')} | itl p50 "
          f"{fmt('p50_itl_s', 1e3, ' ms')} / p99 {fmt('p99_itl_s', 1e3, ' ms')}")
    print(f"mid-stream admissions: {out['mid_stream_admissions']} | "
          f"replans: {out['replans']} | preemptions: {out['preemptions']}")
    st = eng.stats()
    if st.pool.backend == "paged":
        print(f"paged cache: {st.pool.blocks_in_use}/{st.pool.blocks_total} "
              f"blocks ({st.pool.cache_bytes} B) vs slot-equivalent "
              f"{st.pool.slot_equivalent_bytes} B")
    if st.prefix.enabled:
        print(f"prefix cache: {st.prefix.hits} hits / {st.prefix.misses} "
              f"misses | {st.prefix.entries} entries holding "
              f"{st.prefix.blocks_held} blocks | {st.prefix.evictions} evictions")
    if st.speculation.enabled:
        acc = ("n/a" if st.speculation.acceptance is None
               else f"{st.speculation.acceptance:.2f}")
        print(f"speculation: {st.speculation.accepted}/{st.speculation.proposed} "
              f"draft tokens accepted (acceptance {acc}, max_k "
              f"{st.speculation.max_k}, draft layers "
              f"{st.speculation.draft_layers or 'all'})")
    for ev in st.scheduler.replan_log:
        tag = "accepted" if ev["accepted"] else "rejected"
        print(f"  replan @ step {ev['step']} ({tag}): imbalance "
              f"{ev['imbalance_before']:.3f} -> {ev['imbalance_after']:.3f}")
    if out.get("drained"):
        # graceful shutdown: cancelled requests are expected, not a failure
        print(f"drained: {out['cancelled']} request(s) shed, "
              f"{out['finished'] - out['cancelled']} decoded to completion")
        return
    if out["finished"] != out["total"]:
        raise RuntimeError(f"only {out['finished']}/{out['total']} requests finished")
    if args.smoke and out["mid_stream_admissions"] < 1:
        raise RuntimeError("smoke trace produced no mid-stream admission — "
                           "raise --requests or lower --rows")


def _frontend_config(args, ecfg: EngineConfig) -> FrontendConfig:
    """The front end ``run_http`` serves with: ``ecfg.frontend`` (the flags,
    or the ``--config`` file under the typed flags), with every request
    bounded by the trace-shape flags: prompts by ``--max-prompt`` (the
    engine's ``max_seq_len`` is sized from it) and generation by ``--gen``."""
    return dataclasses.replace(ecfg.frontend,
                               max_prompt_tokens=max(args.min_prompt, args.max_prompt),
                               max_new_tokens_cap=args.gen)


def run_http(args) -> None:
    """``--http``: the multi-tenant asyncio front end over the continuous
    engine.  `FrontendServer.start` warms the engine up before it listens,
    so serving replays the captured steps.  SIGINT / SIGTERM drain: the
    listener closes, queued requests are shed (503 ``draining``), live rows
    decode to the end, and ``--metrics-out`` / ``--trace-out`` are written."""
    import asyncio
    import signal

    from repro_torch.frontend import FrontendServer

    max_prompt = max(args.min_prompt, args.max_prompt)
    ecfg = _engine_config(args, max_prompt + args.gen + 8, args.rows,
                          _scheduler_config(args))
    fcfg = _frontend_config(args, ecfg)
    eng = _build_engine(args, ecfg.replace(frontend=fcfg))

    async def _main() -> None:
        server = FrontendServer(eng, fcfg)
        await server.start()
        print(f"serving on http://{server.host}:{server.port} "
              f"(admission={fcfg.admission}, rows={args.rows}, "
              f"backend={ecfg.cache_backend}, executor={ecfg.executor}, "
              f"device {ecfg.device})", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        print("signal received: draining (live rows decode to completion, "
              "queued requests shed) ...", flush=True)
        await server.shutdown(drain=True)
        summary = server.engine_loop.fe.summary()
        print(f"drained after {summary['steps']} steps | "
              f"{summary['finished']} terminal requests | goodput "
              f"{summary['goodput_tokens']:.0f} tokens", flush=True)
        if server.engine_loop.error is not None:
            raise RuntimeError("the engine loop failed") from server.engine_loop.error

    try:
        asyncio.run(_main())
    finally:
        _export_obs(eng, args)


def run_oneshot(args) -> None:
    """Fixed-batch serve: one prefill + ``--gen`` decode steps."""
    ecfg = _engine_config(args, args.prompt_len + args.gen + 8, args.batch)
    eng = _build_engine(args, ecfg)
    data = SyntheticLM(ecfg.model, InputShape("cli", args.prompt_len, args.batch,
                                              "prefill"))
    res = eng.generate(data.get_batch(0), args.gen, collect_logits=False)
    if res.lengths.size:  # an attention-free model retains nothing
        lens = np.asarray(res.lengths, np.float64)
        print(f"prefill {res.prefill_s * 1e3:7.1f} ms | realized per-head budget "
              f"min/mean/max = {lens.min():.0f}/{lens.mean():.0f}/{lens.max():.0f} | "
              f"plan E = {res.efficiency:.3f} ({ecfg.planner.mode}, "
              f"{ecfg.compression.policy}, device {ecfg.device})")
    else:
        print(f"prefill {res.prefill_s * 1e3:7.1f} ms | no KV cache (attention-free), "
              f"device {ecfg.device}")
    if res.step_s:
        print(f"decode  {np.median(res.step_s) * 1e3:7.1f} ms/step (median of "
              f"{len(res.step_s)}; first {res.step_s[0] * 1e3:.0f} ms incl. "
              f"the step's capture)")
    pool = eng.stats().pool
    if pool.backend == "paged":
        print(f"paged cache: {pool.cache_bytes} B in {pool.blocks_in_use} "
              f"blocks vs slot-equivalent {pool.slot_equivalent_bytes} B")
    _export_obs(eng, args)
    _collective_audit(eng)
    for b in range(min(args.batch, 2)):
        print(f"row {b}: {res.tokens[b].tolist()}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="",
                    help=f"architecture id; the port runs {list_archs()} "
                         f"(required unless --config provides the model)")
    ap.add_argument("--config", default="",
                    help="JSON EngineConfig file (EngineConfig.to_dict format, "
                         "the port's or the reference's) used as the base "
                         "config; explicitly typed flags override it")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced test variant, in fp32")
    ap.add_argument("--device", default="cuda",
                    help="where weights, cache and steps live (cuda, cuda:N, "
                         "or cpu for the plain PyTorch path)")
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--budget", type=int, default=32)
    ap.add_argument("--policy", default="ada_snapkv",
                    help=f"compression policy; registered: {list_policies()}")
    ap.add_argument("--planner", default="fairkv_dp", choices=list(PLANNER_MODES))
    ap.add_argument("--engine", default="auto",
                    help=f"assignment engine; registered: {list_engines()}")
    ap.add_argument("--shards", type=int, default=4,
                    help="logical model shards for the plan")
    ap.add_argument("--copies", type=int, default=4, help="CH")
    # --- cache backend -------------------------------------------------------
    ap.add_argument("--cache-backend", default="slot",
                    help=f"cache storage backend; registered: {list_cache_backends()}")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged backend: tokens per KV block")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="paged backend: blocks per layer pool "
                         "(0 = slot-equivalent worst case)")
    ap.add_argument("--kv-dtype", default="fp32", choices=["fp32", "int8", "fp8"],
                    help="paged backend: KV block storage format (quantized "
                         "pools carry per-block scales and dequantize in the "
                         "decode kernel)")
    ap.add_argument("--pool-hbm-bytes", type=int, default=0,
                    help="paged backend: size the per-layer pool from a byte "
                         "budget instead of --pool-blocks")
    # --- speculative decoding ------------------------------------------------
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding: propose up to K draft tokens "
                         "per tick and verify them in one multi-query pass "
                         "(0 = off; implies --cache-backend paged)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="depth of the self-speculative draft (first N layers "
                         "+ the target's unembedding; 0 = all layers)")
    # --- shared-prefix reuse + chunked prefill -------------------------------
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="split prompt prefill into chunks of this many tokens, "
                         "interleaved with decode ticks (0 = monolithic)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed shared-prefix block reuse (paged "
                         "backend; implies --prefill-chunk 32 when unset)")
    ap.add_argument("--prefix-entries", type=int, default=256,
                    help="prefix index capacity (LRU-evicted entries)")
    ap.add_argument("--prefix-templates", type=int, default=0,
                    help="continuous trace: number of shared prompt templates")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="continuous trace: tokens per shared template")
    ap.add_argument("--shared-fraction", type=float, default=0.8,
                    help="continuous trace: fraction of requests that start "
                         "with a template prefix")
    # --- executor --------------------------------------------------------------
    ap.add_argument("--executor", default="local",
                    help=f"device execution strategy; registered: "
                         f"{list_executors()} ('mesh': one process per rank "
                         f"under torchrun, model axis = --shards)")
    ap.add_argument("--data", type=int, default=1,
                    help="--executor mesh: data-axis size (batch rows split over "
                         "it); WORLD_SIZE must be shards * data")
    # --- continuous batching -------------------------------------------------
    ap.add_argument("--continuous", action="store_true",
                    help="run the continuous-batching scheduler on a Poisson "
                         "request trace")
    ap.add_argument("--rows", type=int, default=2,
                    help="batch rows (concurrent requests)")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson arrival rate, requests per decode step")
    ap.add_argument("--min-prompt", type=int, default=12)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--max-live-tokens", type=int, default=0,
                    help="admission token budget (0 = rows-only admission)")
    ap.add_argument("--replan-window", type=int, default=8)
    ap.add_argument("--replan-threshold", type=float, default=1.25)
    ap.add_argument("--replan-cooldown", type=int, default=16)
    ap.add_argument("--no-replan", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    # --- observability -------------------------------------------------------
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the metrics/trace subsystem entirely")
    ap.add_argument("--obs-print-every", type=int, default=0,
                    help="scheduler steps between one-line stats prints (0 = off)")
    ap.add_argument("--metrics-out", default="",
                    help="write Prometheus text metrics here on exit")
    ap.add_argument("--trace-out", default="",
                    help="write Chrome trace-event JSON here on exit")
    # --- the multi-tenant HTTP front end --------------------------------------
    ap.add_argument("--http", action="store_true",
                    help="serve the multi-tenant asyncio HTTP front end (POST "
                         "/v1/generate, POST /v1/stream [SSE], GET /metrics, GET "
                         "/healthz) over the continuous engine; SIGINT/SIGTERM "
                         "drain gracefully")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="listen port (0 = a free port, printed on start)")
    ap.add_argument("--admission", default="slo", choices=["slo", "fcfs"],
                    help="admission controller: 'slo' (priority classes, "
                         "degrade/shed, tenant-fair DRR) or 'fcfs' (baseline "
                         "global queue)")
    ap.add_argument("--quantum", type=int, default=512,
                    help="DRR per-tenant token refill per engine tick")
    ap.add_argument("--quota-cap", type=int, default=8192,
                    help="DRR banked-deficit cap per tenant (tokens)")
    # --- the reference's flags the port refuses (see _REFUSED) ---------------
    refused = ap.add_argument_group("not ported (refused with the ROADMAP item)")
    refused.add_argument("--paged-impl", default=None, help=argparse.SUPPRESS)
    return ap


def parse_args(argv: Sequence[str]):
    """(parser, args): ``args._explicit`` holds the flags the user typed (vs
    argparse defaults), which --config merging applies; "--flag value" and
    "--flag=value" both count."""
    ap = build_parser()
    argv = list(argv)
    args = ap.parse_args(argv)
    args._explicit = {
        a.dest for a in ap._actions
        if any(tok == opt or tok.startswith(opt + "=")
               for opt in a.option_strings for tok in argv)}
    return ap, args


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap, args = parse_args(sys.argv[1:] if argv is None else argv)
    for dest, why in _REFUSED.items():
        if dest in args._explicit:
            ap.error(f"--{dest.replace('_', '-')} is not supported: {why}")
    if args.executor != "mesh" and "data" in args._explicit:
        ap.error("--data sizes the mesh's data axis: it needs --executor mesh")
    if args.executor == "mesh":
        world = os.environ.get("WORLD_SIZE")
        if world is None:
            ap.error(f"--executor mesh needs a process group of shards * data = "
                     f"{args.shards * args.data} ranks: launch with torchrun "
                     f"--nproc-per-node {args.shards * args.data} -m "
                     f"repro_torch.launch.serve ...")
        if args.http:
            ap.error("--http serves from one process; a mesh needs every rank to see "
                     "the same requests, which the front end does not do: drop --http "
                     "or --executor mesh")
        if int(world) != args.shards * args.data:
            ap.error(f"WORLD_SIZE={world} but the mesh needs shards * data = "
                     f"{args.shards * args.data} ranks")
        if int(os.environ.get("RANK", "0")) != 0:
            sys.stdout = open(os.devnull, "w")  # rank 0 prints and exports
    if not args.arch and not args.config:
        ap.error("one of --arch or --config is required")
    if args.arch and args.arch not in list_archs():
        ap.error(f"--arch {args.arch!r} is not a registered arch: {list_archs()}")
    if args.http:
        run_http(args)
    elif args.continuous:
        run_continuous(args)
    else:
        run_oneshot(args)


if __name__ == "__main__":
    main()
