"""The port's production dry run (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`).

The reference side runs in subprocesses with 512 (or 8) XLA host devices
(`tests/_torch_dryrun_ref.py`), started together by one module fixture and
read by the tests that need them; nothing there is compiled but the
executor audit's small step.  The port side runs here on fake tensors
under a fake process group.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.cache.slot_cache import PlanArrays
from repro_torch.compression.base import CompressionConfig
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.distributed import step_stats
from repro_torch.distributed.param_specs import shard_shape, tree_specs
from repro_torch.distributed.sharding import serve_rules, train_rules
from repro_torch.exec.local import LocalExecutor
from repro_torch.kernels import build, ops, ref
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.models.transformer import init_params
from repro_torch.serving import engine as E
from repro_torch.serving.quant import QTensor

REF = Path(__file__).with_name("_torch_dryrun_ref.py")
SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"2x4": {"data": 2, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
PROD = {"16x16": False, "2x16x16": True}


def _start(job: str, devices: int) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    return subprocess.Popen([sys.executable, str(REF), job], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def reference():
    """The reference's records, each read when a test first asks for it
    (the three subprocesses run side by side)."""
    procs = {"specs": _start("specs", 512), "bytes": _start("bytes", 512),
             "audit": _start("audit", 8)}
    done = {}

    def get(job):
        if job not in done:
            out, err = procs[job].communicate(timeout=600)
            assert procs[job].returncode == 0, err[-3000:]
            done[job] = json.loads(out.strip().splitlines()[-1])
        return done[job]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _flat(spec_tree, prefix="") -> dict:
    """{path: spec entries} of a port spec tree (tuples are leaf specs)."""
    if isinstance(spec_tree, QTensor):
        return {**_flat(spec_tree.q, prefix + "q"), **_flat(spec_tree.scale, prefix + "scale")}
    if isinstance(spec_tree, dict):
        return {k: v for key, sub in spec_tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(spec_tree, list):
        return {k: v for i, sub in enumerate(spec_tree)
                for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): [list(e) if isinstance(e, tuple) else e for e in spec_tree]}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_tree_specs_match_reference(reference, arch):
    """`tree_specs` equals the reference's `tree_pspecs` leaf by leaf, for
    the arch's full config in train and serve modes (serve with and
    without long_context and weights_2d, int8 by the auto rule) on (2, 4),
    (16, 16) and (2, 16, 16)."""
    want = reference("specs")["specs"]
    cfg = get_config(arch)
    decode = SHAPES["decode_32k"]
    with step_stats.fake_tensors():
        params = specs.params_fake(cfg, SHAPES["train_4k"])
        serve = {}
        for name, axes in MESHES.items():
            n_model = axes["model"]
            assert _flat(tree_specs(params, train_rules(axes), "train")) == \
                want[f"{arch}|{name}|train"]
            if n_model not in serve:
                plan = specs.cell_plan(cfg, n_model, batch_cap=decode.global_batch)
                serve[n_model] = specs.serve_params_fake(
                    cfg, decode, plan, quantize=specs.quantize_auto(cfg, n_model))
            for lc in (False, True):
                for w2 in (False, True):
                    got = tree_specs(serve[n_model], serve_rules(axes, lc, w2), "serve")
                    assert _flat(got) == want[f"{arch}|{name}|serve|{int(lc)}|{int(w2)}"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_plan_matches_reference(reference, arch):
    """`cell_plan` gives the reference's plan bitwise, per planner."""
    want = reference("specs")["plans"]
    cfg = get_config(arch)
    for mode in ("sha", "fairkv_nodp", "fairkv_dp"):
        for n_model in (4, 16):
            plan = specs.cell_plan(cfg, n_model, mode,
                                   batch_cap=SHAPES["decode_32k"].global_batch)
            w = want[f"{arch}|{mode}|{n_model}"]
            if plan is None:
                assert w is None
                continue
            for k, v in plan.as_arrays().items():
                assert np.array_equal(v, np.asarray(w[k], np.int32)), (mode, n_model, k)


def test_shard_shape():
    axes = MESHES["2x16x16"]
    assert shard_shape((64, 48, 5), (("pod", "data"), "model", None), axes) == (2, 3, 5)
    assert shard_shape((7,), (None,), axes) == (7,)
    with pytest.raises(ValueError):
        shard_shape((8,), ("model",), axes)


def test_fake_process_group_refuses_a_second_and_cleans_up():
    with fake_process_group(8):
        assert dist.get_world_size() == 8 and dist.get_backend() == "fake"
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_process_group(4):
                pass
        assert dist.get_world_size() == 8  # the refused call left the group alone
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        with fake_process_group(2):
            raise RuntimeError("boom")
    assert not dist.is_initialized()


def test_fake_backend_only_through_the_production_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    with fake_process_group(8):
        with pytest.raises(ValueError, match="fake"):
            make_host_mesh(model=4, data=2)
        mesh = make_production_mesh(model=4, data=2)
        assert (mesh.model, mesh.data, mesh.axes) == (4, 2, {"data": 2, "model": 4})
    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert mesh.axes == {"pod": 2, "data": 16, "model": 16} and mesh.data == 32
        assert mesh.device == torch.device("cpu")


def test_fake_cuda_entry_points_with_a_device_guard():
    """Indexing, ``copy_``, ``contiguous``, ``~``, ``.to`` and ``as_tensor``
    on fake CUDA tensors give fake CUDA tensors of the right shape, views
    where the real ones are views (on a CPU-only torch their device guard
    would need the CUDA runtime)."""
    with step_stats.fake_tensors():
        x = torch.empty((4, 6), device="cuda")
        m = torch.ones((4, 6), dtype=torch.bool, device="cuda")
        idx = torch.as_tensor(np.array([0, 2]), device="cuda")
        outs = {"slice": x[1:3], "select": x[1], "index": x[idx], "not": ~m,
                "contiguous": x.t().contiguous(), "to": x.to(torch.bfloat16),
                "to_cuda": x.to("cuda"), "from_cpu": torch.zeros(3).to("cuda")}
        x[idx] = 1.0
        assert x.copy_(x) is x and x.contiguous() is x
        assert {k: tuple(v.shape) for k, v in outs.items()} == {
            "slice": (2, 6), "select": (6,), "index": (2, 6), "not": (4, 6),
            "contiguous": (6, 4), "to": (4, 6), "to_cuda": (4, 6), "from_cpu": (3,)}
        assert all(v.device.type == "cuda" for v in outs.values())
        assert outs["slice"].untyped_storage()._cdata == x.untyped_storage()._cdata
        assert outs["to_cuda"] is x and outs["to"].dtype == torch.bfloat16


def _decode_step(fake: bool, kind: str):
    """One smoke-config step of the local executor on the CPU, measured."""
    cfg = get_smoke_config("minitron-8b")
    ccfg = CompressionConfig(policy="ada_snapkv", budget=16, alpha_max=2.0, obs_window=8,
                             sink=2, decode_margin=8)
    plan = specs.cell_plan(cfg, 2, batch_cap=4)
    with step_stats.fake_tensors() if fake else contextlib.nullcontext():
        params = init_params(cfg, 0, torch.float32, device="cpu")
        sp = E.slotify_params(params, plan, cfg)
        del params
        pa = PlanArrays.from_plan(plan)
        ex = LocalExecutor(cfg, ccfg, device="cpu", graphs=False)
        with torch.inference_mode():
            if kind == "decode":
                state = E.init_serve_state(cfg, pa, 4, ccfg)
                return step_stats.measure(ex._decode, (sp, state, pa), sp, state, pa, None,
                                          None)[1]
            batch = {"tokens": torch.zeros((4, 24), dtype=torch.int64)}
            return step_stats.measure(ex._prefill, (sp, pa, batch), sp, batch, pa, None,
                                      None)[1]


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_memory_tracker_fake_equals_real(kind):
    """The tracker's bytes, FLOPs and traffic over a smoke step are the same
    on fake CPU tensors as on real ones."""
    real, fake = _decode_step(False, kind), _decode_step(True, kind)
    assert fake == real
    assert real.peak_bytes == real.argument_bytes + real.output_bytes + real.temp_bytes
    assert real.temp_bytes > 0 and real.flops > 0


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_kernel_flop_formulas_match_plain_versions():
    """Each kernel's FLOP formula (the custom op on fake CUDA tensors) equals
    FlopCounterMode's count of its plain version's products."""
    g = torch.Generator().manual_seed(0)
    B, S, G, Dh, C, W, T, Hkv, N, bs, Q = 2, 3, 4, 32, 40, 8, 50, 2, 24, 8, 3

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    q, k, v = r(B, S, G, Dh), r(S, B, C, Dh), r(S, B, C, Dh)
    ln = torch.full((S, B), 7, dtype=torch.int32)
    qo, kk = r(B, W, Hkv * G, Dh), r(B, T, Hkv, Dh)
    opos = torch.arange(T - W, T, dtype=torch.int32).expand(B, W).contiguous()
    kpos = torch.arange(T, dtype=torch.int32).expand(B, T).contiguous()
    kp, vp = r(N, bs, Dh), r(N, bs, Dh)
    pp = torch.arange(N * bs, dtype=torch.int32).reshape(N, bs)
    tbl = torch.arange(1, S * B * 5 + 1, dtype=torch.int32).reshape(S, B, 5) % N
    qm = r(B, S, Q, G, Dh)
    plain = [lambda: ref.fairkv_decode_ref(q, k, v, ln),
             lambda: ref.snapkv_scores_ref(qo, kk, opos, kpos),
             lambda: ref.paged_fairkv_decode_ref(q, kp, vp, pp, tbl, ln, C),
             lambda: ref.paged_fairkv_decode_ref(qm, kp, vp, pp, tbl, ln, C)]
    want = [_flops(f) for f in plain]
    with step_stats.fake_tensors():
        cu = [torch.empty(t.shape, dtype=t.dtype, device="cuda")
              for t in (q, k, v, ln, qo, kk, opos, kpos, kp, vp, pp, tbl, qm)]
        q_, k_, v_, ln_, qo_, kk_, op_, kp_, kpl, vpl, pp_, tb_, qm_ = cu
        got = [_flops(lambda: ops.fairkv_decode(q_, k_, v_, ln_)),
               _flops(lambda: ops.snapkv_scores(qo_, kk_, op_, kp_)),
               _flops(lambda: ops.paged_fairkv_decode(q_, kpl, vpl, pp_, tb_, ln_, C)),
               _flops(lambda: ops.paged_fairkv_decode(qm_, kpl, vpl, pp_, tb_, ln_, C))]
    assert got == want and min(want) > 0


def test_kernel_fake_implementations_count_their_scratch():
    """On fake CUDA tensors a kernel's output comes from its fake
    implementation, whose scratch the memory tracker counts as a temp."""
    with step_stats.fake_tensors():
        q = torch.empty((8, 16, 4, 128), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((16, 8, 576, 128), dtype=torch.bfloat16, device="cuda")
        ln = torch.empty((16, 8), dtype=torch.int32, device="cuda")
        out, st = step_stats.measure(ops.fairkv_decode, (q, k, ln), q, k, k, ln)
    from repro_torch.kernels.fairkv_decode import scratch_floats
    assert out.shape == q.shape and out.device.type == "cuda"
    assert st.temp_bytes == scratch_floats(8, 16, 4, 128, 576) * 4 + 16 * 8 * 4
    assert st.flops == 4 * 8 * 16 * 4 * 576 * 128


@pytest.mark.parametrize("C", [576, 4096, 4097, 131_136])
def test_kernel_scratch_spans_segments(C):
    """Below, at and past the decode kernels' segment (4096 columns), each
    fake implementation allocates the scratch and the arrival counters its
    formulas give: the states of every segment, ceil(C / 4096) times one
    segment's, and past one segment a counter per segment beside the
    pair's."""
    from repro_torch.kernels import fairkv_decode as K1
    from repro_torch.kernels import paged_fairkv_decode as KP
    B, S, G, Dh, bs, Q = 1, 8, 2, 256, 16, 5
    seen = []
    build.ALLOC_LISTENERS.append(seen.append)
    try:
        with step_stats.fake_tensors():
            q = torch.empty((B, S, G, Dh), dtype=torch.bfloat16, device="cuda")
            k = torch.empty((S, B, C, Dh), dtype=torch.bfloat16, device="cuda")
            ln = torch.empty((S, B), dtype=torch.int32, device="cuda")
            M = -(-C // bs)
            pool = torch.empty((S * B * M + 1, bs, Dh), dtype=torch.bfloat16, device="cuda")
            pos = torch.empty((S * B * M + 1, bs), dtype=torch.int32, device="cuda")
            tbl = torch.empty((S, B, M), dtype=torch.int32, device="cuda")
            qm = torch.empty((B, S, Q, G, Dh), dtype=torch.bfloat16, device="cuda")
            got = []
            for fn in (lambda: ops.fairkv_decode(q, k, k, ln),
                       lambda: ops.fairkv_decode_partial(q, k, k, ln),
                       lambda: ops.paged_fairkv_decode(q, pool, pool, pos, tbl, ln, C),
                       lambda: ops.paged_fairkv_decode(qm, pool, pool, pos, tbl, ln, C)):
                seen.clear()
                fn()
                got.append([(t.numel(), t.dtype) for t in seen if t.dim() == 1])
    finally:
        build.ALLOC_LISTENERS.remove(seen.append)
    want = [(K1.scratch_floats(B, S, G, Dh, C), K1.counters(B, S, C))] * 2 + [
        (KP.scratch_floats(B, S, 1, G, Dh, C), KP.counters(B, S, 1, C)),
        (KP.scratch_floats(B, S, Q, G, Dh, C), KP.counters(B, S, Q, C))]
    assert got == [[(f, torch.float32), (c, torch.int32)] for f, c in want]
    n = K1.segments(C)
    assert n == (1 if C <= 4096 else -(-C // 4096))
    assert want[0][0] == n * K1.scratch_floats(B, S, G, Dh, 1)
    assert want[3][0] == n * KP.scratch_floats(B, S, Q, G, Dh, 1)
    assert want[0][1] == S * B * (1 if n == 1 else 1 + n)
    assert want[3][1] == S * B * KP.n_chunks(Q) * (1 if n == 1 else 1 + n)


def test_long_cell_partial_scratch_spans_segments(monkeypatch):
    """gemma2-9b's long_500k cell on the fake (data 16, model 16) mesh: each
    rank's 32,772 cache columns are 9 of the partial kernel's segments, so
    every layer's fake implementation allocates 9 segments' states; the
    record's temporaries cover them (a step's other temporaries are larger,
    so the peak is the one-segment kernel's) and the cell fits."""
    from repro_torch.kernels import fairkv_decode as K1
    calls = []
    real = K1.scratch_floats
    monkeypatch.setattr(K1, "scratch_floats", lambda *a: calls.append(a) or real(*a))
    rec = dryrun.run_cell("gemma2-9b", "long_500k", False, dev_bytes=dryrun.H100_BYTES)
    cfg = get_config("gemma2-9b")
    assert rec["status"] == "ok" and rec["fits"] is True
    C_loc = -(-(SHAPES["long_500k"].seq_len + CompressionConfig().decode_margin) // 16)
    assert C_loc == 32_772 and K1.segments(C_loc) == 9
    assert len(calls) == cfg.n_layers
    assert {c[2:] for c in calls} == {(cfg.q_per_kv, cfg.head_dim, C_loc)}
    B, S = calls[0][:2]
    scratch = 4 * real(B, S, cfg.q_per_kv, cfg.head_dim, C_loc)
    assert scratch == 9 * 4 * real(B, S, cfg.q_per_kv, cfg.head_dim, 1)
    assert rec["executed"]["memory"]["temp_bytes"] >= scratch + 4 * K1.counters(B, S, C_loc)


def test_executor_audit_matches_reference(reference):
    """The mesh executor's decode step on a fake (data 2, model 4) mesh
    (minitron-8b's smoke config, decode_32k) issues the reference's
    collectives over ``model``: its HLO's all-reduces (a while body's
    counted once per trip), of the elements and type its lowered program
    gives them (XLA:CPU compiles that bf16 all-reduce in f32, twice the
    bytes), in its byte convention.  Over ``data`` the port gathers the
    step's tokens and logits, which the reference leaves sharded."""
    want = reference("audit")
    cfg = get_smoke_config("minitron-8b")
    rec = dryrun.run_executor_audit("minitron-8b", cfg=cfg, model=4, data=2)
    count, nbytes = want["collectives"]["all-reduce"]["count"], \
        want["collectives"]["all-reduce"]["bytes"]
    for body in want["while_bodies"].values():  # none while the layers unroll
        count += body["count"] * (want["n_layers"] - 1)
        nbytes += body["bytes"] * (want["n_layers"] - 1)
    assert set(want["collectives"]) == {"all-reduce"}
    lowered = want["lowered_all_reduce"]
    assert len(lowered) == count and {t for _, t in lowered} == {"bf16"}
    elements = sum(int(np.prod([int(d) for d in shp.split("x")])) for shp, _ in lowered)
    assert nbytes == 2 * 4 * elements  # compiled in f32
    g = rec["collectives_by_group"]
    assert set(g["model"]) == {"all_reduce"}
    ar = g["model"]["all_reduce"]
    assert ar["calls"] == count == cfg.n_layers
    assert ar["elements"] == elements and ar["bytes"] == 2 * elements  # bf16, as lowered
    assert step_stats.comm_bytes("all_reduce", ar["bytes"]) == nbytes // 2
    assert set(g["data"]) == {"all_gather"} and g["data"]["all_gather"]["calls"] == 2
    assert rec["contract"] == {"model_all_reduce_per_layer": True,
                               "no_all_gather_over_model": True}


@pytest.mark.parametrize("mesh", list(PROD))
def test_arg_bytes_per_rank_match_reference(reference, mesh):
    """For every applicable cell of the production mesh, rank 0's argument
    bytes under the rules equal the reference's Σ shard_shape x itemsize."""
    want = reference("bytes")
    axes = MESHES[mesh]
    n = 0
    with step_stats.fake_tensors():
        for arch in ALL_ARCHS:
            cfg = get_config(arch)
            for shape_name, shape in SHAPES.items():
                if shape_name in cfg.shape_skips:
                    continue
                cell = specs.build_cell(cfg, shape, axes)
                assert cell.arg_bytes_per_rank == want[f"{mesh}|{arch}|{shape_name}"], \
                    (arch, shape_name)
                n += 1
    assert n == sum(k.startswith(mesh + "|") for k in want)


DENSE = ["minitron-8b", "gemma2-9b", "granite-3-2b", "qwen1.5-110b"]
MOE = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
FAMILY = ["mamba2-1.3b", "hymba-1.5b", "whisper-small", "llava-next-34b"]


@pytest.fixture(scope="module")
def dense_sweep(tmp_path_factory):
    """`dryrun.sweep` of the dense, MoE, SSM, hybrid, encoder-decoder and
    VLM archs at decode_32k and long_500k on the single production mesh,
    against an H100's 85.0 GB: its result and the directory of its
    records."""
    out = tmp_path_factory.mktemp("dryrun")
    res = dryrun.sweep(DENSE + MOE + FAMILY, ["decode_32k", "long_500k"], [False],
                       "fairkv_dp", str(out), dev_bytes=dryrun.H100_BYTES)
    return res, out


def test_run_cell_records(dense_sweep):
    """A cell the port has a step for runs it (``ok``, ``executed`` with the
    reference's record keys and the cell step's decode contract: 2·L + 1
    all-reduces over ``model`` for a dense arch; for mamba2, attention-free,
    two all-gathers (``in_proj``'s columns, the conv's channels) and two
    all-reduces (the gated norm's Σ, ``out_proj``) a layer beside the
    embedding's all-reduce and the argmax's pair gather, at decode_32k and
    at long_500k, where nothing splits over ``data``); every cell of the
    sweep runs: a record is ``ok``, ``skipped`` or ``fail``, no cell is
    only sized (the train cells of every family execute their step:
    `tests/test_torch_dryrun_train*.py`); a skipped shape is
    ``skipped``."""
    res, out = dense_sweep
    recs = {(r["arch"], r["shape"]): r for r in res["records"]}
    assert res["counts"]["fail"] == 0
    ok = recs[("granite-3-2b", "decode_32k")]
    assert ok["status"] == "ok" and ok["fits"] is True
    ex = ok["executed"]
    for key in ("argument_bytes", "temp_bytes", "peak_per_device_gb"):
        assert key in ex["memory"]
    assert ex["cost"]["flops_per_device"] > 0 and ex["cost"]["bytes_per_device"] > 0
    assert ex["step"].startswith("repro_torch.serving.engine.decode_step")
    cfg = get_config("granite-3-2b")
    assert ex["collectives_by_group"]["model"]["all_reduce"]["calls"] == 2 * cfg.n_layers + 1
    assert ok["memory"]["argument_bytes"] > 0
    assert set(res["counts"]) == {"ok", "skipped", "fail"}
    assert all(r["status"] != "ok" or "executed" in r for r in res["records"])
    m2 = get_config("mamba2-1.3b")
    L = m2.n_layers
    for shape_name, rows in (("decode_32k", SHAPES["decode_32k"].global_batch // 16),
                             ("long_500k", 1)):
        rec = recs[("mamba2-1.3b", shape_name)]
        assert rec["status"] == "ok" and rec["fits"] is True
        assert all(rec["executed"]["contract"].values())
        g = rec["executed"]["collectives_by_group"]
        assert set(g) == {"model"}
        assert g["model"]["all_reduce"]["calls"] == g["model"]["all_gather"]["calls"] == 2 * L + 1
        assert g["model"]["all_reduce"]["elements"] == rows * ((L + 1) * m2.d_model + L)
    assert recs[("gemma2-9b", "long_500k")]["status"] == "ok"
    assert recs[("granite-3-2b", "long_500k")]["status"] in ("ok", "skipped")
    assert recs[("minitron-8b", "long_500k")]["status"] == "skipped"
    written = json.loads((out / "granite-3-2b__decode_32k__single.json").read_text())
    assert written["executed"]["memory"] == ex["memory"]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_decode_cell_executes_its_step(reference, dense_sweep, arch):
    """The dense archs' decode_32k cells on the fake (data 16, model 16)
    mesh execute ``build_cell(...).fn`` on the rules' arguments: its
    argument bytes are the reference's; per rank, over ``model``, 2·L + 1
    all-reduces of (B / 16, d_model) bf16 and one all-gather of the
    argmax's (B / 16, 2) fp32 pairs, nothing over ``data``; its peak fits
    the card (qwen1.5-110b on int8 weights by the auto rule)."""
    rec = {(r["arch"], r["shape"]): r for r in dense_sweep[0]["records"]}[arch, "decode_32k"]
    cfg = get_config(arch)
    ex = rec["executed"]
    assert rec["status"] == "ok" and rec["fits"] is True
    assert ex["memory"]["peak_bytes"] <= dryrun.H100_BYTES
    want = reference("bytes")[f"16x16|{arch}|decode_32k"]
    assert rec["memory"]["argument_bytes"] == ex["memory"]["argument_bytes"] == want
    assert rec["quantize"] == (arch == "qwen1.5-110b")
    assert ex["contract"] == {"model_all_reduces": True, "model_all_gathers": True,
                              "nothing_over_data": True}
    rows = SHAPES["decode_32k"].global_batch // 16
    g = ex["collectives_by_group"]
    assert set(g) == {"model"}
    n = 2 * cfg.n_layers + 1
    assert g["model"]["all_reduce"] == {"calls": n, "elements": n * rows * cfg.d_model,
                                        "bytes": 2 * n * rows * cfg.d_model}
    assert g["model"]["all_gather"] == {"calls": 1, "elements": rows * 2 * 16,
                                        "bytes": 4 * rows * 2 * 16}


def test_long_cell_executes_split_s(reference, dense_sweep):
    """gemma2-9b's long_500k cell (B 1, 524,352 columns split 16 ways over
    ``data``) executes its split-S step on the fake (data 16, model 16)
    mesh on the reference's arguments (2.80 GB a rank): over ``model`` 2·L
    + 1 all-reduces of (1, d_model) and the argmax's pair gather, over
    ``data`` one all-gather a layer of the rank's (o, lse) pairs (16 x (1,
    S / 16, G, Dh + 1) fp32); the partial kernel's fake implementation runs
    on every layer."""
    rec = {(r["arch"], r["shape"]): r for r in dense_sweep[0]["records"]}["gemma2-9b",
                                                                          "long_500k"]
    cfg = get_config("gemma2-9b")
    ex = rec["executed"]
    assert rec["status"] == "ok" and rec["fits"] is True
    want = reference("bytes")["16x16|gemma2-9b|long_500k"]
    assert rec["memory"]["argument_bytes"] == ex["memory"]["argument_bytes"] == want
    assert round(want / 1e9, 2) == 2.80
    assert ex["contract"] == {"model_all_reduces": True, "model_all_gathers": True,
                              "data_one_all_gather_per_layer": True}
    L, G, Dh = cfg.n_layers, cfg.q_per_kv, cfg.head_dim
    n_slots = rec["executed"]["collectives_by_group"]["data"]["all_gather"]["elements"] // (
        L * 16 * G * (Dh + 1))
    assert n_slots * 16 == specs.cell_plan(cfg, 16, batch_cap=1).n_slots
    g = ex["collectives_by_group"]
    assert g["model"]["all_reduce"]["calls"] == 2 * L + 1
    assert g["data"]["all_gather"]["bytes"] == 4 * L * 16 * n_slots * G * (Dh + 1)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_cell_executes_expert_parallel(reference, dense_sweep, arch):
    """The MoE archs' decode_32k cells on the fake (data 16, model 16)
    mesh execute their step on the reference's arguments: per MoE layer
    one all-gather of the expert counts over ``data`` (16 x 3E float64),
    one of the router's columns over ``model`` (D x E) and one all-reduce
    of the experts' (B / 16, d_model) outputs over it, beside the
    attention's."""
    rec = {(r["arch"], r["shape"]): r for r in dense_sweep[0]["records"]}[arch, "decode_32k"]
    cfg = get_config(arch)
    ex = rec["executed"]
    assert rec["status"] == "ok" and rec["fits"] is True
    want = reference("bytes")[f"16x16|{arch}|decode_32k"]
    assert rec["memory"]["argument_bytes"] == ex["memory"]["argument_bytes"] == want
    assert all(ex["contract"].values()) and "data_one_all_gather_per_layer" in ex["contract"]
    L, E, D = cfg.n_layers, cfg.moe.num_experts, cfg.d_model
    rows = SHAPES["decode_32k"].global_batch // 16
    g = ex["collectives_by_group"]
    assert g["model"]["all_reduce"]["calls"] == 2 * L + 1
    assert g["model"]["all_gather"] == {"calls": L + 1, "elements": L * D * E + rows * 2 * 16,
                                        "bytes": 2 * L * D * E + 4 * rows * 2 * 16}
    assert g["data"]["all_gather"] == {"calls": L, "elements": L * 16 * 3 * E,
                                       "bytes": 8 * L * 16 * 3 * E}


def test_partial_kernel_fake_implementation_and_flops():
    """The partial variant's custom op on fake CUDA tensors: (o, lse) in
    fp32 from its fake implementation, which reports the full kernel's
    scratch and counters as temps; its FLOP formula equals FlopCounterMode's
    count of its plain version's products."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in ((2, 3, 4, 32), (3, 2, 40, 32),
                                                       (3, 2, 40, 32)))
    ln = torch.full((3, 2), 7, dtype=torch.int32)
    want = _flops(lambda: ref.fairkv_decode_partial_ref(q, k, v, ln))
    with step_stats.fake_tensors():
        qc = torch.empty((8, 16, 4, 256), dtype=torch.bfloat16, device="cuda")
        kc = torch.empty((16, 8, 512, 256), dtype=torch.bfloat16, device="cuda")
        lc = torch.empty((16, 8), dtype=torch.int32, device="cuda")
        (o, lse), st = step_stats.measure(ops.fairkv_decode_partial, (qc, kc, lc), qc, kc, kc,
                                          lc)
        cu = [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in (q, k, v, ln)]
        got = _flops(lambda: ops.fairkv_decode_partial(*cu))
    from repro_torch.kernels.fairkv_decode import scratch_floats
    assert o.shape == qc.shape and o.dtype == torch.float32 and lse.shape == (8, 16, 4)
    assert st.temp_bytes == scratch_floats(8, 16, 4, 256, 512) * 4 + 16 * 8 * 4
    assert got == want == 4 * 2 * 3 * 4 * 40 * 32


@pytest.mark.parametrize("arch", FAMILY)
def test_family_decode_cells_execute_their_step(reference, dense_sweep, arch):
    """The SSM, hybrid, encoder-decoder and VLM archs' decode_32k cells (and
    mamba2's and hymba's long_500k) on the fake (data 16, model 16) mesh
    execute ``build_cell(...).fn`` on the reference's arguments, within the
    card, with the derived collectives per rank:

    - mamba2 (in_proj's 8512 columns, the conv's 4352 channels, 64 heads
      and out_proj's 4096 rows all split 16 ways): per layer over
      ``model`` two all-gathers (in_proj's columns, the activated conv
      output) and two all-reduces (the gated norm's Σ, out_proj);
    - hymba (in_proj's 3257 columns and its 25 heads whole, the conv's
      1632 channels and out_proj's 1600 rows split): per layer one
      all-gather (the conv output) and four all-reduces (the slot norm's
      Σ, the o-projection, out_proj, the MLP); at long_500k also one
      all-gather of the split-S pairs over ``data`` a layer;
    - whisper (12 heads whole) and llava: the dense contract;

    beside the embedding's all-reduce and the argmax's pair gather."""
    recs = {(r["arch"], r["shape"]): r for r in dense_sweep[0]["records"]}
    cfg = get_config(arch)
    L = cfg.n_layers
    per_layer = {"mamba2-1.3b": (2, 2), "hymba-1.5b": (4, 1), "whisper-small": (2, 0),
                 "llava-next-34b": (2, 0)}[arch]  # (all-reduces, all-gathers) a layer
    shapes = ["decode_32k"] + (["long_500k"] if arch in ("mamba2-1.3b", "hymba-1.5b") else [])
    for shape_name in shapes:
        rec = recs[arch, shape_name]
        ex = rec["executed"]
        assert rec["status"] == "ok" and rec["fits"] is True, shape_name
        want = reference("bytes")[f"16x16|{arch}|{shape_name}"]
        assert rec["memory"]["argument_bytes"] == ex["memory"]["argument_bytes"] == want
        assert all(ex["contract"].values()), ex["contract"]
        assert ex["step"].startswith("repro_torch.serving.engine.decode_step")
        g = ex["collectives_by_group"]
        assert g["model"]["all_reduce"]["calls"] == per_layer[0] * L + 1
        assert g["model"]["all_gather"]["calls"] == per_layer[1] * L + 1
        split_s = shape_name == "long_500k" and not cfg.attention_free
        assert set(g) == ({"model", "data"} if split_s else {"model"})
        if split_s:
            assert g["data"] == {"all_gather": g["data"]["all_gather"]}
            assert g["data"]["all_gather"]["calls"] == L
