"""The port's `Engine` against the JAX `Engine`, end to end, on the CPU.

minitron-8b smoke with the quickstart's settings (8 shards, Ada-SnapKV
budget 24, T=96, B=2, 8 new tokens), weights carried across with
`repro_torch.interop` and the same numpy prompts fed to both.  Under sha,
fairkv_nodp and fairkv_dp: identical greedy tokens, retained lengths and
measured profile; logits within 1e-4 (fp32, summation order); the port's
own plan invariance below 1e-3; and no kernel launch on the CPU.

Also the port's hygiene: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package, and the entry point
refuses to fall back to the CPU when CUDA is absent.
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.api import CompressionConfig as JCompression
from repro.api import Engine as JEngine
from repro.api import EngineConfig as JEngineConfig
from repro.api import PlannerConfig as JPlanner
from repro_torch import interop
from repro_torch.api import CompressionConfig, Engine, EngineConfig, PlannerConfig
from repro_torch.kernels import build

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH, SHARDS, BUDGET = "minitron-8b", 8, 24
T, B, GEN = 96, 2, 8
PLANNERS = [("sha", 0), ("fairkv_nodp", 0), ("fairkv_dp", 4)]
COMP = dict(policy="ada_snapkv", budget=BUDGET, alpha_max=2.0, obs_window=8,
            sink=2, decode_margin=8)


def _configs(mode, ch):
    j = JEngineConfig.smoke(ARCH, n_shards=SHARDS, max_seq_len=T + GEN + 8,
                            compression=JCompression(**COMP),
                            planner=JPlanner(mode=mode, extra_copies=ch, batch_cap=B))
    t = EngineConfig.smoke(ARCH, n_shards=SHARDS, max_seq_len=T + GEN + 8,
                           device="cpu", compression=CompressionConfig(**COMP),
                           planner=PlannerConfig(mode=mode, extra_copies=ch, batch_cap=B))
    return j, t


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    sample = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    j0, t0 = _configs("sha", 0)
    jprobe = JEngine.build(j0)
    params = interop.to_torch(jax.tree.map(np.asarray, jprobe.params))
    tprobe = Engine.build(t0, params=params)
    build.reset_launches()
    out = {"profile": (jprobe.measure_profile(sample), tprobe.measure_profile(sample))}
    for mode, ch in PLANNERS:
        jc, tc = _configs(mode, ch)
        je = JEngine.build(jc, params=jprobe.params, profile=out["profile"][0])
        te = Engine.build(tc, params=params, profile=out["profile"][1])
        out[mode] = (je.generate(prompts, GEN), te.generate(prompts, GEN))
    out["launches"] = dict(build.LAUNCHES)
    return out


def test_measure_profile_identical(runs):
    jprof, tprof = runs["profile"]
    assert np.array_equal(jprof, tprof)


@pytest.mark.parametrize("mode", [m for m, _ in PLANNERS])
def test_generate_matches_reference(runs, mode):
    jr, tr = runs[mode]
    assert np.array_equal(jr.tokens, tr.tokens)
    assert np.array_equal(np.asarray(jr.lengths), tr.lengths)
    assert np.abs(np.asarray(jr.logits) - tr.logits).max() < 1e-4
    assert jr.efficiency == tr.efficiency and jr.makespan == tr.makespan
    assert len(tr.step_s) == GEN


def test_plan_invariance(runs):
    base = runs["sha"][1].logits
    for mode in ("fairkv_nodp", "fairkv_dp"):
        assert np.abs(runs[mode][1].logits - base).max() < 1e-3
    assert runs["fairkv_dp"][1].efficiency >= runs["sha"][1].efficiency


def test_no_kernel_launch_on_cpu(runs):
    assert runs["launches"] == {"fairkv_decode": 0, "snapkv_scores": 0,
                                "paged_fairkv_decode": 0,
                                "paged_fairkv_decode_mq": 0}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_engine_build_requires_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = EngineConfig.smoke(ARCH)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine.build(cfg)
