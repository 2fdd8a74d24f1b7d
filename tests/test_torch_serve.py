"""The port's serving CLI, ``python -m repro_torch.launch.serve``, on the
CPU (``--device cpu``, smoke width).

One-shot and ``--continuous`` runs return normally and write Prometheus
metrics and a Chrome trace that parse; ``--config`` takes a dict the
reference's `EngineConfig.to_dict` wrote; a trace whose requests do not
finish raises (a nonzero exit); SIGINT / SIGTERM drain the engine; the
flags the port does not have are refused with the ROADMAP item.
"""
import json
import os
import signal

import pytest
import torch

from repro.api import CompressionConfig as JCompression
from repro.api import EngineConfig as JEngineConfig
from repro_torch.api import Engine, EngineConfig
from repro_torch.launch import serve

torch.set_num_threads(2)

BASE = ["--arch", "minitron-8b", "--smoke", "--device", "cpu", "--gen", "4"]


def _parse_outputs(metrics, trace):
    lines = [ln for ln in open(metrics).read().splitlines() if not ln.startswith("#")]
    assert lines
    for ln in lines:
        body, val = ln.rsplit(" ", 1)
        float(val)
        assert body
    doc = json.load(open(trace))
    assert doc["traceEvents"]
    return {ln.split("{")[0].split(" ")[0] for ln in lines}, {e["name"] for e in doc["traceEvents"]}


@pytest.mark.parametrize("policy", ["headkv", "h2o"])
def test_oneshot_writes_metrics_and_trace(tmp_path, capsys, policy):
    m, t = tmp_path / "m.prom", tmp_path / "t.json"
    serve.main(BASE + ["--policy", policy, "--prompt-len", "40", "--metrics-out", str(m),
                       "--trace-out", str(t)])
    names, events = _parse_outputs(m, t)
    assert {"ttft_s_count", "itl_s_count", "stepfn_wall_s_count"} <= names
    assert {"stepfn_prefill", "stepfn_decode"} <= events
    out = capsys.readouterr().out
    assert f"{policy}, device cpu" in out and "row 0:" in out


def test_continuous_writes_metrics_and_trace(tmp_path, capsys):
    m, t = tmp_path / "m.prom", tmp_path / "t.json"
    serve.main(BASE + ["--continuous", "--policy", "pyramidkv", "--cache-backend", "paged",
                       "--kv-dtype", "int8", "--prefix-cache", "--requests", "6",
                       "--prefix-templates", "1", "--prefix-len", "32", "--rows", "2",
                       "--metrics-out", str(m), "--trace-out", str(t)])
    names, events = _parse_outputs(m, t)
    assert {"sched_admissions_total", "shard_load_tokens", "sched_imbalance",
            "pool_alloc_blocks_total", "kv_quant_tokens_total", "prefix_hits_total"} <= names
    assert {"admit_chunked", "prefill_chunk", "decode_tick", "retire"} <= events
    out = capsys.readouterr().out
    assert "prefix cache:" in out and "paged cache:" in out


def test_config_file_from_the_reference(tmp_path, capsys):
    """A reference `to_dict` file as the base; typed flags override it."""
    cfg = JEngineConfig.smoke("minitron-8b", compression=JCompression(
        policy="streaming_llm", budget=16, obs_window=8, sink=2, decode_margin=8))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg.to_dict()))
    serve.main(["--config", str(path), "--device", "cpu", "--gen", "3", "--prompt-len", "30",
                "--no-obs"])
    out = capsys.readouterr().out
    assert "streaming_llm, device cpu" in out
    serve.main(["--config", str(path), "--device", "cpu", "--gen", "3", "--prompt-len", "30",
                "--policy", "h2o"])
    assert "h2o, device cpu" in capsys.readouterr().out


def test_unfinished_requests_fail():
    with pytest.raises(RuntimeError, match="requests finished"):
        serve.main(BASE + ["--continuous", "--requests", "4", "--max-steps", "3"])


@pytest.mark.parametrize("flags,item", [
    (["--http"], "A.9"), (["--port", "8001"], "A.9"), (["--admission", "fcfs"], "A.9"),
    (["--quantum", "5"], "A.9"), (["--quota-cap", "5"], "A.9"), (["--host", "0.0.0.0"], "A.9"),
    (["--executor", "mesh"], "A.10"), (["--data", "2"], "A.10"),
    (["--paged-impl", "pallas"], "on purpose")])
def test_unported_flags_are_refused(capsys, flags, item):
    with pytest.raises(SystemExit) as e:
        serve.main(BASE + flags)
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_other_archs_are_refused(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu"])
    assert "A.11" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--smoke"])


def test_signal_drains_the_engine():
    """SIGTERM → `Engine.drain`; the next signal reaches the previous
    handler again."""
    eng = Engine.build(EngineConfig.smoke("minitron-8b", device="cpu"))
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda *a: seen.append(a[0]))
    try:
        restore = serve._install_drain_handlers(eng)
        os.kill(os.getpid(), signal.SIGTERM)
        assert eng._drain_pending and not seen
        os.kill(os.getpid(), signal.SIGTERM)  # restored: the previous handler
        assert seen == [signal.SIGTERM]
        restore()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_default_device_is_the_card():
    args = serve.build_parser().parse_args(["--arch", "minitron-8b"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", "minitron-8b", "--smoke", "--gen", "2"])
