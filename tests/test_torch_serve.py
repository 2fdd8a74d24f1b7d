"""The port's serving CLI, ``python -m repro_torch.launch.serve``, on the
CPU (``--device cpu``, smoke width).

One-shot and ``--continuous`` runs return normally and write Prometheus
metrics and a Chrome trace that parse; ``--config`` takes a dict the
reference's `EngineConfig.to_dict` wrote; a trace whose requests do not
finish raises (a nonzero exit); SIGINT / SIGTERM drain the engine; the
flags the port does not have are refused with the ROADMAP item.  The
front end's flags build the `FrontendConfig` that ``--http`` serves with
(from a ``--config`` file's section too), a bad ``--admission`` is refused,
and ``--http --device cpu`` serves a request in a subprocess and drains on
SIGTERM.
"""
import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest
import torch

from repro.api import CompressionConfig as JCompression
from repro.api import EngineConfig as JEngineConfig
from repro.frontend.config import FrontendConfig as JFrontendConfig
from repro.frontend.config import PriorityClass as JClass
from repro_torch.api import Engine, EngineConfig, FrontendConfig, PriorityClass
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
    (["--executor", "mesh"], "needs a process group"), (["--data", "2"], "--executor mesh"),
    (["--paged-impl", "pallas"], "on purpose")])
def test_unported_flags_are_refused(capsys, flags, item):
    with pytest.raises(SystemExit) as e:
        serve.main(BASE + flags)
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_other_archs_are_refused(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu"])
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


# ---------------------------------------------------------------------------
# --http: the multi-tenant front end
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _served_frontend(argv):
    """The `FrontendConfig` ``run_http`` would serve with for these flags."""
    _, args = serve.parse_args(argv)
    max_prompt = max(args.min_prompt, args.max_prompt)
    ecfg = serve._engine_config(args, max_prompt + args.gen + 8, args.rows,
                                serve._scheduler_config(args))
    return serve._frontend_config(args, ecfg)


@pytest.mark.parametrize("flags,expect", [
    ([], dict()),
    (["--admission", "fcfs", "--port", "0", "--host", "0.0.0.0"],
     dict(admission="fcfs", port=0, host="0.0.0.0")),
    (["--quantum", "64", "--quota-cap=640"], dict(quantum_tokens=64, quota_cap_tokens=640)),
    (["--max-prompt", "40", "--gen", "7", "--port=9001"],
     dict(port=9001, max_prompt_tokens=40, max_new_tokens_cap=7)),
], ids=["defaults", "admission-host-port", "quota", "bounds"])
def test_http_flags_build_the_frontend_config(flags, expect):
    """Each front-end flag lands in its `FrontendConfig` field; prompts are
    bounded by --max-prompt and generation by --gen."""
    got = _served_frontend(BASE + ["--http"] + flags)
    want = dict(max_prompt_tokens=24, max_new_tokens_cap=4)
    want.update(expect)
    assert got == FrontendConfig(**want)


def test_http_config_file_frontend_section(tmp_path):
    """A reference dict's ``frontend`` section is the base; typed flags
    override its fields, the rest (classes included) are kept."""
    classes = (JClass("chat", 0, ttft_slo_steps=5, preempt_below=True),
               JClass("bulk", 3, degrade_floor=2))
    cfg = JEngineConfig.smoke("minitron-8b", frontend=JFrontendConfig(
        admission="fcfs", quantum_tokens=32, quota_cap_tokens=320, classes=classes,
        latency_window=9))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg.to_dict()))
    got = _served_frontend(["--config", str(path), "--device", "cpu", "--http", "--port", "0",
                            "--quantum", "48"])
    assert got.admission == "fcfs" and got.port == 0 and got.quantum_tokens == 48
    assert got.quota_cap_tokens == 320 and got.latency_window == 9
    assert got.classes == (PriorityClass("chat", 0, ttft_slo_steps=5, preempt_below=True),
                           PriorityClass("bulk", 3, degrade_floor=2))


def test_http_bad_admission_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(BASE + ["--http", "--admission", "lifo"])
    assert e.value.code == 2
    assert "invalid choice: 'lifo'" in capsys.readouterr().err


def test_http_bad_quota_is_refused():
    with pytest.raises(ValueError, match="quota_cap_tokens"):
        serve.main(BASE + ["--http", "--quantum", "9000"])


def test_http_without_a_card_refuses_before_listening():
    """``--http`` runs on the card unless ``--device cpu`` is given."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device serves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "minitron-8b", "--smoke", "--http", "--port", "0"])


def test_http_serves_and_drains_on_sigterm(tmp_path):
    """``--http --device cpu --port 0`` in a subprocess: the ``serving on``
    line names the port, a request gets its tokens, SIGTERM drains (exit 0,
    the drain line) and the metrics file parses with the front end's
    families."""
    metrics = tmp_path / "m.prom"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "minitron-8b", "--smoke",
         "--device", "cpu", "--http", "--port", "0", "--gen", "5", "--metrics-out",
         str(metrics)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), line + proc.stderr.read()
        port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
        body = json.dumps({"prompt": [3, 1, 4, 1, 5, 9], "max_new_tokens": 9,
                           "tenant": "cli"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate", data=body,
                                     method="POST")
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert out["state"] == "finished" and len(out["tokens"]) == 5  # --gen caps it
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    assert "draining" in stdout and "drained after" in stdout and "1 terminal requests" in stdout
    lines = [ln for ln in metrics.read_text().splitlines() if not ln.startswith("#")]
    for ln in lines:
        float(ln.rsplit(" ", 1)[1])
    text = metrics.read_text()
    for fam in ("slo_attained_total", "goodput_tokens_total", "frontend_admission_total"):
        assert f'{fam}{{' in text and 'tenant="cli"' in text, fam


def test_mesh_executor_under_torchrun(tmp_path):
    """``--executor mesh --shards 2 --data 1 --device cpu`` as a 2-rank gloo
    launch (``torchrun --standalone``): exit 0, rank 0 alone prints the run
    and the collective-audit line (two all-reduces over model for the smoke
    model's two layers, no all-gather) and writes the metrics, whose decode
    series carry the executor label "mesh"."""
    metrics = tmp_path / "m.prom"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.serve", "--arch", "minitron-8b", "--smoke",
         "--device", "cpu", "--executor", "mesh", "--shards", "2", "--data", "1",
         "--continuous", "--requests", "4", "--gen", "4", "--metrics-out", str(metrics)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    audit = [ln for ln in out.stdout.splitlines() if ln.startswith("decode step collectives")]
    assert audit == ["decode step collectives/rank: model all_reduce x2 (1.0 kB) | "
                     "2 all-reduce over model for 2 layers, 0 all-gather over model"]
    assert out.stdout.count("continuous: 4 requests") == 1  # rank 0 prints
    text = metrics.read_text()
    assert 'stepfn_wall_s_count{executor="mesh",kind="decode"}' in text


@pytest.mark.parametrize("rank", [None, 0, 1])
def test_export_obs_only_from_rank_zero(tmp_path, rank):
    """``--metrics-out`` / ``--trace-out`` are written by a single-process
    engine and by a mesh's rank 0; another rank's registry (its own step
    timings and spans) never reaches the shared paths."""
    from types import SimpleNamespace

    eng = SimpleNamespace(mesh=None if rank is None else SimpleNamespace(rank=rank),
                          metrics_prometheus=lambda: "m 1\n", trace_export=lambda: "{}")
    args = SimpleNamespace(metrics_out=str(tmp_path / "m.prom"),
                           trace_out=str(tmp_path / "t.json"))
    serve._export_obs(eng, args)
    written = rank in (None, 0)
    assert (tmp_path / "m.prom").exists() == written
    assert (tmp_path / "t.json").exists() == written
