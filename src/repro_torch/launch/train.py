"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

The port of ``repro.launch.train``, with its flags and meanings plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
path).  ``--smoke`` trains the reduced config in fp32 at ``--batch`` x
``--seq``; without it the full config trains in bf16 (fp32 master weights
and moments) at ``SHAPES["train_4k"]``, a global batch of 256 x 4096, as
the reference does.  That batch does not fit one card, and the CLI,
like the reference's, has no microbatching: drive the full width through
the library (`make_train_step` at a batch that fits) instead.

Checkpoints go to ``--ckpt-dir`` every ``--ckpt-every`` steps and at the
end; ``--resume`` continues from the newest one.  Restarts are bit-exact
(the batches are a pure function of the step): the CLI turns on
``torch.use_deterministic_algorithms`` (with ``CUBLAS_WORKSPACE_CONFIG``
set for cuBLAS, unless the environment sets it), since on the card the
embedding's backward otherwise accumulates with atomics.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.models import init_params
from repro_torch.training import (
    OptimizerConfig,
    SupervisorConfig,
    SyntheticLM,
    TrainingSupervisor,
    init_optimizer,
    make_train_step,
)


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A `SyntheticLM` batch as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shapes (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device} but CUDA is not available; "
                         f"pass --device cpu to run the plain PyTorch path")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = (InputShape("cli", args.seq, args.batch, "train") if args.smoke
             else SHAPES["train_4k"])
    data = SyntheticLM(cfg, shape)
    dtype = torch.float32 if args.smoke else torch.bfloat16

    params = init_params(cfg, 0, dtype=dtype, device=device,
                         max_seq_len=max(shape.seq_len, 4096))
    opt = init_optimizer(params)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                           total_steps=args.steps)
    step_fn = make_train_step(cfg, ocfg, remat=True)

    sup = TrainingSupervisor(SupervisorConfig(
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every))
    start = 0
    state = {"params": params, "opt": opt}
    if args.resume:
        start, state = sup.restore_or_init(state)
        print(f"resumed from step {start}")

    def one_step(st, batch):
        p, o, m = step_fn(st["params"], st["opt"], batch)
        return {"params": p, "opt": o}, m

    t0 = time.time()
    losses = []
    for s in range(start, args.steps):
        state, metrics = one_step(state, device_batch(data.get_batch(s), device))
        loss = float(metrics["loss"])
        losses.append(loss)
        if (s + 1) % max(1, args.steps // 20) == 0 or s == start:
            dt = time.time() - t0
            print(f"step {s + 1:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        if (s + 1) % args.ckpt_every == 0:
            sup.ckpt.save(s + 1, state)
    sup.ckpt.wait()
    sup.emergency_save(args.steps, state)
    first = f"{losses[0]:.4f}" if losses else "-"
    last = f"{losses[-1]:.4f}" if losses else "-"
    print(f"done: loss {first} -> {last} "
          f"({time.time() - t0:.1f}s, ckpt at {args.ckpt_dir})")


if __name__ == "__main__":
    main()
