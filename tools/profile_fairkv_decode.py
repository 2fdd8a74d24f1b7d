"""Profile kernel 1 (``csrc/fairkv_decode.cu``) on the card.

Run from the repository root on a machine with an NVIDIA GPU and ``nvcc``::

    python3 tools/profile_fairkv_decode.py [--parent DIR] [--out FILE]

It builds the kernel libraries from the checkout, then at the shapes that
matter for the kernel (the main path's B 8 / S 16 / G 4 / Dh 128 / C 576,
gemma2-9b's Dh 256 with and without its 4096 window, llava's G 7,
hymba's G 5 / Dh 64 / window 1024 (also without the window, and at Dh
128), and gemma2-9b's long_500k decode at B 1,
C 131,136, its window layer and the split-S partial variant at C_loc
65,536, each from seeded synthetic tensors) prints the kernel's device
time (median of 25 CUDA-event runs, L2 flushed, `chip_smoke.time_ms`), the
efficient SDPA's on the same inputs and the bound (the kept entries' K / V
read once at 3.35 TB/s).

``--parent DIR``: DIR holds another tree (``git archive <commit> | tar -x
-C DIR``); its kernel-1 library is built in a subprocess and called through
its C entry points beside this tree's: bitwise equal at lengths of at most
one segment (the redesign's contract), and timed in turns parent, new,
new, parent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (name, (B, S, G, Dh, C), lengths drawn in [lo, hi], q position, window,
# softcap, positions spread over [0, spread) (None: entry c at position c),
# partial variant)
CASES = [
    ("main B8 S16 G4 Dh128 C576", (8, 16, 4, 128, 576), (1, 576), 2080, 0, 0.0, None, False),
    ("gemma2 B4 S16 G2 Dh256 C576", (4, 16, 2, 256, 576), (480, 576), 4640, 0, 50.0, None, False),
    ("gemma2 window 4096", (4, 16, 2, 256, 576), (480, 576), 4640, 4096, 50.0, 4640, False),
    ("llava G7 B2 S16 Dh128 C576", (2, 16, 7, 128, 576), (480, 576), 2080, 0, 0.0, None, False),
    ("hymba G5 B8 S16 Dh64 C576 window 1024", (8, 16, 5, 64, 576), (480, 576), 2080, 1024, 0.0,
     2080, False),
    ("hymba G5 without the window", (8, 16, 5, 64, 576), (480, 576), 2080, 0, 0.0, 2080, False),
    ("G5 at Dh 128 without the window", (8, 16, 5, 128, 576), (480, 576), 2080, 0, 0.0, 2080,
     False),
    ("long B1 S8 G2 Dh256 C131136", (1, 8, 2, 256, 131136), (100000, 131072), 131136, 0, 50.0,
     None, False),
    ("long window 4096", (1, 8, 2, 256, 131136), (100000, 131072), 131136, 4096, 50.0, None,
     False),
    ("partial B1 S8 G2 Dh256 C_loc 65536", (1, 8, 2, 256, 65536), (50000, 65536), 131136, 0, 50.0,
     None, True),
]
_ARGTYPES = {
    "fairkv_decode_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "fairkv_decode_partial_launch": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


class Lib:
    """A kernel-1 library called through its C entry points, with its own
    scratch and counters (``sizes(B, S, G, Dh, C)`` -> (floats, ints))."""

    def __init__(self, path, sizes):
        import torch
        self.lib = ctypes.CDLL(str(path))
        for name, types in _ARGTYPES.items():
            getattr(self.lib, name).restype = ctypes.c_int
            getattr(self.lib, name).argtypes = types
        self.sizes = sizes
        self.torch = torch
        self.buf = {}

    def __call__(self, q, k, v, ln, cap, kp, qp, window, partial):
        torch = self.torch
        B, S, G, Dh = q.shape
        C = k.shape[2]
        nf, nc = self.sizes(B, S, G, Dh, C)
        if self.buf.get("nf", 0) < nf or self.buf.get("nc", 0) < nc:
            self.buf = dict(nf=nf, nc=nc, scr=torch.zeros(nf, device="cuda"),
                            cnt=torch.zeros(nc, dtype=torch.int32, device="cuda"))
        st = torch.cuda.current_stream().cuda_stream
        dt = 0 if q.dtype == torch.float32 else 1
        kpp = kp.data_ptr() if window else None
        qpp = qp.data_ptr() if window else None
        scr, cnt = self.buf["scr"].data_ptr(), self.buf["cnt"].data_ptr()
        if partial:
            o = torch.empty(q.shape, dtype=torch.float32, device="cuda")
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
            err = self.lib.fairkv_decode_partial_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(), kpp, qpp,
                o.data_ptr(), lse.data_ptr(), scr, cnt, B, S, G, C, Dh, cap, window, dt, st)
            out = (o, lse)
        else:
            out = torch.empty_like(q)
            err = self.lib.fairkv_decode_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(), kpp, qpp,
                out.data_ptr(), scr, cnt, B, S, G, C, Dh, cap, window, dt, st)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out


def inputs(gen, shape, lens, qpos, spread):
    import torch
    Bq, S, G, Dh, C = shape
    q = torch.randn((Bq, S, G, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((S, Bq, C, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((S, Bq, C, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    ln = torch.randint(lens[0], lens[1] + 1, (S, Bq), generator=gen, device="cuda",
                       dtype=torch.int32)
    cols = torch.arange(C, dtype=torch.int32, device="cuda")
    if spread is None:
        pos = cols.expand(S, Bq, C)
    else:  # sorted distinct positions, as a compressed cache keeps them
        r = torch.rand((S, Bq, spread), generator=gen, device="cuda").argsort(-1)[..., :C]
        pos = r.sort(-1).values.to(torch.int32)
    kp = torch.where(cols < ln[..., None], pos, -1).contiguous()
    qp = torch.full((Bq,), qpos, dtype=torch.int32, device="cuda")
    return q, k, v, ln, kp, qp


def parent_lib(parent: Path):
    """Build the parent tree's kernel-1 library in a subprocess (its own
    ``repro_torch``) and wrap it; its scratch and counters as its launch
    wants them (one segment: S B 8 G (Dh + 2) floats, S B ints, unless the
    tree exports its own sizes)."""
    out = subprocess.run([sys.executable, "-c", (
        f"import sys; sys.path.insert(0, {str(parent / 'src')!r});"
        "from repro_torch.kernels import build; build.build(['fairkv_decode']);"
        "print(build.lib_path('fairkv_decode'))")], capture_output=True, text=True, check=True)
    path = out.stdout.strip().splitlines()[-1]
    probe = ctypes.CDLL(path)
    if hasattr(probe, "fairkv_decode_counters"):
        probe.fairkv_decode_scratch_floats.argtypes = [ctypes.c_int] * 5
        probe.fairkv_decode_scratch_floats.restype = ctypes.c_longlong
        probe.fairkv_decode_counters.argtypes = [ctypes.c_int] * 3
        probe.fairkv_decode_counters.restype = ctypes.c_longlong
        return Lib(path, lambda B, S, G, Dh, C: (probe.fairkv_decode_scratch_floats(
            B, S, G, Dh, C), probe.fairkv_decode_counters(B, S, C)))
    return Lib(path, lambda B, S, G, Dh, C: (S * B * 8 * G * (Dh + 2), S * B))


def bitwise_vs_parent(gen, new, old) -> int:
    """This tree's kernel bitwise equal to the parent's at lengths of at
    most one segment (full and partial variants, with and without window
    and softcap); returns the number of cases."""
    import torch

    import chip_smoke as cs
    n = 0
    shapes = [(4, 8, 8, 64, 256), (2, 16, 1, 128, 200), (3, 5, 4, 32, 96), (8, 16, 4, 128, 576),
              (2, 5, 4, 128, 1600), (2, 3, 2, 256, 4096), (1, 2, 5, 64, 4096)]
    for dtype in (torch.float32, torch.bfloat16):
        for (Bq, S, G, Dh, C) in shapes + cs.FAMILY_DECODE_SHAPES:
            for window, cap, empty in ((0, 0.0, True), (C // 3, 0.0, False), (C // 2, 30.0, False)):
                q, k, v, ln, kp, qp = cs.decode_inputs(gen, Bq, S, G, Dh, C, dtype, empty)
                for partial in (False, True):
                    a = new(q, k, v, ln, cap, kp, qp, window, partial)
                    b = old(q, k, v, ln, cap, kp, qp, window, partial)
                    torch.cuda.synchronize()
                    same = (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])) if partial \
                        else torch.equal(a, b)
                    if not same:
                        raise RuntimeError(f"not bitwise the parent's at {(Bq, S, G, Dh, C)} "
                                           f"{dtype} window {window} cap {cap} partial {partial}")
                    n += 1
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_fairkv_decode: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fairkv_decode as K1
    t0 = time.perf_counter()
    build.build(["fairkv_decode"])
    new = Lib(build.lib_path("fairkv_decode"), lambda B, S, G, Dh, C: (
        K1.scratch_floats(B, S, G, Dh, C), K1.counters(B, S, C)))
    old = parent_lib(args.parent) if args.parent else None
    print(f"{cs.card_line()}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    report = {"card": cs.card_line(), "cases": {}}
    if old is not None:
        report["bitwise_vs_parent_cases"] = bitwise_vs_parent(gen, new, old)
        print(f"bitwise equal to the parent's: {report['bitwise_vs_parent_cases']} cases",
              flush=True)
    for name, shape, lens, qpos, window, cap, spread, partial in CASES:
        q, k, v, ln, kp, qp = inputs(gen, shape, lens, qpos, spread)
        run_new = lambda: new(q, k, v, ln, cap, kp, qp, window, partial)  # noqa: E731
        row = {}
        if old is not None:
            run_old = lambda: old(q, k, v, ln, cap, kp, qp, window, partial)  # noqa: E731
            t = [cs.time_ms(run_old, flush), cs.time_ms(run_new, flush),
                 cs.time_ms(run_new, flush), cs.time_ms(run_old, flush)]
            row.update(parent_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2, turns_ms=t)
        else:
            row["ms"] = cs.time_ms(run_new, flush)
        if not partial:
            row["sdpa_ms"] = cs.sdpa_decode_ms(q, k, v, ln, flush, kp, qp, window)
        Dh, C = shape[3], shape[4]
        kept = torch.arange(C, device="cuda") < ln[..., None]
        if window:
            kept &= kp > qpos - window
        n = int(kept.sum())
        row["bound_ms"] = 1e3 * (n * Dh * 2 * 2 + 2 * q.numel() * 2) / cs.HBM_BYTES_PER_S
        row["kept_entries"] = n
        report["cases"][name] = row
        print(f"{name}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                      for k, v in row.items() if k != "turns_ms"), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
