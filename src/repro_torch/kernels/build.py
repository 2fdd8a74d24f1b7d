"""Build and load the port's CUDA kernels.

Each kernel's sources (``csrc/<name>.cu``, and for the multi-query kernel
one more translation unit per chunk width) are compiled by ``nvcc`` for
``sm_90a``, every translation unit of every library in parallel, and linked
into a shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, from the repository's sources only, into
``build/`` at the repository root; the file name carries a hash of the
sources, the shared headers and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that a path went
through the kernels (``reset_launches`` before, read after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("fairkv_decode", "snapkv_scores", "paged_fairkv_decode",
           "paged_fairkv_decode_mq")
# translation units per library: the multi-query kernel's chunk widths
# compile apart (its instantiations are most of the build's time)
SOURCES: Dict[str, Tuple[str, ...]] = {name: (f"{name}.cu",) for name in KERNELS}
SOURCES["paged_fairkv_decode_mq"] += tuple(
    f"paged_fairkv_decode_mq_w{w}.cu" for w in range(1, 6))
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use")
    return path


def lib_path(name: str) -> Path:
    """The library of kernel ``name``; its file name hashes its sources,
    every shared header (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256()
    for src in SOURCES[name]:
        h.update(src.encode() + b"\0" + (CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[str, float]]:
    """Compile every named kernel whose library is missing: one ``nvcc -c``
    per translation unit, all started together, then one link per library.
    Returns ``{name: (ptxas report, seconds from the start to the linked
    library)}`` for the kernels built by this call; raises with the
    compiler output on failure."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    procs = {}
    try:
        for name in todo:
            procs[name] = []
            for src in SOURCES[name]:
                obj = tmpdir / (Path(src).stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                procs[name].append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        reports, errors = {}, []
        for name, units in procs.items():
            outs, failed = [], False
            for src, _, proc in units:
                out, _ = proc.communicate()
                outs.append(out)
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for {src}:\n{out}")
                    failed = True
            if failed:
                continue
            lib = tmpdir / f"{name}.so"
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                                   *(str(obj) for _, obj, _ in units)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                errors.append(f"nvcc failed to link {name}:\n{link.stdout}")
                continue
            # rename is atomic: a concurrent loader sees no half-written library
            os.replace(lib, lib_path(name))
            reports[name] = ("".join(outs), time.perf_counter() - t0)
    finally:
        for units in procs.values():
            for _, _, proc in units:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        shutil.rmtree(tmpdir, ignore_errors=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        describe = getattr(lib, f"{name}_error_string")
        describe.restype = ctypes.c_char_p
        describe.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({describe(err).decode()})")
