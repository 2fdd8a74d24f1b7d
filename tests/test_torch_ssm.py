"""The port's Mamba-2 SSD functions (`repro_torch.models.ssm`) against the
reference's (`repro.models.ssm`) on the CPU, fp32, within 1e-5: the chunked
scan at a T on and off the chunk (the padded last chunk) with and without
a given initial state, the single-token decode step, and the depthwise
causal conv with and without a carried window.  The recurrence identity
holds in both packages: a prompt run through ``ssd_chunked`` in two parts
(the second seeded with the first's final state), or its head through
``ssd_chunked`` and its tail token by token through ``ssd_decode_step``,
gives the outputs and final state of the whole prompt in one call.
Inputs are numpy draws from a seed, with non-zero ``A_log`` and ``D``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as S

TOL = 1e-5
Bsz, H, P, G, N = 2, 4, 8, 1, 6


def inputs(T, seed=0):
    """x, dt (post-softplus, positive), A_log, B, C, D and an initial
    state, as numpy fp32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(Bsz, T, H, P), dt=np.log1p(np.exp(f(Bsz, T, H))).astype(np.float32),
                A_log=(0.5 * f(H)), B_=f(Bsz, T, G, N), C_=f(Bsz, T, G, N),
                D_=f(H), init_state=(0.3 * f(Bsz, H, P, N)))


def run_both(fn_j, fn_t, args: dict, **kw):
    j = fn_j(**{k: jnp.asarray(v) for k, v in args.items()}, **kw)
    t = fn_t(**{k: torch.from_numpy(v) for k, v in args.items()}, **kw)
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


def close(a, b):
    assert a.shape == b.shape
    assert np.abs(a - b).max() < TOL * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [16, 21, 5])
def test_ssd_chunked_matches_reference(T, with_state):
    a = inputs(T)
    if not with_state:
        a.pop("init_state")
    (jy, js), (ty, ts) = run_both(JS.ssd_chunked, S.ssd_chunked, a, chunk=8)
    assert ty.dtype == np.float32 and ts.dtype == np.float32
    close(jy, ty)
    close(js, ts)


def test_ssd_decode_step_matches_reference():
    a = inputs(1)
    step = dict(x=a["x"][:, 0], dt=a["dt"][:, 0], A_log=a["A_log"], B_=a["B_"][:, 0],
                C_=a["C_"][:, 0], D_=a["D_"], state=a["init_state"])
    (jy, js), (ty, ts) = run_both(JS.ssd_decode_step, S.ssd_decode_step, step)
    close(jy, ty)
    close(js, ts)


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_causal_matches_reference(with_state):
    rng = np.random.default_rng(5)
    a = dict(x=rng.standard_normal((Bsz, 7, 10)).astype(np.float32),
             w=rng.standard_normal((4, 10)).astype(np.float32))
    if with_state:
        a["state"] = rng.standard_normal((Bsz, 3, 10)).astype(np.float32)
    (jy, js), (ty, ts) = run_both(JS.conv1d_causal, S.conv1d_causal, a)
    close(jy, ty)
    assert np.array_equal(js, ts)  # the window is the inputs' last W-1 rows


def _slice(a, lo, hi):
    return {k: (v[:, lo:hi] if v.ndim > 1 and k not in ("init_state",) else v)
            for k, v in a.items() if k != "init_state"}


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_recurrence_identity(pkg):
    """Whole prompt = head chunked + tail chunked from its state = head
    chunked + tail decoded token by token (T = 21, split at 13: both parts
    off the chunk of 8)."""
    mod, arr = (JS, jnp.asarray) if pkg == "reference" else (S, torch.from_numpy)
    T, cut = 21, 13
    a = inputs(T, seed=3)
    conv = lambda d: {k: arr(np.ascontiguousarray(v)) for k, v in d.items()}  # noqa: E731
    y_all, s_all = mod.ssd_chunked(**conv(_slice(a, 0, T)), chunk=8)
    y_h, s_h = mod.ssd_chunked(**conv(_slice(a, 0, cut)), chunk=8)
    y_t, s_t = mod.ssd_chunked(**conv(_slice(a, cut, T)), chunk=8, init_state=s_h)
    y_all, s_all, y_h, s_h, y_t, s_t = (np.asarray(v) for v in (y_all, s_all, y_h, s_h,
                                                                 y_t, s_t))
    close(y_all[:, :cut], y_h)
    close(y_all[:, cut:], y_t)
    close(s_all, s_t)
    state = arr(s_h)
    for t in range(cut, T):
        step = dict(x=a["x"][:, t], dt=a["dt"][:, t], A_log=a["A_log"], B_=a["B_"][:, t],
                    C_=a["C_"][:, t], D_=a["D_"])
        y, state = mod.ssd_decode_step(**conv(step), state=state)
        close(y_all[:, t], np.asarray(y))
    close(s_all, np.asarray(state))
