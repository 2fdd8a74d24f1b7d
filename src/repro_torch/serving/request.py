"""Request lifecycle for continuous batching (port of
``repro.serving.request``).

A ``Request`` carries one prompt through the scheduler's state machine::

    QUEUED ──admit──▶ PREFILLING ──splice──▶ DECODING ──EOS/max──▶ FINISHED

PREFILLING lasts one scheduler tick for a monolithic prefill (prefill runs,
then the sub-state is spliced into a live batch row) and one tick per
chunk for a chunked prefill.  Timestamps are kept in
scheduler steps (one decode tick each) and in wall-clock seconds.  Traces
come from a seeded numpy generator with the reference's draw order, so
one seed gives both packages the same requests.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"  # retired early (client disconnect / shed)


@dataclass
class Request:
    """One generation request and its realized lifecycle telemetry.

    ``priority`` is a class index, lower is more urgent; preemption takes
    the least urgent, then the youngest, request first.
    """

    req_id: int
    prompt: np.ndarray  # (T,) int32 token ids
    arrival_step: int = 0  # scheduler step at which the request exists
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    priority: int = 1

    state: RequestState = RequestState.QUEUED
    row: Optional[int] = None  # live batch row while DECODING
    generated: List[int] = field(default_factory=list)
    logits: Optional[List[np.ndarray]] = None  # per-token logits if collected

    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    arrival_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    n_preemptions: int = 0  # times evicted back to QUEUED
    # prefix cache: stamped on a hit, (L,) full blocks per layer reused
    # from the index (admission charges only the unshared blocks)
    prefix_shared_blocks: Optional[np.ndarray] = None
    prefix_hit_tokens: int = 0  # matched prefix length at admission (0 = miss)
    # speculative decoding: lifetime draft tokens proposed and accepted
    # (acceptance = spec_accepted / spec_proposed feeds the adaptive depth)
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[0])

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def is_finished(self) -> bool:
        """Terminal: no further tokens (retired or cancelled)."""
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED)

    @property
    def cancelled(self) -> bool:
        return self.state is RequestState.CANCELLED

    def reset_for_requeue(self) -> None:
        """Preemption (recompute policy): drop the generated state so a
        later admission replays the request from its prompt.  Greedy decode
        is deterministic, so the replay gives the same tokens; arrival
        telemetry stays, admission telemetry is stamped again."""
        self.state = RequestState.QUEUED
        self.row = None
        self.generated = []
        if self.logits is not None:
            self.logits = []
        self.admit_step = None
        self.first_token_step = None
        self.first_token_time = None
        self.prefix_shared_blocks = None  # stamped again at re-admission
        self.prefix_hit_tokens = 0
        self.spec_proposed = 0  # the replay speculates from scratch
        self.spec_accepted = 0
        self.n_preemptions += 1

    def queueing_steps(self) -> Optional[int]:
        """Arrival → admission, in scheduler steps."""
        if self.admit_step is None:
            return None
        return self.admit_step - self.arrival_step

    def latency_steps(self) -> Optional[int]:
        """Arrival → last token, in scheduler steps."""
        if self.finish_step is None:
            return None
        return self.finish_step - self.arrival_step

    def latency_seconds(self) -> Optional[float]:
        if self.finish_time is None or self.arrival_time is None:
            return None
        return self.finish_time - self.arrival_time

    def ttft_steps(self) -> Optional[int]:
        """Arrival → first token, in scheduler steps."""
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.arrival_step

    def ttft_seconds(self) -> Optional[float]:
        """Arrival → first token, wall clock (queueing + prefill)."""
        if self.first_token_time is None or self.arrival_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def itl_seconds(self) -> Optional[float]:
        """Mean inter-token latency after the first token."""
        if (self.finish_time is None or self.first_token_time is None
                or self.n_generated < 2):
            return None
        return (self.finish_time - self.first_token_time) / (self.n_generated - 1)


def poisson_arrivals(n_requests: int, rate: float,
                     rng: np.random.Generator) -> np.ndarray:
    """(n,) sorted integer arrival steps at ``rate`` requests per step:
    exponential gaps of mean ``1/rate`` floored to whole steps; the first
    request arrives at step 0."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    if n_requests == 0:
        return np.zeros(0, dtype=int)
    gaps = np.floor(rng.exponential(1.0 / rate, size=n_requests)).astype(int)
    arrivals = np.cumsum(gaps)
    return arrivals - arrivals[0]


def synthesize_requests(
    n_requests: int,
    rate: float,
    vocab_size: int,
    min_prompt: int = 16,
    max_prompt: int = 48,
    max_new_tokens: int = 12,
    seed: int = 0,
    prefix_templates: int = 0,
    prefix_len: int = 0,
    shared_fraction: float = 0.0,
) -> List[Request]:
    """A reproducible Poisson trace of random-token requests.

    Shared-prefix traces: with ``prefix_templates > 0``, ``shared_fraction``
    of the requests start with one of the template prefixes (``prefix_len``
    tokens each, drawn once per template) followed by a unique random
    suffix; the rest stay fully random at the same total length, so
    sharing changes the cache topology, never the workload size.  The
    reference's tenant mixes (and their binding of tenants to templates)
    come with the multi-tenant front end.
    """
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n_requests, rate, rng)
    templates = None
    if prefix_templates > 0:
        if prefix_len <= 0:
            raise ValueError("prefix_templates > 0 requires prefix_len > 0")
        if not 0.0 <= shared_fraction <= 1.0:
            raise ValueError(f"shared_fraction must be in [0, 1], "
                             f"got {shared_fraction}")
        if prefix_len >= min_prompt:
            raise ValueError(f"prefix_len ({prefix_len}) must leave room for a "
                             f"unique suffix (min_prompt {min_prompt})")
        templates = [rng.integers(0, vocab_size, size=prefix_len).astype(np.int32)
                     for _ in range(prefix_templates)]
    reqs = []
    for i, step in enumerate(arrivals):
        T = int(rng.integers(min_prompt, max_prompt + 1))
        if templates is None:
            prompt = rng.integers(0, vocab_size, size=T).astype(np.int32)
        elif rng.random() < shared_fraction:
            t_ix = int(rng.integers(len(templates)))
            suffix = rng.integers(0, vocab_size, size=T - prefix_len).astype(np.int32)
            prompt = np.concatenate([templates[t_ix], suffix])
        else:
            prompt = rng.integers(0, vocab_size, size=T).astype(np.int32)
        reqs.append(Request(req_id=i, prompt=prompt, arrival_step=int(step),
                            max_new_tokens=max_new_tokens))
    return reqs


def latency_percentiles(requests: List[Request]) -> dict:
    """p50/p99 of end-to-end latency, TTFT and mean ITL over the finished
    requests, in steps and seconds; a key is present only when some
    request recorded it."""
    samples = {
        "steps": [r.latency_steps() for r in requests],
        "s": [r.latency_seconds() for r in requests],
        "ttft_steps": [r.ttft_steps() for r in requests],
        "ttft_s": [r.ttft_seconds() for r in requests],
        "itl_s": [r.itl_seconds() for r in requests],
    }
    out = {"n_finished": sum(1 for v in samples["steps"] if v is not None)}
    for key, vals in samples.items():
        vals = [v for v in vals if v is not None]
        if vals:
            out[f"p50_{key}"] = float(np.percentile(vals, 50))
            out[f"p99_{key}"] = float(np.percentile(vals, 99))
    return out
