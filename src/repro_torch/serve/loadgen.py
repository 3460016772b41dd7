"""Deterministic serving workload generator.

Produces replayable request streams for the continuous-batching engine:
arrival times from a Poisson / bursty (Markov-modulated Poisson) /
uniform process, prompt and output lengths from configurable
distributions, token ids from the same seeded generator.  The whole
stream is a pure function of :class:`LoadConfig` — identical config
(including ``seed``) always yields the identical stream, so every
``BENCH_serve.json`` entry names the workload it was measured under and
any run can be replayed bit-for-bit.

A copy of ``repro/serve/loadgen.py`` (numpy only): the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Integer length distribution clamped to [lo, hi].

    kind: "fixed" (always ``lo``), "uniform" (inclusive [lo, hi]), or
    "lognormal" (exp(N(mu, sigma)) clamped — the long-tail shape real
    prompt/output lengths follow).
    """

    kind: str = "uniform"
    lo: int = 4
    hi: int = 32
    mu: float = 2.0
    sigma: float = 0.8

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "fixed":
            out = np.full(n, self.lo, np.int64)
        elif self.kind == "uniform":
            out = rng.integers(self.lo, self.hi + 1, n)
        elif self.kind == "lognormal":
            out = np.rint(rng.lognormal(self.mu, self.sigma, n)).astype(np.int64)
        else:
            raise ValueError(f"unknown length distribution {self.kind!r}")
        return np.clip(out, self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """One serving workload, fully determined by its fields."""

    num_requests: int = 32
    vocab_size: int = 256
    seed: int = 0
    # arrival process: "poisson" | "bursty" | "uniform"
    process: str = "poisson"
    rate: float = 8.0                 # mean arrivals per time unit
    burst_rate: float = 32.0          # bursty: rate inside a burst
    burst_fraction: float = 0.25      # bursty: fraction of time in burst state
    burst_len: float = 1.0            # bursty: mean burst duration (time units)
    prompt: LengthDist = LengthDist("uniform", 4, 16)
    output: LengthDist = LengthDist("uniform", 2, 12)

    def describe(self) -> Dict:
        d = dataclasses.asdict(self)
        d["prompt"] = dataclasses.asdict(self.prompt)
        d["output"] = dataclasses.asdict(self.output)
        return d


@dataclasses.dataclass(frozen=True)
class GenRequest:
    """One generated request of the stream."""

    rid: int
    arrival: float                    # time units since stream start
    prompt: np.ndarray                # (P,) int32 token ids
    max_new: int                      # tokens to generate (incl. first)


def _interarrival(cfg: LoadConfig, rng: np.random.Generator) -> np.ndarray:
    n = cfg.num_requests
    if cfg.process == "uniform":
        return np.full(n, 1.0 / cfg.rate)
    if cfg.process == "poisson":
        return rng.exponential(1.0 / cfg.rate, n)
    if cfg.process == "bursty":
        # two-state MMPP: "calm" at ``rate``, "burst" at ``burst_rate``;
        # state flips are sampled per-arrival with mean sojourns chosen so
        # ``burst_fraction`` of time is spent bursting.
        gaps = np.empty(n)
        in_burst = False
        t_left = rng.exponential(cfg.burst_len / max(cfg.burst_fraction, 1e-9))
        for i in range(n):
            r = cfg.burst_rate if in_burst else cfg.rate
            gap = rng.exponential(1.0 / r)
            t_left -= gap
            if t_left <= 0.0:
                in_burst = not in_burst
                mean = (cfg.burst_len if in_burst
                        else cfg.burst_len * (1.0 - cfg.burst_fraction)
                        / max(cfg.burst_fraction, 1e-9))
                t_left = rng.exponential(mean)
            gaps[i] = gap
        return gaps
    raise ValueError(f"unknown arrival process {cfg.process!r}")


def generate_stream(cfg: LoadConfig) -> List[GenRequest]:
    """The full request stream for ``cfg`` — deterministic in ``cfg``."""
    rng = np.random.default_rng(cfg.seed)
    gaps = _interarrival(cfg, rng)
    arrivals = np.cumsum(gaps)
    plens = cfg.prompt.sample(rng, cfg.num_requests)
    olens = cfg.output.sample(rng, cfg.num_requests)
    out: List[GenRequest] = []
    for i in range(cfg.num_requests):
        toks = rng.integers(0, cfg.vocab_size, plens[i]).astype(np.int32)
        out.append(GenRequest(rid=i, arrival=float(arrivals[i]),
                              prompt=toks, max_new=int(olens[i])))
    return out


def stream_digest(stream: List[GenRequest]) -> Tuple[int, int, int, float]:
    """Cheap replayability fingerprint: (n, prompt tokens, output tokens,
    last arrival) — equal streams have equal digests."""
    return (len(stream),
            int(sum(len(r.prompt) for r in stream)),
            int(sum(r.max_new for r in stream)),
            float(stream[-1].arrival) if stream else 0.0)
