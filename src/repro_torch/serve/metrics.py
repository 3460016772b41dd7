"""Serving latency metrics: streaming histograms + per-request records.

``StreamingHistogram`` keeps log-spaced buckets (2% growth) so p50/p90/
p99 are recovered within ~2% relative error at O(1) memory regardless of
request count — the structure every serving system uses for tail
latency.  ``ServeMetrics`` ties the histograms to the request lifecycle
(arrival -> admit -> first token -> per-token -> finish), tracks queue
depth and slot occupancy per engine step, and snapshots everything into
the JSON dict ``BENCH_serve.json`` entries embed.

Time comes from a :class:`Clock`: ``WallClock`` for real measurements,
``VirtualClock`` for deterministic transcripts (docs, CI smoke) where
each engine step advances time by a fixed cost instead of wall time.

A copy of ``repro/serve/metrics.py`` (numpy only): the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np


# --------------------------------------------------------------------------
# clocks
# --------------------------------------------------------------------------


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def advance(self, dt: float) -> None:
        """Engine hooks call this per step; real clocks ignore it."""

    kind = "abstract"


class WallClock(Clock):
    kind = "wall"

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0


class VirtualClock(Clock):
    """Deterministic clock: time only moves when ``advance`` is called."""

    kind = "virtual"

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += float(dt)


# --------------------------------------------------------------------------
# streaming histogram
# --------------------------------------------------------------------------


class StreamingHistogram:
    """Log-spaced bucket histogram over (0, +inf) with ~``growth``-1
    relative resolution; exact count/sum/min/max."""

    def __init__(self, lo: float = 1e-7, hi: float = 1e5,
                 growth: float = 1.02):
        self.lo, self.hi, self.growth = lo, hi, growth
        self._lg = math.log(growth)
        self.nbuckets = int(math.ceil(math.log(hi / lo) / self._lg)) + 2
        self.counts = np.zeros(self.nbuckets, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = 1 + int(math.log(v / self.lo) / self._lg)
        return min(i, self.nbuckets - 1)

    def _edge(self, i: int) -> float:
        """Lower edge of bucket i (bucket 0 is the underflow bucket)."""
        return 0.0 if i == 0 else self.lo * self.growth ** (i - 1)

    def record(self, v: float) -> None:
        v = float(v)
        self.counts[self._index(v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100]; midpoint-of-bucket estimate, clamped to the
        exact observed min/max so p0/p100 are exact."""
        if not self.count:
            return 0.0
        if q <= 0:
            return float(self.min)
        if q >= 100:
            return float(self.max)
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += int(c)
            if cum >= target and c:
                lo = max(self._edge(i), self.min)
                hi = min(self._edge(i + 1), self.max)
                mid = math.sqrt(lo * hi) if lo > 0 else (lo + hi) / 2.0
                return float(min(max(mid, self.min), self.max))
        return float(self.max)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "min": 0.0 if self.count == 0 else self.min,
                "max": 0.0 if self.count == 0 else self.max,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


# --------------------------------------------------------------------------
# request lifecycle metrics
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _ReqState:
    arrival: float
    admit: Optional[float] = None
    first_token: Optional[float] = None
    last_token: Optional[float] = None
    tokens: int = 0


class ServeMetrics:
    """Lifecycle recorder for one serving run.

    TTFT  = first sampled token time - arrival (includes queueing).
    TPOT  = gap between consecutive decode tokens of one request.
    e2e   = finish - arrival.
    Queue depth and active slots are sampled once per engine step.
    """

    def __init__(self, clock: Optional[Clock] = None, slots: int = 0):
        self.clock = clock or WallClock()
        self.slots = slots
        self.ttft = StreamingHistogram()
        self.tpot = StreamingHistogram()
        self.e2e = StreamingHistogram()
        self.queue_depth = StreamingHistogram(lo=0.5, hi=1e6, growth=1.05)
        self._req: Dict[int, _ReqState] = {}
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self._steps = 0
        self._occupancy = 0
        self._t_start = self.clock.now()

    # ---- lifecycle hooks (engine calls these) -----------------------------

    def on_submit(self, rid: int, arrival: Optional[float] = None) -> None:
        self.submitted += 1
        t = self.clock.now() if arrival is None else float(arrival)
        self._req[rid] = _ReqState(arrival=t)

    def on_reject(self, rid: int) -> None:
        self.rejected += 1

    def on_admit(self, rid: int, prompt_len: int) -> None:
        st = self._req.setdefault(rid, _ReqState(arrival=self.clock.now()))
        st.admit = self.clock.now()
        self.prefill_tokens += int(prompt_len)

    def on_token(self, rid: int) -> None:
        now = self.clock.now()
        st = self._req.setdefault(rid, _ReqState(arrival=now))
        st.tokens += 1
        self.decode_tokens += 1
        if st.first_token is None:
            st.first_token = now
            self.ttft.record(max(now - st.arrival, 0.0))
        elif st.last_token is not None:
            self.tpot.record(max(now - st.last_token, 0.0))
        st.last_token = now

    def on_finish(self, rid: int) -> None:
        st = self._req.get(rid)
        if st is None:
            return
        self.completed += 1
        self.e2e.record(max(self.clock.now() - st.arrival, 0.0))

    def on_step(self, queue_depth: int, active_slots: int) -> None:
        self._steps += 1
        self._occupancy += int(active_slots)
        if queue_depth > 0:
            self.queue_depth.record(queue_depth)
        else:
            self.queue_depth.count += 1      # depth 0 still counts

    # ---- snapshot ---------------------------------------------------------

    @property
    def duration(self) -> float:
        return max(self.clock.now() - self._t_start, 1e-12)

    def slot_utilization(self) -> float:
        if not self._steps or not self.slots:
            return 0.0
        return self._occupancy / (self._steps * self.slots)

    def snapshot(self) -> Dict:
        """JSON-able summary — the per-run payload of BENCH_serve.json."""
        dur = self.duration
        toks = self.decode_tokens
        return {
            "schema": "serve_metrics/v1",
            "clock": self.clock.kind,
            "duration": dur,
            "requests": {"submitted": self.submitted,
                         "completed": self.completed,
                         "backpressure_events": self.rejected},
            "tokens": {"prefill": self.prefill_tokens, "decode": toks},
            "tokens_per_s": toks / dur,
            "ttft": self.ttft.summary(),
            "tpot": self.tpot.summary(),
            "e2e": self.e2e.summary(),
            "queue_depth": {"mean": (self.queue_depth.sum
                                     / max(self.queue_depth.count, 1)),
                            "max": (0.0 if self.queue_depth.max < 0
                                    else self.queue_depth.max)},
            "steps": self._steps,
            "slot_utilization": self.slot_utilization(),
        }
