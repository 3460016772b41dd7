"""Captured decode steps: one CUDA graph per serving decode step.

The counterpart of the reference's jitted steps (``repro/serve/engine.py``
and ``continuous.py`` compile each step into one XLA program).  A
:class:`DecodeGraph` holds a model's decode step on static buffers: the
cache it was given, a (B, 1) int32 token buffer and a (B,) int32 lengths
buffer, which ``model.apply`` takes as its device-tensor form of
``len`` (per-row writes, positions and ``valid``).  On the card the step
is captured once with ``torch.cuda.graph``, after a warm-up run on the
capture stream (cuBLAS picks its kernels and workspace there, and the
kernels' libraries are built); a call then copies the tokens and lengths
into the buffers and replays the graph.  A graph bakes every pointer it
reads, so one graph serves one (batch, depth, params, cache).  On CPU
tensors the same body runs eagerly, so what the CPU runs is what the card
captures.

On a mesh (DTensor params and cache, ``Model.cache_init(mesh=)``) the
step's logits are gathered whole on every rank (``sharding.full``), so
each rank samples the same tokens.  DTensor's dispatch then runs once, at
capture, and the step's collectives (the reductions of the row-parallel
products, the logits' gather) are captured on the capture stream with its
kernels; the warm-up run creates the NCCL communicators first.  A capture
that fails raises: only the caller's ``cuda_graphs=False`` runs the step
eagerly.  A graph that captured a collective holds its NCCL communicator:
drop the engines (and collect any reference cycle holding one) before
``destroy_process_group``, which on four NCCL ranks did not return while
such a graph was alive.

A replay runs no Python, so it moves no launch counter
(``decode_attention.launches`` and the others in ``COUNTERS``).  Capture
runs no kernel either: what the counters moved while capturing is taken
back, kept as the graph's ``moves``, and added at each replay.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import backend_cuda
from repro_torch.distributed.sharding import full
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import cuda_gemm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.transformer import depth

# every kernel wrapper's launch counters: (wrapper, attribute)
COUNTERS = tuple((fn, attr) for fn, attrs in (
    (decode_attention, ("launches", "narrow_launches")),
    (cuda_gemm, ("launches", "wgmma_launches", "ffma_launches")),
    (flash_attention, ("launches", "wgmma_launches", "ffma_launches")),
    (ssd_scan, ("launches",)),
    (backend_cuda.emit_general, ("launches",))) for attr in attrs)


def counters() -> Dict[str, int]:
    """Every launch counter's value, by ``wrapper.attribute``."""
    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in COUNTERS}


def moved(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """The counters that moved from ``before`` to ``after``, and by how
    much."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def add(moves: Dict[str, int], times: int = 1) -> None:
    """Move each counter named in ``moves`` on by ``times`` its move."""
    for fn, attr in COUNTERS:
        key = f"{fn.__name__}.{attr}"
        if key in moves:
            setattr(fn, attr, getattr(fn, attr) + times * moves[key])


class DecodeGraph:
    """One decode step of ``model`` with ``params`` over ``cache`` (a cache
    tree whose ``len`` is ignored: the lengths come with each call), for
    ``batch`` rows, each of which may hold up to the cache's depth (or
    ``max_len`` where the cache has no sequence axis) positions.
    ``step(tok, lens)`` returns the (B, V) last-position logits and
    leaves the lengths to the caller, which advances them.  On the card
    the logits of a replay are the graph's static output, which the next
    replay overwrites: use them (or clone them) before it."""

    def __init__(self, model, params, cache, batch: int,
                 max_len: Optional[int] = None):
        self.model = model
        self.params = params
        self.cache = cache
        self.batch = batch
        # positions a row may reach: the cache's depth, or for a cache of
        # constant-size states (an attention-free model) the engine's own
        # ``max_len``
        self.depth = depth(cache) or max_len
        if self.depth is None:
            raise ValueError("a cache with no sequence axis needs max_len")
        dev = model.device
        self.tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.lens = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.moves: Dict[str, int] = {}
        self.replays = 0
        # on the card the step is captured; on the CPU it runs eagerly
        self.capture = dev.type == "cuda"
        if self.capture:
            # lengths go up from a pinned buffer, asynchronously; the
            # event says when the last upload has left it
            self._host = torch.zeros((batch,), dtype=torch.int32,
                                     pin_memory=True)
            self._uploaded = torch.cuda.Event()

    def body(self) -> torch.Tensor:
        """The captured computation: the model's step on the buffers."""
        view = {k: v for k, v in self.cache.items() if k != "len"}
        view["len"] = self.lens
        logits, _ = self.model.apply(self.params, self.tok, cache=view)
        return full(logits[:, -1])

    def _put(self, tok: torch.Tensor, lens) -> None:
        """Copy a step's tokens (a (B, 1) tensor) and lengths (an int for
        every row, or a (B,) array) into the static buffers."""
        lens_max = int(np.max(lens))
        if lens_max + 1 > self.depth:
            raise ValueError(f"KV cache full: {lens_max} + 1 > {self.depth}")
        self.tok.copy_(tok.reshape(self.batch, 1), non_blocking=True)
        if np.ndim(lens) == 0:
            self.lens.fill_(int(lens))
        elif self.lens.device.type == "cuda":
            self._uploaded.synchronize()
            self._host.numpy()[:] = lens
            self.lens.copy_(self._host, non_blocking=True)
            self._uploaded.record()
        else:
            self.lens.copy_(torch.as_tensor(np.asarray(lens, np.int32)))

    def __call__(self, tok: torch.Tensor, lens) -> torch.Tensor:
        self._put(tok, lens)
        if not self.capture:
            return self.body()
        if self.graph is None:
            # the first step runs eagerly (it is also the warm-up), then
            # the step is captured; its logits are this step's
            return self._capture()
        self.graph.replay()
        add(self.moves)
        self.replays += 1
        return self.logits

    def _warm(self):
        """The step run eagerly on a side stream, the one it is captured
        on: (its logits, the stream)."""
        dev = self.lens.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = self.body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        out.record_stream(torch.cuda.current_stream(dev))
        return out, stream

    def _capture(self) -> torch.Tensor:
        out, stream = self._warm()
        before = counters()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                self.logits = self.body()
        finally:
            # a capture launches nothing: take back what it moved, also
            # where it failed (the failure is raised, never stepped round)
            self.moves = moved(before, counters())
            add(self.moves, -1)
        self.graph = graph
        return out
