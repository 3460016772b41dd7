"""Batched serving engine: prefill + decode steps.

The PyTorch counterpart of ``repro/serve/engine.py``.  ``make_prefill_step``
/ ``make_decode_step`` are the step functions, run eagerly; ``Engine``
drives them for real generation, greedy or with temperature sampling.
Where the reference jits its steps, the engines here replay each decode
step as a CUDA graph (``serve.graphs.DecodeGraph``, ``cuda_graphs=True``,
the default): an engine owns a static KV cache per (batch, depth), prefills
into it eagerly (a prompt's length varies) and replays the captured step,
one graph per cache.  Positions past a row's length may hold an earlier
call's keys and values; attention gives them a weight of exactly 0.

Continuous batching lives next door: the serving engine is
:class:`repro_torch.serve.continuous.ContinuousEngine` (one batched
decode step across all occupied slots, an admission queue,
backpressure); :class:`SerialSlotEngine` below decodes each slot with its
own B=1 step, the differential reference the batched engine is held to.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import current_mesh, full
from repro_torch.models.layers import cache_depth
from repro_torch.models.model import Model, mask_padded_vocab
from repro_torch.models.transformer import reset
from repro_torch.serve.graphs import DecodeGraph
# ContinuousEngine and Request are re-exported, as the reference's module does
from repro_torch.serve.continuous import (ContinuousEngine, Request,  # noqa: F401
                                         sample, serving_params)


def make_prefill_step(model: Model) -> Callable:
    """The prefill step: (last-position logits, gathered whole under a
    mesh, and the cache)."""
    def prefill(params, cache, tokens, extra_embeds=None):
        logits, cache = model.apply(params, tokens, extra_embeds=extra_embeds,
                                    cache=cache)
        return full(logits[:, -1]), cache
    return prefill


def make_decode_step(model: Model) -> Callable:
    """The decode step: (logits, gathered whole under a mesh, and the
    cache)."""
    def decode(params, cache, token):
        logits, cache = model.apply(params, token, cache=cache)
        return full(logits[:, -1]), cache
    return decode


@dataclasses.dataclass
class EngineConfig:
    max_len: int = 256
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0
    cuda_graphs: bool = True          # replay captured decode steps


class Engine:
    """Generates from a batch of prompts.  After each ``generate`` call,
    ``last_timing`` holds the prefill and decode phases' wall times (each
    ends in a device synchronise) and the number of decode steps run.
    Under a mesh it serves on it (``continuous.serving_params``; its
    caches made on the mesh), every rank generating the same tokens."""

    def __init__(self, model: Model, params,
                 cfg: EngineConfig = EngineConfig()):
        self.model = model
        self.cfg = cfg
        self.prefill = make_prefill_step(model)
        self.decode = make_decode_step(model)
        self.last_timing: Dict[str, float] = {}
        self._given = params
        self._bind(current_mesh())

    def _bind(self, mesh) -> None:
        """Serve on ``mesh`` (None: one device): the params placed on it,
        and no static cache yet."""
        self._mesh = mesh
        self.params = serving_params(self.model, self._given, mesh)
        # (batch, depth) -> the decode step captured over a static cache
        self._steps: Dict[Tuple[int, int], DecodeGraph] = {}

    def _static(self, batch: int, depth: int) -> DecodeGraph:
        """The decode step captured over the engine's static cache of
        ``batch`` rows and ``depth`` positions, which it empties
        (``transformer.reset``: ``len`` 0, recurrent states zeroed); both
        made at first use."""
        key = (batch, depth)
        if key not in self._steps:
            self._steps[key] = DecodeGraph(
                self.model, self.params,
                self.model.cache_init(batch, depth, self._mesh), batch,
                depth)
        step = self._steps[key]
        reset(step.cache)
        return step

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _sample(self, logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        logits = mask_padded_vocab(logits.float(), self.model.cfg.vocab_size)
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, steps: int,
                 extra_embeds: Optional[torch.Tensor] = None,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """prompts: (B, P) int32 -> (B, P+steps) generated continuation.

        ``extra_embeds`` (a tensor on the model's device) goes to the
        prefill: patch embeddings (pixtral) or the encoder's frame
        embeddings (whisper, whose cross keys and values the prefill
        writes into the cache for the decode steps to read).

        Rows that have emitted ``eos_id`` are frozen: every subsequent
        position is ``eos_id``, so outputs are stable however long the
        other rows keep the batch alive.  Temperature sampling draws from
        a generator seeded with ``cfg.seed``; its streams differ from the
        reference's by design (greedy streams are the same).
        """
        if current_mesh() is not self._mesh:
            self._bind(current_mesh())
        device = self.model.device
        B, P = prompts.shape
        gen = torch.Generator(device=device).manual_seed(self.cfg.seed)
        depth = cache_depth(self.cfg.max_len)
        if self.cfg.cuda_graphs:
            step = self._static(B, depth)
            cache = step.cache
        else:
            cache = self.model.cache_init(B, depth, self._mesh)
        prompt = torch.as_tensor(np.asarray(prompts, np.int64), device=device)
        t0 = time.perf_counter()
        logits, cache = self.prefill(self.params, cache, prompt, extra_embeds)
        tok = self._sample(logits, gen)[:, None]
        self._sync()
        t1 = time.perf_counter()
        out = [prompt.to(torch.int32)]
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        eos = torch.tensor(eos_id if eos_id is not None else 0,
                           dtype=torch.int32, device=device)
        decode_steps = 0
        for _ in range(steps):
            if eos_id is not None:
                tok = torch.where(done[:, None], eos, tok)
            out.append(tok)
            if eos_id is not None:
                done = done | (tok[:, 0] == eos)
                if bool(done.all()):
                    break
            if self.cfg.cuda_graphs:
                logits = step(tok, cache["len"])
                cache["len"] += 1
            else:
                logits, cache = self.decode(self.params, cache, tok)
            decode_steps += 1
            tok = self._sample(logits, gen)[:, None]
        result = torch.cat(out, dim=1).cpu().numpy()
        self._sync()
        t2 = time.perf_counter()
        self.last_timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                            "decode_steps": decode_steps}
        return result


def real_token_count(out: np.ndarray, prompt_len: int,
                     eos_id: Optional[int] = None) -> int:
    """Generated tokens actually produced: everything after the prompt,
    counting each finished row only up to (and including) its first
    ``eos_id`` — the post-eos padding the engine emits is not work."""
    gen = out[:, prompt_len:]
    if eos_id is None:
        return int(gen.size)
    total = 0
    for row in gen:
        hits = np.flatnonzero(row == eos_id)
        total += int(hits[0]) + 1 if hits.size else row.size
    return total


def throughput_stats(engine: Engine, prompts: np.ndarray, steps: int,
                     eos_id: Optional[int] = None,
                     extra_embeds: Optional[torch.Tensor] = None
                     ) -> Dict[str, float]:
    """Wall time and rates of one ``generate`` call (``extra_embeds`` as
    there).  Prefill tokens/s counts prompt tokens; decode tokens/s counts
    one token per row for each decode step."""
    t0 = time.perf_counter()
    out = engine.generate(prompts, steps, extra_embeds=extra_embeds,
                          eos_id=eos_id)
    dt = time.perf_counter() - t0
    new_tokens = real_token_count(out, prompts.shape[1], eos_id)
    t = engine.last_timing
    B = prompts.shape[0]
    return {"wall_s": dt, "tokens": new_tokens,
            "tok_per_s": new_tokens / dt,
            "prefill_s": t["prefill_s"],
            "prefill_tok_per_s": prompts.size / t["prefill_s"],
            "decode_s": t["decode_s"],
            "decode_steps": t["decode_steps"],
            "decode_tok_per_s": (B * t["decode_steps"] / t["decode_s"]
                                 if t["decode_steps"] else 0.0)}


# --------------------------------------------------------------------------
# continuous batching — serial reference implementation
# --------------------------------------------------------------------------


class SerialSlotEngine:
    """Per-slot continuous batching, the differential reference for
    :class:`ContinuousEngine`.

    A fixed decode batch of ``slots`` where finished or empty slots are
    refilled from the queue at once; every slot decodes with its own B=1
    step on its own cache (``slots`` forwards per generated token, where
    the batched engine runs one), and the batched engine must produce the
    same greedy token streams.  Sampling at a temperature draws from one
    generator seeded with ``seed``, in scheduling order, as the
    reference's single key stream does.  With ``cuda_graphs`` each slot
    owns a static B=1 cache and a captured B=1 decode step over it.  Under
    a mesh it serves on it, as ``Engine`` does.
    """

    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0,
                 seed: int = 0, cuda_graphs: bool = True):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.cfg = EngineConfig(max_len=max_len, temperature=temperature,
                                seed=seed, cuda_graphs=cuda_graphs)
        self.decode = make_decode_step(model)
        self.prefill = make_prefill_step(model)
        self._given = params
        self._bind(current_mesh())

    def _bind(self, mesh) -> None:
        """Serve on ``mesh`` (None: one device): the params placed on it,
        the slots' static caches and captured steps made on it."""
        self._mesh = mesh
        self.params = serving_params(self.model, self._given, mesh)
        depth = cache_depth(self.max_len)
        self._steps = ([DecodeGraph(self.model, self.params,
                                    self.model.cache_init(1, depth, mesh), 1,
                                    depth) for _ in range(self.slots)]
                       if self.cfg.cuda_graphs else None)

    @torch.no_grad()
    def serve(self, requests) -> Dict[int, np.ndarray]:
        """Run all requests to completion; returns rid -> generated ids."""
        if current_mesh() is not self._mesh:
            self._bind(current_mesh())
        dev = self.model.device
        gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        depth = cache_depth(self.max_len)
        queue = list(requests)
        results: Dict[int, np.ndarray] = {}
        # eager per-slot caches are allocated inside admit(), captured
        # ones are the slots' own; slots start empty
        slot_cache: list = [None] * self.slots
        slot_req: list = [None] * self.slots
        slot_tok: list = [None] * self.slots
        slot_left = np.zeros(self.slots, np.int64)
        slot_hist: list = [[] for _ in range(self.slots)]

        def draw(logits):
            return sample(logits, self.model.cfg.vocab_size,
                          self.cfg.temperature, [gen])

        def finish(s):
            req = slot_req[s]
            results[req.rid] = np.asarray(slot_hist[s], np.int32)
            slot_req[s] = None

        def admit(s):
            while queue:
                req = queue.pop(0)
                if self._steps is not None:
                    cache = reset(self._steps[s].cache)
                else:
                    cache = self.model.cache_init(1, depth, self._mesh)
                prompt = torch.as_tensor(
                    np.asarray(req.prompt, np.int64)[None], device=dev)
                logits, cache = self.prefill(self.params, cache, prompt)
                tok = draw(logits)
                if req.max_new <= 1:
                    # the prefill sampled this request's only token; a
                    # decode pass would emit a second one (max_new=1
                    # off-by-one) — finish here instead
                    results[req.rid] = np.asarray([int(tok[0])], np.int32)
                    continue
                slot_cache[s] = cache
                slot_req[s] = req
                slot_hist[s] = [int(tok[0])]
                slot_left[s] = req.max_new - 1
                slot_tok[s] = tok[:, None]
                return True
            return False

        for s in range(self.slots):
            admit(s)
        while any(r is not None for r in slot_req) or queue:
            for s in range(self.slots):
                if slot_req[s] is None:
                    admit(s)
                    continue
                if self._steps is not None:
                    logits = self._steps[s](slot_tok[s],
                                            slot_cache[s]["len"])
                    slot_cache[s]["len"] += 1
                else:
                    logits, slot_cache[s] = self.decode(
                        self.params, slot_cache[s], slot_tok[s])
                tok = draw(logits)
                slot_tok[s] = tok[:, None]
                slot_hist[s].append(int(tok[0]))
                slot_left[s] -= 1
                if slot_left[s] <= 0 or \
                        slot_cache[s]["len"] >= self.max_len - 1:
                    finish(s)
        return results
