"""Batched serving engine: prefill + decode steps.

The PyTorch counterpart of ``repro/serve/engine.py``.  ``make_prefill_step``
/ ``make_decode_step`` are the step functions; ``Engine`` drives them for
real generation, greedy or with temperature sampling.  PyTorch runs
eagerly, so the steps are called as they are (the reference jits them).

Continuous batching lives next door: the serving engine is
:class:`repro_torch.serve.continuous.ContinuousEngine` (one batched
decode step across all occupied slots, an admission queue,
backpressure); :class:`SerialSlotEngine` below decodes each slot with its
own B=1 step, the differential reference the batched engine is held to.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models.layers import cache_depth
from repro_torch.models.model import Model, mask_padded_vocab
# ContinuousEngine and Request are re-exported, as the reference's module does
from repro_torch.serve.continuous import (ContinuousEngine, Request,  # noqa: F401
                                         sample)


def make_prefill_step(model: Model) -> Callable:
    def prefill(params, cache, tokens):
        logits, cache = model.apply(params, tokens, cache=cache)
        return logits[:, -1], cache
    return prefill


def make_decode_step(model: Model) -> Callable:
    def decode(params, cache, token):
        logits, cache = model.apply(params, token, cache=cache)
        return logits[:, -1], cache
    return decode


@dataclasses.dataclass
class EngineConfig:
    max_len: int = 256
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0


class Engine:
    """Generates from a batch of prompts.  After each ``generate`` call,
    ``last_timing`` holds the prefill and decode phases' wall times (each
    ends in a device synchronise) and the number of decode steps run."""

    def __init__(self, model: Model, params,
                 cfg: EngineConfig = EngineConfig()):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.prefill = make_prefill_step(model)
        self.decode = make_decode_step(model)
        self.last_timing: Dict[str, float] = {}

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
                 eos_id: Optional[int] = None) -> np.ndarray:
        """prompts: (B, P) int32 -> (B, P+steps) generated continuation.

        Rows that have emitted ``eos_id`` are frozen: every subsequent
        position is ``eos_id``, so outputs are stable however long the
        other rows keep the batch alive.  Temperature sampling draws from
        a generator seeded with ``cfg.seed``; its streams differ from the
        reference's by design (greedy streams are the same).
        """
        device = self.model.device
        B, P = prompts.shape
        gen = torch.Generator(device=device).manual_seed(self.cfg.seed)
        cache = self.model.cache_init(B, cache_depth(self.cfg.max_len))
        prompt = torch.as_tensor(np.asarray(prompts, np.int64), device=device)
        t0 = time.perf_counter()
        logits, cache = self.prefill(self.params, cache, prompt)
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
                     eos_id: Optional[int] = None) -> Dict[str, float]:
    """Wall time and rates of one ``generate`` call.  Prefill tokens/s
    counts prompt tokens; decode tokens/s counts one token per row for
    each decode step."""
    t0 = time.perf_counter()
    out = engine.generate(prompts, steps, eos_id=eos_id)
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
    reference's single key stream does.
    """

    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0,
                 seed: int = 0):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.cfg = EngineConfig(max_len=max_len, temperature=temperature,
                                seed=seed)
        self.decode = make_decode_step(model)
        self.prefill = make_prefill_step(model)

    @torch.no_grad()
    def serve(self, requests) -> Dict[int, np.ndarray]:
        """Run all requests to completion; returns rid -> generated ids."""
        dev = self.model.device
        gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        depth = cache_depth(self.max_len)
        queue = list(requests)
        results: Dict[int, np.ndarray] = {}
        # per-slot caches are allocated inside admit(); slots start empty
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
                cache = self.model.cache_init(1, depth)
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
