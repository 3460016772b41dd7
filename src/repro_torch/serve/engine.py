"""Batched serving engine: prefill + decode steps.

The PyTorch counterpart of ``repro/serve/engine.py``.  ``make_prefill_step``
/ ``make_decode_step`` are the step functions; ``Engine`` drives them for
real generation, greedy or with temperature sampling.  PyTorch runs
eagerly, so the steps are called as they are (the reference jits them).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models.layers import DECODE_BLOCK
from repro_torch.models.model import Model, mask_padded_vocab


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


def cache_depth(max_len: int) -> int:
    """Depth of the KV cache that ``Engine`` allocates for ``max_len``
    positions: past one decode tile, ``max_len`` rounded up to a whole
    number of tiles, so the decode kernel always runs full-size tiles
    (``models.layers.decode_block``).  A decode step always has at least
    one valid position, so the extra, never-written positions get a
    weight of exactly 0 and the tokens are those of a ``max_len``-deep
    cache."""
    if max_len <= DECODE_BLOCK:
        return max_len
    return -(-max_len // DECODE_BLOCK) * DECODE_BLOCK


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
