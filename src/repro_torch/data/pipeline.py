"""Deterministic, restart-safe data pipeline.

Stateless by construction: batch contents are a pure function of
(seed, step, host_shard), so checkpoint/restore and elastic re-sharding
need only the step counter — no iterator state to persist, no skew after
a failover.  Two sources:

  * ``synthetic`` — structured pseudo-text (Zipf-ish token stream with
    local repetition so a real LM can actually reduce loss on it);
  * ``memmap``    — a flat token file (np.memmap) sliced per step/shard,
    the production path for tokenised corpora.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    memmap_path: Optional[str] = None
    num_shards: int = 1                # data-parallel host shards
    shard_id: int = 0


class Pipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} not divisible "
                             f"by num_shards {cfg.num_shards}")
        self.local_batch = cfg.global_batch // cfg.num_shards
        self._mm = None
        if cfg.source == "memmap":
            if not cfg.memmap_path:
                raise ValueError("memmap source requires memmap_path")
            self._mm = np.memmap(cfg.memmap_path, dtype=np.int32, mode="r")

    # ---- synthetic ---------------------------------------------------------

    def _synthetic(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng(
            np.uint64(c.seed) * np.uint64(1_000_003)
            + np.uint64(step) * np.uint64(9176) + np.uint64(c.shard_id))
        B, S = self.local_batch, c.seq_len + 1
        # Zipf-distributed base stream
        ranks = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        toks = (ranks - 1) % c.vocab_size
        # inject local repetition: copy a window forward (learnable signal)
        for b in range(B):
            if S >= 8:
                w = rng.integers(2, max(3, S // 4))
                src = rng.integers(0, S - 2 * w)
                toks[b, src + w:src + 2 * w] = toks[b, src:src + w]
        return toks.astype(np.int32)

    def _memmap(self, step: int) -> np.ndarray:
        c = self.cfg
        B, S = self.local_batch, c.seq_len + 1
        n = self._mm.shape[0]
        per_step = c.global_batch * S
        base = (step * per_step + self.local_batch * S * c.shard_id) % max(
            n - B * S, 1)
        flat = np.asarray(self._mm[base:base + B * S])
        return (flat.reshape(B, S) % c.vocab_size).astype(np.int32)

    # ---- public -------------------------------------------------------------

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = (self._synthetic(step) if self.cfg.source == "synthetic"
                else self._memmap(step))
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones_like(toks[:, 1:], np.float32),
        }

    def torch_batch(self, step: int, device="cuda", shardings=None
                    ) -> Dict[str, torch.Tensor]:
        """``batch(step)`` as tensors on ``device`` (int32 tokens and
        labels, an f32 mask); with ``shardings`` (one
        ``distributed.sharding.Sharding`` for every array, or a dict of
        them by key), DTensors of which each rank keeps its piece (every
        rank makes the same batch), the counterpart of ``jax_batch``'s
        ``device_put``."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in self.batch(step).items()}
        if shardings is None:
            return out
        from repro_torch.distributed.sharding import distribute
        return {k: distribute(v, shardings[k] if isinstance(shardings, dict)
                              else shardings) for k, v in out.items()}
