"""Model facade: build, init, apply and cache for one architecture.

The PyTorch counterpart of ``repro/models/model.py``.  ``RunConfig.backend``
picks the attention decode path: ``"cuda"`` (default) runs the hand-written
kernels, ``"torch"`` their plain PyTorch versions (the counterparts of the
reference's ``pallas`` and ``xla``).  On CPU tensors ``"cuda"`` runs the
plain versions too, as the reference's ``pallas`` runs in interpret mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution configuration orthogonal to the architecture.  Params
    and caches are float32."""
    backend: str = "cuda"              # cuda | torch


class Model:
    """Thin, stateless wrapper tying a ModelConfig to the generic stack.
    Params and caches are made on ``device``."""

    def __init__(self, cfg: ModelConfig, run: RunConfig = RunConfig(),
                 device: Any = "cuda"):
        if run.backend not in BACKENDS:
            raise ValueError(f"backend {run.backend!r} not in {BACKENDS}")
        self.cfg = cfg
        self.run = run
        self.device = torch.device(device)

    # ---- params ------------------------------------------------------------

    def init(self, generator: torch.Generator):
        """Random params drawn from ``generator`` (which must live on the
        model's device)."""
        return T.init_params(self.cfg, mode="init", generator=generator,
                             device=self.device)

    def param_shapes(self):
        return T.init_params(self.cfg, mode="shape")

    def param_count(self) -> int:
        return sum(t.numel() for t in _leaves(self.param_shapes()))

    # ---- caches ------------------------------------------------------------

    def cache_shapes(self, batch: int, max_len: int):
        return T.cache_spec(self.cfg, batch, max_len, mode="shape")

    def cache_init(self, batch: int, max_len: int):
        return T.cache_spec(self.cfg, batch, max_len, mode="init",
                            device=self.device)

    # ---- compute -----------------------------------------------------------

    def apply(self, params, tokens: torch.Tensor, *,
              cache: Optional[dict] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
        """(logits, cache).  A given cache is updated in place and returned
        (the reference returns a new cache pytree)."""
        return T.forward(params, self.cfg, tokens, cache=cache,
                         backend=self.run.backend)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def mask_padded_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """-1e30 out padded logit columns so softmax normalisation is exact."""
    if logits.shape[-1] == vocab_size:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < vocab_size, logits,
                       torch.full((), -1e30, device=logits.device,
                                  dtype=logits.dtype))

