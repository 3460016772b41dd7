"""Model facade: build, init, apply and cache for one architecture.

The PyTorch counterpart of ``repro/models/model.py``.  ``RunConfig.backend``
picks the attention decode path: ``"cuda"`` (default) runs the hand-written
kernels, ``"torch"`` their plain PyTorch versions (the counterparts of the
reference's ``pallas`` and ``xla``).  On CPU tensors ``"cuda"`` runs the
plain versions too, as the reference's ``pallas`` runs in interpret mode.
``param_dtype`` and ``cache_dtype`` make the params and KV caches float32
or bfloat16; activations follow the params' type, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import transformer as T

BACKENDS = ("cuda", "torch")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution configuration orthogonal to the architecture: the
    reference's fields, less ``remat`` (training's)."""
    param_dtype: str = "float32"
    activation_dtype: str = "float32"  # read by nothing yet, as in the reference
    backend: str = "cuda"              # cuda | torch
    max_seq: int = 4096                # position-table / cache upper bound
    cache_dtype: str = "float32"


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
        self.pdtype = DTYPES[run.param_dtype]
        self.cdtype = DTYPES[run.cache_dtype]

    # ---- params ------------------------------------------------------------

    def init(self, generator: torch.Generator):
        """Random params drawn from ``generator`` (which must live on the
        model's device), in ``param_dtype``: each is drawn in float32 and
        cast, so a bf16 model is the cast of the f32 one of the same
        seed."""
        return T.init_params(self.cfg, mode="init", generator=generator,
                             device=self.device, dtype=self.pdtype)

    def param_shapes(self):
        return T.init_params(self.cfg, mode="shape", dtype=self.pdtype)

    def param_count(self) -> int:
        return sum(t.numel() for t in _leaves(self.param_shapes()))

    # ---- caches ------------------------------------------------------------

    def cache_shapes(self, batch: int, max_len: int):
        return T.cache_spec(self.cfg, batch, max_len, mode="shape",
                            dtype=self.cdtype)

    def cache_init(self, batch: int, max_len: int):
        return T.cache_spec(self.cfg, batch, max_len, mode="init",
                            device=self.device, dtype=self.cdtype)

    # ---- compute -----------------------------------------------------------

    def apply(self, params, tokens: torch.Tensor, *,
              cache: Optional[dict] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
        """(logits, cache).  A given cache is updated in place and returned
        (the reference returns a new cache pytree).  Its ``len`` is an int
        (every row) or a (B,) array of per-row lengths (``T.forward``)."""
        return T.forward(params, self.cfg, tokens, cache=cache,
                         backend=self.run.backend)


def build(arch: str, run: RunConfig = RunConfig(),
          device: Any = "cuda") -> Model:
    return Model(get_config(arch), run, device)


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

