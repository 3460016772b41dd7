"""Model facade: build, init, apply and cache for one architecture.

The PyTorch counterpart of ``repro/models/model.py``.  ``RunConfig.backend``
picks the attention decode path: ``"cuda"`` (default) runs the hand-written
kernels, ``"torch"`` their plain PyTorch versions (the counterparts of the
reference's ``pallas`` and ``xla``).  On CPU tensors ``"cuda"`` runs the
plain versions too, as the reference's ``pallas`` runs in interpret mode.
``param_dtype`` and ``cache_dtype`` make the params and caches float32
or bfloat16 (a cache's recurrent states stay float32, as in the
reference); activations follow the params' type, as in the reference.
``remat`` ("none" | "full" | "dots") checkpoints the stacked groups of a
training forward (``transformer.forward``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.distributed.sharding import (current_rules, place,
                                              replicate_plain)
from repro_torch.models import transformer as T

BACKENDS = ("cuda", "torch")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution configuration orthogonal to the architecture: the
    reference's fields."""
    param_dtype: str = "float32"
    activation_dtype: str = "float32"  # read by nothing yet, as in the reference
    backend: str = "cuda"              # cuda | torch
    remat: str = "none"                # none | full | dots
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

    def init(self, generator: torch.Generator, mesh=None):
        """Random params drawn from ``generator`` (which must live on the
        model's device), in ``param_dtype``: each is drawn in float32 and
        cast, so a bf16 model is the cast of the f32 one of the same
        seed.  With a ``mesh`` each is a DTensor placed by its logical
        axes, with the same values."""
        return T.init_params(self.cfg, mode="init", generator=generator,
                             device=self.device, dtype=self.pdtype,
                             max_seq=self.run.max_seq, mesh=mesh)

    def param_shapes(self):
        return T.init_params(self.cfg, mode="shape", dtype=self.pdtype,
                             max_seq=self.run.max_seq)

    def param_axes(self):
        return T.init_params(self.cfg, mode="axes", max_seq=self.run.max_seq)

    def param_count(self) -> int:
        return sum(t.numel() for t in _leaves(self.param_shapes()))

    # ---- caches ------------------------------------------------------------

    def cache_shapes(self, batch: int, max_len: int):
        return T.cache_spec(self.cfg, batch, max_len, mode="shape",
                            dtype=self.cdtype)

    def cache_init(self, batch: int, max_len: int, mesh=None):
        """A zeroed cache tree for ``batch`` rows of ``max_len`` positions.
        With a ``mesh`` each tensor is a DTensor placed by its logical axes
        (``cache_axes``) under the active rules, its sequence axis whole
        (the rule ``kv_seq`` set aside): each rank holds whole rows of its
        batch shard and its KV heads, which the decode path writes and
        attends in place (``layers.apply_attention``)."""
        cache = T.cache_spec(self.cfg, batch, max_len, mode="init",
                             device=self.device, dtype=self.cdtype)
        if mesh is None:
            return cache
        return place(cache, self.cache_axes(batch, max_len), mesh,
                     dict(current_rules(), kv_seq=()))

    def cache_axes(self, batch: int, max_len: int):
        return T.cache_spec(self.cfg, batch, max_len, mode="axes")

    # ---- compute -----------------------------------------------------------

    def apply(self, params, tokens: torch.Tensor, *,
              extra_embeds: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
        """(logits, cache); the reference also returns the aux loss, which
        ``loss`` reads from ``T.forward``.  A given cache is updated in
        place and returned (the reference returns a new cache pytree).
        Its ``len`` is an int (every row) or a (B,) array of per-row
        lengths (``T.forward``)."""
        logits, cache, _ = T.forward(
            params, self.cfg, tokens, extra_embeds=extra_embeds, cache=cache,
            backend=self.run.backend, remat=self.run.remat)
        return logits, cache

    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"tokens", "labels", "mask"?, "extra_embeds"?} ->
        (loss, metrics): the masked mean next-token NLL over f32 logits
        (padded vocab columns masked out) plus the MoE aux loss; metrics
        ``loss``, ``ce``, ``aux`` and ``tokens`` (the mask's sum)."""
        with replicate_plain(params["final_norm"]):
            return self._loss(params, batch)

    def _loss(self, params, batch):
        logits, _, aux = T.forward(
            params, self.cfg, batch["tokens"],
            extra_embeds=batch.get("extra_embeds"),
            backend=self.run.backend, remat=self.run.remat)
        logits = mask_padded_vocab(logits.float(), self.cfg.vocab_size)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[
            ..., 0]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(nll)
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        total = ce + aux
        return total, {"loss": total, "ce": ce, "aux": aux,
                       "tokens": denom}


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



# --------------------------------------------------------------------------
# assigned input shapes (the 4 shape cells)
# --------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if it doesn't."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k-context decode is "
                       "skipped per assignment (sub-quadratic archs only)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Meta-tensor stand-ins (shape and dtype, nothing allocated) for
    every model input of a shape cell, where the reference gives
    ShapeDtypeStructs."""
    info = SHAPES[shape]
    B, S = info["global_batch"], info["seq_len"]
    kind = info["kind"]

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    specs: Dict[str, Any] = {}
    tok_len = S if kind != "decode" else 1
    specs["tokens"] = meta((B, tok_len), torch.int32)
    if kind == "train":
        specs["labels"] = meta((B, S), torch.int32)
        specs["mask"] = meta((B, S), dtype)
    if cfg.frontend == "image_patches" and kind != "decode":
        specs["extra_embeds"] = meta((B, cfg.frontend_len, cfg.d_model),
                                     dtype)
    if cfg.frontend == "audio_frames" and kind != "decode":
        ed = cfg.encoder.d_model or cfg.d_model
        specs["extra_embeds"] = meta((B, cfg.encoder.context, ed), dtype)
    return specs
