"""Continuous batching: one batched decode step for all slots.

The PyTorch counterpart of ``repro/serve/continuous.py``.  The engine's
slots are the batch axis of one KV cache, (groups, slots, depth, KV, hd)
per leaf, whose per-slot lengths live on the host as a numpy array
(``cache["len"]``).  Every occupied slot decodes in ONE batched forward
with per-row lengths: each row writes its key and value at its own
position, takes its own RoPE positions and attends its own valid prefix
(``decode_attention``'s per-row ``valid``).  The reference vmaps a B=1
step over slot-stacked caches instead; the arithmetic of a row is the
same.

Admission is decoupled from decode through a bounded pending queue
(``submit`` returns ``False`` when the queue is full — backpressure the
load generator must absorb).  Admitting a request runs the same B=1
prefill the serial engine uses (``serve.engine.SerialSlotEngine``) and
copies the prefilled cache into the slot's rows, so greedy decode token
streams match the serial engine's wherever a batched product gives each
row the sums a B=1 product gives it.

Sampling at a temperature draws from one ``torch.Generator`` per request,
seeded from ``(seed, rid)``, so a request's tokens never depend on its
slot or on what else is resident.  JAX's ``fold_in`` streams cannot be
reproduced in PyTorch, so sampled tokens differ from the reference's;
greedy decoding is unaffected.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.layers import cache_depth
from repro_torch.models.model import Model, mask_padded_vocab
from repro_torch.models.transformer import cache_leaves
from repro_torch.serve.metrics import ServeMetrics

# prefill / decode step costs for deterministic VirtualClock runs (time
# units; WallClock.advance ignores them)
VIRTUAL_STEP_COST = 1.0
VIRTUAL_PREFILL_COST = 1.0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (P,) int32
    max_new: int
    out: Optional[np.ndarray] = None


def request_generator(seed: int, rid: int,
                      device: torch.device) -> torch.Generator:
    """The sampling stream of request ``rid``: a pure function of
    ``(seed, rid)``."""
    state = np.random.SeedSequence([seed, rid]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def sample(logits: torch.Tensor, vocab_size: int, temperature: float,
           generators: List[Optional[torch.Generator]]) -> torch.Tensor:
    """(B,) int32 tokens of (B, V) logits: argmax (greedy), or row ``b``
    drawn from softmax(logits / T) with ``generators[b]``."""
    logits = mask_padded_vocab(logits.float(), vocab_size)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    out = torch.zeros(logits.shape[0], dtype=torch.int32,
                      device=logits.device)
    for b, gen in enumerate(generators):
        if gen is not None:
            out[b] = torch.multinomial(probs[b], 1, generator=gen)[0]
    return out


class ContinuousEngine:
    """Slot-based continuous batching with a single batched decode step.

    API:
      ``submit(req)``   enqueue; ``False`` = queue full (backpressure).
      ``step()``        admit into free slots, then one batched decode
                        step across all occupied slots; returns the
                        number of tokens emitted.
      ``serve(reqs)``   run a request list to completion (differential-
                        test convenience; bypasses the queue limit).
      ``results``       rid -> generated ids (np.int32) of finished
                        requests.

    ``steps`` counts the batched decode steps run.
    """

    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0,
                 seed: int = 0, queue_limit: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None):
        self.model = model
        self.params = params
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.queue_limit = queue_limit
        self.metrics = metrics
        self.depth = cache_depth(self.max_len)
        self.steps = 0

        self.pending: Deque[Request] = collections.deque()
        self.results: Dict[int, np.ndarray] = {}
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._slot_hist: List[List[int]] = [[] for _ in range(self.slots)]
        self._slot_left = np.zeros(self.slots, np.int64)
        self._slot_gen: List[Optional[torch.Generator]] = [None] * self.slots

        self._cache = model.cache_init(self.slots, self.depth)
        self._cache["len"] = np.zeros(self.slots, np.int64)
        self._tok = torch.zeros((self.slots, 1), dtype=torch.int32,
                                device=model.device)

    # ---- queue / admission -------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def busy(self) -> bool:
        return bool(self.pending) or self.active_slots > 0

    def submit(self, req: Request, arrival: Optional[float] = None) -> bool:
        """Enqueue; ``False`` (and no enqueue) when the admission queue
        is at ``queue_limit`` — backpressure for the load generator."""
        if self.queue_limit is not None and \
                len(self.pending) >= self.queue_limit:
            if self.metrics:
                self.metrics.on_reject(req.rid)
            return False
        if self.metrics:
            self.metrics.on_submit(req.rid, arrival)
        self.pending.append(req)
        return True

    def _admit(self, s: int) -> bool:
        """Prefill the next pending request into free slot ``s``."""
        dev = self.model.device
        while self.pending:
            req = self.pending.popleft()
            cache = self.model.cache_init(1, self.depth)
            gen = request_generator(self.seed, req.rid, dev)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None],
                                     device=dev)
            logits, cache = self.model.apply(self.params, prompt, cache=cache)
            tok0 = sample(logits[:, -1], self.model.cfg.vocab_size,
                          self.temperature, [gen])
            if self.metrics:
                self.metrics.clock.advance(VIRTUAL_PREFILL_COST)
                self.metrics.on_admit(req.rid, len(req.prompt))
                self.metrics.on_token(req.rid)
            first = int(tok0[0])
            if req.max_new <= 1:
                # the prefill already sampled the request's only token —
                # finish without occupying a slot (max_new=1 regression)
                self.results[req.rid] = np.asarray([first], np.int32)
                if self.metrics:
                    self.metrics.on_finish(req.rid)
                continue
            for big, one in zip(cache_leaves(self._cache),
                                cache_leaves(cache)):
                big[:, s] = one[:, 0]
            self._cache["len"][s] = len(req.prompt)
            self._tok[s] = tok0
            self._slot_req[s] = req
            self._slot_hist[s] = [first]
            self._slot_left[s] = req.max_new - 1
            self._slot_gen[s] = gen
            return True
        return False

    def _finish(self, s: int) -> None:
        req = self._slot_req[s]
        self.results[req.rid] = np.asarray(self._slot_hist[s], np.int32)
        self._slot_req[s] = None
        self._slot_gen[s] = None
        if self.metrics:
            self.metrics.on_finish(req.rid)

    # ---- the serving loop --------------------------------------------------

    def slot_state(self, s: int):
        """(cache, token) of slot ``s`` as a B=1 engine would hold them: a
        copy of its cache rows with its length, and its next input token
        (1, 1)."""
        one = self.model.cache_init(1, self.depth)
        for big, leaf in zip(cache_leaves(self._cache), cache_leaves(one)):
            leaf[:, 0] = big[:, s]
        one["len"] = int(self._cache["len"][s])
        return one, self._tok[s:s + 1].clone()

    @torch.no_grad()
    def decode_step(self) -> torch.Tensor:
        """ONE decode step for all slots, each row at its own length: the
        (slots, V) logits.  Every row writes its key and value; an empty
        slot's length stays frozen (the next admission overwrites its
        rows), and it samples token 0."""
        lens = self._cache["len"]
        logits, _ = self.model.apply(self.params, self._tok,
                                     cache=self._cache)
        active = np.asarray([r is not None for r in self._slot_req])
        self._cache["len"] = np.where(active, lens + 1, lens)
        return logits[:, -1]

    @torch.no_grad()
    def step(self) -> int:
        """Admissions + one batched decode step; returns tokens emitted."""
        for s in range(self.slots):
            if self._slot_req[s] is None:
                self._admit(s)
        active = np.asarray([r is not None for r in self._slot_req])
        if self.metrics:
            self.metrics.on_step(len(self.pending), int(active.sum()))
        if not active.any():
            return 0
        logits = self.decode_step()
        self.steps += 1
        nxt = sample(logits, self.model.cfg.vocab_size, self.temperature,
                     self._slot_gen)
        nxt = torch.where(torch.as_tensor(active, device=nxt.device), nxt,
                          torch.zeros_like(nxt))
        self._tok = nxt[:, None]
        if self.metrics:
            self.metrics.clock.advance(VIRTUAL_STEP_COST)
        toks = nxt.cpu().numpy()
        emitted = 0
        for s in range(self.slots):
            if self._slot_req[s] is None:
                continue
            self._slot_hist[s].append(int(toks[s]))
            if self.metrics:
                self.metrics.on_token(self._slot_req[s].rid)
            emitted += 1
            self._slot_left[s] -= 1
            if self._slot_left[s] <= 0 or \
                    self._cache["len"][s] >= self.max_len - 1:
                self._finish(s)
        return emitted

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Step until queue and slots are empty (or ``max_steps``)."""
        steps = 0
        while self.busy and (max_steps is None or steps < max_steps):
            self.step()
            steps += 1
        return self.results

    def serve(self, requests) -> Dict[int, np.ndarray]:
        """Run ``requests`` to completion; rid -> generated ids."""
        self.pending.extend(requests)        # bypass the queue limit
        if self.metrics:
            for r in requests:
                self.metrics.on_submit(r.rid)
        return self.drain()

