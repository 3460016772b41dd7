"""Continuous batching: one batched decode step for all slots.

The PyTorch counterpart of ``repro/serve/continuous.py``.  The engine's
slots are the batch axis of one cache tree (axis 1 of a leaf stacked on
the group axis, axis 0 of an unrolled layer's: ``transformer.copy_rows``
copies a slot), whose per-slot lengths live on the host as a numpy array
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

With ``cuda_graphs`` (the default) the batched step is captured as a
CUDA graph over the engine's cache (``serve.graphs.DecodeGraph``) and
replayed each step, with the step's tokens and per-row lengths copied
into its static buffers first; admission's B=1 prefill, sampling and the
token readback stay outside the graph.

Sampling at a temperature draws from one ``torch.Generator`` per request,
seeded from ``(seed, rid)``, so a request's tokens never depend on its
slot or on what else is resident.  JAX's ``fold_in`` streams cannot be
reproduced in PyTorch, so sampled tokens differ from the reference's;
greedy decoding is unaffected.

Under a mesh (``sharding.axis_rules(mesh)``, as the reference's
``serve_bench --mesh`` drives the engine) the engines serve on it: plain
params are placed by their logical axes, DTensor params (``Model.init(
mesh=)``) used as they are, every cache made on the mesh (``Model.
cache_init(mesh=)``), and each step's logits gathered whole on every rank
(``sharding.full``), so every rank samples the same tokens from the same
generators.  On a mesh of more than one rank (one process a rank) the
ranks also agree on every host decision: each ``step`` first gathers from
every rank the count of requests its serving loop has submitted, and rank 0's
queue, which becomes every rank's; so a rank whose wall clock lags
admits what rank 0 admitted, and no rank prefills while another decodes.
``busy`` stays true while the ranks' counts differ, so loops that
submit by their own clocks end on the same step.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (current_mesh, full, is_dtensor,
                                              place)
from repro_torch.models.layers import cache_depth
from repro_torch.models.model import Model, mask_padded_vocab
from repro_torch.models.transformer import copy_rows
from repro_torch.serve.graphs import DecodeGraph
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


def serving_params(model: Model, params, mesh):
    """``params`` for an engine serving under ``mesh`` (the active one, or
    None for one device): plain params placed on it by their logical axes
    (``model.param_axes()``), each rank keeping its own piece; DTensors as
    they are, which serve only under their own mesh."""
    if mesh is not None:
        return place(params, model.param_axes(), mesh)
    if is_dtensor(params["final_norm"]):
        raise ValueError("DTensor params serve under their mesh: run the "
                         "engine inside sharding.axis_rules(mesh)")
    return params


def on_group(mesh) -> bool:
    """Whether ``mesh`` spans more than one rank (then the default process
    group's ranks, one process each)."""
    return mesh is not None and mesh.size() > 1


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

    ``steps`` counts the batched decode steps run.  ``plan`` (a
    ``serve.compiled.ServeCompilePlan``) is kept as ``self.plan`` for the
    caller to report; the decode step does not read it.
    """

    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0,
                 seed: int = 0, queue_limit: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None,
                 cuda_graphs: bool = True, plan=None):
        self.model = model
        self.params = params
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.queue_limit = queue_limit
        self.metrics = metrics
        self.plan = plan                       # ServeCompilePlan or None
        self.depth = cache_depth(self.max_len)
        self.steps = 0
        self.cuda_graphs = cuda_graphs

        self.pending: Deque[Request] = collections.deque()
        self.results: Dict[int, np.ndarray] = {}
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._slot_hist: List[List[int]] = [[] for _ in range(self.slots)]
        self._slot_left = np.zeros(self.slots, np.int64)
        self._slot_gen: List[Optional[torch.Generator]] = [None] * self.slots
        self._tok = torch.zeros((self.slots, 1), dtype=torch.int32,
                                device=model.device)
        # on a group of ranks: rids the ranks agreed on, this rank's
        # accepted submissions, whether the ranks' counts differed at the
        # last step, the arrivals of queued requests, rids with on_submit
        self._agreed: set = set()
        self._submitted = 0
        self._lag = False
        self._arrival: Dict[int, Optional[float]] = {}
        self._noted: set = set()
        self._given = params
        self._bind(current_mesh())

    def _bind(self, mesh) -> None:
        """Serve on ``mesh`` (None: one device): the params placed on it
        (``serving_params``), the slots' cache and its captured step made
        on it.  Done again only when the active mesh changes, which must
        not happen while a request holds a slot."""
        if self.active_slots:
            raise RuntimeError("the active mesh changed while requests "
                               "held slots")
        self._mesh = mesh
        self.params = serving_params(self.model, self._given, mesh)
        self._cache = self.model.cache_init(self.slots, self.depth, mesh)
        self._cache["len"] = np.zeros(self.slots, np.int64)
        self._step = (DecodeGraph(self.model, self.params, self._cache,
                                  self.slots, self.depth)
                      if self.cuda_graphs else None)

    def _on_active_mesh(self) -> None:
        mesh = current_mesh()
        if mesh is not self._mesh:
            self._bind(mesh)

    # ---- queue / admission -------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def busy(self) -> bool:
        """Requests queued or in slots; on a group of ranks, also while
        the ranks' serving loops had submitted different counts at the
        last step."""
        return bool(self.pending) or self.active_slots > 0 or self._lag

    def submit(self, req: Request, arrival: Optional[float] = None) -> bool:
        """Enqueue; ``False`` (and no enqueue) when the admission queue
        is at ``queue_limit`` — backpressure for the load generator.  On a
        group of ranks a request the ranks already took from rank 0's
        queue is accepted and not queued again."""
        if req.rid in self._agreed:
            self._submitted += 1
            return True
        if self.queue_limit is not None and \
                len(self.pending) >= self.queue_limit:
            if self.metrics:
                self.metrics.on_reject(req.rid)
            return False
        self._note(req.rid, arrival)
        self.pending.append(req)
        self._submitted += 1
        return True

    def _note(self, rid: int, arrival: Optional[float]) -> None:
        """Keep a queued request's arrival and tell the metrics, once a
        request: on a group of ranks it may come from rank 0's queue
        before or after this rank's serving loop submits it (also where
        the loop submitted before the first ``step`` bound the mesh)."""
        self._arrival[rid] = arrival
        if rid in self._noted:
            return
        if self.metrics:
            self.metrics.on_submit(rid, arrival)
        self._noted.add(rid)

    def _agree(self) -> None:
        """On a group of ranks: gather every rank's count of accepted
        submissions and rank 0's queue, which becomes every rank's (a
        request rank 0 has not submitted yet waits for it); ``busy`` holds
        while the counts differ.  No collective on one rank."""
        if not on_group(self._mesh):
            return
        lead = dist.get_rank() == 0
        queue = ([(r.rid, np.asarray(r.prompt, np.int32), r.max_new,
                   self._arrival.get(r.rid)) for r in self.pending]
                 if lead else None)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (self._submitted, queue))
        counts = [n for n, _ in got]
        self._lag = min(counts) != max(counts)
        queue = got[0][1]
        if not lead:
            self.pending = collections.deque(
                Request(rid, prompt, max_new)
                for rid, prompt, max_new, _ in queue)
            for rid, _, _, arrival in queue:
                self._note(rid, arrival)
        self._agreed.update(rid for rid, *_ in queue)

    def _admit(self, s: int) -> bool:
        """Prefill the next pending request into free slot ``s``."""
        dev = self.model.device
        while self.pending:
            req = self.pending.popleft()
            self._arrival.pop(req.rid, None)
            self._noted.discard(req.rid)
            cache = self.model.cache_init(1, self.depth, self._mesh)
            gen = request_generator(self.seed, req.rid, dev)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None],
                                     device=dev)
            logits, cache = self.model.apply(self.params, prompt, cache=cache)
            tok0 = sample(full(logits[:, -1]), self.model.cfg.vocab_size,
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
            copy_rows(self._cache, s, cache, 0)
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
        one = self.model.cache_init(1, self.depth, self._mesh)
        copy_rows(one, 0, self._cache, s)
        one["len"] = int(self._cache["len"][s])
        return one, self._tok[s:s + 1].clone()

    @torch.no_grad()
    def decode_step(self) -> torch.Tensor:
        """ONE decode step for all slots, each row at its own length: the
        (slots, V) logits.  Every row writes its key and value; an empty
        slot's length stays frozen (the next admission overwrites its
        rows), and it samples token 0.  With ``cuda_graphs`` on the card
        the logits are the captured step's static output, which the next
        step overwrites."""
        self._on_active_mesh()
        lens = self._cache["len"]
        if self._step is not None:
            logits = self._step(self._tok, lens)
        else:
            logits, _ = self.model.apply(self.params, self._tok,
                                         cache=self._cache)
            logits = full(logits[:, -1])
        active = np.asarray([r is not None for r in self._slot_req])
        self._cache["len"] = np.where(active, lens + 1, lens)
        return logits

    @torch.no_grad()
    def step(self) -> int:
        """Admissions + one batched decode step; returns tokens emitted.
        On a group of ranks every rank must call it as often as rank 0
        (``busy`` says when to stop)."""
        self._on_active_mesh()
        self._agree()
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
        for r in requests:
            self._note(r.rid, None)
        self._submitted += len(requests)
        return self.drain()

