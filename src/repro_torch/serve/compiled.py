"""Compiler bridge: the per-block compile plan of a serving model.

For one model config, every raisable forward-pass block
(``core/raise.py``) is compiled with ``pipeline.compile_traced`` under a
schedule chosen by the autotuner (``autotune.best_schedule`` on the
block's dominant matmul shape, with legality-driven fallbacks down to the
nested schedule) and validated against the raised graph on real inputs.
Blocks that do not raise, do not lower, or do not validate fall back to
the plain PyTorch path — explicitly, with the reason recorded, so a plan
always states exactly which blocks of the serving model compile through
the stack and which do not.  ``cuda`` says whether the general CUDA
emitter produced ``run_cuda`` for the chosen schedule.

The plan is a record: ``ContinuousEngine(plan=)`` keeps it, and the decode
step does not run the compiled blocks.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.machine_model import TPU_V5E, MachineModel

_VALIDATE_RTOL = 1e-4


@dataclasses.dataclass
class BlockChoice:
    """Per-block outcome of the compile plan."""

    block: str
    status: str                       # "compiled" | "fallback"
    schedule: Optional[str] = None    # pipeline/schedule label
    cycles: Optional[int] = None      # machine-model cycles of the HwIR
    cuda: bool = False                # the general CUDA emitter succeeded
    reason: str = ""                  # validation note or fallback cause
    # the compiled artifact of ``schedule``; not part of the row
    kernel: Any = dataclasses.field(default=None, repr=False,
                                    compare=False)

    def row(self) -> Dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "kernel"}


@dataclasses.dataclass
class ServeCompilePlan:
    """Which blocks of one serving model run through the compiler."""

    config: str
    choices: List[BlockChoice]
    machine: str = "tpu_v5e"

    @property
    def compiled(self) -> List[BlockChoice]:
        return [c for c in self.choices if c.status == "compiled"]

    @property
    def fallbacks(self) -> List[BlockChoice]:
        return [c for c in self.choices if c.status != "compiled"]

    def summary_rows(self) -> List[Dict]:
        return [c.row() for c in self.choices]

    def describe(self) -> str:
        lines = [f"// serve compile plan for {self.config} "
                 f"({len(self.compiled)}/{len(self.choices)} blocks "
                 f"compiled, machine={self.machine})"]
        for c in self.choices:
            if c.status == "compiled":
                lines.append(
                    f"//   {c.block}: COMPILED schedule={c.schedule} "
                    f"cycles={c.cycles} cuda={c.cuda} — {c.reason}")
            else:
                lines.append(f"//   {c.block}: FALLBACK plain torch — "
                             f"{c.reason}")
        return "\n".join(lines)


def _first_matmul_shape(graph) -> Optional[tuple]:
    for op in graph.ops:
        if op.opname == "matmul":
            m, k = op.inputs[0].type.shape
            _, n = op.inputs[1].type.shape
            return (m, n, k)
    return None


def _schedule_candidates(graph):
    """Ordered (schedule, tile) attempts: autotuned first, then the
    canned families, then the always-legal nested schedule."""
    cands = []
    mnk = _first_matmul_shape(graph)
    if mnk is not None:
        from repro_torch.core import autotune
        sched, (tm, tn, tk) = autotune.best_schedule(*mnk)
        cands.append((f"autotuned:{sched}",
                      dict(schedule=sched,
                           tile={"m": tm, "n": tn, "k": tk})))
    cands.append(("tpu_mxu", dict(schedule="tpu_mxu")))
    cands.append(("nested", dict(schedule="nested")))
    return cands


def compile_first(rg, *, accept: Optional[Callable] = None, **kw
                  ) -> Tuple[Optional[str], Any, List[str]]:
    """Compile a raised graph under the first of
    :func:`_schedule_candidates` that compiles and that ``accept`` (called
    on the artifact, when given) does not raise on.  Returns ``(label,
    compiled, refusals)``, with ``(None, None, refusals)`` when no
    candidate passes; ``refusals`` has one line per candidate passed
    over.  ``kw`` goes to ``RaisedGraph.compile``."""
    refusals: List[str] = []
    for label, sched in _schedule_candidates(rg.graph):
        try:
            ck = rg.compile(**sched, **kw)
        except Exception as e:                      # legality/lowering
            refusals.append(f"{label}: {str(e).splitlines()[0]}")
            continue
        if accept is not None:
            try:
                accept(ck)
            except Exception as e:
                refusals.append(f"{label}: validation failed: "
                                f"{str(e).splitlines()[0]}")
                continue
        return label, ck, refusals
    return None, None, refusals


def plan_blocks(config_name: str, *, seq: int = 8, seed: int = 0,
                machine: MachineModel = TPU_V5E,
                validate: bool = True,
                device: str = "cuda") -> ServeCompilePlan:
    """Build the per-block compile plan for one registry config.
    ``device`` is where the compiled blocks' ``run_torch`` / ``run_cuda``
    put their inputs (validation runs ``run_torch`` there)."""
    raising = importlib.import_module("repro_torch.core.raise")
    reports = raising.raise_model_blocks(config_name, seq=seq, seed=seed)
    choices: List[BlockChoice] = []
    for rep in reports:
        if not rep.ok:
            first = (rep.error or "unraisable").splitlines()[0]
            choices.append(BlockChoice(rep.block, "fallback", reason=first))
            continue
        rg = rep.raised
        if not rg.lowerable:
            choices.append(BlockChoice(
                rep.block, "fallback",
                reason=f"unlowerable ops: {', '.join(rg.unlowerable_ops)}"))
            continue
        accept, note = None, "not validated"
        if validate:
            def accept(ck, rg=rg, inputs=rep.example_inputs):
                want = rg.run_ref(*inputs)
                got = rg.run_compiled(ck, *inputs, backend="torch")
                for w, g in zip(want, got):
                    np.testing.assert_allclose(g, w, rtol=_VALIDATE_RTOL,
                                               atol=1e-5)
            note = (f"validated torch backend vs reference at "
                    f"rtol={_VALIDATE_RTOL}")
        label, ck, refusals = compile_first(rg, accept=accept,
                                            machine=machine, device=device)
        if ck is None:
            choice = BlockChoice(rep.block, "fallback", reason=refusals[-1])
        else:
            choice = BlockChoice(
                rep.block, "compiled", schedule=label,
                cycles=int(ck.cycles.total),
                cuda=ck.run_cuda is not None, reason=note, kernel=ck)
        choices.append(choice)
    return ServeCompilePlan(config=config_name, choices=choices,
                            machine=machine.name)
