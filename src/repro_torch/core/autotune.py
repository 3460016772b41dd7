"""Automatic schedule selection — the "automatic" of the paper's title.

The paper's pipeline fixes its schedule by hand (nested vs
inner-flattened).  Going beyond: ``autotune_gemm`` enumerates the
schedule space (schedule family x tile sizes), prices every candidate
with the machine model (cycles + resource feasibility against VMEM), and
returns the winner — i.e. the Vivado-simulation feedback loop folded
into the compiler as a cost-model search, which is how a production
kernel compiler chooses its tiles.

The search is pure cost-model evaluation (no execution), so it is fast
enough to run at trace time; ``best_schedule`` caches per problem shape.
The machine it prices on is the modelled TPU v5e (``TPU_V5E``, its VMEM
and MXU), as in the JAX package, so the picks equal that package's
number for number; they are not tuned for the GPU that runs the emitted
kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, List, Optional, Tuple

from .machine_model import TPU_V5E, MachineModel
from .pipeline import CompiledKernel, compile_gemm

# candidate tile edges (MXU-aligned first, small fallbacks for odd shapes)
_TILES = (256, 128, 64, 32, 16, 8)
_SCHEDULES = ("tpu_mxu_kgrid", "tpu_mxu")


@dataclasses.dataclass
class Candidate:
    schedule: str
    tile: Dict[str, int]
    cycles: int
    vmem_bytes: int
    feasible: bool

    def key(self):
        return (not self.feasible, self.cycles)


def _fits(t: int, dim: int) -> bool:
    return t <= dim and dim % t == 0


def family_points(m: int, n: int, k: int) -> Dict[str, List[Tuple[int, int, int]]]:
    """Unique design points per schedule family (canonical signatures).

    ``tpu_mxu`` keeps the whole K reduction resident in one grid block:
    its working set — the VMEM claim below — is ``(tm*k + k*tn)``
    regardless of ``tk``, and its modeled cycles are monotone
    non-increasing in ``tk`` (larger K steps mean fewer FSM trips at
    identical port traffic).  So per-``tk`` variants would be
    cost-dominated spellings of the same ``(tm, tn)`` working set,
    burning up to ``len(_TILES)``× budget per point; the canonical
    representative is ``(tm, tn)`` with ``tk = K``.
    ``tpu_mxu_kgrid`` time-multiplexes K over the grid, so ``tk`` is a
    real knob there and stays in the signature.
    """
    pts: Dict[str, List[Tuple[int, int, int]]] = {s: [] for s in _SCHEDULES}
    for tm, tn in itertools.product(_TILES, _TILES):
        if not (_fits(tm, m) and _fits(tn, n)):
            continue
        pts["tpu_mxu"].append((tm, tn, k))
        for tk in _TILES:
            if _fits(tk, k):
                pts["tpu_mxu_kgrid"].append((tm, tn, tk))
    return pts


def enumerate_candidates(m: int, n: int, k: int,
                         machine: MachineModel = TPU_V5E,
                         max_candidates: int = 64) -> List[Candidate]:
    pts = family_points(m, n, k)
    # interleave families round-robin under the budget so one family's
    # points can never evict another's (pre-canonicalization, tpu_mxu
    # duplicates and kgrid's cubic tile grid crowded each other out)
    picked: List[Tuple[str, Tuple[int, int, int]]] = []
    for row in itertools.zip_longest(*(pts[s] for s in _SCHEDULES)):
        for sched, tile in zip(_SCHEDULES, row):
            if tile is not None and len(picked) < max_candidates:
                picked.append((sched, tile))
    out: List[Candidate] = []
    for sched, (tm, tn, tk) in picked:
        ck = compile_gemm(m, n, k, schedule=sched,
                          tile={"m": tm, "n": tn, "k": tk},
                          machine=machine, want_torch=False,
                          want_cuda=False)
        # working set while one grid step is resident: operand tiles +
        # accumulator (the BlockSpec VMEM claim)
        if sched == "tpu_mxu":
            vmem = (tm * k + k * tn) * 4 + tm * tn * 4
        else:
            vmem = (tm * tk + tk * tn) * 4 + tm * tn * 4
        out.append(Candidate(
            schedule=sched, tile={"m": tm, "n": tn, "k": tk},
            cycles=ck.cycles.total, vmem_bytes=vmem,
            feasible=vmem <= machine.vmem_capacity_bytes))
    return sorted(out, key=Candidate.key)


@functools.lru_cache(maxsize=128)
def best_schedule(m: int, n: int, k: int,
                  machine: MachineModel = TPU_V5E
                  ) -> Tuple[str, Tuple[int, int, int]]:
    """Winner of the cost-model search for one problem shape *on one
    machine* — ``machine`` (a frozen, hashable dataclass) is part of the
    memoization key, so machines with different VMEM capacities or unit
    costs tune independently instead of silently reusing each other's
    schedules."""
    cands = enumerate_candidates(m, n, k, machine=machine)
    if not cands:
        return ("tpu_mxu_kgrid", (1, 1, 1))
    b = cands[0]
    return (b.schedule, (b.tile["m"], b.tile["n"], b.tile["k"]))


def compile_gemm_autotuned(m: int, n: int, k: int, *, dtype: str = "float32",
                           device: str = "cuda",
                           machine: MachineModel = TPU_V5E) -> CompiledKernel:
    """``compile_gemm`` at ``best_schedule``'s schedule and tiles, with its
    emitted CUDA kernel (``run_cuda``; the plain version on CPU tensors).
    ``device`` is where ``run_torch`` / ``run_cuda`` put numpy inputs."""
    sched, (tm, tn, tk) = best_schedule(m, n, k, machine=machine)
    return compile_gemm(m, n, k, schedule=sched,
                        tile={"m": tm, "n": tn, "k": tk}, dtype=dtype,
                        machine=machine, device=device, want_cuda=True)
