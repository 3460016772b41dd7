"""DSE — hardware design-space exploration over schedule programs × HwIR.

The paper's flow leaves the *choice* of schedule manual: generate RTL
for a hand-picked transformation, simulate it in Vivado, read off
cycles and utilisation, repeat.  ``autotune.py`` automated a slice of
that (GEMM tile sweep under one cost model); this module generalizes it
into compiler infrastructure:

  * a **design point** (:class:`DsePoint`) is a *schedule program* — a
    real pass-pipeline spec over the LoopIR scheduling passes (tile
    choices via ``lower{...}``, ``split`` + ``unroll`` replication,
    ``interchange``, ``vectorize``, ``fuse-epilogue``, ``set-space``
    memory placement, ``grid``) plus an optional HwIR-level knob
    pipeline (``set-sequencer`` — ``@fsm`` ↔ ``@stream``
    double-buffering).  Every point is a string the ``reproc`` driver
    can replay verbatim;
  * each point lowers through the **real pipeline** (``PassManager`` →
    scheduled ``Kernel`` → ``hw_ir.lower_to_hw`` → ``HwModule``), is
    priced *structurally* by ``machine_model.cycles``/``resources``,
    checked against a :class:`ResourceBudget`, and folded onto a
    cycles × area **Pareto frontier**;
  * the top frontier points are then **validated** the way the paper
    validates in Vivado: ``hw_sim.cosim`` executes the module
    cycle-accurately against the numpy oracle and cross-checks observed
    vs modeled cycles.

Before pricing, design points are deduplicated by **canonical form**
(:func:`dedupe_points`): two schedule programs whose canonicalized
kernels print identically are spellings of one design (e.g.
``grid{vars=2}`` vs ``grid{vars=3}`` when the extra grid loop has
extent 1), so only the first is priced — and every elimination is
recorded on ``DseResult.deduped`` and logged in the result table.
Candidate pricing is memoized in a persistent on-disk cache keyed by
(kernel text, machine, schedule program), and uncached points evaluate
in parallel.  The cache is this package's own (a ``torch`` directory
under the cache root and a package name in every key), so a parity test
against the JAX package never reads that package's cached pricing.
Entry points: :func:`explore` (library), ``CompiledKernel.explore()``
(artifact method), the ``dse`` pass (pipelines) and
``reproc --dse[=N] [--pareto-csv F]`` (CLI).

Legality is enforced, not assumed: ``vectorize`` candidates are only
generated for loops whose written tiles all depend on the loop variable
(SIMD lanes must write disjoint tiles; a reduction loop like GEMM's K
is *not* vectorizable, while it *is* unrollable — the paper's
flattening chains spatial MACs).

Beyond one kernel in isolation, :func:`explore_fleet` (implemented in
``core/fabric.py``, re-exported here) composes the per-kernel frontiers
this module computes into *fleet* candidates — which kernels get area,
how many copies of each — priced under crossbar contention against a
traffic mix and ranked on a throughput × total-area frontier.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from . import hw_ir, hw_sim, ir_text, machine_model
from .hw_ir import HwModule, HwStep
from .loop_ir import Kernel, Loop, MemSpace, _stmt_refs, _stmt_written_refs
from .machine_model import (TPU_V5E, CycleReport, MachineModel,
                            ResourceReport)
from .passes import PassError, PassManager
from .tensor_ir import Graph, dtype_bytes

# --------------------------------------------------------------------------
# area model — one scalar "hardware size" so the frontier is 2-D
# --------------------------------------------------------------------------

#: FF/LUT-equivalents per spatial datapath lane (a DSP slice + glue)
LANE_AREA = 64
#: BRAM bits are denser than register bits by roughly this factor
BRAM_BIT_DISCOUNT = 16
#: on-chip RAM is quantized in blocks (an 18Kb BRAM): a 4-byte
#: accumulator pushed to @vmem still burns a whole block
BRAM_BLOCK_BITS = 18 * 1024


def stream_dbuf_bytes(mod: HwModule) -> int:
    """Double-buffer RAM implied by ``@stream`` sequencers.

    The cycle model's overlap credit assumes the grid sequencer
    ping-pongs each step's off-chip tiles (a double-buffered grid
    DMA); that storage is real hardware, so the area model charges two
    copies of every HBM-port tile touched under a stream loop.
    """
    total = 0
    for node, _, trail in mod.walk():
        if not any(l.kind == "stream" for l in trail):
            continue
        if isinstance(node, HwStep):
            operands = node.operands
        elif isinstance(node, hw_ir.HwInstance):
            operands = node.portmap     # the call's HBM traffic ping-pongs
        else:
            continue
        for o in operands:
            if mod.space_of(o.target) == MemSpace.HBM:
                total += 2 * o.elems * dtype_bytes(
                    mod.storage(o.target).dtype)
    # a sub-module definition is one hardware instance however many call
    # states reference it, so its double buffers are paid once
    return total + sum(stream_dbuf_bytes(s) for s in mod.submodules)


def _bram_area(mod: HwModule) -> int:
    a = 0
    for mm in mod.mems:
        blocks = math.ceil(8 * mm.bytes / BRAM_BLOCK_BITS)
        a += blocks * BRAM_BLOCK_BITS // BRAM_BIT_DISCOUNT
    return a + sum(_bram_area(s) for s in mod.submodules)


def area(mod: HwModule) -> int:
    """Composite spatial footprint of a module, in FF/LUT-equivalents.

    summed lanes × :data:`LANE_AREA` over every declared unit (the DSP
    column — *summed*, not peak, so sharing a unit across FSM states and
    outlining a repeated subcircuit into one definition both shrink it)
    + architectural/counter/state register bits (the FF column) +
    input-mux overhead of time-multiplexed units + block-quantized RAM
    bits (the BRAM column, discounted per bit) + stream double-buffer
    RAM.  Sub-module definitions count once, however many call sites
    instance them.
    """
    a = (mod.total_lanes() * LANE_AREA + mod.register_bits()
         + mod.mux_bits())
    a += _bram_area(mod)
    a += 8 * stream_dbuf_bytes(mod) // BRAM_BIT_DISCOUNT
    return a


@dataclasses.dataclass(frozen=True)
class ResourceBudget:
    """Feasibility envelope — the FPGA-size analogue of the search."""

    max_lanes: int
    max_vmem_bytes: int
    max_reg_bits: int

    @classmethod
    def from_machine(cls, m: MachineModel) -> "ResourceBudget":
        return cls(max_lanes=m.mxu_dim * m.mxu_dim,
                   max_vmem_bytes=m.vmem_capacity_bytes,
                   max_reg_bits=64 * 1024 * 1024)

    def admits(self, res: ResourceReport, dbuf_bytes: int = 0) -> bool:
        return (res.compute_lanes <= self.max_lanes
                and res.vmem_bytes + dbuf_bytes <= self.max_vmem_bytes
                and res.reg_bits <= self.max_reg_bits)


# --------------------------------------------------------------------------
# design points
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DsePoint:
    """One candidate schedule program.

    ``pipeline`` takes the TensorIR graph to a scheduled LoopIR kernel;
    ``hw_pipeline`` (optional) applies HwIR-level knobs after
    ``lower-to-hw``.  ``spec`` is the single replayable pipeline string.
    """

    family: str
    pipeline: str
    hw_pipeline: str = ""

    @property
    def spec(self) -> str:
        s = f"{self.pipeline},lower-to-hw"
        if self.hw_pipeline:
            s += f",{self.hw_pipeline}"
        return s


@dataclasses.dataclass
class DseCandidate:
    """A priced design point."""

    point: DsePoint
    cycles: CycleReport
    resources: ResourceReport
    area: int
    dbuf_bytes: int
    feasible: bool
    on_frontier: bool = False
    cached: bool = False

    @property
    def key(self) -> Tuple[int, int]:
        return (self.cycles.total, self.area)


@dataclasses.dataclass
class DseValidation:
    """One cosim validation of a frontier point (the Vivado-sim leg)."""

    point: DsePoint
    ok: bool
    observed_cycles: int
    modeled_cycles: int
    max_abs_err: float
    detail: str = ""

    @property
    def cycle_dev_pct(self) -> float:
        if self.modeled_cycles <= 0:
            return 0.0
        return 100.0 * abs(self.observed_cycles - self.modeled_cycles) \
            / self.modeled_cycles


# --------------------------------------------------------------------------
# candidate enumeration
# --------------------------------------------------------------------------

#: tile edges tried for the grid-mapped (tpu_mxu-family) points
DEFAULT_TILES = (128, 64, 32, 16, 8)
#: spatial replication factors tried for split+unroll points
DEFAULT_UNROLL_FACTORS = (2, 4, 8, 16)


def _innermost(kernel: Kernel) -> Optional[Loop]:
    """Deepest loop with no nested loops (flatten-inner's target)."""
    best, depth_of = None, -1
    for s, depth, _ in kernel.walk():
        if isinstance(s, Loop) and not any(isinstance(b, Loop)
                                           for b in s.body):
            if depth > depth_of:
                depth_of, best = depth, s
    return best


def _perfect_pair(kernel: Kernel) -> Optional[Tuple[Loop, Loop]]:
    """Topmost perfectly-nested (outer, inner) loop pair, if any."""
    for s, _, _ in kernel.walk():
        if isinstance(s, Loop) and len(s.body) == 1 \
                and isinstance(s.body[0], Loop):
            return s, s.body[0]
    return None


def vectorize_legal(kernel: Kernel, loop: Loop) -> bool:
    """A loop is SIMD-legal iff every tile written under it is indexed
    by the loop variable (lanes write disjoint tiles).  A reduction
    loop (GEMM's K: the accumulator index is K-invariant) is not, and
    neither is any loop threading a carry (a ``ReduceTile`` running
    statistic, a ``ScanTile`` state row) — ``_stmt_written_refs``
    surfaces the carry as a written ref, so those loops fail the
    disjointness test here and ``schedule.vectorize`` raises on them."""
    def written_depends(stmts) -> bool:
        for s in stmts:
            if isinstance(s, Loop):
                if not written_depends(s.body):
                    return False
            else:
                for ref in _stmt_written_refs(s):
                    used = {v for e in ref.index for v, _ in e.coeffs}
                    if loop.var.name not in used:
                        return False
        return True
    return written_depends(loop.body)


def _lower_nested(graph: Graph) -> Kernel:
    return PassManager.parse("lower").run(graph).artifact


def canonical_key(graph: Graph, point: DsePoint,
                  machine: MachineModel = TPU_V5E,
                  hw: Optional[HwModule] = None) -> Optional[str]:
    """Canonical-form dedupe key of a design point: the canonicalized
    textual form of the *hardware* the point lowers to (HwIR knobs
    applied).  Two schedule programs with the same key describe one
    design — e.g. ``grid{vars=2}`` vs ``grid{vars=3}`` at full-dim
    tiles, whose extra trip-1 stream sequencer collapses away.

    Pass ``hw`` to key an already-built module (``explore`` builds each
    point once and reuses it for pricing); the module itself is never
    mutated (``canonical_text`` canonicalizes a re-parsed copy).
    Returns ``None`` when the point's pipeline fails — such points are
    kept so the caller records the real error.
    """
    from . import rewrite

    try:
        if hw is None:
            _, hw = build_point(graph, point, machine)
        return rewrite.canonical_text(hw)
    except (PassError, ValueError, KeyError):
        return None


def _dedupe_by_key(points: Sequence[DsePoint],
                   keys: Sequence[Optional[str]]
                   ) -> Tuple[List[int], List[Tuple[DsePoint, DsePoint]]]:
    """The one dedupe policy (first point with a key wins; ``None`` keys
    — failed builds — are never deduped): index-level so both the
    public :func:`dedupe_points` and :func:`explore` share it exactly.
    Returns ``(kept_indices, dropped_pairs)``."""
    seen: Dict[str, int] = {}
    keep: List[int] = []
    dropped: List[Tuple[DsePoint, DsePoint]] = []
    for i, (pt, key) in enumerate(zip(points, keys)):
        if key is not None and key in seen:
            dropped.append((pt, points[seen[key]]))
            continue
        if key is not None:
            seen[key] = i
        keep.append(i)
    return keep, dropped


def dedupe_points(graph: Graph, points: Sequence[DsePoint],
                  machine: MachineModel = TPU_V5E
                  ) -> Tuple[List[DsePoint], List[Tuple[DsePoint, DsePoint]]]:
    """Drop design points whose canonical form duplicates an earlier
    point's.  Returns ``(kept, dropped)`` where each dropped entry pairs
    the eliminated point with the kept point it duplicates — the caller
    logs every elimination (no silent shrinkage of the search space).

    Convenience wrapper (keys computed serially, uncached) over the same
    :func:`_dedupe_by_key` policy ``explore`` uses; explore itself keys
    off artifacts it already built and cached."""
    keys = [canonical_key(graph, pt, machine) for pt in points]
    keep, dropped = _dedupe_by_key(points, keys)
    return [points[i] for i in keep], dropped


def enumerate_points(graph: Graph,
                     tiles: Sequence[int] = DEFAULT_TILES,
                     unroll_factors: Sequence[int] = DEFAULT_UNROLL_FACTORS,
                     ) -> List[DsePoint]:
    """The search space: schedule families instantiated against the
    *actual* lowered structure of ``graph`` (loop names, extents and
    scratch buffers are discovered from the real nested lowering, so
    every generated pipeline replays verbatim)."""
    k = _lower_nested(graph)
    pts: List[DsePoint] = []

    # -- the two paper points ------------------------------------------------
    pts.append(DsePoint("nested", "lower"))
    inner = _innermost(k)
    if inner is not None:
        pts.append(DsePoint("inner_flattened", "lower,flatten-inner"))

    # -- split+unroll: partial spatial replication (unit replication N) ------
    if inner is not None:
        for f in unroll_factors:
            if f < inner.var.extent and inner.var.extent % f == 0:
                v = inner.var.name
                pts.append(DsePoint(
                    "split_unroll",
                    f"lower,split{{var={v},factor={f}}},"
                    f"unroll{{var={v}_i}}"))

    # -- interchange (only where it changes the trip structure) --------------
    pair = _perfect_pair(k)
    if pair is not None and pair[0].var.extent != pair[1].var.extent:
        pts.append(DsePoint(
            "interchange",
            f"lower,interchange{{outer={pair[0].var.name},"
            f"inner={pair[1].var.name}}}"))

    # -- vectorize (SIMD) every legal loop -----------------------------------
    for loop in k.loops():
        if not any(isinstance(s, Loop) for s in loop.body) \
                and vectorize_legal(k, loop):
            pts.append(DsePoint(
                "simd", f"lower,vectorize{{var={loop.var.name}}}"))

    # -- epilogue fusion on the scalar nest ----------------------------------
    if sum(1 for s in k.body if isinstance(s, Loop)) > 1:
        pts.append(DsePoint("nested_fused", "lower,fuse-epilogue"))

    # -- memory-space placement: accumulator VREG -> VMEM --------------------
    for b in k.scratch:
        if b.space == MemSpace.VREG:
            pts.append(DsePoint(
                "vmem_acc", f"lower,set-space{{buffer={b.name},space=vmem}}"))
            break

    # -- HwIR knob: re-sequence the outer loop as @stream (double buffer) ----
    tops = [s for s in k.body if isinstance(s, Loop)]
    if tops:
        outer = tops[0].var.name
        pts.append(DsePoint(
            "stream_outer", "lower",
            hw_pipeline=f"set-sequencer{{counter={outer},kind=stream}}"))
        if inner is not None:
            pts.append(DsePoint(
                "flat_stream", "lower,flatten-inner",
                hw_pipeline=f"set-sequencer{{counter={outer},kind=stream}}"))

    # -- resource sharing: outline repeats, time-multiplex units -------------
    # "shared" trades nothing (bindings at serial=1 fold duplicate units
    # behind muxes); "serialized" additionally lets wide units run on
    # narrow hardware, trading cycles for the smallest area on the
    # frontier.
    pts.append(DsePoint("shared", "lower",
                        hw_pipeline="canonicalize,set-sharing{mode=share}"))
    if inner is not None:
        pts.append(DsePoint(
            "flat_serialized", "lower,flatten-inner",
            hw_pipeline="canonicalize,set-sharing{mode=serialize}"))

    # -- grid-mapped MXU tilings (the TPU-native families) -------------------
    dims = [b.type.shape for b in k.params]
    flat_dims = sorted({d for shape in dims for d in shape})
    for t in tiles:
        if not all(d % t == 0 for shape in dims for d in shape) or \
                t > min(flat_dims):
            continue
        lowered = f"lower{{tile_m={t},tile_n={t},tile_k={t}}},fuse-epilogue"
        pts.append(DsePoint("tpu_mxu", f"{lowered},grid{{vars=2}}"))
        pts.append(DsePoint("tpu_mxu_kgrid", f"{lowered},grid{{vars=3}}"))
    return pts


# --------------------------------------------------------------------------
# pricing (with the persistent candidate cache)
# --------------------------------------------------------------------------


def _default_cache_dir() -> str:
    """``$STAGECC_DSE_CACHE`` or ``~/.cache/stagecc/dse`` (the JAX
    package's root), with this package's entries in a ``torch``
    directory beneath it."""
    root = os.environ.get("STAGECC_DSE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "stagecc", "dse")
    return os.path.join(root, "torch")


def _cache_key(graph_text: str, machine: MachineModel,
               point: DsePoint, budget: ResourceBudget) -> str:
    blob = "\x1f".join(("dse-v2", "repro_torch", graph_text, repr(machine),
                        point.spec, repr(budget)))
    return hashlib.sha256(blob.encode()).hexdigest()


def _cache_load(path: str, point: DsePoint
                ) -> Tuple[Optional[DseCandidate], Optional[str]]:
    """Load a cached pricing plus its canonical dedupe key (the key
    rides in the cache so a warm explore never recompiles a point).
    Deduped points cache a key-only entry: ``(None, key)``."""
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None, None               # corrupt/missing entry
    if not isinstance(d, dict):
        return None, None               # valid JSON, wrong shape
    key = d.get("canonical_key")
    try:
        cand = DseCandidate(
            point=point, cycles=CycleReport(**d["cycles"]),
            resources=ResourceReport(**d["resources"]), area=d["area"],
            dbuf_bytes=d["dbuf_bytes"], feasible=d["feasible"], cached=True)
    except (ValueError, KeyError, TypeError):
        cand = None                     # key-only entry (or stale format)
    return cand, key


def _cache_store(path: str, cand: Optional[DseCandidate],
                 canonical_key: Optional[str] = None,
                 point: Optional[DsePoint] = None) -> None:
    """Persist a pricing (or, with ``cand=None``, just a point's
    canonical key — enough for the next explore to dedupe it without
    recompiling)."""
    pt = cand.point if cand is not None else point
    entry = {"spec": pt.spec, "family": pt.family,
             "canonical_key": canonical_key}
    if cand is not None:
        entry.update({
            "cycles": dataclasses.asdict(cand.cycles),
            "resources": dataclasses.asdict(cand.resources),
            "area": cand.area, "dbuf_bytes": cand.dbuf_bytes,
            "feasible": cand.feasible})
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f)
        os.replace(tmp, path)
    except OSError:
        pass                            # cache is best-effort


def build_point(graph: Graph, point: DsePoint,
                machine: MachineModel = TPU_V5E
                ) -> Tuple[Kernel, HwModule]:
    """Replay a design point through the real pipeline: Graph →
    scheduled Kernel → HwModule (+ HwIR knob passes)."""
    kernel = PassManager.parse(point.pipeline).run(graph).artifact
    if not isinstance(kernel, Kernel):
        raise PassError(f"point {point.spec!r} did not produce a Kernel")
    hw = hw_ir.lower_to_hw(kernel, mxu_min_dim=machine.mxu_min_dim)
    if point.hw_pipeline:
        hw = PassManager.parse(point.hw_pipeline).run(hw).artifact
    return kernel, hw


def evaluate(graph: Graph, point: DsePoint, machine: MachineModel,
             budget: ResourceBudget,
             built: Optional[Tuple[Kernel, HwModule]] = None) -> DseCandidate:
    """Price one design point structurally (no execution).  ``built``
    reuses an already-lowered (kernel, hw) pair instead of recompiling
    (``explore`` builds each point exactly once)."""
    _, hw = built if built is not None else \
        build_point(graph, point, machine)
    cyc = machine_model.cycles(hw, machine)
    try:
        res = machine_model.resources(hw, machine)
        over_capacity = False
    except ResourceWarning:
        # RAM footprint exceeds the machine: reconstruct the report
        # structurally and mark the point infeasible
        res = ResourceReport(
            compute_lanes=hw.lane_count(), vmem_bytes=hw.mem_bytes(),
            vreg_tiles=0, fsm_states=hw.fsm_state_count(),
            reg_bits=hw.register_bits(), total_lanes=hw.total_lanes(),
            mux_bits=hw.mux_bits(), shared_units=hw.shared_unit_count())
        over_capacity = True
    dbuf = stream_dbuf_bytes(hw)
    return DseCandidate(
        point=point, cycles=cyc, resources=res, area=area(hw),
        dbuf_bytes=dbuf,
        feasible=not over_capacity and budget.admits(res, dbuf))


# --------------------------------------------------------------------------
# Pareto frontier
# --------------------------------------------------------------------------


def dominates(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    """Strict Pareto domination on (cycles, area): no worse on both,
    strictly better on at least one.  Equal points do not dominate."""
    return a[0] <= b[0] and a[1] <= b[1] and a != b


def pareto_frontier(cands: Sequence[DseCandidate]) -> List[DseCandidate]:
    """Non-dominated feasible candidates, fastest first."""
    feas = [c for c in cands if c.feasible]
    front = [c for c in feas
             if not any(dominates(o.key, c.key) for o in feas)]
    return sorted(front, key=lambda c: c.key)


# --------------------------------------------------------------------------
# the explorer
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DseResult:
    graph_name: str
    machine: MachineModel
    budget: ResourceBudget
    candidates: List[DseCandidate]
    errors: List[Tuple[DsePoint, str]]
    validations: List[DseValidation]
    #: (eliminated, kept) pairs from the canonical-form dedupe — every
    #: shrink of the explored space is recorded, never silent
    deduped: List[Tuple[DsePoint, DsePoint]] = \
        dataclasses.field(default_factory=list)

    @property
    def frontier(self) -> List[DseCandidate]:
        return sorted((c for c in self.candidates if c.on_frontier),
                      key=lambda c: c.key)

    def best(self) -> Optional[DseCandidate]:
        front = self.frontier
        return front[0] if front else None

    # ---- rendering ---------------------------------------------------------

    def table(self) -> str:
        rows = [f"// dse {self.graph_name} on {self.machine.name}: "
                f"{len(self.candidates)} candidates "
                f"({sum(c.cached for c in self.candidates)} cached, "
                f"{len(self.errors)} failed, "
                f"{len(self.deduped)} deduped), "
                f"{len(self.frontier)} on the Pareto frontier"]
        if self.deduped:
            total = len(self.candidates) + len(self.errors) \
                + len(self.deduped)
            rows.append(f"// canonical-form dedupe eliminated "
                        f"{len(self.deduped)} of {total} design points "
                        f"before pricing:")
            for gone, kept in self.deduped:
                rows.append(f"//   dedupe {gone.family}: {gone.spec}  ==  "
                            f"{kept.family}: {kept.spec}")
        hdr = (f"{'':2s}{'FAMILY':16s} {'CYCLES':>12s} {'AREA':>10s} "
               f"{'LANES':>6s} {'REGBITS':>8s} {'VMEM':>7s} {'FSM':>5s}  "
               f"SCHEDULE PROGRAM")
        rows.append(hdr)
        for c in sorted(self.candidates, key=lambda c: c.key):
            mark = "* " if c.on_frontier else ("  " if c.feasible else "! ")
            rows.append(
                f"{mark}{c.point.family:16s} {c.cycles.total:>12,} "
                f"{c.area:>10,} {c.resources.compute_lanes:>6,} "
                f"{c.resources.reg_bits:>8,} {c.resources.vmem_bytes:>7,} "
                f"{c.resources.fsm_states:>5,}  {c.point.spec}")
        rows.append("// '*' = Pareto frontier (cycles x area), "
                    "'!' = infeasible under the resource budget")
        for v in self.validations:
            status = "ok" if v.ok else "FAIL"
            rows.append(
                f"// cosim {v.point.family:16s} [{status}] "
                f"observed={v.observed_cycles:,} "
                f"modeled={v.modeled_cycles:,} "
                f"(dev {v.cycle_dev_pct:.2f}%) "
                f"max|err|={v.max_abs_err:.2e}"
                + (f"  {v.detail}" if v.detail else ""))
        for pt, msg in self.errors:
            rows.append(f"// error {pt.family}: {pt.spec}: {msg}")
        return "\n".join(rows)

    def to_csv(self) -> str:
        lines = ["family,spec,cycles,compute,memory,control,lanes,"
                 "reg_bits,vmem_bytes,fsm_states,area,dbuf_bytes,"
                 "feasible,on_frontier,validated,observed_cycles,"
                 "max_abs_err,total_lanes,mux_bits,shared_units"]
        vmap = {v.point.spec: v for v in self.validations}
        for c in sorted(self.candidates, key=lambda c: c.key):
            v = vmap.get(c.point.spec)
            lines.append(",".join(str(x) for x in (
                c.point.family, f'"{c.point.spec}"', c.cycles.total,
                c.cycles.compute, c.cycles.memory, c.cycles.control,
                c.resources.compute_lanes, c.resources.reg_bits,
                c.resources.vmem_bytes, c.resources.fsm_states, c.area,
                c.dbuf_bytes, int(c.feasible), int(c.on_frontier),
                int(v is not None and v.ok),
                v.observed_cycles if v else "",
                f"{v.max_abs_err:.3e}" if v else "",
                c.resources.total_lanes, c.resources.mux_bits,
                c.resources.shared_units)))
        return "\n".join(lines) + "\n"


def validate_point(graph: Graph, cand: DseCandidate,
                   machine: MachineModel, seed: int = 0,
                   atol: float = 1e-5,
                   cycle_tol_pct: float = 10.0) -> DseValidation:
    """Co-simulate one candidate against the numpy oracle (the Vivado
    simulation leg of the closed loop).

    ``ok`` requires *both* checks: outputs within ``atol`` of the
    oracle, and observed cycles within ``cycle_tol_pct`` percent of the
    structural model (the same gate the ``simulate`` pass applies — a
    frontier priced by a model the simulation contradicts is not a
    frontier).
    """
    kernel, hw = build_point(graph, cand.point, machine)
    inputs = hw_sim.random_inputs(hw, seed=seed)
    try:
        rep = hw_sim.cosim(hw, kernel, inputs, machine=machine,
                           modeled=cand.cycles.total, atol=atol)
    except hw_sim.SimError as e:
        return DseValidation(point=cand.point, ok=False,
                             observed_cycles=0,
                             modeled_cycles=cand.cycles.total,
                             max_abs_err=float("nan"), detail=str(e))
    v = DseValidation(point=cand.point, ok=True,
                      observed_cycles=rep.observed_cycles,
                      modeled_cycles=rep.modeled_cycles,
                      max_abs_err=rep.max_abs_err)
    if v.cycle_dev_pct > cycle_tol_pct:
        v.ok = False
        v.detail = (f"observed cycles deviate {v.cycle_dev_pct:.1f}% "
                    f"from modeled (> {cycle_tol_pct:g}%)")
    return v


def explore(graph: Graph, machine: MachineModel = TPU_V5E,
            budget: Optional[ResourceBudget] = None,
            tiles: Sequence[int] = DEFAULT_TILES,
            validate_top: int = 0,
            workers: Optional[int] = None,
            cache_dir: Optional[str] = None,
            use_cache: bool = True,
            seed: int = 0, atol: float = 1e-5,
            cycle_tol_pct: float = 10.0) -> DseResult:
    """Run the full DSE loop: enumerate → price (parallel, cached) →
    Pareto → validate the ``validate_top`` fastest frontier points.
    """
    graph.verify()
    budget = budget or ResourceBudget.from_machine(machine)
    points = enumerate_points(graph, tiles=tiles)
    gtext = ir_text.print_ir(graph)
    cdir = cache_dir or _default_cache_dir()
    nworkers = workers or min(8, os.cpu_count() or 1)

    def path_of(i: int) -> str:
        return os.path.join(cdir, _cache_key(gtext, machine, points[i],
                                             budget) + ".json")

    cands: List[Optional[DseCandidate]] = [None] * len(points)
    ckeys: List[Optional[str]] = [None] * len(points)
    errors: List[Tuple[DsePoint, str]] = []
    failed: set = set()
    built: Dict[int, Tuple[Kernel, HwModule]] = {}

    to_build: List[int] = []
    for i, pt in enumerate(points):
        if use_cache:
            cands[i], ckeys[i] = _cache_load(path_of(i), pt)
        if ckeys[i] is None:
            to_build.append(i)

    # build every uncached point exactly once (parallel); the lowered
    # artifacts feed both the canonical dedupe key and the pricing below
    def build(i: int) -> None:
        try:
            built[i] = build_point(graph, points[i], machine)
            ckeys[i] = canonical_key(graph, points[i], machine,
                                     hw=built[i][1])
        except (PassError, ValueError, KeyError) as e:
            errors.append((points[i], str(e)))
            failed.add(i)

    if to_build:
        with ThreadPoolExecutor(max_workers=nworkers) as ex:
            list(ex.map(build, to_build))

    # canonical-form dedupe *before* pricing — every elimination logged
    # (failed builds sit in `errors`, not in the dedupe or the pricing)
    kept_idx, deduped = _dedupe_by_key(
        points, [None if i in failed else k for i, k in enumerate(ckeys)])
    keep = [i for i in kept_idx if i not in failed]
    dropped_idx = set(range(len(points))) - set(kept_idx)
    if use_cache:
        for i in dropped_idx & set(to_build):
            # key-only entry: the next explore dedupes this point
            # straight from the cache, compiling nothing
            _cache_store(path_of(i), None, ckeys[i], point=points[i])

    def price(i: int) -> Optional[DseCandidate]:
        try:
            return evaluate(graph, points[i], machine, budget,
                            built=built.get(i))
        except (PassError, ValueError, KeyError) as e:
            errors.append((points[i], str(e)))
            return None

    to_price = [i for i in keep if cands[i] is None]
    if to_price:
        with ThreadPoolExecutor(max_workers=nworkers) as ex:
            for i, cand in zip(to_price, ex.map(price, to_price)):
                cands[i] = cand
                if cand is not None and use_cache:
                    _cache_store(path_of(i), cand, ckeys[i])
    if use_cache:
        # refresh pre-canonical-key cache entries so the next explore is
        # fully warm (no rebuild just to recover the dedupe key)
        for i in keep:
            if i in to_build and cands[i] is not None and cands[i].cached:
                _cache_store(path_of(i), cands[i], ckeys[i])

    priced = [cands[i] for i in keep if cands[i] is not None]
    for c in pareto_frontier(priced):
        c.on_frontier = True

    validations: List[DseValidation] = []
    if validate_top:
        front = pareto_frontier(priced)
        for cand in front[:validate_top]:
            validations.append(validate_point(
                graph, cand, machine, seed=seed, atol=atol,
                cycle_tol_pct=cycle_tol_pct))
    return DseResult(graph_name=graph.name, machine=machine, budget=budget,
                     candidates=priced, errors=errors,
                     validations=validations, deduped=deduped)


def explore_fleet(graphs, mix, **kwargs):
    """Fleet-level DSE: optimize N kernels sharing one crossbar against
    a traffic mix under a total :class:`ResourceBudget` — per-kernel
    frontiers from :func:`explore`, fleets priced by the fabric machine
    model under contention, ranked on requests/s × total area, top
    points validated by the fabric event simulator.  Implemented in
    :mod:`repro_torch.core.fabric`; see
    :func:`repro_torch.core.fabric.explore_fleet` for the parameters."""
    from .fabric import explore_fleet as _explore_fleet

    return _explore_fleet(graphs, mix, **kwargs)
