"""Subcircuit outlining + time-multiplexed resource sharing over HwIR.

The two transforms that turn the flat, replicate-per-use hardware form
into the hierarchical, shared-resource form (the XLS / ripple-ir
direction named in ROADMAP):

  * :class:`OutlineSubcircuits` — a rewrite-driver pattern that hashes
    the canonical textual form of every control subtree (storage names
    anonymised to positional ports, units and counters renamed, address
    generators normalised) and outlines structurally repeated subtrees
    into one sub-module definition + :class:`~repro_torch.core.hw_ir.HwInstance`
    call states.  The repeated datapath is then *declared once*, however
    many call sites reference it.

  * :func:`share_units` — a port-conflict-aware binding scheduler: unit
    declarations of the same kind whose uses sit in different FSM states
    (one control program = one state active at a time, so distinct steps
    provably never drive a unit's ports concurrently) fold onto one
    shared physical unit via the module's binding table.  Where the
    physical unit provides fewer spatial copies than a virtual user was
    lowered with, the binding carries ``serial > 1`` — the activation
    serialises into rounds, and *both* ``machine_model.cycles`` and
    ``hw_sim`` charge the same per-invocation stall, so cosim stays
    within tolerance with sharing enabled.

``set_sharing`` packages both behind one DSE knob (``none`` / ``share``
/ ``serialize``); the passes register as ``outline-subcircuits``,
``share-units`` and ``set-sharing`` at the hw level.  Neither transform
joins the canonicalize pattern set: sharing is a *scheduling decision*
(it trades mux overhead and serial rounds for area), not a canonical
form, so the DSE chooses it per design point.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .hw_ir import (HwBinding, HwCtrl, HwInstance, HwLoop, HwModule,
                    HwOperand, HwPort, HwStep, HwUnit)
from .loop_ir import AffineExpr
from .rewrite import (Pattern, RewriteDriver, RewriteStats, _publish,
                      _prune_unused_units, normalize_affine)

#: port direction <-> operand role, both ways
ROLE_OF_DIRECTION = {"in": "read", "out": "write", "inout": "acc"}


# --------------------------------------------------------------------------
# canonical subtree signatures
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _SubtreeInfo:
    """An outlineable control subtree, anonymised into a sub-module."""

    module: HwModule                 # the anonymised definition ("sub")
    signature: str                   # its canonical textual form
    storages: List[str]              # parent storage names, port order
    directions: List[str]            # port direction per storage


def _subtree_info(loop: HwLoop, mod: HwModule) -> Optional[_SubtreeInfo]:
    """Anonymise the subtree rooted at ``loop`` into a candidate
    sub-module, or ``None`` when it is not outlineable: it contains an
    instance already, references a bound (shared) unit, or reads a
    counter of an *enclosing* loop (the instance call site binds no
    counters, so free counters have no meaning inside the definition).
    """
    storages: List[str] = []         # first-use order -> p0, p1, ...
    roles: Dict[str, set] = {}
    units: List[str] = []            # first-use order -> u0, u1, ...
    counters: List[str] = []         # pre-order       -> c0, c1, ...
    bound: set = set()
    ok = True

    def scan(nodes: Sequence[HwCtrl]) -> None:
        nonlocal ok
        for n in nodes:
            if not ok:
                return
            if isinstance(n, HwInstance):
                ok = False
                return
            if isinstance(n, HwLoop):
                counters.append(n.counter)
                bound.add(n.counter)
                scan(n.body)
                continue
            if mod.binding_of(n.unit) is not None:
                ok = False
                return
            if n.unit not in units:
                units.append(n.unit)
            for o in n.operands:
                if o.target not in storages:
                    storages.append(o.target)
                roles.setdefault(o.target, set()).add(o.role)
                for e in o.index:
                    for v, _ in e.coeffs:
                        if v not in bound:
                            ok = False   # free counter
                            return

    scan([loop])
    if not ok:
        return None
    pmap = {n: f"p{i}" for i, n in enumerate(storages)}
    umap = {n: f"u{i}" for i, n in enumerate(units)}
    cmap = {n: f"c{i}" for i, n in enumerate(counters)}

    def rebuild(nodes: Sequence[HwCtrl]) -> List[HwCtrl]:
        out: List[HwCtrl] = []
        for n in nodes:
            if isinstance(n, HwLoop):
                out.append(HwLoop(cmap[n.counter], n.trips, n.kind,
                                  rebuild(n.body)))
            else:
                ops = [HwOperand(
                    o.role, pmap[o.target], tuple(o.tile),
                    tuple(normalize_affine(AffineExpr(
                        tuple((cmap[v], s) for v, s in e.coeffs), e.const))
                        for e in o.index))
                    for o in n.operands]
                out.append(HwStep(n.op, umap[n.unit], ops))
        return out

    directions = []
    ports = []
    for name in storages:
        rs = roles[name]
        if "acc" in rs or ("read" in rs and "write" in rs):
            dirn = "inout"
        elif "write" in rs:
            dirn = "out"
        else:
            dirn = "in"
        directions.append(dirn)
        d = mod.storage(name)
        ports.append(HwPort(pmap[name], dirn, d.dtype, tuple(d.shape),
                            mod.space_of(name).value))
    decls = [dataclasses.replace(mod.unit(n), name=umap[n]) for n in units]
    sub = HwModule("sub", ports=ports, regs=[], mems=[], units=decls,
                   ctrl=rebuild([loop]))
    from . import ir_text
    return _SubtreeInfo(module=sub,
                        signature=ir_text.print_hw_module(sub),
                        storages=storages, directions=directions)


def _iter_with_parents(nodes: List[HwCtrl]):
    """Yield ``(node, containing_list)`` over a control forest."""
    for n in nodes:
        yield n, nodes
        if isinstance(n, HwLoop):
            yield from _iter_with_parents(n.body)


def _instance_for(info: _SubtreeInfo, name: str, mod: HwModule) -> HwInstance:
    """Call-site state for one occurrence: each port binds the whole of
    the occurrence's storage (zero block index, full-shape tile)."""
    ops = []
    for target, dirn in zip(info.storages, info.directions):
        shape = tuple(mod.storage(target).shape)
        ops.append(HwOperand(ROLE_OF_DIRECTION[dirn], target, shape,
                             tuple(AffineExpr((), 0) for _ in shape)))
    return HwInstance(name, ops)


class OutlineSubcircuits(Pattern):
    """Outline structurally repeated control subtrees into one sub-module
    definition instanced from every occurrence: subtrees whose canonical
    anonymised form (storages as positional ports, units/counters
    renamed, address generators normalised) prints identically become
    one declaration + N call states, so the repeated datapath pays area
    once."""

    name = "outline-subcircuits"

    def match_and_rewrite(self, parent, siblings, i, root):
        loop = siblings[i]
        if not isinstance(loop, HwLoop) or not isinstance(root, HwModule):
            return None
        info = _subtree_info(loop, root)
        if info is None:
            return None
        # every other occurrence of the same canonical subtree, anywhere
        # in the control tree (equal signatures have equal size, so
        # occurrences are always disjoint)
        occs = []
        for node, holder in _iter_with_parents(root.ctrl):
            if node is loop or not isinstance(node, HwLoop):
                continue
            other = _subtree_info(node, root)
            if other is not None and other.signature == info.signature:
                occs.append((node, holder, other))
        if not occs:
            return None
        taken = {s.name for s in root.submodules}
        n = 0
        while f"sub{n}" in taken:
            n += 1
        info.module.name = f"sub{n}"
        root.submodules.append(info.module)
        for node, holder, other in occs:
            j = next(j for j, x in enumerate(holder) if x is node)
            holder[j] = _instance_for(other, info.module.name, root)
        return (1, [_instance_for(info, info.module.name, root)])


def outline_subcircuits(mod: HwModule) -> HwModule:
    """Run :class:`OutlineSubcircuits` to a fixpoint and prune the unit
    declarations the outlined occurrences orphaned (each occurrence's
    private units are re-declared once inside the definition)."""
    RewriteDriver([OutlineSubcircuits()], max_iterations=8).run(mod)
    pruned = _prune_unused_units(mod)
    if pruned:
        _publish(RewriteStats(hits={"prune-unused-unit": pruned}))
    mod.verify()
    return mod


# --------------------------------------------------------------------------
# the binding scheduler
# --------------------------------------------------------------------------


def share_units(mod: HwModule, max_copies: int = 0) -> HwModule:
    """Time-multiplex datapath units across FSM states via the binding
    table.

    Port-conflict analysis: two steps can share a physical unit iff
    their activations are provably non-overlapping.  Within one control
    program exactly one FSM state is active per cycle, so *distinct
    steps never conflict* — what can conflict are the spatial copies
    *inside* one activation.  The scheduler therefore folds same-kind
    units whose per-copy geometry fits under a representative
    (elementwise ``rep >= member``), keeps enough physical copies to
    cover the widest member (conflict-free in space), and when
    ``max_copies`` clamps below that, serialises the surplus copies into
    ``serial`` rounds — muxing the unit's input buses between rounds
    instead of replicating the datapath.  Every fold is recorded as a
    binding row; steps keep their virtual names, and the pricing /
    simulation layers resolve (and charge) the binding.

    ``max_copies=0`` means "never serialise" (pure sharing); the
    ``serialize`` sharing mode passes 1.  Idempotent: already-bound
    units are never re-folded.
    """
    made = _share_one(mod, max_copies)
    if made:
        _publish(RewriteStats(hits={"bind-shared-unit": made}))
    mod.verify()
    return mod


def _share_one(mod: HwModule, max_copies: int) -> int:
    made = 0
    for sub in mod.submodules:
        made += _share_one(sub, max_copies)
    used = {s.unit for s in mod.steps()}
    phys = {b.unit for b in mod.bindings}
    direct = [u for u in mod.units if u.name in used and u.name not in phys]
    by_kind: Dict[str, List[HwUnit]] = {}
    for u in direct:
        by_kind.setdefault(u.kind, []).append(u)
    taken = ({u.name for u in mod.units}
             | {b.virtual for b in mod.bindings}
             | {d.name for d in mod.ports + mod.regs + mod.mems})
    for kind in sorted(by_kind):
        remaining = sorted(by_kind[kind], key=lambda u: (-u.lanes, u.name))
        while remaining:
            rep = remaining[0]
            members = [u for u in remaining
                       if len(u.geometry) == len(rep.geometry)
                       and all(a >= b for a, b in
                               zip(rep.geometry, u.geometry))]
            mnames = {u.name for u in members}
            remaining = [u for u in remaining if u.name not in mnames]
            maxc = max(u.copies for u in members)
            copies = maxc if max_copies <= 0 else min(maxc, max_copies)
            if len(members) < 2 and copies >= maxc:
                continue            # nothing saved by a 1:1 rebind
            n = 0
            while f"{kind}_shared{n}" in taken:
                n += 1
            pname = f"{kind}_shared{n}"
            taken.add(pname)
            for u in sorted(members, key=lambda u: u.name):
                mod.bindings.append(HwBinding(
                    u.name, pname, math.ceil(u.copies / copies), u.copies))
                made += 1
            mod.units = ([u for u in mod.units if u.name not in mnames]
                         + [HwUnit(pname, kind, rep.geometry, copies)])
    return made


# --------------------------------------------------------------------------
# the DSE knob
# --------------------------------------------------------------------------

SHARING_MODES = ("none", "share", "serialize")


def set_sharing(mod: HwModule, mode: str = "share") -> HwModule:
    """Apply one of the three sharing policies to a hardware module:

    * ``none``      — leave the flat, replicate-per-use form alone;
    * ``share``     — outline repeated subcircuits and fold same-kind
      units, keeping enough physical copies that nothing serialises
      (area drops, cycles unchanged);
    * ``serialize`` — additionally clamp every shared unit to one
      physical copy, trading serial rounds (priced in ``cycles``) for
      the smallest datapath.
    """
    if mode not in SHARING_MODES:
        raise ValueError(f"set-sharing: unknown mode {mode!r}; choose "
                         f"from {'/'.join(SHARING_MODES)}")
    if mode == "none":
        return mod
    outline_subcircuits(mod)
    return share_units(mod, max_copies=0 if mode == "share" else 1)
