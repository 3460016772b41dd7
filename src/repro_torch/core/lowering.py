"""TensorIR -> LoopIR lowering (the MLIR -> Calyx step of the paper's Fig. 1).

Each TensorIR op lowers to a canonical *nested sequential* loop nest over
tiles — the direct analogue of the paper's "nested for-loop" baseline
schedule, where a single time-multiplexed datapath walks the iteration
space.  All scheduling (tiling choice aside) is left to subsequent passes
in ``schedule.py``; this separation of lowering from scheduling is the
reusability property the paper argues for.

Tile sizes default to 1 (fully scalar — what Calyx generates from the
paper's MLIR in Fig. 2) and can be set per-op for MXU-shaped lowering.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .loop_ir import (AffineExpr, Buffer, EwiseTile, FillTile, Kernel, Loop,
                      LoopKind, LoopVar, MatmulTile, MemSpace, ReduceTile,
                      ScanTile, TileRef, ZeroTile)
from .tensor_ir import Graph, Op, TensorType, Value, reduce_identity


def fit_tile(tile: int, dim: int) -> int:
    """Largest divisor of ``dim`` that is <= ``tile`` (always >= 1)."""
    t = min(tile, dim)
    while dim % t:
        t -= 1
    return t


@dataclasses.dataclass
class LoweringOptions:
    """Tiling choices consumed at lowering time (like linalg tiling)."""

    tile_m: int = 1
    tile_n: int = 1
    tile_k: int = 1
    # accumulate in a VREG tile instead of writing C through HBM each k-step
    use_accumulator: bool = True

    def clamp(self, m: int, n: int, k: int) -> "LoweringOptions":
        return LoweringOptions(tile_m=fit_tile(self.tile_m, m),
                               tile_n=fit_tile(self.tile_n, n),
                               tile_k=fit_tile(self.tile_k, k),
                               use_accumulator=self.use_accumulator)


_EWISE_BIN = {"add", "sub", "mul", "maximum", "div"}
_EWISE_UN = {"relu", "gelu", "exp", "neg",
             "tanh", "sigmoid", "sqrt", "rsqrt", "log1p", "abs"}


class _Lowerer:
    def __init__(self, graph: Graph, opts: LoweringOptions):
        graph.verify()
        self.graph = graph
        self.opts = opts
        self.buffers: Dict[int, Buffer] = {}
        self.scratch: List[Buffer] = []
        self.body: List[Stmt] = []  # type: ignore[name-defined]
        self._uid = 0

    def uid(self, hint: str) -> str:
        self._uid += 1
        return f"{hint}{self._uid}"

    def buf_for(self, v: Value, space: MemSpace = MemSpace.HBM) -> Buffer:
        if id(v) not in self.buffers:
            self.buffers[id(v)] = Buffer(v.name, v.type, space)
        return self.buffers[id(v)]

    # ---- op lowerings ------------------------------------------------------

    def lower_matmul(self, op: Op) -> None:
        a, b = op.inputs
        c = op.result
        M, K = a.type.shape
        _, N = b.type.shape
        o = self.opts.clamp(M, N, K)
        A, B, C = self.buf_for(a), self.buf_for(b), self.buf_for(c)

        i = LoopVar(self.uid("i"), M // o.tile_m)
        j = LoopVar(self.uid("j"), N // o.tile_n)
        k = LoopVar(self.uid("k"), K // o.tile_k)

        ij = (AffineExpr.of(i), AffineExpr.of(j))
        a_ref = TileRef(A, (AffineExpr.of(i), AffineExpr.of(k)), (o.tile_m, o.tile_k))
        b_ref = TileRef(B, (AffineExpr.of(k), AffineExpr.of(j)), (o.tile_k, o.tile_n))

        if o.use_accumulator:
            acc = Buffer(self.uid("acc"), TensorType((o.tile_m, o.tile_n), c.type.dtype),
                         MemSpace.VREG)
            self.scratch.append(acc)
            zero = (AffineExpr.of(None), AffineExpr.of(None))
            acc_ref = TileRef(acc, zero, (o.tile_m, o.tile_n))
            c_ref = TileRef(C, ij, (o.tile_m, o.tile_n))
            kloop = Loop(k, LoopKind.SEQUENTIAL,
                         [MatmulTile(acc_ref, a_ref, b_ref, accumulate=True)])
            inner = [ZeroTile(acc_ref), kloop,
                     EwiseTile("copy", c_ref, [acc_ref])]
        else:
            c_ref = TileRef(C, ij, (o.tile_m, o.tile_n))
            kloop = Loop(k, LoopKind.SEQUENTIAL,
                         [MatmulTile(c_ref, a_ref, b_ref, accumulate=True)])
            inner = [ZeroTile(c_ref), kloop]

        nest = Loop(i, LoopKind.SEQUENTIAL, [Loop(j, LoopKind.SEQUENTIAL, inner)])
        self.body.append(nest)

    def lower_ewise(self, op: Op) -> None:
        out = op.result
        O = self.buf_for(out)
        shape = out.type.shape

        # tile the trailing two dims like the matmul output (tile_m, tile_n)
        # so elementwise epilogues walk the same tile grid as the producer
        # and ``fuse_epilogue`` can merge the nests.
        tiles = [1] * len(shape)
        if shape:
            tiles[-1] = fit_tile(self.opts.tile_n, shape[-1])
        if len(shape) >= 2:
            tiles[-2] = fit_tile(self.opts.tile_m, shape[-2])
        loop_vars = [LoopVar(self.uid("e"), shape[d] // tiles[d])
                     for d in range(len(shape))]
        idx = tuple(AffineExpr.of(v) for v in loop_vars)
        dst = TileRef(O, idx, tuple(tiles))
        srcs = []
        for v in op.inputs:
            buf = self.buf_for(v)
            if v.type.shape == shape:
                srcs.append(TileRef(buf, idx, tuple(tiles)))
            elif op.opname == "bias_add" and v.type.rank == 1:
                srcs.append(TileRef(buf, (idx[-1],), (tiles[-1],)))
            elif v.type.rank == len(shape) and \
                    all(db == da or db == 1
                        for da, db in zip(shape, v.type.shape)):
                # size-1 broadcast dims (per-row softmax statistics):
                # pin the index to 0 and the tile to 1 on those dims
                bidx = tuple(idx[d] if v.type.shape[d] == shape[d]
                             else AffineExpr.of(None)
                             for d in range(len(shape)))
                btile = tuple(tiles[d] if v.type.shape[d] == shape[d] else 1
                              for d in range(len(shape)))
                srcs.append(TileRef(buf, bidx, btile))
            else:
                raise NotImplementedError(
                    f"broadcast lowering for {op.opname} {v.type} vs {shape}")
        name = {"bias_add": "add"}.get(op.opname, op.opname)
        stmt: Stmt = EwiseTile(name, dst, srcs)  # type: ignore[name-defined]
        for v in reversed(loop_vars):
            stmt = Loop(v, LoopKind.SEQUENTIAL, [stmt])
        self.body.append(stmt)

    def lower_reduce_sum(self, op: Op) -> None:
        """Row reduction over the last axis: (M, N) -> (M,).

        Lowered as a matmul against a ones-vector — the GEMM-ification of
        reductions (the MXU *is* the reduction tree on TPU), mirroring how
        the paper's future work folds tensor ops onto its GEMM datapath.
        """
        (src,) = op.inputs
        if src.type.rank != 2 or op.attrs.get("axis") != 1:
            raise NotImplementedError(
                "reduce_sum lowering supports rank-2, axis=1")
        M, N = src.type.shape
        o = self.opts.clamp(M, 1, N)
        A = self.buf_for(src)
        OUT = self.buf_for(op.result)
        ones = Buffer(self.uid("ones"), TensorType((N, 1), src.type.dtype),
                      MemSpace.VMEM)
        self.scratch.append(ones)
        i = LoopVar(self.uid("i"), M // o.tile_m)
        k = LoopVar(self.uid("k"), N // o.tile_k)
        acc = Buffer(self.uid("acc"), TensorType((o.tile_m, 1), "float32"),
                     MemSpace.VREG)
        self.scratch.append(acc)
        zero2 = (AffineExpr.of(None), AffineExpr.of(None))
        acc_ref = TileRef(acc, zero2, (o.tile_m, 1))
        a_ref = TileRef(A, (AffineExpr.of(i), AffineExpr.of(k)),
                        (o.tile_m, o.tile_k))
        ones_ref = TileRef(ones, (AffineExpr.of(k), AffineExpr.of(None)),
                           (o.tile_k, 1))
        out_ref = TileRef(OUT, (AffineExpr.of(i),), (o.tile_m,))
        # initialise the ones vector once (elementwise broadcast of 1.0 is
        # modelled as copy of itself after backend-side init; backends zero
        # scratch, so materialise ones via a dedicated statement)
        init = EwiseTile("ones", TileRef(ones, (AffineExpr.of(None),
                                                AffineExpr.of(None)),
                                         (N, 1)), [])
        kloop = Loop(k, LoopKind.SEQUENTIAL,
                     [MatmulTile(acc_ref, a_ref, ones_ref, accumulate=True)])
        body = Loop(i, LoopKind.SEQUENTIAL,
                    [ZeroTile(acc_ref), kloop,
                     EwiseTile("copy1", out_ref, [acc_ref])])
        self.body.extend([init, body])

    def lower_reduce(self, op: Op) -> None:
        """Carried reduction over the last axis: (M, N) -> (M, 1) / (M,).

        The running statistic (max or sum) lives in a VREG accumulator
        that is *carried* across the sequential k-loop — the online-softmax
        structure.  Tiling the k axis is legal only because the carry
        threads through ``ReduceTile(accumulate=True)``; schedule passes
        that would replicate the k loop spatially must refuse (see
        ``schedule.carry_axis_reason``).
        """
        (src,) = op.inputs
        kind = op.attrs["kind"]
        if src.type.rank != 2 or op.attrs.get("axis") != 1:
            raise NotImplementedError("reduce lowering supports rank-2, axis=1")
        keepdims = op.attrs.get("keepdims", True)
        M, N = src.type.shape
        o = self.opts.clamp(M, 1, N)
        A = self.buf_for(src)
        OUT = self.buf_for(op.result)
        i = LoopVar(self.uid("i"), M // o.tile_m)
        k = LoopVar(self.uid("k"), N // o.tile_k)
        acc = Buffer(self.uid("acc"), TensorType((o.tile_m, 1), "float32"),
                     MemSpace.VREG)
        self.scratch.append(acc)
        zero2 = (AffineExpr.of(None), AffineExpr.of(None))
        acc_ref = TileRef(acc, zero2, (o.tile_m, 1))
        a_ref = TileRef(A, (AffineExpr.of(i), AffineExpr.of(k)),
                        (o.tile_m, o.tile_k))
        kloop = Loop(k, LoopKind.SEQUENTIAL,
                     [ReduceTile(kind, acc_ref, a_ref, accumulate=True)])
        if keepdims:
            out_ref = TileRef(OUT, (AffineExpr.of(i), AffineExpr.of(None)),
                              (o.tile_m, 1))
            copy = EwiseTile("copy", out_ref, [acc_ref])
        else:
            out_ref = TileRef(OUT, (AffineExpr.of(i),), (o.tile_m,))
            copy = EwiseTile("copy1", out_ref, [acc_ref])
        body = Loop(i, LoopKind.SEQUENTIAL,
                    [FillTile(acc_ref, reduce_identity(kind)), kloop, copy])
        self.body.append(body)

    def lower_scan(self, op: Op) -> None:
        """Associative scan along axis 0: h_t = a_t * h_{t-1} + x_t.

        The carry row (last state of the previous time tile) lives in a
        VREG buffer threaded across the sequential time loop; column tiles
        are independent and free to parallelise, the time axis is not.
        """
        kind = op.attrs["kind"]
        if op.result.type.rank != 2 or op.attrs.get("axis") != 0:
            raise NotImplementedError("scan lowering supports rank-2, axis=0")
        x = op.inputs[-1]
        S, C = x.type.shape
        ts = fit_tile(self.opts.tile_m, S)
        tc = fit_tile(self.opts.tile_n, C)
        OUT = self.buf_for(op.result)
        j = LoopVar(self.uid("j"), C // tc)
        t = LoopVar(self.uid("t"), S // ts)
        carry = Buffer(self.uid("carry"), TensorType((1, tc), "float32"),
                       MemSpace.VREG)
        self.scratch.append(carry)
        zero2 = (AffineExpr.of(None), AffineExpr.of(None))
        carry_ref = TileRef(carry, zero2, (1, tc))
        tj = (AffineExpr.of(t), AffineExpr.of(j))
        srcs = [TileRef(self.buf_for(v), tj, (ts, tc)) for v in op.inputs]
        dst = TileRef(OUT, tj, (ts, tc))
        tloop = Loop(t, LoopKind.SEQUENTIAL,
                     [ScanTile(kind, dst, srcs, carry_ref)])
        body = Loop(j, LoopKind.SEQUENTIAL, [FillTile(carry_ref, 0.0), tloop])
        self.body.append(body)

    # ---- driver --------------------------------------------------------------

    def run(self) -> Kernel:
        for v in self.graph.inputs:
            self.buf_for(v)
        for op in self.graph.ops:
            if op.opname == "matmul":
                self.lower_matmul(op)
            elif op.opname == "reduce_sum":
                self.lower_reduce_sum(op)
            elif op.opname == "reduce":
                self.lower_reduce(op)
            elif op.opname == "scan":
                self.lower_scan(op)
            elif op.opname in _EWISE_BIN | _EWISE_UN | {"bias_add"}:
                self.lower_ewise(op)
            else:
                raise NotImplementedError(
                    f"no LoopIR lowering for op {op.opname!r} yet")
        out_ids = {id(v) for v in self.graph.outputs}
        params = [self.buffers[id(v)] for v in self.graph.inputs]
        inter = [self.buffers[id(op.result)] for op in self.graph.ops]
        # intermediates that are not outputs stay HBM temporaries (params at
        # the end so backends can allocate them); outputs are params too.
        outputs = [self.buffers[id(v)] for v in self.graph.outputs]
        temps = [b for op in self.graph.ops
                 for b in [self.buffers[id(op.result)]]
                 if id(op.result) not in out_ids]
        kern = Kernel(name=self.graph.name, params=params + temps + outputs,
                      outputs=outputs, scratch=self.scratch, body=self.body)
        kern.verify()
        return kern


def lower_graph(graph: Graph, opts: Optional[LoweringOptions] = None) -> Kernel:
    return _Lowerer(graph, opts or LoweringOptions()).run()


# placate the forward references used above
from .loop_ir import Stmt  # noqa: E402  (cycle-free: loop_ir has no deps on us)
