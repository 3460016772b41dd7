"""Reference backend: interpret LoopIR with numpy (the simulation oracle).

Every other backend (jax codegen, pallas emission) is validated against
this interpreter, the same way the paper validates generated RTL against
the expected output matrices ("accurate output matrices from MLIR").
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .loop_ir import (EwiseTile, FillTile, Kernel, Loop, MatmulTile, MemSpace,
                      ReduceTile, ScanTile, Stmt, TileRef, ZeroTile)

_EWISE_NP = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "maximum": np.maximum,
    "relu": lambda a: np.maximum(a, 0),
    "gelu": lambda a: 0.5 * a * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                               * (a + 0.044715 * a ** 3))),
    "exp": np.exp,
    "neg": lambda a: -a,
    "tanh": np.tanh,
    "sigmoid": lambda a: 1.0 / (1.0 + np.exp(-a)),
    "sqrt": np.sqrt,
    "rsqrt": lambda a: 1.0 / np.sqrt(a),
    "log1p": np.log1p,
    "abs": np.abs,
    "copy": lambda a: a,
}


def reduce_tile_np(kind: str, dst: np.ndarray, src: np.ndarray,
                   accumulate: bool) -> np.ndarray:
    """Last-axis keepdims reduction of ``src`` combined into ``dst``.

    Shared by the reference interpreter and the HwIR simulator so cosim
    is bitwise for carried reductions."""
    r = (np.max if kind == "max" else np.sum)(src, axis=-1, keepdims=True)
    if accumulate:
        r = np.maximum(dst, r) if kind == "max" else dst + r
    return r


def scan_tile_np(kind: str, srcs: List[np.ndarray],
                 carry: np.ndarray) -> np.ndarray:
    """Row-sequential scan over a (T, C) tile seeded by the (1, C) carry;
    returns the (T, C) output (its last row is the new carry).  Shared
    with the HwIR simulator for bitwise cosim."""
    x = srcs[-1]
    out = np.empty_like(x)
    c = carry[0]
    if kind == "linear":
        a = srcs[0]
        for t in range(x.shape[0]):
            c = a[t] * c + x[t]
            out[t] = c
    else:
        for t in range(x.shape[0]):
            c = c + x[t]
            out[t] = c
    return out


def _np_dtype(dtype: str):
    # bfloat16 arithmetic is carried in float32 in the oracle
    return {"float32": np.float32, "bfloat16": np.float32,
            "float16": np.float16, "int32": np.int32, "int8": np.int8}[dtype]


def run(kernel: Kernel, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Execute the kernel; ``inputs`` bind the *read-only* HBM params in
    order.  Returns the output buffers' final contents."""
    kernel.verify()
    out_names = {b.name for b in kernel.outputs}
    mem: Dict[str, np.ndarray] = {}
    it = iter(inputs)
    for b in kernel.params:
        if b.name in out_names:
            mem[b.name] = np.zeros(b.shape, _np_dtype(b.type.dtype))
        else:
            try:
                a = next(it)
            except StopIteration:
                # HBM temporary introduced by lowering — allocate
                mem[b.name] = np.zeros(b.shape, _np_dtype(b.type.dtype))
                continue
            if tuple(a.shape) != b.shape:
                raise ValueError(f"param {b.name}: shape {a.shape} != {b.shape}")
            mem[b.name] = np.array(a, dtype=_np_dtype(b.type.dtype))
    for b in kernel.scratch:
        mem[b.name] = np.zeros(b.shape, _np_dtype(b.type.dtype))

    def read(ref: TileRef, env: Dict[str, int]) -> np.ndarray:
        return mem[ref.buffer.name][ref.slices(env)]

    def write(ref: TileRef, env: Dict[str, int], val: np.ndarray) -> None:
        mem[ref.buffer.name][ref.slices(env)] = val

    def go(stmts: List[Stmt], env: Dict[str, int]) -> None:
        for s in stmts:
            if isinstance(s, Loop):
                # all loop kinds share sequential *semantics*; kinds differ
                # only in schedule/cost.  (Verified: GRID/UNROLLED bodies in
                # our IR have no cross-iteration ordering hazards by
                # construction of the lowering.)
                for t in range(s.var.extent):
                    go(s.body, {**env, s.var.name: t})
            elif isinstance(s, ZeroTile):
                write(s.dst, env, 0.0)
            elif isinstance(s, FillTile):
                write(s.dst, env, s.value)
            elif isinstance(s, ReduceTile):
                write(s.dst, env,
                      reduce_tile_np(s.kind, read(s.dst, env),
                                     read(s.src, env), s.accumulate))
            elif isinstance(s, ScanTile):
                out = scan_tile_np(s.kind, [read(r, env) for r in s.srcs],
                                   read(s.carry, env))
                write(s.dst, env, out)
                write(s.carry, env, out[-1:])
            elif isinstance(s, MatmulTile):
                a = read(s.lhs, env).astype(np.float32)
                b = read(s.rhs, env).astype(np.float32)
                c = a @ b
                if s.accumulate:
                    c = read(s.dst, env) + c
                write(s.dst, env, c)
            elif isinstance(s, EwiseTile):
                if s.op == "ones":
                    write(s.dst, env, 1.0)
                    continue
                srcs = [read(r, env) for r in s.srcs]
                if s.op == "copy1":
                    sl = s.dst.slices(env)
                    shape = mem[s.dst.buffer.name][sl].shape
                    write(s.dst, env, srcs[0].reshape(shape))
                    continue
                if s.op == "cast":
                    val = srcs[0]
                else:
                    # broadcast rank-1 bias against rank-n tiles
                    if len(srcs) == 2 and srcs[1].ndim < srcs[0].ndim:
                        srcs[1] = srcs[1][(None,) * (srcs[0].ndim - srcs[1].ndim)]
                    val = _EWISE_NP[s.op](*srcs)
                write(s.dst, env, val)
            else:
                raise TypeError(f"unknown stmt {type(s)}")

    go(kernel.body, {})
    return [mem[b.name] for b in kernel.outputs]
