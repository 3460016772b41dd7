"""PyTorch backend: run scheduled LoopIR as eager torch code.

The port of ``backend_jax.py``: the same statement-tree interpreter, with
torch tensors in place of jnp arrays and in-place slice writes in place
of functional updates.  Every loop kind runs as a Python loop (PyTorch
has no trace to keep small, so there is no ``fori_loop`` threshold).

Like ``emit_jit``, emission is lazy: ``emit`` checks the kernel and
returns a callable; nothing runs until its first call.  numpy inputs go
to ``device``; tensor inputs stay on the device they are on.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from .loop_ir import (EwiseTile, FillTile, Kernel, Loop, MatmulTile,
                      ReduceTile, ScanTile, Stmt, TileRef, ZeroTile)

_EWISE = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "maximum": torch.maximum,
    "relu": lambda a: torch.clamp_min(a, 0),
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda a: torch.nn.functional.gelu(a, approximate="tanh"),
    "exp": torch.exp,
    "neg": lambda a: -a,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "log1p": torch.log1p,
    "abs": torch.abs,
    "copy": lambda a: a,
}

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32,
                "int8": torch.int8}


def as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` in ``dtype``: a tensor stays on its device, anything else
    (numpy, lists) goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)


def emit(kernel: Kernel, device="cuda") -> Callable[..., List[torch.Tensor]]:
    """Return ``f(*inputs) -> [outputs]`` implementing the kernel."""
    kernel.verify()
    out_names = {b.name for b in kernel.outputs}
    in_params = [b for b in kernel.params if b.name not in out_names]

    def fn(*inputs):
        if len(inputs) > len(in_params):
            raise ValueError(f"{kernel.name}: expected <= {len(in_params)} "
                             f"inputs")
        given = [as_tensor(a, _TORCH_DTYPE[b.type.dtype], device)
                 for a, b in zip(inputs, in_params)]
        dev = given[0].device if given else torch.device(device)
        if any(t.device != dev for t in given):
            raise ValueError(f"{kernel.name}: inputs on several devices")
        mem: Dict[str, torch.Tensor] = {}
        for b, t in zip(in_params, given):
            # a private copy: fusion temporaries among the params are
            # written in place, and the caller's tensors must not be
            mem[b.name] = t.clone()
        for b in [*in_params[len(given):], *kernel.outputs, *kernel.scratch]:
            mem[b.name] = torch.zeros(b.shape, dtype=_TORCH_DTYPE[
                b.type.dtype], device=dev)

        def read(ref: TileRef, env):
            return mem[ref.buffer.name][ref.slices(env)]

        def write(ref: TileRef, env, val):
            dst = mem[ref.buffer.name]
            dst[ref.slices(env)] = val.to(dst.dtype)

        def full(ref: TileRef, value: float):
            return torch.full(ref.tile, value, dtype=torch.float32,
                              device=dev)

        def exec_stmt(s: Stmt, env):
            if isinstance(s, ZeroTile):
                write(s.dst, env, full(s.dst, 0.0))
            elif isinstance(s, MatmulTile):
                c = read(s.lhs, env).float() @ read(s.rhs, env).float()
                if s.accumulate:
                    c = read(s.dst, env).float() + c
                write(s.dst, env, c)
            elif isinstance(s, FillTile):
                write(s.dst, env, full(s.dst, s.value))
            elif isinstance(s, ReduceTile):
                src = read(s.src, env)
                r = (src.amax(dim=-1, keepdim=True) if s.kind == "max"
                     else src.sum(dim=-1, keepdim=True))
                if s.accumulate:
                    d = read(s.dst, env)
                    r = torch.maximum(d, r) if s.kind == "max" else d + r
                write(s.dst, env, r)
            elif isinstance(s, ScanTile):
                srcs = [read(r, env) for r in s.srcs]
                x = srcs[-1]
                c = read(s.carry, env)[0].clone()
                rows = []
                for t in range(x.shape[0]):
                    c = srcs[0][t] * c + x[t] if s.kind == "linear" \
                        else c + x[t]
                    rows.append(c)
                write(s.dst, env, torch.stack(rows))
                write(s.carry, env, c[None])
            elif isinstance(s, EwiseTile):
                if s.op == "ones":
                    write(s.dst, env, full(s.dst, 1.0))
                elif s.op == "copy1":
                    write(s.dst, env, read(s.srcs[0], env).reshape(
                        s.dst.tile))
                else:
                    srcs = [read(r, env) for r in s.srcs]
                    if len(srcs) == 2 and srcs[1].ndim < srcs[0].ndim:
                        srcs[1] = srcs[1][(None,) * (srcs[0].ndim
                                                     - srcs[1].ndim)]
                    write(s.dst, env, _EWISE[s.op](*srcs))
            else:
                raise TypeError(type(s))

        def go(stmts: List[Stmt], env):
            for s in stmts:
                if isinstance(s, Loop):
                    for t in range(s.var.extent):
                        go(s.body, {**env, s.var.name: t})
                else:
                    exec_stmt(s, env)

        go(kernel.body, {})
        return [mem[b.name] for b in kernel.outputs]

    fn.__name__ = f"stagecc_torch_{kernel.name}"
    return fn
