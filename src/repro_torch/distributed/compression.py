"""Gradient compression: int8 quantised all-reduce with error feedback.

The PyTorch counterpart of ``repro/distributed/compression.py``.
Data-parallel gradient all-reduces move ~4 bytes/param/step;
per-tensor-scaled int8 cuts that 4x on the wire.  Error feedback
(residual carried to the next step) keeps SGD convergence unbiased in
expectation.

The reduction is explicit collectives over the mesh axis's process
sub-group, so the quantised payload is what crosses the wire: the int8
values summed in int32, the replica count summed, the scale reduced with
MAX.  The semantics are the reference's exactly: every rank's own int8
payload at its own scale is summed, then multiplied by the *largest*
scale and divided by n, which is not the true mean when the scales
differ (a caveat of the reference, kept).  The reference's train step
never reads ``TrainConfig.grad_compress``; neither does the port's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # a true division on every device: PyTorch's CUDA kernels multiply by
    # the reciprocal of a host scalar divisor, which can round otherwise
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / torch.full(
        (), 127.0, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks of ``group`` of int8-quantised ``x`` (this
    rank's local tensor), every rank getting the same result."""
    q, scale = quantize_int8(x)
    # int8 payloads sum in int32 to avoid overflow across replicas;
    # scales are tiny and reduce in f32
    s = q.to(torch.int32)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    n = torch.ones((), dtype=torch.float32, device=x.device)
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=group)
    # all replicas must agree on a scale: use the max scale
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    return s.float() * smax / n


def make_compressed_allreduce(mesh, axis: str = "data"):
    """Returns f(local_grads_tree) -> mean-reduced tree, communicating
    int8 over ``mesh``'s ``axis``.  A leaf is this rank's local gradient
    (a plain tensor), or a DTensor sharded on its first dim over ``axis``
    (one block a replica) and replicated over the other mesh axes, the
    reference's ``shard_map`` specs: each block is reduced as a local
    gradient and the result keeps those placements."""
    group = mesh.get_group(axis)

    def one(x):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor):
            return compressed_psum_mean(x, group)
        from torch.distributed.tensor.experimental import local_map
        spec = [Shard(0) if a == axis else Replicate()
                for a in mesh.mesh_dim_names]
        return local_map(lambda t: compressed_psum_mean(t, group),
                         out_placements=spec, in_placements=(spec,),
                         device_mesh=mesh, redistribute_inputs=True)(x)

    @torch.no_grad()
    def reduce_tree(tree):
        if isinstance(tree, dict):
            return {k: reduce_tree(v) for k, v in tree.items()}
        return one(tree)

    return reduce_tree


@torch.no_grad()
def error_feedback_update(grads, residual):
    """g' = g + r;  r' = g' - Q(g') applied leaf-wise (int8), in f32.
    Trees are nested dicts; returns (new grads, new residual)."""
    if isinstance(grads, dict):
        pairs = {k: error_feedback_update(grads[k], residual[k])
                 for k in grads}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    g = grads.float() + residual
    q, scale = quantize_int8(g)
    deq = dequantize_int8(q, scale)
    return deq, g - deq
