"""The dry run and its trace analysis against the JAX package, on the CPU.

``roofline_terms`` and the collective wire-byte formulas are held to the
reference's number for number; ``analyze_trace``'s dot FLOPs to
``analyze_hlo_module`` of the jitted reference (a product, and an L-step
loop whose trip count the reference recovers from its HLO); the cell
list to the reference's ``--list``.  Anything that needs the ``"fake"``
process group runs in a subprocess, so no test worker keeps a group.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as JH
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_launcher

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _python(code: str, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("args", [
    (1e15, 2e12, 3e10, 0.0, 1),
    (4.2e14, 8.8e11, 7.5e9, 6e17, 256),
    (1e9, 1e13, 0.0, 1e12, 512),
])
def test_roofline_terms_equal_the_reference(args):
    want = JH.roofline_terms(*args).as_dict()
    got = H.roofline_terms(*args).as_dict()
    assert got == want
    # the H100 set beside it: its own peaks
    h = H.roofline_terms(*args, peaks=H.H100)
    assert h.compute_s == args[0] / 989e12
    assert h.memory_s == args[1] / 3.35e12
    assert h.collective_s == args[2] / 450e9


def test_dot_flops_equal_analyze_hlo_module():
    """A product and an L-step loop of products: the trace's FLOPs equal
    the reference's trip-count-correct count of the jitted function."""
    M, K, N, L = 64, 48, 32, 5
    a, b = jnp.ones((M, K)), jnp.ones((K, N))
    txt = jax.jit(lambda x, y: x @ y).lower(a, b).compile().as_text()
    want = JH.analyze_hlo_module(txt).flops
    ta, tb = torch.ones(M, K), torch.ones(K, N)
    assert H.analyze_trace(lambda x, y: x @ y, ta, tb).flops == want == \
        2 * M * N * K

    w = jnp.ones((K, K))
    loop = jax.jit(lambda x, w: jax.lax.fori_loop(
        0, L, lambda i, x: x @ w, x))
    want = JH.analyze_hlo_module(loop.lower(a, w).compile().as_text()).flops

    def body(x, w):
        for _ in range(L):
            x = x @ w
        return x
    got = H.analyze_trace(body, ta, torch.ones(K, K))
    assert got.flops == want == L * 2 * M * K * K
    assert got.bytes > 0 and got.collectives.total_bytes == 0


def test_trace_counts_backward_and_skips_views():
    w = torch.ones(8, 8, requires_grad=True)
    x = torch.ones(4, 8)

    def step():
        y = (x @ w).reshape(2, 16).t()
        y.sum().backward()
    got = H.analyze_trace(step)
    # forward x @ w, backward x^T @ g (x needs no gradient)
    assert got.flops == 2 * (2 * 4 * 8 * 8)


_FAKE = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.launch.hlo_analysis import analyze_trace
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
one = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("data",))
two = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                 mesh_dim_names=("data", "model"))
g = torch.empty(64, 32, device="meta")
def stats(f):
    s = analyze_trace(f)
    return {"counts": s.collectives.counts,
            "bytes": s.collectives.bytes_by_kind, "flops": s.flops}
rows = distribute_tensor(g, one, [Shard(0)], src_data_rank=None)
part = DTensor.from_local(torch.empty(64, 32, device="meta"), one,
                          [Partial()])
part2 = DTensor.from_local(torch.empty(64, 32, device="meta"), two,
                           [Partial(), Replicate()])
b = distribute_tensor(torch.empty(32, 16, device="meta"), one, [Replicate()],
                      src_data_rank=None)
print(json.dumps({
    "all-gather": stats(lambda: rows.redistribute(one, [Replicate()])),
    "reduce-scatter": stats(lambda: part.redistribute(one, [Shard(0)])),
    "all-reduce": stats(lambda: part.redistribute(one, [Replicate()])),
    "all-reduce-4": stats(lambda: part2.redistribute(
        two, [Replicate(), Replicate()])),
    "mm": stats(lambda: rows @ b),
}))
"""

_GROUP8 = "replica_groups={{0,1,2,3,4,5,6,7}}"
_HLO = {
    "all-gather": f"%c = f32[64,32]{{1,0}} all-gather(f32[8,32]{{1,0}} %p), "
                  f"{_GROUP8}, dimensions={{0}}",
    "reduce-scatter": f"%c = f32[8,32]{{1,0}} reduce-scatter(f32[64,32]"
                      f"{{1,0}} %p), {_GROUP8}, dimensions={{0}}, "
                      f"to_apply=%add",
    "all-reduce": f"%c = f32[64,32]{{1,0}} all-reduce(f32[64,32]{{1,0}} %p),"
                  f" {_GROUP8}, to_apply=%add",
    "all-reduce-4": "%c = f32[64,32]{1,0} all-reduce(f32[64,32]{1,0} %p), "
                    "replica_groups={{0,2,4,6},{1,3,5,7}}, to_apply=%add",
}


def test_collective_bytes_on_a_fake_group_equal_the_reference():
    """DTensor redistributions on a fake group of 8 (and a 4-rank axis of
    a (4, 2) mesh): the trace's wire bytes equal the reference's formulas
    (``collective_bytes`` of the same collective in HLO)."""
    got = json.loads(_python(_FAKE).strip().splitlines()[-1])
    for name, line in _HLO.items():
        want = JH.collective_bytes(line)
        kind = name.split("-4")[0]
        assert got[name]["counts"] == {kind: 1}
        assert got[name]["bytes"] == want.bytes_by_kind, name
    # a (64, 32) x (32, 16) product on 8 row shards: 1/8 of the FLOPs
    assert got["mm"]["flops"] == 2 * 64 * 32 * 16 / 8
    assert got["mm"]["counts"] == {}


def test_list_prints_the_reference_cells(capsys):
    """``--list``: the reference's 33 ``run`` and 7 ``SKIP`` rows, line for
    line (the arch names are the registry's)."""
    assert dryrun.main(["--list"]) == 0
    got = capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    want = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                           "--list"], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=120).stdout
    assert got == want
    rows = got.splitlines()
    assert sum(r.endswith(" run") for r in rows) == 33
    assert sum(r.endswith(" SKIP") for r in rows) == 7


_CELL = """
import json
from repro_torch.launch import dryrun
rec = dryrun.dryrun_cell("whisper-base", "decode_32k", False)
print(json.dumps(rec))
"""


def test_dryrun_cell_on_a_fake_group(tmp_path):
    """One full-config cell on the 256-rank fake group (the reference's
    slow test's cell), nothing allocated: the reference's record keys
    with ``trace_s`` for ``lower_s`` / ``compile_s``, the plain attention,
    a bottleneck, FLOPs and collectives."""
    rec = json.loads(_python(_CELL, timeout=120).strip().splitlines()[-1])
    for k in ("arch", "shape", "mesh", "n_devices", "params",
              "active_params", "tokens_per_step", "state_bytes_per_device",
              "collectives", "roofline", "tag"):
        assert k in rec
    assert "lower_s" not in rec and "compile_s" not in rec
    assert rec["trace_s"] > 0 and rec["attention"] == "plain"
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert rec["roofline"]["peaks"] == H.H100.name
    assert rec["trace_stats"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0


def test_production_meshes_refuse_too_few_ranks():
    """With no process group (or one too small) the production meshes
    raise, as the reference's do; so does the launcher's --mesh single."""
    if torch.distributed.is_initialized():
        pytest.skip("a process group is running in this worker")
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        train_launcher.main(["--arch", "qwen2-7b", "--reduced", "--device",
                             "cpu", "--mesh", "single"])
    assert not torch.distributed.is_initialized()


def test_bytes_per_device_matches_state_bytes():
    """The dry run's two routes to the state bytes agree: its shard count
    over a ``Sharding`` tree and ``state_bytes``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, RunConfig
    from repro_torch.train.step import state_axes, state_shapes
    cfg = get_config("qwen2-7b")
    model = Model(cfg, RunConfig(param_dtype="bfloat16", max_seq=4096),
                  device="meta")
    opt = dryrun.build_optimizer(cfg)
    sizes = {"data": 16, "model": 16}
    sh = dryrun.tree_map_axes(
        lambda ax, t: dryrun._sizes_sharding(sizes, ax, t),
        state_axes(model, opt), state_shapes(model, opt))
    assert dryrun._bytes_per_device(state_shapes(model, opt), sh) == \
        dryrun.state_bytes("qwen2-7b", False)
