"""Raising traced PyTorch into TensorIR, held to the JAX package's raiser.

``repro_torch.core.raise`` walks ``make_fx``'s ATen graph where
``repro.core.raise`` walks a jaxpr.  The reference runs here through
``tests/_torch_raise_ref.py`` (a monkeypatch of its module object for the
installed jax, undone at the end of this module).  For every registry
config and block: the same block names, order and outcome, byte-identical
TensorIR, byte-equal example inputs, the port's graph bound with the
reference's constants equal to the reference's ``run_ref`` within 1e-6,
the port's ``run_ref`` equal to the port's own torch function at the
reference matrix's ``1e-4 * max(1, |exp|)``, and compiled blocks with the
reference's modelled cycles.  Then the rest of ``tests/test_raise.py``:
mirrors, scans, the fuzz round trip, negatives (each naming its ATen op),
``bind`` arity and const dedup.
"""

import functools
import importlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import _torch_raise_ref
import repro.core.frontend as ref_fe
import repro_torch.core.frontend as fe
from repro_torch.configs.base import ARCHS
from repro_torch.core import ir_text

raising = importlib.import_module("repro_torch.core.raise")

_TILE8 = {"m": 8, "n": 8, "k": 8}
# the reference's primitive names -> the ATen ops the port names
_OP_NAMES = {"slice": "aten.slice.Tensor", "top_k": "aten.topk.default"}


@pytest.fixture(scope="module")
def ref():
    with _torch_raise_ref.shim() as mod:
        yield mod


@functools.lru_cache(maxsize=None)
def _port(arch):
    return raising.raise_model_blocks(arch)


_REF = {}


def _ref(ref, arch):
    if arch not in _REF:
        _REF[arch] = ref.raise_model_blocks(arch)
    return _REF[arch]


def _torch_fn(rep):
    ins = [torch.from_numpy(np.ascontiguousarray(a))
           for a in rep.example_inputs]
    with torch.no_grad():
        return rep.fn(*ins).numpy()


def _tol(exp, rel=1e-4):
    return rel * max(1.0, float(np.max(np.abs(exp))))


# --------------------------------------------------------------------------
# the differential matrix
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_the_reference(arch, ref):
    """Names, order, outcome, printed IR and example inputs, block for
    block; an unraisable block names the reference's primitive as its
    ATen op."""
    mine, theirs = _port(arch), _ref(ref, arch)
    assert [r.block for r in mine] == [r.block for r in theirs]
    for p, r in zip(mine, theirs):
        assert p.ok == r.ok, (p.block, p.error, r.error)
        assert len(p.example_inputs) == len(r.example_inputs)
        for a, b in zip(p.example_inputs, r.example_inputs):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), p.block
        if p.ok:
            assert str(p.raised.graph) == str(r.raised.graph), p.block
            assert p.raised.out_shapes == r.raised.out_shapes
            assert p.raised.scan_lengths == r.raised.scan_lengths
            assert p.raised.unlowerable_ops == r.raised.unlowerable_ops
            assert p.raised.lowerable
        else:
            prim = r.error.split("[primitive: ")[1].split("]")[0]
            assert f"[primitive: {_OP_NAMES[prim]}]" in p.error
            assert "in node: " in p.error


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_with_reference_constants_matches_reference(arch, ref):
    """The port's graph, bound with the reference's constants, computes
    the reference's ``run_ref`` within 1e-6 (the MLP weights come from
    each package's own initialiser, so only the graphs are compared)."""
    for p, r in zip(_port(arch), _ref(ref, arch)):
        if not p.ok:
            continue
        rg = p.raised
        args = [np.asarray(a, np.float32).reshape(v.type.shape)
                for a, v in zip(p.example_inputs,
                                rg.graph.inputs[:rg.n_args])]
        consts = [r.raised.const_bindings[v.name]
                  for v in rg.graph.inputs[rg.n_args:]]
        got = [o.reshape(s) for o, s in zip(rg.graph.eval_np(*args, *consts),
                                            rg.out_shapes)]
        want = r.raised.run_ref(*r.example_inputs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                       err_msg=f"{arch}:{p.block}")


@pytest.mark.parametrize("arch", ARCHS)
def test_run_ref_matches_the_torch_function(arch):
    """Every raised block on the graph interpreter against the torch
    function it was traced from, at 1e-4."""
    ok = [r for r in _port(arch) if r.ok]
    assert ok, arch
    for rep in ok:
        exp = _torch_fn(rep)
        (got,) = rep.raised.run_ref(*rep.example_inputs)
        assert got.shape == exp.shape, rep.block
        np.testing.assert_allclose(got, exp, atol=_tol(exp), rtol=0,
                                   err_msg=f"{arch}:{rep.block}")


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_blocks_match_the_reference(arch, ref):
    """Each raised block compiles with the reference's modelled cycles;
    the largest one's ref and torch backends agree with the torch
    function."""
    mine = [r for r in _port(arch) if r.ok]
    theirs = {r.block: r for r in _ref(ref, arch)}
    for rep in mine:
        sched = "nested" if rep.raised.scan_lengths else "tpu_mxu"
        ck = rep.raised.compile(tile=_TILE8, schedule=sched, device="cpu",
                                want_cuda=False)
        rck = theirs[rep.block].raised.compile(
            tile=_TILE8, schedule=sched, want_jax=False, want_pallas=False)
        assert str(ck.cycles) == str(rck.cycles), rep.block
        assert str(ck.resources) == str(rck.resources), rep.block
    rep = max(mine, key=lambda r: len(r.raised.graph.ops))
    sched = "nested" if rep.raised.scan_lengths else "tpu_mxu"
    ck = rep.raised.compile(tile=_TILE8, schedule=sched, device="cpu")
    exp = _torch_fn(rep)
    for backend in ("ref", "torch", "cuda"):
        (got,) = rep.raised.run_compiled(ck, *rep.example_inputs,
                                         backend=backend)
        np.testing.assert_allclose(
            got, exp, atol=_tol(exp), rtol=0,
            err_msg=f"{arch}:{rep.block} backend={backend}")


def test_expected_block_coverage():
    """Which blocks raise per config family, and the negatives' ops."""
    def ok(arch):
        return {r.block for r in _port(arch) if r.ok}
    assert ok("qwen2_7b") == {"rmsnorm", "mlp", "head", "attn_softmax"}
    assert ok("mamba2_130m") == {"rmsnorm", "head", "ssd_core"}
    assert ok("recurrentgemma_2b") == {"rmsnorm", "mlp", "head",
                                       "attn_softmax", "rglru_core"}
    rope = {r.block: r for r in _port("qwen2_7b")}["rope"]
    assert not rope.ok and "aten.slice.Tensor" in rope.error
    router = {r.block: r for r in _port("deepseek_v2_236b")}["moe_router"]
    assert not router.ok and "aten.topk.default" in router.error


def test_shim_restores_the_reference_module():
    """In a fresh process: the reference module as imported, patched
    inside the shim, and exactly as imported again after it."""
    code = (
        "import _torch_raise_ref as r\n"
        "before = r.snapshot()\n"
        "assert before[3] is False and before[5] is False\n"
        "with r.shim() as m:\n"
        "    assert r.snapshot() != before\n"
        "    assert len(m.raise_model_blocks('mamba2_130m')) == 3\n"
        "after = r.snapshot()\n"
        "assert all(a is b for a, b in zip(after, before)), after\n"
        "print('ok')\n")
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(here.parent / "src"),
                                           str(here)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=here,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --------------------------------------------------------------------------
# equivalence against the hand-written frontend builders
# --------------------------------------------------------------------------


def _assert_numeric_identical(rg, hand, shapes, rng, atol=1e-5):
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    got = rg.graph.eval_np(*rg.bind(*args))
    want = hand.eval_np(*[a.reshape(v.type.shape)
                          for a, v in zip(args, hand.inputs)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("which", ["flash", "decode", "ssd"])
def test_mirrors_are_equivalent_to_both_frontends(which):
    rg, hands = {
        "flash": lambda: (raising.reference_flash(8, 16, 4),
                          [fe.flash_attention_graph(8, 16, 4),
                           ref_fe.flash_attention_graph(8, 16, 4)]),
        "decode": lambda: (raising.reference_decode(4, 16, 4),
                           [fe.decode_attention_graph(4, 16, 4),
                            ref_fe.decode_attention_graph(4, 16, 4)]),
        "ssd": lambda: (raising.reference_ssd(8, 2, 4),
                        [fe.ssd_scan_graph(8, 2, 4),
                         ref_fe.ssd_scan_graph(8, 2, 4)]),
    }[which]()
    assert rg.graph.is_equivalent(hands[0]), \
        f"raised:\n{ir_text.print_graph(rg.graph)}\nhand:\n{hands[0]}"
    assert str(hands[0]) == str(hands[1])
    rng = np.random.default_rng(2)
    if which == "ssd":
        a = rng.uniform(0.2, 0.95, rg.arg_shapes[0]).astype(np.float32)
        rest = [rng.standard_normal(s).astype(np.float32)
                for s in rg.arg_shapes[1:]]
        got = rg.graph.eval_np(*rg.bind(a, *rest))
        want = hands[0].eval_np(a, *rest)
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    else:
        _assert_numeric_identical(rg, hands[0], rg.arg_shapes, rng)


# --------------------------------------------------------------------------
# scans and the trip-count cross-check
# --------------------------------------------------------------------------


def test_cumsum_raises_to_scan():
    rg = raising.raise_fx(lambda x: torch.cumsum(x, 0), (8, 4))
    ops = {op.opname: op for op in rg.graph.ops}
    assert ops["scan"].attrs["kind"] == "cumsum"
    assert rg.scan_lengths == [8]
    x = np.random.default_rng(3).standard_normal((8, 4)).astype(np.float32)
    np.testing.assert_allclose(rg.run_ref(x)[0], np.cumsum(x, axis=0),
                               atol=1e-5, rtol=0)


def test_linear_scan_raises():
    """A scan of h = a*h + u raises to a linear scan op of its length."""
    def fn(a, u, ct, g):
        return (raising._scan_linear(a, u) * ct) @ g

    rg = raising.raise_fx(fn, (8, 16), (8, 16), (8, 16), (16, 2))
    ops = {op.opname: op for op in rg.graph.ops}
    assert ops["scan"].attrs["kind"] == "linear"
    assert rg.scan_lengths == [8]


def test_check_hlo_trips_is_refused_naming_the_missing_hlo():
    """The stated difference: the reference cross-checks scan lengths
    against XLA's while-loop trip counts, and a traced PyTorch function
    compiles to no HLO, so the option raises before tracing, and every
    block of a config reports it."""
    with pytest.raises(raising.RaiseError, match="check_hlo_trips needs the "
                       "while-loop trip counts of a compiled HLO module"):
        raising.raise_fx(raising._scan_linear, (8, 16), (8, 16),
                         check_hlo_trips=True)
    reps = raising.raise_model_blocks("mamba2_130m", check_hlo_trips=True)
    assert [r.ok for r in reps] == [False] * 3
    assert all("compiled HLO" in r.error for r in reps)


def _scan(step, init, xs):
    return raising.scan_hop(step, init, xs)


_SCAN_REJECTS = [
    ("quadratic", lambda h, ut: h * h + ut),
    ("div_by_carry", lambda h, ut: ut / h),
    ("max_over_carry", lambda h, ut: torch.maximum(h, ut)),
    ("tanh_of_carry", lambda h, ut: torch.tanh(h) + ut),
]


@pytest.mark.parametrize("name,upd", _SCAN_REJECTS,
                         ids=[c[0] for c in _SCAN_REJECTS])
def test_scan_rejects_nonlinear_carry_uses(name, upd):
    def fn(u):
        return _scan(upd, torch.zeros(4), (u,))

    with pytest.raises(raising.RaiseError) as ei:
        raising.raise_fx(fn, (6, 4))
    assert "scan body not affine" in str(ei.value)


def test_scan_body_vocabulary(ref):
    """The linearity analysis sees through div/neg/max/unaries/outer
    consts in the body as long as the carry enters linearly — the same
    TensorIR as the reference's for each body."""
    w = np.random.default_rng(9).standard_normal((4,)).astype(np.float32)
    wt = torch.from_numpy(w)
    cases = {
        "div": (lambda h, at, ut: at * h + ut / (torch.abs(ut) + 1.5),
                lambda h, at, ut: at * h + ut / (jnp.abs(ut) + 1.5)),
        "neg_max": (lambda h, at, ut: at * h - torch.maximum(
            ut, torch.tensor(0.25)),
            lambda h, at, ut: at * h - jnp.maximum(ut, 0.25)),
        "outer_const": (lambda h, at, ut: torch.tanh(at) * h + ut * wt,
                        lambda h, at, ut: jnp.tanh(at) * h + ut * w),
        "neg_carry": (lambda h, at, ut: (-h) * (-at) + ut,
                      lambda h, at, ut: (-h) * (-at) + ut),
        "view": (lambda h, at, ut: at * h + (-ut).reshape(4),
                 lambda h, at, ut: at * h + (-ut).reshape(4)),
    }
    rng = np.random.default_rng(10)
    a = rng.uniform(0.2, 0.95, (6, 4)).astype(np.float32)
    u = rng.standard_normal((6, 4)).astype(np.float32)
    def pair(tstep, jstep):
        def tf(a, u):
            return _scan(tstep, torch.zeros(4), (a, u))

        def jf(a, u):
            def step(h, xs):
                h = jstep(h, *xs)
                return h, h
            return jax.lax.scan(step, jnp.zeros((4,)), (a, u))[1]
        return tf, jf

    for name, steps in cases.items():
        tf, jf = pair(*steps)
        rg = raising.raise_fx(tf, a, u, name=name)
        ops = {op.opname: op for op in rg.graph.ops}
        assert ops["scan"].attrs["kind"] == "linear", name
        assert str(rg.graph) == str(ref.raise_jaxpr(jf, a, u,
                                                    name=name).graph), name
        exp = tf(torch.from_numpy(a), torch.from_numpy(u)).numpy()
        np.testing.assert_allclose(rg.run_ref(a, u)[0], exp, atol=1e-5,
                                   rtol=0, err_msg=name)


# --------------------------------------------------------------------------
# wiring: frontend delegators, DSE
# --------------------------------------------------------------------------


def test_frontend_delegators():
    rg = fe.raise_fx(lambda x: torch.tanh(x) + 1.0, (4, 4))
    assert isinstance(rg, raising.RaisedGraph)
    reps = fe.raise_model_blocks("mamba2_130m")
    assert any(r.ok for r in reps)


def test_const_inputs_are_deduped():
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 4)).astype(np.float32))
    rg = raising.raise_fx(lambda x: (x + w) * w, (4, 4))
    # one user arg + ONE captured const, despite two uses of w
    assert rg.n_args == 1
    assert len(rg.graph.inputs) == 2
    assert set(rg.const_bindings) == {"c0"}


def test_bind_arity_error():
    rg = raising.raise_fx(lambda x: x + 1.0, (4, 4))
    with pytest.raises(ValueError):
        rg.bind(np.zeros((4, 4), np.float32), np.zeros((4, 4), np.float32))


def test_dse_explores_raised_region(tmp_path, monkeypatch):
    monkeypatch.setenv("STAGECC_DSE_CACHE", str(tmp_path / "dse"))
    rep = {r.block: r for r in _port("qwen2_7b")}["rmsnorm"]
    res = rep.raised.explore(tiles=(8,), validate_top=1)
    assert res.frontier, "no feasible frontier point for the raised graph"
    assert res.validations and all(v.ok for v in res.validations)


# --------------------------------------------------------------------------
# property-based round-trip fuzzer (each program also in jnp: same IR)
# --------------------------------------------------------------------------


def _const(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _scan_sig(v):
    return raising._scan_linear(torch.sigmoid(v), v)


def _jscan_sig(v):
    def step(h, xs):
        a_t, u_t = xs
        h = a_t * h + u_t
        return h, h
    h0 = jnp.zeros(v.shape[1:], jnp.float32)
    return jax.lax.scan(step, h0, (jax.nn.sigmoid(v), v))[1]


# name -> (torch step, jnp step, const shape or None)
_STEP_POOL = [
    ("tanh", torch.tanh, jnp.tanh, None),
    ("abs", torch.abs, jnp.abs, None),
    ("neg", lambda v: -v, lambda v: -v, None),
    ("exp", lambda v: torch.exp(-torch.abs(v)),
     lambda v: jnp.exp(-jnp.abs(v)), None),
    ("sigmoid", torch.sigmoid, jax.nn.sigmoid, None),
    ("sqrt", lambda v: torch.sqrt(torch.abs(v) + 0.5),
     lambda v: jnp.sqrt(jnp.abs(v) + 0.5), None),
    ("log1p", lambda v: torch.log1p(torch.abs(v)),
     lambda v: jnp.log1p(jnp.abs(v)), None),
    ("add", lambda v, w: v + w, lambda v, w: v + w, "rc"),
    ("sub", lambda v, w: v - w, lambda v, w: v - w, "rc"),
    ("mul_row", lambda v, w: v * w, lambda v, w: v * w, "1c"),
    ("maximum", torch.maximum, jnp.maximum, "rc"),
    ("div", lambda v, w: v / (torch.abs(w) + 0.7),
     lambda v, w: v / (jnp.abs(w) + 0.7), "rc"),
    ("softmax_shift", lambda v: v - torch.amax(v, 1, keepdim=True),
     lambda v: v - jnp.max(v, axis=1, keepdims=True), None),
    ("l1_norm",
     lambda v: v / (torch.sum(torch.abs(v), 1, keepdim=True) + 1.0),
     lambda v: v / (jnp.sum(jnp.abs(v), axis=1, keepdims=True) + 1.0),
     None),
    ("matmul", lambda v, w: v @ w, lambda v, w: v @ w, "cc"),
    ("cumsum", lambda v: torch.cumsum(v, 0),
     lambda v: jnp.cumsum(v, axis=0), None),
    ("scan_linear", _scan_sig, _jscan_sig, None),
]


def _build_program(seed):
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(2, 7))
    cols = int(rng.integers(2, 6))
    n = int(rng.integers(2, 7))
    tsteps, jsteps, names = [], [], []
    for _ in range(n):
        name, tf, jf, cshape = _STEP_POOL[int(rng.integers(len(_STEP_POOL)))]
        if cshape is None:
            tsteps.append(tf)
            jsteps.append(jf)
        else:
            shape = {"rc": (rows, cols), "1c": (1, cols),
                     "cc": (cols, cols)}[cshape]
            w = _const(rng, *shape)
            wt = torch.from_numpy(w)
            tsteps.append(functools.partial(lambda v, f, w: f(v, w),
                                            f=tf, w=wt))
            jsteps.append(functools.partial(lambda v, f, w: f(v, w),
                                            f=jf, w=w))
        names.append(name)

    def run(steps):
        def fn(x):
            v = x
            for s in steps:
                v = s(v)
            return v
        return fn

    return run(tsteps), run(jsteps), (rows, cols), names


@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=15, deadline=None, derandomize=True, database=None)
def test_fuzz_roundtrip(seed):
    fn, jfn, (rows, cols), names = _build_program(seed)
    rg = raising.raise_fx(fn, (rows, cols), name=f"fuzz{seed}")

    # the reference raises the jnp spelling of the program to the same IR
    with _torch_raise_ref.shim() as ref:
        want = ref.raise_jaxpr(jfn, (rows, cols), name=f"fuzz{seed}")
    assert str(rg.graph) == str(want.graph), names

    # textual round-trip fixpoint: print(parse(print(g))) == print(g)
    text = ir_text.print_graph(rg.graph)
    assert ir_text.print_graph(ir_text.parse_graph(text)) == text, names

    x = np.random.default_rng(seed ^ 0x5EED).standard_normal(
        (rows, cols)).astype(np.float32)
    exp = fn(torch.from_numpy(x)).numpy()
    tol = _tol(exp)
    (got,) = rg.run_ref(x)
    np.testing.assert_allclose(got, exp, atol=tol, rtol=0, err_msg=str(names))

    # tpu_mxu (correctly) refuses to grid a scan's time axis or a carried
    # reduction split over tiles: such programs take the nested schedule
    carried = rg.scan_lengths or any(op.opname == "reduce"
                                     for op in rg.graph.ops)
    sched = "nested" if carried else "tpu_mxu"
    ck = rg.compile(tile={"m": 4, "n": 4, "k": 4}, schedule=sched,
                    want_torch=False, want_cuda=False, device="cpu")
    (got,) = rg.run_compiled(ck, x, backend="ref")
    np.testing.assert_allclose(got, exp, atol=tol, rtol=0, err_msg=str(names))


# --------------------------------------------------------------------------
# handler edge cases: the corners of the vocabulary
# --------------------------------------------------------------------------

_W8 = np.random.default_rng(8).standard_normal((6, 3)).astype(np.float32)

# name -> (torch fn, jnp fn, shapes); the same TensorIR from both raisers
_EDGES = {
    "dot_rhs_transposed": (lambda x, w: torch.einsum("ij,kj->ik", x, w),
                           lambda x, w: jnp.einsum("ij,kj->ik", x, w),
                           [(6, 4), (5, 4)]),
    "dot_lhs_traced_transpose": (lambda x: x.T @ x, lambda x: x.T @ x,
                                 [(6, 4)]),
    "dot_const_lhs": (lambda x: torch.einsum("ji,jk->ik",
                                             torch.from_numpy(_W8), x),
                      lambda x: jnp.einsum("ji,jk->ik", _W8, x), [(6, 4)]),
    "integer_pow": (lambda x: x ** 2 + x ** 3, lambda x: x ** 2 + x ** 3,
                    [(4, 4)]),
    "scalar": (lambda s: s * 2.0 + 1.0, lambda s: s * 2.0 + 1.0, [()]),
    "rank1": (lambda v: torch.exp(v) / 3.0, lambda v: jnp.exp(v) / 3.0,
              [(5,)]),
    "reciprocal": (lambda x: 2.0 / (torch.abs(x) + 1.0),
                   lambda x: 2.0 / (jnp.abs(x) + 1.0), [(4, 4)]),
    "rsub": (lambda x: 1.0 - x * x, lambda x: 1.0 - x * x, [(4, 4)]),
    "relu": (lambda x: torch.relu(x), lambda x: jax.nn.relu(x), [(4, 4)]),
    "silu": (lambda x: torch.nn.functional.silu(x),
             lambda x: jax.nn.silu(x), [(4, 4)]),
    "gelu_tanh": (lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
                  lambda x: jax.nn.gelu(x), [(4, 4)]),
    "softplus": (lambda x: torch.nn.functional.softplus(x),
                 lambda x: jax.nn.softplus(x), [(4, 4)]),
    "mean": (lambda x: torch.mean(x, -1, keepdim=True),
             lambda x: jnp.mean(x, -1, keepdims=True), [(3, 4)]),
    "nan_guard_select": (
        lambda x: torch.where(torch.isnan(x), torch.zeros_like(x), x),
        lambda x: jnp.where(jnp.isnan(x), jnp.zeros_like(x), x), [(4, 4)]),
    "broadcast_of_reduce": (
        lambda x: torch.sum(x, 1, keepdim=True).expand(x.shape) + x,
        lambda x: jnp.broadcast_to(jnp.sum(x, axis=1, keepdims=True),
                                   x.shape) + x, [(5, 3)]),
    "rank1_reduce_orientation": (lambda x: torch.sum(x, 1),
                                 lambda x: jnp.sum(x, axis=1), [(5, 3)]),
    "unit_dim_reshape": (lambda x: (x[:, None, :] * 1.0).reshape(4, 4),
                         lambda x: (x[:, None, :] * 1.0).reshape(4, 4),
                         [(4, 4)]),
    "max_dim": (lambda x: x - torch.max(x, dim=1, keepdim=True)[0],
                lambda x: x - jnp.max(x, axis=1, keepdims=True), [(4, 4)]),
    "softmax": (lambda x: torch.softmax(x, -1),
                lambda x: jax.nn.softmax(x, axis=-1), [(4, 4)]),
    "const_only_output": (lambda x: torch.ones(3, 2) * 2.0,
                          lambda x: jnp.ones((3, 2), jnp.float32) * 2.0,
                          [(4, 4)]),
}


@pytest.mark.parametrize("name", list(_EDGES))
def test_edge_cases_match_the_reference(name, ref):
    tfn, jfn, shapes = _EDGES[name]
    rg = raising.raise_fx(tfn, *shapes, name=name)
    want = ref.raise_jaxpr(jfn, *shapes, name=name)
    assert str(rg.graph) == str(want.graph)
    assert rg.arg_shapes == want.arg_shapes
    assert rg.out_shapes == want.out_shapes
    args = [np.random.default_rng(7).standard_normal(s).astype(np.float32)
            for s in shapes]
    exp = tfn(*map(torch.from_numpy, args)).numpy()
    (got,) = rg.run_ref(*args)
    np.testing.assert_allclose(got, exp, atol=1e-5 * max(1.0, float(
        np.max(np.abs(exp)))), rtol=0)


def test_nan_guard_select_folds_away():
    rg = raising.raise_fx(
        lambda x: torch.where(torch.isnan(x), torch.zeros_like(x), x), (4, 4))
    assert not rg.graph.ops


def test_traced_transposes_emit_transpose():
    for fn, shapes in ((lambda x, w: torch.einsum("ij,kj->ik", x, w),
                        [(6, 4), (5, 4)]), (lambda x: x.T @ x, [(6, 4)])):
        rg = raising.raise_fx(fn, *shapes)
        assert "transpose" in {op.opname for op in rg.graph.ops}


def test_scan_final_carry_only_rejected():
    from torch._higher_order_ops.scan import scan_op

    def fn(u):
        def body(c, x):
            c = c + x
            return [c, c.clone()]
        return scan_op(body, [torch.zeros(4)], [u], ())[0]
    with pytest.raises(raising.RaiseError):
        raising.raise_fx(fn, (6, 4))


def _two_carries(x):
    from torch._higher_order_ops.scan import scan_op

    def body(c0, c1, xt):
        return [c0 + xt, c1 + xt, (c0 + xt).clone()]
    return scan_op(body, [torch.zeros(4), torch.zeros(4)], [x], ())[2]


_NEGATIVES = [
    ("sin", "aten.sin.default", lambda x: torch.sin(x)),
    ("concatenate", "aten.cat.default", lambda x: torch.cat([x, x], 0)),
    ("top_k", "aten.topk.default", lambda x: torch.topk(x, 2)[0]),
    ("sort", "aten.sort.default", lambda x: torch.sort(x, 1)[0]),
    ("slice", "aten.slice.Tensor", lambda x: x[0:1, :]),
    ("rank-1 rhs", "aten.mv.default",
     lambda x: x @ torch.ones(4)),
    ("reduce over rows", "aten.sum.dim_IntList", lambda x: torch.sum(x, 0)),
    ("reduce_min", "aten.amin.default", lambda x: torch.amin(x, 1)),
    ("cumsum along cols", "aten.cumsum.default",
     lambda x: torch.cumsum(x, 1)),
    ("reverse cumsum", "aten.flip.default",
     lambda x: torch.flip(torch.cumsum(torch.flip(x, [0]), 0), [0])),
    ("data-dependent select", "aten.where.self",
     lambda x: torch.where(x > 0, x, -x)),
    ("integer pow 4", "aten.pow.Tensor_Scalar", lambda x: x ** 4),
    ("comparison consumed as data", "aten.gt.Scalar",
     lambda x: (x > 0.0) * 1.0),
    ("int conversion", "aten._to_copy.default",
     lambda x: x.to(torch.int32).to(torch.float32) * 1.0),
    ("non-unit reshape", "aten.view.default", lambda x: x.reshape(2, 8)),
    ("two carries", "higher_order.scan", _two_carries),
    ("nonzero init", "higher_order.scan",
     lambda x: _scan(lambda h, xt: h + xt, torch.ones(4), (x,))),
    ("gelu without tanh", "aten.gelu.default",
     lambda x: torch.nn.functional.gelu(x)),
]


@pytest.mark.parametrize("label,op,fn", _NEGATIVES,
                         ids=[c[0].replace(" ", "-") for c in _NEGATIVES])
def test_negatives_name_the_aten_op(label, op, fn):
    with pytest.raises(raising.RaiseError) as ei:
        raising.raise_fx(fn, (4, 4))
    msg = str(ei.value)
    assert op in msg, msg
    assert "in node: " in msg, msg
