"""The port's SSD scan (``ssd_ref``, ``ssd_chunked``, ``ssd_scan`` and its
plain version) and ``ops.ssd`` against the JAX package's.

On the CPU the port's ``ssd_scan`` runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_kernels.py
does, and its oracles.  Inputs are drawn as tests/test_kernels.py:82-90
draws them, with numpy from a seed.  The hand-written kernel itself is held
against the plain version on a GPU, in test_torch_cuda.py.  The kernel's
three passes (chunk states, state passing, chunk outputs) have plain
versions of their own; composed, they are held to the JAX kernel and to
``ssd_scan_plain``, at chunk 128 and 256, P 128 and N 256 among
others.
"""

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_chunked as jax_chunked
from repro.kernels.ssd_scan import ssd_scan as jax_scan
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss

# The same function on both sides (the same f32 operations in the same
# order, up to the order of the sums inside a product): ~1e-6 apart on
# outputs up to ~10, so 1e-5.  Across algorithms (chunked against the
# sequential oracle): tests/test_kernels.py's SSD bound, rtol 1e-3 / atol
# 1e-4.  bf16: the reference's bf16 bound, 5e-2.
SAME = dict(rtol=1e-5, atol=1e-5)
ACROSS = dict(rtol=1e-3, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _inputs(S, H, P, N, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (S, H, P)).astype(np.float32),
            (np.abs(rng.standard_normal(lead + (S, H))) * 0.1
             ).astype(np.float32),
            -np.abs(rng.standard_normal(H)).astype(np.float32),
            rng.standard_normal(lead + (S, N)).astype(np.float32),
            rng.standard_normal(lead + (S, N)).astype(np.float32),
            rng.standard_normal(H).astype(np.float32))


def _cast(arrays, jax_dtype=jnp.float32, torch_dtype=torch.float32):
    """x, dt, B, C in the dtype given; A and D stay f32."""
    j = [jnp.asarray(a, jax_dtype if i in (0, 1, 3, 4) else jnp.float32)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(torch_dtype if i in (0, 1, 3, 4)
                                else torch.float32)
         for i, a in enumerate(arrays)]
    return j, t


def _np(y):
    return y.float().numpy() if isinstance(y, torch.Tensor) else \
        np.asarray(y).astype(np.float32)


@pytest.mark.parametrize("with_d", [True, False])
def test_oracle_matches_jax_oracle(with_d):
    arrays = _inputs(128, 4, 16, 8)
    j, t = _cast(arrays)
    if not with_d:
        j[5], t[5] = None, None
    want = _np(jax_ref.ssd_ref(*j))
    np.testing.assert_allclose(_np(ref.ssd_ref(*t)), want, **SAME)


@pytest.mark.parametrize("with_d", [True, False])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_and_scan_match_jax(chunk, with_d):
    arrays = _inputs(128, 4, 16, 8)
    j, t = _cast(arrays)
    if not with_d:
        j[5], t[5] = None, None
    oracle = _np(jax_ref.ssd_ref(*j))
    want_chunked = _np(jax_chunked(*j, chunk=chunk))
    want_scan = _np(jax_scan(*j, chunk=chunk))
    got_chunked = _np(ss.ssd_chunked(*t, chunk=chunk))
    got_plain = _np(ss.ssd_scan_plain(*t, chunk=chunk))
    before = ss.ssd_scan.launches
    got_scan = _np(ss.ssd_scan(*t, chunk=chunk))
    assert ss.ssd_scan.launches == before     # CPU: the plain version
    np.testing.assert_allclose(got_chunked, want_chunked, **SAME)
    np.testing.assert_allclose(got_plain, want_scan, **SAME)
    np.testing.assert_allclose(got_scan, got_plain, rtol=0, atol=0)
    for got in (got_chunked, got_plain):
        np.testing.assert_allclose(got, oracle, **ACROSS)


@pytest.mark.parametrize("S,H,P,N,chunk", [(32, 1, 8, 4, 16),
                                           (64, 2, 16, 8, 16),
                                           (128, 2, 8, 4, 64)])
def test_other_widths(S, H, P, N, chunk):
    """tests/test_kernels.py's hypothesis widths, against the oracle."""
    arrays = _inputs(S, H, P, N, seed=S + H + P)
    j, t = _cast(arrays)
    want = _np(jax_ref.ssd_ref(*j))
    np.testing.assert_allclose(_np(ss.ssd_chunked(*t, chunk=chunk)), want,
                               **ACROSS)
    np.testing.assert_allclose(_np(ss.ssd_scan(*t, chunk=chunk)), want,
                               **ACROSS)


def test_bf16_each_side_of_the_d_add():
    """ssd_scan casts y to x's dtype and then adds (D·x) cast to it;
    ssd_chunked adds in f32 and casts once.  Each port matches its own
    JAX function within the bf16 bound and in all but a few elements
    exactly (one f32 sum rounding to the neighbouring bf16 value); the
    two orders differ in many more elements."""
    j, t = _cast(_inputs(128, 4, 16, 8), jnp.bfloat16, torch.bfloat16)
    want_scan = _np(jax_scan(*j, chunk=32))
    want_chunked = _np(jax_chunked(*j, chunk=32))
    got_scan = ss.ssd_scan(*t, chunk=32)
    got_chunked = ss.ssd_chunked(*t, chunk=32)
    assert got_scan.dtype == got_chunked.dtype == torch.bfloat16
    got_scan, got_chunked = _np(got_scan), _np(got_chunked)
    np.testing.assert_allclose(got_scan, want_scan, **BF16)
    np.testing.assert_allclose(got_chunked, want_chunked, **BF16)
    assert (got_scan != want_scan).mean() < 0.01
    assert (got_chunked != want_chunked).mean() < 0.01
    assert (want_scan != want_chunked).mean() > 0.1
    assert (got_scan != want_chunked).mean() > 0.1


def _passes(t, chunk):
    """The three plain passes composed: y (..., S, H, P) f32, no D."""
    x, dt, A, B, C = t[:5]
    states, decays = ss.ssd_chunk_states_plain(x, dt, A, B, chunk=chunk)
    h_in = ss.ssd_state_passing_plain(states, decays)
    return ss.ssd_chunk_outputs_plain(x, dt, A, B, C, h_in, chunk=chunk)


@pytest.mark.parametrize("S,H,P,N,chunk", [
    (128, 4, 16, 8, 32),
    (96, 2, 6, 5, 32),          # widths not 4k
    (256, 2, 8, 4, 128),        # chunk 128
    (512, 1, 8, 8, 256),        # chunk 256
    (128, 1, 128, 16, 64),      # P 128
    (128, 1, 8, 256, 64),       # N 256
    (128, 1, 65, 129, 64),      # P 65, N 129: a tile and one more
])
def test_passes_compose_to_jax_kernel(S, H, P, N, chunk):
    arrays = _inputs(S, H, P, N, seed=S + P + N)
    j, t = _cast(arrays)
    y = _passes(t, chunk)
    skip = (t[5][:, None] * t[0].float())
    want_scan = _np(jax_scan(*j, chunk=chunk))
    want_chunked = _np(jax_chunked(*j, chunk=chunk))
    np.testing.assert_allclose(_np(y + skip), want_scan, **ACROSS)
    np.testing.assert_allclose(_np(y + skip), want_chunked, **ACROSS)
    np.testing.assert_allclose(_np(y), _np(ss._chunk_scan(*t[:5], chunk)),
                               **ACROSS)
    np.testing.assert_allclose(_np(y + skip),
                               _np(ss.ssd_scan_plain(*t, chunk=chunk)),
                               **ACROSS)


def test_passes_with_a_batch_axis():
    """Leading dims ride through every pass, and the passes are the state
    recurrence of ``_chunk_scan`` in the same order."""
    arrays = _inputs(64, 3, 8, 4, seed=5, lead=(2,))
    _, t = _cast(arrays)
    states, decays = ss.ssd_chunk_states_plain(*t[:4], chunk=16)
    assert states.shape == (2, 4, 3, 8, 4) and decays.shape == (2, 4, 3)
    h_in = ss.ssd_state_passing_plain(states, decays)
    assert torch.equal(h_in[:, 0], torch.zeros_like(h_in[:, 0]))
    y = ss.ssd_chunk_outputs_plain(*t[:5], h_in, chunk=16)
    np.testing.assert_allclose(_np(y), _np(ss._chunk_scan(*t[:5], 16)),
                               **SAME)


def test_workspace_size():
    """A state and a decay per (sequence, chunk, head), s per step and
    head, and each chunk's C B^T, as ssd_scan_launch reads it."""
    x = torch.zeros((2, 192, 3, 8))
    B = torch.zeros((2, 192, 5))
    assert ss._workspace(x, B, 64).numel() == 2 * (3 * 3 * (8 * 5 + 1)
                                                   + 192 * (3 + 64)) + 8


def test_chunk_must_divide_s():
    j, t = _cast(_inputs(96, 2, 8, 4))
    with pytest.raises(ValueError, match="must divide chunk"):
        jax_scan(*j, chunk=64)
    for fn in (ss.ssd_scan, ss.ssd_scan_plain):
        with pytest.raises(ValueError, match="must divide chunk"):
            fn(*t, chunk=64)
    with pytest.raises(ValueError, match="must divide chunk"):
        ss.ssd_chunked(*t, chunk=64)
    # chunk = min(chunk, S): a chunk longer than S is one chunk of S
    np.testing.assert_allclose(_np(ss.ssd_scan(*t, chunk=128)),
                               _np(jax_scan(*j, chunk=128)), **SAME)


def test_shape_checks():
    _, t = _cast(_inputs(32, 2, 8, 4))
    x, dt, A, B, C, D = t
    with pytest.raises(ValueError, match="expected dt"):
        ss.ssd_scan(x, dt[:, :1], A, B, C, D)
    with pytest.raises(ValueError, match="expected dt"):
        ss.ssd_scan(x, dt, A, B, C[:, :2], D)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_ops_ssd_leading_batch_dim(backend):
    """(batch, S, H, P) through ops.ssd against the reference's ops.ssd,
    which vmaps its kernel (backend "pallas") or its XLA path over the
    leading dim; on the CPU "cuda" takes the plain version."""
    arrays = _inputs(64, 3, 8, 4, seed=5, lead=(2,))
    j, t = _cast(arrays)
    jax_backend = {"torch": "xla", "cuda": "pallas"}[backend]
    want = _np(jax_ops.ssd(*j[:5], j[5], chunk=16, backend=jax_backend))
    before = ss.ssd_scan.launches
    got = ops.ssd(*t[:5], t[5], chunk=16, backend=backend)
    assert ss.ssd_scan.launches == before
    assert got.shape == (2, 64, 3, 8)
    np.testing.assert_allclose(_np(got), want, **SAME)
    # each row of the batch is the single-sequence function on that row
    one = _np(ss.ssd_scan_plain(*(a[1] for a in t[:2]), t[2], t[3][1],
                                t[4][1], t[5], chunk=16))
    np.testing.assert_allclose(_np(got)[1], one, **SAME)


def test_ops_ssd_refuses_an_unknown_backend():
    _, t = _cast(_inputs(16, 1, 4, 4))
    with pytest.raises(ValueError, match="unknown backend"):
        ops.ssd(*t, backend="xla")
