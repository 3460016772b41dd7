"""The port's flash attention and ``ops.attention`` against the JAX
package's.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_kernels.py does,
and its oracle.  Inputs are made with numpy from a seed.  The hand-written
kernel itself is held against the plain version on a GPU, in
test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

# tests/test_kernels.py's bounds: f32 attention 2e-5 (two f32 softmaxes
# that sum in another order), bf16 5e-2 (one bf16 rounding of O(1) values
# on each side, which may land on neighbouring bf16 values)
TOL, TOL_BF16 = 2e-5, 5e-2


def _qkv(seed, bh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d)))


def _jax_ref(q, k, v, **kw):
    return np.asarray(jax.vmap(lambda a, b, c: jax_ref.attention_ref(
        a, b, c, **kw))(*(jnp.asarray(t) for t in (q, k, v))))


def _port(q, k, v, dtype=torch.float32, **kw):
    out = fa.flash_attention(*(torch.from_numpy(t).to(dtype)
                               for t in (q, k, v)), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


# tests/test_kernels.py:34-40: Sk > Sq, a window, no causal mask
@pytest.mark.parametrize("sq,sk,d,causal,window", [
    (128, 128, 64, True, None),
    (128, 128, 64, False, None),
    (64, 128, 32, True, 32),
    (256, 256, 64, True, 128),
    (128, 256, 128, True, None),
])
def test_matches_jax_kernel_and_oracle(sq, sk, d, causal, window):
    q, k, v = _qkv(sq + sk + d, 3, sq, sk, d)
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                block_q=64, block_k=64))
    want = _jax_ref(q, k, v, causal=causal, window=window)
    got = _port(q, k, v, causal=causal, window=window, block_q=64,
                block_k=64)
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the oracle alone, with the reference's signature (one head)
    one = ref.attention_ref(*(torch.from_numpy(t[0]) for t in (q, k, v)),
                            causal=causal, window=window).numpy()
    np.testing.assert_allclose(one, want[0], rtol=TOL, atol=TOL)


def test_row_masked_everywhere_is_mean_of_v():
    """Sk < Sq under a causal mask: query rows before position 0 see no
    key, their logits are all -1e30, and they return the mean of V."""
    sq, sk, d = 128, 64, 32
    q, k, v = _qkv(7, 2, sq, sk, d)
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=64, block_k=64))
    got = _port(q, k, v, block_q=64, block_k=64)
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got[:, :sq - sk], np.broadcast_to(v.mean(axis=1)[:, None],
                                          (2, sq - sk, d)),
        rtol=TOL, atol=TOL)


def test_scale_and_window_without_causal():
    q, k, v = _qkv(3, 2, 64, 64, 16)
    kw = dict(causal=False, window=8, scale=0.3)
    kern = np.asarray(jax_flash(*(jnp.asarray(t) for t in (q, k, v)),
                                block_q=32, block_k=32, **kw))
    got = _port(q, k, v, block_q=32, block_k=32, **kw)
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)


def test_blocks_must_divide_the_lengths():
    q, k, v = _qkv(0, 1, 96, 96, 16)
    with pytest.raises(ValueError, match="must divide blocks"):
        jax_flash(*(jnp.asarray(t) for t in (q, k, v)), block_q=64)
    with pytest.raises(ValueError, match="must divide blocks"):
        _port(q, k, v, block_q=64)
    with pytest.raises(ValueError, match="must divide blocks"):
        _port(q, k, v, block_k=64)
    with pytest.raises(ValueError, match="expected q"):
        fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, k[:, :, :8])))


@pytest.mark.parametrize("bq,bk", [(32, 32), (32, 128), (128, 64)])
def test_block_invariance(bq, bk):
    """tests/test_kernels.py:54-65: the output does not depend on the
    tiles; the port at (bq, bk) against the JAX kernel at 128 x 128."""
    q, k, v = _qkv(42, 2, 128, 128, 32)
    want = np.asarray(jax_flash(*(jnp.asarray(t) for t in (q, k, v)),
                                block_q=128, block_k=128))
    got = _port(q, k, v, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bf16():
    q, k, v = _qkv(5, 2, 128, 128, 64)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    kern = np.asarray(jax_flash(jq, jk, jv)).astype(np.float32)
    got = _port(q, k, v, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, kern, rtol=TOL_BF16, atol=TOL_BF16)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_ops_attention_leading_dims(backend, causal, window):
    """(B, H, S, D) through ops.attention against the reference's
    ops.attention with backend "pallas"; on the CPU "cuda" takes the
    plain version and launches nothing."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 3, 64, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 96, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 96, 16)).astype(np.float32)
    want = np.asarray(jax_ops.attention(
        *(jnp.asarray(t) for t in (q, k, v)), causal=causal, window=window,
        backend="pallas", block_q=32, block_k=32))
    before = fa.flash_attention.launches
    got = ops.attention(*(torch.from_numpy(t) for t in (q, k, v)),
                        causal=causal, window=window, backend=backend,
                        block_q=32, block_k=32)
    assert fa.flash_attention.launches == before
    assert got.shape == (2, 3, 64, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_ops_attention_refuses_an_unknown_backend():
    q = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="unknown backend"):
        ops.attention(q, q, q, backend="pallas")
