"""The port's decode_attention against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode and its oracle.  The plain version
of the kernel's split-KV ranges and merge, ``decode_attention_split_ref``,
is held to both at several split counts.  Inputs are made
with numpy from a seed.  The hand-written kernel itself is held against the
plain version on a GPU, in test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import decode_attention as jax_da
from repro_torch.kernels import decode_attention as da

TOL = 2e-5          # tests/test_kernels.py's bound for decode attention
TOL_BF16 = 5e-2     # the reference's bf16 bound


def _inputs(seed, B, KV, rep, hd, Smax, valid):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, rep, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Smax, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Smax, hd)).astype(np.float32)
    return q, k, v, np.asarray(valid, np.int32)


def _jax(q, k, v, valid, block_k):
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    kern = jax_da.decode_attention(*args, block_k=block_k)
    ref = jax_da.decode_attention_ref(*args)
    return np.asarray(kern), np.asarray(ref)


def _port(q, k, v, valid, block_k, device="cpu"):
    t = [torch.from_numpy(a).to(device) for a in (q, k, v, valid)]
    return da.decode_attention(*t, block_k=block_k).cpu().numpy()


CASES = {
    # tests/test_kernels.py:138-151
    "vs_ref": ((3, 2, 4, 32, 512), [17, 256, 511], 128),
    # tests/test_kernels.py:154-165
    "boundary_1": ((1, 1, 2, 16, 512), [1], 256),
    "boundary_100": ((1, 1, 2, 16, 512), [100], 256),
    "boundary_512": ((1, 1, 2, 16, 512), [512], 256),
    # qwen2-7b's group (rep 7, hd 128) at the serving smoke's cache depth
    "odd_group": ((4, 4, 7, 128, 161), [0, 1, 129, 161], 256),
    # an empty cache: every position masked, output = mean of V
    "valid_0": ((2, 1, 3, 16, 64), [0, 0], 32),
    # a cache deeper than one 256 tile that 256 does not divide, at the
    # tile the model picks for it (models.layers.decode_block(300) = 150)
    "deep_cache": ((2, 2, 7, 16, 300), [257, 300], 150),
}


@functools.lru_cache(maxsize=None)
def _case(case):
    """A case's inputs and the JAX kernel's and oracle's results."""
    shape, valid, block_k = CASES[case]
    q, k, v, valid = _inputs(len(case), *shape, valid)
    return (q, k, v, valid), _jax(q, k, v, valid, block_k)


# split counts: one range, a few, split_plan's own (None), one position a
# range, and more ranges than positions (the last ones empty)
SPLITS = [1, 2, 3, 7, None, "smax", "smax+5"]


def _splits(spec, smax):
    if spec == "smax":
        return smax
    return smax + 5 if spec == "smax+5" else spec


@pytest.mark.parametrize("splits", SPLITS, ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_ref_matches_jax_kernel_and_oracle(case, splits):
    (q, k, v, valid), (kern, ref) = _case(case)
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    got = da.decode_attention_split_ref(*t, _splits(splits, k.shape[2]))
    np.testing.assert_allclose(got.numpy(), kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(),
                               da.decode_attention_ref(*t).numpy(),
                               rtol=TOL, atol=TOL)


# (valid, splits) on a 64-deep cache of ranges of 64 / splits: ranges wholly
# past valid, a boundary at valid - 1, valid and valid + 1, an empty cache,
# and more ranges than positions
EDGES = {
    "past_valid": ([5, 20], 8),          # ranges of 8: 1 and 3 live
    "boundary_below": ([15], 4),         # ranges of 16: 15 ends one short
    "boundary_at": ([16], 4),
    "boundary_above": ([17], 4),         # one live position in range 2
    "valid_0": ([0, 0], 4),
    "more_splits_than_positions": ([40, 64], 80),
}


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_split_ref_edges(edge):
    valid, splits = EDGES[edge]
    q, k, v, valid = _inputs(7, len(valid), 2, 3, 16, 64, valid)
    kern, ref = _jax(q, k, v, valid, 16)
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    got = da.decode_attention_split_ref(*t, splits).numpy()
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_split_ref_bf16_rounds_once():
    q, k, v, valid = _inputs(5, 2, 2, 4, 32, 64, [9, 0])
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    vt = torch.from_numpy(valid)
    got = da.decode_attention_split_ref(*t, vt, 5)
    assert got.dtype == torch.bfloat16
    want = da.decode_attention_split_ref(*(a.float() for a in t), vt, 5)
    assert torch.equal(got, want.to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), da.decode_attention_ref(
        *t, vt).float().numpy(), rtol=TOL_BF16, atol=TOL_BF16)


@pytest.mark.parametrize("smax,groups,want", [
    (161, 16, (11, 15)),      # the serving shapes: B 4 x KV 4, Smax 161
    (547, 4, (35, 16)),       # a prime depth: ranges of 16, not tiles of 1
    (512, 6, (32, 16)),
    (16, 16, (1, 16)),        # too short to split
    (4096, 16, (17, 241)),    # enough blocks: 17 x 16 = 272
    (161, 70000, (1, 161)),   # B * KV alone fills the card
])
def test_split_plan(smax, groups, want):
    splits, length = da.split_plan(smax, groups)
    assert (splits, length) == want
    assert (splits - 1) * length < smax <= splits * length
    assert da.kernels_per_call(splits) == (1 if splits == 1 else 2)
    assert da.split_plan(smax, groups, 7) == (7, -(-smax // 7))
    with pytest.raises(ValueError, match="splits=0"):
        da.split_plan(smax, groups, 0)


def test_wide_copies_need_16_byte_rows():
    cache = torch.zeros((2, 2, 40, 3, 16))
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    assert da.wide(k, v)
    assert not da.wide(k[..., :6], v[..., :6])            # hd 6: 24 bytes
    buf = torch.zeros(cache.numel() + 1)[1:].view(cache.shape)
    assert not da.wide(buf[0].transpose(1, 2), buf[1].transpose(1, 2))
    bf = cache.to(torch.bfloat16)
    assert da.wide(bf[0].transpose(1, 2), bf[1].transpose(1, 2))  # 8 x 2 B
    assert not da.wide(bf[0, ..., :4].transpose(1, 2),
                       bf[1, ..., :4].transpose(1, 2))


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_kernel_and_oracle(case):
    shape, valid, block_k = CASES[case]
    q, k, v, valid = _inputs(len(case), *shape, valid)
    kern, ref = _jax(q, k, v, valid, block_k)
    got = _port(q, k, v, valid, block_k)
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_valid_0_is_mean_of_v():
    q, k, v, valid = _inputs(3, 2, 2, 3, 16, 48, [0, 5])
    got = _port(q, k, v, valid, 16)
    np.testing.assert_allclose(
        got[0], np.broadcast_to(v[0].mean(axis=1)[:, None], got[0].shape),
        rtol=TOL, atol=TOL)


def test_strided_cache_view():
    """The model hands the wrapper transposed views of its (B, Smax, KV,
    hd) cache; the result must equal the contiguous layout's."""
    B, KV, rep, hd, Smax = 2, 3, 2, 16, 40
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, KV, rep, hd)).astype(np.float32)
    cache_k = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    cache_v = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    valid = np.asarray([7, 40], np.int32)
    kd = torch.from_numpy(cache_k).transpose(1, 2)
    vd = torch.from_numpy(cache_v).transpose(1, 2)
    assert not kd.is_contiguous()
    got = da.decode_attention(torch.from_numpy(q), kd, vd,
                              torch.from_numpy(valid)).numpy()
    kern, ref = _jax(q, np.swapaxes(cache_k, 1, 2),
                     np.swapaxes(cache_v, 1, 2), valid, 256)
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_bf16_matches_jax():
    q, k, v, valid = _inputs(5, 2, 2, 4, 32, 64, [9, 64])
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_da.decode_attention(
        *bf, jnp.asarray(valid), block_k=32).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = da.decode_attention(tq, tk, tv, torch.from_numpy(valid), block_k=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=TOL_BF16,
                               atol=TOL_BF16)


def test_block_k_must_divide_cache():
    q, k, v, valid = _inputs(0, 1, 1, 2, 16, 96, [5])
    with pytest.raises(ValueError, match="Smax=96 % block_k=64"):
        _port(q, k, v, valid, 64)
    with pytest.raises(ValueError):
        jax_da.decode_attention(*(jnp.asarray(a) for a in (q, k, v, valid)),
                                block_k=64)


def test_cpu_runs_plain_version_and_counts_no_launch():
    q, k, v, valid = _inputs(1, 1, 1, 2, 16, 32, [4])
    before = da.decode_attention.launches
    _port(q, k, v, valid, 32)
    assert da.decode_attention.launches == before


def test_rejects_bad_shapes_and_devices():
    q, k, v, valid = (torch.from_numpy(a) for a in
                      _inputs(2, 2, 1, 2, 16, 32, [4, 4]))
    with pytest.raises(ValueError, match="valid"):
        da.decode_attention(q, k, v, valid[:1])
    with pytest.raises(ValueError, match="Smax"):
        da.decode_attention(q, k, v[:, :, :16], valid)
    meta = [t.to("meta") for t in (q, k, v, valid)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        da.decode_attention(*meta)
