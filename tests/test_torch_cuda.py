"""The port's hand-written CUDA kernels against their plain versions, on a
GPU.  Every test here is marked ``cuda`` and skips where no card is
present.  The file imports no JAX, so it runs on a machine with PyTorch
alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import decode_attention as da
from repro_torch.models.model import Model, RunConfig
from repro_torch.serve.engine import Engine, EngineConfig

TOL, TOL_BF16 = 2e-5, 5e-2      # tests/test_kernels.py's bounds
# bf16 output rounding: half a bf16 ulp, at most 2^-8 of the value, over
# the plain version in f32 on the same bf16 inputs (the kernel's
# statistics are f32, so it rounds once, at the output)
BF16_ROUND = 2.0 ** -8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, dtype, B, KV, rep, hd, Smax, valid, seed=0):
    """q and a (B, Smax, KV, hd) cache read through transposed views, as
    the model passes them."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, KV, rep, hd))).to(dev, dtype)
    cache = torch.from_numpy(rng.standard_normal((2, B, Smax, KV, hd)))
    cache = cache.to(dev, dtype)
    valid = torch.tensor(valid, dtype=torch.int32, device=dev)
    return q, cache[0].transpose(1, 2), cache[1].transpose(1, 2), valid


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("shape,valid,block_k", [
    ((4, 4, 7, 128, 161), [0, 1, 129, 161], 256),   # the serving smoke's
    ((3, 2, 4, 32, 512), [17, 256, 511], 128),      # several tiles
    ((2, 1, 9, 64, 96), [96, 40], 32),              # rep above one chunk
    ((1, 2, 2, 256, 64), [70, ], 64),               # hd 256, valid > Smax
    ((2, 2, 7, 128, 300), [257, 300], 150),         # partial last tile
])
def test_kernel_matches_plain(cuda, dtype, tol, shape, valid, block_k):
    q, k, v, valid = _inputs(cuda, dtype, *shape, valid)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, valid, block_k=block_k)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = da.decode_attention_ref(q, k, v, valid)
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        want32 = da.decode_attention_ref(q.float(), k.float(), v.float(),
                                         valid)
        assert ((got.float() - want32).abs()
                <= BF16_ROUND * want32.abs() + TOL).all()


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, valid = _inputs(cuda, torch.float32, 1, 1, 2, 16, 32, [4])
    with pytest.raises(TypeError):
        da.decode_attention(q.half(), k.half(), v.half(), valid)
    with pytest.raises(TypeError):
        da.decode_attention(q, k, v, valid.long())
    wide = torch.zeros((1, 1, 32, 32), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        da.decode_attention(q, wide, wide, valid)


def _models(cuda):
    cfg = dataclasses.replace(reduced(get_config("qwen2_7b")), num_heads=14,
                              num_kv_heads=2, head_dim=8)
    m = Model(cfg, RunConfig(backend="cuda"), cuda)
    plain = Model(cfg, RunConfig(backend="torch"), cuda)
    return cfg, m, plain, m.init(torch.Generator(device=cuda).manual_seed(0))


@pytest.mark.parametrize("depth", [16, 300, 547])
def test_model_decode_runs_the_kernel(cuda, depth):
    """Cache depths of one tile, of tiles of 150 (300) and of tiles of 1
    (the prime 547)."""
    cfg, m, plain, params = _models(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda)
    c1, c2 = m.cache_init(2, depth), plain.cache_init(2, depth)
    m.apply(params, toks[:, :8], cache=c1)
    plain.apply(params, toks[:, :8], cache=c2)
    before = da.decode_attention.launches
    a, _ = m.apply(params, toks[:, 8:], cache=c1)
    b, _ = plain.apply(params, toks[:, 8:], cache=c2)
    assert da.decode_attention.launches == before + cfg.num_layers
    assert (a - b).abs().max().item() < 1e-4


def test_engine_serves_past_one_tile(cuda):
    """max_len 300 (a 512-deep cache), decode reaching 291 valid
    positions: the kernel's greedy stream is the plain version's."""
    cfg, m, plain, params = _models(cuda)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 280)).astype(np.int32)
    before = da.decode_attention.launches
    got = Engine(m, params, EngineConfig(max_len=300)).generate(prompts, 12)
    assert da.decode_attention.launches == before + cfg.num_layers * 12
    want = Engine(plain, params, EngineConfig(max_len=300)).generate(
        prompts, 12)
    np.testing.assert_array_equal(got, want)
