"""rt_tpu_torch.rng against jax.random (threefry2x32, partitionable keys):
keys and folds, ``uniform`` and ``unit_vector(mode="reference")`` bit for
bit, ``mode="sphere"`` within its stated tolerance, and the fold chain of
``integrator.render_pixels`` for one chunk."""

import jax
import numpy as np
import pytest
import torch

from rt_tpu import rng as jrng
from rt_tpu_torch import rng as trng

SEEDS = (0, 1, 17, -3, 2**31 - 1)
CHAINS = ((0,), (3, 1), (7, 2, 5))


def _keys(seed, chain):
    jk = jrng.fold(jrng.make_key(seed), *chain)
    return jk, trng.fold(trng.make_key(seed), *chain)


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_folds_equal(seed):
    assert trng.make_key(seed) == tuple(int(w) for w in jax.random.key_data(jrng.make_key(seed)))
    for chain in CHAINS:
        jk, tk = _keys(seed, chain)
        assert tk == tuple(int(w) for w in jax.random.key_data(jk)), chain


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_exact(seed):
    for chain in CHAINS:
        jk, tk = _keys(seed, chain)
        for shape in ((1,), (5,), (1000,), (100, 3), (196608,)):
            want = jrng.uniform(jk, shape)
            got = trng.uniform(tk, shape, device="cpu")
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                          err_msg=f"{chain} {shape}")


@pytest.mark.parametrize("seed", SEEDS)
def test_unit_vector_reference_bit_exact(seed):
    for chain in CHAINS:
        jk, tk = _keys(seed, chain)
        want = jrng.unit_vector(jk, (4096,), mode="reference")
        got = trng.unit_vector(tk, (4096,), mode="reference", device="cpu")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want), err_msg=str(chain))


def test_sphere_mode_within_tolerance():
    """``jax.random.normal`` goes through XLA's float32 erfinv, whose log1p
    is XLA's own: the port's Giles polynomial (with the fused multiply-adds
    XLA's CPU backend emits) differs from it in about 1% of the values, by
    at most 3 ulp (measured 3 on every seed and chain here); torch.erfinv
    would differ in 59% of them, by up to 86 ulp.  The unit vectors differ
    by at most 1.2e-7."""
    differ = total = 0
    for seed in SEEDS:
        for chain in CHAINS:
            jk, tk = _keys(seed, chain)
            want = np.asarray(jax.random.normal(jk, (30000,)))
            got = trng.normal(tk, (30000,), device="cpu").numpy()
            ulp = np.abs(_bits(got).astype(np.int64) - _bits(want).astype(np.int64))
            assert ulp.max() <= 3, (seed, chain, ulp.max())
            differ += (ulp > 0).sum()
            total += ulp.size
            uv = trng.unit_vector(tk, (4096,), mode="sphere", device="cpu").numpy()
            np.testing.assert_allclose(uv, np.asarray(jrng.unit_vector(jk, (4096,), mode="sphere")),
                                       rtol=0, atol=2.5e-7)
    assert differ / total < 0.02, differ / total
    with pytest.raises(ValueError, match="unit_vector mode"):
        trng.unit_vector(trng.make_key(0), (2,), mode="cube", device="cpu")


def test_render_pixels_fold_chain_bit_exact():
    """One chunk of ``render_pixels`` (sample 2, chunk 1 at chunk_offset 5):
    the jitter and every bounce's unit vectors and coins, bit for bit."""
    n, depth = 512, 4
    jkey, tkey = jrng.make_key(42), trng.make_key(42)
    jkc = jrng.fold(jkey, 2, 5 + 1)
    tkc = trng.fold(tkey, 2, 5 + 1)
    assert tkc == tuple(int(w) for w in jax.random.key_data(jkc))
    np.testing.assert_array_equal(
        _bits(trng.uniform(trng.fold(tkc, 0), (n, 2), device="cpu").numpy()),
        _bits(jrng.uniform(jrng.fold(jkc, 0), (n, 2))))
    jtrace, ttrace = jrng.fold(jkc, 3), trng.fold(tkc, 3)
    from rt_tpu_torch.integrator import _draws

    ur, coin = _draws(ttrace, depth, n, "reference", "cpu")
    assert ur.shape == (depth, n, 3) and coin.shape == (depth, n)
    for b in range(depth):
        kb = jrng.fold(jtrace, b)
        np.testing.assert_array_equal(_bits(ur[b].numpy()),
                                      _bits(jrng.unit_vector(jrng.fold(kb, 1), (n,))))
        np.testing.assert_array_equal(_bits(coin[b].numpy()),
                                      _bits(jrng.uniform(jrng.fold(kb, 2), (n,))))


def test_list_of_keys_draws_each_key():
    """A list of keys draws one row per key, equal to that key's own draw."""
    keys = [trng.fold(trng.make_key(s), 1, 2) for s in (0, 9, -3)]
    for fn, shape in ((trng.uniform, (40, 3)), (trng.normal, (41,)),
                      (trng.unit_vector, (17,))):
        rows = fn(keys, shape, device="cpu")
        assert tuple(rows.shape) == (3,) + tuple(fn(keys[0], shape, device="cpu").shape)
        for k, row in zip(keys, rows):
            assert torch.equal(row, fn(k, shape, device="cpu")), fn.__name__
    assert torch.equal(trng.random_bits(keys, 7, device="cpu")[1],
                       trng.random_bits(keys[1], 7, device="cpu"))
