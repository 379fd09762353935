"""Interleavers of the PyTorch port against the JAX package: the random
interleaver (NumPy's ``default_rng(seed).permutation``), the 3GPP turbo
interleaver and the deinterleaver of each, bit-exact (they are
permutations)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sionna_tpu.phy.fec.interleaving as jil
from sionna_tpu.phy import config as jax_config
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.fec.interleaving import (Deinterleaver,
                                                   RandomInterleaver,
                                                   RowColumnInterleaver,
                                                   Turbo3GPPInterleaver)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("axis,shape", [(-1, (3, 4, 97)), (1, (2, 50, 3))])
def test_random_interleaver_matches_jax(axis, shape):
    x = _x(shape)
    for inverse in (False, True):
        ti = RandomInterleaver(seed=1234, axis=axis, inverse=inverse)
        ji = jil.RandomInterleaver(seed=1234, axis=axis, inverse=inverse)
        np.testing.assert_array_equal(ti(torch.as_tensor(x)).numpy(),
                                      np.asarray(ji(jnp.asarray(x))))
    ti, ji = RandomInterleaver(seed=5, axis=axis), \
        jil.RandomInterleaver(seed=5, axis=axis)
    # a call-time seed, and the spread factor of its permutation
    np.testing.assert_array_equal(ti(torch.as_tensor(x), seed=77).numpy(),
                                  np.asarray(ji(jnp.asarray(x), seed=77)))
    assert ti.find_s_min(77, shape[axis]) == ji.find_s_min(77, shape[axis])
    # keep_state=False: each call takes the next seed of the same stride
    ts = RandomInterleaver(seed=9, keep_state=False, axis=axis)
    js = jil.RandomInterleaver(seed=9, keep_state=False, axis=axis)
    for _ in range(3):
        np.testing.assert_array_equal(ts(torch.as_tensor(x)).numpy(),
                                      np.asarray(js(jnp.asarray(x))))
    # integer inputs pass through uncast
    xi = np.arange(np.prod(shape)).reshape(shape)
    out = ti(torch.as_tensor(xi))
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), np.asarray(ji(xi)))


def test_random_interleaver_seed_from_config():
    """``seed=None`` draws the seed from ``config.np_rng``, in both
    packages from a NumPy generator seeded alike."""
    old_seed = torch_config.seed
    torch_config.seed = 11
    jax_config.seed = 11
    try:
        ti, ji = RandomInterleaver(), jil.RandomInterleaver()
    finally:
        torch_config.seed = old_seed
    assert ti.seed == ji.seed
    x = _x((2, 64))
    np.testing.assert_array_equal(ti(torch.as_tensor(x)).numpy(),
                                  np.asarray(ji(jnp.asarray(x))))
    with pytest.raises(TypeError):
        RandomInterleaver(seed=1.5)


@pytest.mark.parametrize("n", [40, 1000, 1001, 6144])
def test_turbo_interleaver_matches_jax(n):
    x = _x((2, n))
    for inverse in (False, True):
        ti = Turbo3GPPInterleaver(inverse=inverse)
        ji = jil.Turbo3GPPInterleaver(inverse=inverse)
        got = ti(torch.as_tensor(x))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ji(jnp.asarray(x))))
        assert ti.frame_size == n
    with pytest.raises(ValueError):
        Turbo3GPPInterleaver()(torch.zeros(1, 6145))


def test_deinterleaver_round_trips():
    """Each interleaver's deinterleaver, against JAX's and as the
    inverse; the random one with a call-time ``seed``."""
    x = _x((3, 2, 120))
    tx = torch.as_tensor(x)
    for ti, ji in ((RandomInterleaver(seed=3), jil.RandomInterleaver(seed=3)),
                   (Turbo3GPPInterleaver(), jil.Turbo3GPPInterleaver()),
                   (RowColumnInterleaver(7), jil.RowColumnInterleaver(7))):
        td, jd = Deinterleaver(ti), jil.Deinterleaver(ji)
        assert td.interleaver is ti
        np.testing.assert_array_equal(td(ti(tx)).numpy(), x)
        np.testing.assert_array_equal(td(tx).numpy(),
                                      np.asarray(jd(jnp.asarray(x))))
    ti, ji = RandomInterleaver(seed=3), jil.RandomInterleaver(seed=3)
    td, jd = Deinterleaver(ti), jil.Deinterleaver(ji)
    y = ti(tx, seed=42)
    np.testing.assert_array_equal(td(y, seed=42).numpy(), x)
    assert not torch.equal(td(y), tx)  # the stored seed is another one
    np.testing.assert_array_equal(td(tx, seed=42).numpy(),
                                  np.asarray(jd(jnp.asarray(x), seed=42)))
    with pytest.raises(TypeError):
        Deinterleaver(object())
