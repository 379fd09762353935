"""The discrete channels of the PyTorch port against the JAX package:
the binary memoryless, symmetric, Z and erasure channels.

Each port channel is fed the uniforms that JAX draws from the same key
(its key splits replayed here), in place of its own draw; then
- outputs (bits, bipolar symbols, erasure marks, LLRs of scalar flip
  probabilities): bit-exact; LLRs of per-position probabilities: signs
  bit-exact, values within LLR_RTOL of the largest (each is a
  difference of two logs, and XLA:CPU's f32 log and torch's differ by
  1 ULP for some arguments);
- gradients into the input and the flip probabilities, through the
  Gumbel softmax and the straight-through estimators, against
  ``jax.grad``: GRAD_RTOL of the largest, the gradient of a scalar flip
  probability summing 150 positions in another order. With a bipolar
  input, ``jax.grad`` of the JAX package raises in its own x64 mode
  (its binarizer returns float64 for a float32 input there, and the
  product ``x * (1 - 2 e)`` then mixes the two in the backward pass);
  its reference gradient is taken with x64 off, where the same forward
  pass gives the same outputs.
The port's own draws are held by statistics: flip and erasure rates
within 5 standard errors of pb.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.channel as jch
import sionna_tpu_torch.phy.channel as tch
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)

GRAD_RTOL = 1e-5
LLR_RTOL = 1e-6
NAMES = ["BinaryMemorylessChannel", "BinarySymmetricChannel",
         "BinaryZChannel", "BinaryErasureChannel"]


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _jax_uniforms(name, key, shape):
    """The (u1, u2) pairs the JAX channel draws from ``key``, in the
    order the port's sampler asks for them: the erasure channel samples
    once from ``key``; the others split it for their two samplers."""
    keys = [key] if name == "BinaryErasureChannel" \
        else list(jax.random.split(key))
    pairs = []
    for k in keys:
        ka, kb = jax.random.split(k)
        pairs.append(tuple(torch.as_tensor(np.array(jax.random.uniform(
            kk, shape, jnp.float32))) for kk in (ka, kb)))
    return pairs


def _replay(channel, pairs):
    """Makes the port's ``channel`` take ``pairs`` as its draws."""
    it = iter(pairs)
    channel._draw_uniforms = lambda shape, generator, device: next(it)
    return channel


def _pb(name):
    return (np.array([0.2, 0.35], np.float32)
            if name == "BinaryMemorylessChannel" else np.float32(0.3))


def _inputs(bipolar, shape=(6, 50), seed=0):
    x = np.random.default_rng(seed).integers(0, 2, shape).astype(np.float32)
    return 2 * x - 1 if bipolar else x


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("bipolar", [False, True])
@pytest.mark.parametrize("llrs", [False, True])
def test_outputs_match_jax_on_its_uniforms(name, bipolar, llrs):
    x, pb = _inputs(bipolar), _pb(name)
    key = jax.random.PRNGKey(3)
    kw = dict(return_llrs=llrs, bipolar_input=bipolar, llr_max=20.)
    want = np.asarray(getattr(jch, name)(**kw)(jnp.asarray(x),
                                               jnp.asarray(pb), key=key))
    port = _replay(getattr(tch, name)(**kw),
                   _jax_uniforms(name, key, x.shape))
    got = port(torch.as_tensor(x), torch.as_tensor(pb)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # some symbols changed, most did not
    changed = (np.sign(got) != (x if bipolar else 2 * x - 1)) if llrs \
        else got != x
    assert 0 < changed.mean() < 0.6, changed.mean()


def test_memoryless_channel_pb_forms_and_llr_clip():
    """pb as a tuple, per-position probabilities, the LLR clip at
    llr_max, and pb outside [0, 1] clipped."""
    x = _inputs(False, (4, 40), seed=1)
    key = jax.random.PRNGKey(4)
    pb_pos = np.random.default_rng(2).uniform(0.0, 0.5, (40, 2)).astype(
        np.float32)
    for pb, llr_max in (((0.001, 0.4), 5.0), (pb_pos, 100.0),
                        ((-0.1, 1.2), 3.0)):
        jpb = tuple(map(jnp.float32, pb)) if isinstance(pb, tuple) \
            else jnp.asarray(pb)
        tpb = tuple(map(float, pb)) if isinstance(pb, tuple) \
            else torch.as_tensor(pb)
        want = np.asarray(jch.BinaryMemorylessChannel(
            return_llrs=True, llr_max=llr_max)(jnp.asarray(x), jpb, key=key))
        port = _replay(tch.BinaryMemorylessChannel(return_llrs=True,
                                                   llr_max=llr_max),
                       _jax_uniforms("BinaryMemorylessChannel", key,
                                     x.shape))
        got = port(torch.as_tensor(x), tpb).numpy()
        np.testing.assert_array_equal(np.sign(got), np.sign(want))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LLR_RTOL * np.abs(want).max())
        assert np.abs(got).max() <= llr_max


def _loss_weights(shape):
    return np.random.default_rng(5).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", ["BinaryMemorylessChannel",
                                  "BinarySymmetricChannel",
                                  "BinaryZChannel"])
@pytest.mark.parametrize("bipolar,llrs", [(False, False), (True, False),
                                          (False, True)])
def test_gradients_match_jax(name, bipolar, llrs):
    """d/dx and d/dpb of sum(w * channel(x, pb)) on JAX's uniforms."""
    x, pb = _inputs(bipolar, (5, 30), seed=6), _pb(name)
    w = _loss_weights(x.shape)
    key = jax.random.PRNGKey(7)
    kw = dict(return_llrs=llrs, bipolar_input=bipolar)
    jchan = getattr(jch, name)(**kw)

    def loss(xx, pp):
        return jnp.sum(jnp.asarray(w) * jchan(xx, pp, key=key))

    with jax.enable_x64(not bipolar):
        gx_j, gp_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(pb))
    tx = torch.tensor(x, requires_grad=True)
    tp = torch.tensor(pb, requires_grad=True)
    port = _replay(getattr(tch, name)(**kw),
                   _jax_uniforms(name, key, x.shape))
    (torch.as_tensor(w) * port(tx, tp)).sum().backward()
    for got, want in ((tx.grad, gx_j), (tp.grad, gp_j)):
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * scale)
    assert np.abs(np.asarray(gp_j)).max() > 0


def test_straight_through_estimators():
    """The binarizer passes its gradient unchanged; XOR passes the same
    gradient to both inputs."""
    from sionna_tpu_torch.phy.channel.discrete_channel import (
        _SteBinarizer, _XorSte)
    v = torch.tensor([0.1, 0.5, 0.7], requires_grad=True)
    out = _SteBinarizer.apply(v)
    assert out.tolist() == [0.0, 1.0, 1.0]
    out.backward(torch.tensor([1., 2., 3.]))
    assert v.grad.tolist() == [1., 2., 3.]
    a = torch.tensor([0., 1.], requires_grad=True)
    b = torch.tensor([1., 1.], requires_grad=True)
    _XorSte.apply(a, b).backward(torch.tensor([4., 5.]))
    assert a.grad.tolist() == b.grad.tolist() == [4., 5.]


def _rate_ok(rate, p, n):
    assert abs(rate - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12, \
        (rate, p, n)


def test_flip_rates_by_statistics():
    """The port's own draws: the flip rate of each input value, the
    erasure rate, and the LLR signs of the BSC."""
    n = 200000
    g = torch.Generator().manual_seed(8)
    x = torch.as_tensor(_inputs(False, (n,), seed=9))
    zeros, ones = x == 0, x == 1
    y = tch.BinaryMemorylessChannel()(x, (0.05, 0.2), generator=g)
    _rate_ok(float((y[zeros] != 0).float().mean()), 0.05, int(zeros.sum()))
    _rate_ok(float((y[ones] != 1).float().mean()), 0.2, int(ones.sum()))
    y = tch.BinarySymmetricChannel()(x, 0.1, generator=g)
    _rate_ok(float((y != x).float().mean()), 0.1, n)
    y = tch.BinaryZChannel()(x, 0.3, generator=g)
    assert not bool((y[zeros] != 0).any())
    _rate_ok(float((y[ones] != 1).float().mean()), 0.3, int(ones.sum()))
    y = tch.BinaryErasureChannel()(x, 0.25, generator=g)
    erased = y == -1
    _rate_ok(float(erased.float().mean()), 0.25, n)
    assert torch.equal(y[~erased], x[~erased])
    llr = tch.BinaryErasureChannel(return_llrs=True, bipolar_input=True)(
        2 * x - 1, 0.25, generator=g)
    _rate_ok(float((llr == 0).float().mean()), 0.25, n)
    llr = tch.BinarySymmetricChannel(return_llrs=True)(x, 0.1, generator=g)
    want = np.log(0.9 / 0.1)
    np.testing.assert_allclose(np.unique(np.abs(llr.numpy())), [want],
                               rtol=1e-6)
    _rate_ok(float((torch.sign(llr) != 2 * x - 1).float().mean()), 0.1, n)


def test_setters_check():
    ch = tch.BinarySymmetricChannel()
    ch.llr_max, ch.temperature = 7, 0.5
    assert (ch.llr_max, ch.temperature) == (7.0, 0.5)
    with pytest.raises(ValueError):
        ch.llr_max = -1
    with pytest.raises(ValueError):
        ch.temperature = -0.1
