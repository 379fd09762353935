"""The signal blocks of the PyTorch port against the JAX package: the
windows, the pulse-shaping filters and up/down-sampling.

Tolerances:
- the windows' coefficients, the filters' taps and sampling times, and
  up/down-sampling: bit-exact (the same NumPy code on the host; index
  operations);
- window outputs: SIG_RTOL of the largest output, the normalizing mean
  being a reduction in another order;
- filter outputs: SIG_RTOL of the largest output, for every padding,
  with and without ``conjugate`` and each window: the taps' energy sum
  and the convolution (XLA's ``conv_general_dilated`` against torch's
  ``conv1d``) add in other orders;
- ``aclr``: ACLR_RTOL relative, NumPy FFTs of taps equal to f32
  rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sionna_tpu.phy.signal as jsig
import sionna_tpu_torch.phy.signal as tsig
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)

SIG_RTOL = 2e-6
ACLR_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _close(got, want, rtol=SIG_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want).max(initial=0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _signal(shape, complex_, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    if complex_:
        x = x + 1j * rng.normal(size=shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


WINDOWS = ["HannWindow", "HammingWindow", "BlackmanWindow"]


@pytest.mark.parametrize("name", WINDOWS)
@pytest.mark.parametrize("normalize", [False, True])
def test_windows_match_jax(name, normalize):
    jw = getattr(jsig, name)(normalize=normalize)
    tw = getattr(tsig, name)(normalize=normalize)
    for length, complex_ in ((33, False), (64, True), (33, True)):
        x = _signal((3, length), complex_)
        want = jw(jnp.asarray(x))
        got = tw(torch.as_tensor(x))
        # a new length regenerates (and keeps) the coefficients
        np.testing.assert_array_equal(tw.coefficients.numpy(),
                                      np.asarray(jw.coefficients))
        assert tw.length == jw.length == length
        _close(got, want)
    jd = getattr(jsig, name)(normalize=normalize, precision="double")
    td = getattr(tsig, name)(normalize=normalize, precision="double")
    x = _signal((2, 17), True).astype(np.complex128)
    _close(td(torch.as_tensor(x)), jd(jnp.asarray(x)), rtol=1e-14)
    np.testing.assert_array_equal(td.coefficients.numpy(),
                                  np.asarray(jd.coefficients))


def test_custom_window_matches_jax():
    coeffs = np.random.default_rng(1).uniform(size=20)
    x = _signal((4, 20), True)
    for normalize in (False, True):
        jw = jsig.CustomWindow(coeffs, normalize=normalize)
        tw = tsig.CustomWindow(coeffs, normalize=normalize)
        np.testing.assert_array_equal(tw.coefficients.numpy(),
                                      np.asarray(jw.coefficients))
        _close(tw(torch.as_tensor(x)), jw(jnp.asarray(x)))
    with pytest.raises(ValueError):
        tw(torch.zeros(4, 21))
    with pytest.raises(TypeError):
        tsig.HannWindow(normalize=1)


def _filters(precision=None):
    """(name, JAX filter, port filter) pairs: each shape at special
    points of its taps (RC: |t| = 1/(2 beta); RRC: 0 and 1/(4 beta)),
    and the edge roll-offs."""
    out = []
    for cls, args in (("RaisedCosineFilter", (8, 4, 0.25)),
                      ("RaisedCosineFilter", (7, 3, 0.0)),
                      ("RaisedCosineFilter", (6, 4, 1.0)),
                      ("RootRaisedCosineFilter", (8, 4, 0.25)),
                      ("RootRaisedCosineFilter", (32, 4, 0.22)),
                      ("RootRaisedCosineFilter", (5, 2, 0.5)),
                      ("SincFilter", (6, 4)), ("SincFilter", (5, 3))):
        out.append((f"{cls}{args}",
                    getattr(jsig, cls)(*args, precision=precision),
                    getattr(tsig, cls)(*args, precision=precision)))
    return out


@pytest.mark.parametrize("precision", ["single", "double"])
def test_filter_taps_bit_exact(precision):
    for name, jf, tf in _filters(precision):
        assert tf.length == jf.length, name
        np.testing.assert_array_equal(tf.sampling_times, jf.sampling_times)
        want = np.asarray(jf.coefficients)
        got = tf.coefficients.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("window", [None, "hann", "hamming", "blackman",
                                    "custom"])
def test_filter_outputs_match_jax(window):
    # longer than the longest filter (129 taps), and shorter
    x_real = _signal((3, 160), False)
    x_cplx = _signal((2, 3, 37), True, seed=1)
    for name, jf, tf in _filters():
        if window == "custom":
            coeffs = np.random.default_rng(2).uniform(size=jf.length)
            jf.window = jsig.CustomWindow(coeffs, normalize=True)
            tf.window = tsig.CustomWindow(coeffs, normalize=True)
        else:
            jf.window = window
            tf.window = window
        for padding in ("full", "same", "valid"):
            for x in (x_real, x_cplx):
                for conjugate in (False, True):
                    want = jf(jnp.asarray(x), padding=padding,
                              conjugate=conjugate)
                    got = tf(torch.as_tensor(x), padding=padding,
                             conjugate=conjugate)
                    _close(got, want)
        np.testing.assert_allclose(tf.aclr, jf.aclr, rtol=ACLR_RTOL,
                                   err_msg=name)


def test_custom_filter_matches_jax():
    rng = np.random.default_rng(3)
    coeffs = (rng.normal(size=11) + 1j * rng.normal(size=11)).astype(
        np.complex64)
    x = _signal((2, 30), True)
    for window in (None, "hamming"):
        for normalize in (True, False):
            jf = jsig.CustomFilter(3, coeffs, window=window,
                                   normalize=normalize)
            tf = tsig.CustomFilter(3, coeffs, window=window,
                                   normalize=normalize)
            assert tf.length == jf.length == 11
            assert tf.span_in_symbols == jf.span_in_symbols == 4
            np.testing.assert_array_equal(tf.sampling_times,
                                          jf.sampling_times)
            np.testing.assert_array_equal(tf.coefficients.numpy(),
                                          np.asarray(jf.coefficients))
            for padding in ("full", "same", "valid"):
                for conjugate in (False, True):
                    _close(tf(torch.as_tensor(x), padding=padding,
                              conjugate=conjugate),
                           jf(jnp.asarray(x), padding=padding,
                              conjugate=conjugate))
            np.testing.assert_allclose(tf.aclr, jf.aclr, rtol=ACLR_RTOL)
    # real taps of an even length
    real = rng.uniform(size=8).astype(np.float32)
    jf, tf = jsig.CustomFilter(2, real), tsig.CustomFilter(2, real)
    np.testing.assert_array_equal(tf.sampling_times, jf.sampling_times)
    _close(tf(torch.as_tensor(x)), jf(jnp.asarray(x)))


def test_filter_checks():
    with pytest.raises(ValueError):
        tsig.RaisedCosineFilter(4, 4, 1.5)
    with pytest.raises(ValueError):
        tsig.SincFilter(0, 4)
    with pytest.raises(ValueError):
        tsig.SincFilter(4, 4, window="kaiser")
    with pytest.raises(TypeError):
        tsig.SincFilter(4, 4, window=3)
    with pytest.raises(TypeError):
        tsig.SincFilter(4, 4, normalize="yes")


@pytest.mark.parametrize("axis", [0, 1, -1, -2])
def test_up_down_sampling_bit_exact(axis):
    for complex_ in (False, True):
        x = _signal((3, 5, 7), complex_)
        for sps in (1, 2, 4):
            jup = jsig.Upsampling(sps, axis=axis)
            tup = tsig.Upsampling(sps, axis=axis)
            up = tup(torch.as_tensor(x))
            want = np.asarray(jup(jnp.asarray(x)))
            np.testing.assert_array_equal(up.numpy(), want)
            for offset, num in ((0, None), (1, None), (sps - 1, 3),
                                (2 * sps, None)):
                jd = jsig.Downsampling(sps, offset, num, axis=axis)
                td = tsig.Downsampling(sps, offset, num, axis=axis)
                np.testing.assert_array_equal(
                    td(up).numpy(), np.asarray(jd(jnp.asarray(want))))
            # the two are inverses on the symbol lattice
            np.testing.assert_array_equal(
                tsig.Downsampling(sps, axis=axis)(up).numpy(), x)


def test_pulse_shaping_cascade_matches_jax():
    """The tutorial's chain at a small size: upsample, RRC, matched
    filter, downsample, on the same 16-QAM symbols."""
    sps, span, beta = 4, 8, 0.22
    x = _signal((4, 64), True, seed=4) / np.float32(np.sqrt(2))
    jr = jsig.RootRaisedCosineFilter(span, sps, beta, window="hann")
    tr = tsig.RootRaisedCosineFilter(span, sps, beta, window="hann")
    jchain = [jsig.Upsampling(sps), jr, jr,
              jsig.Downsampling(sps, span * sps, 64)]
    tchain = [tsig.Upsampling(sps), tr, tr,
              tsig.Downsampling(sps, span * sps, 64)]
    jy, ty = jnp.asarray(x), torch.as_tensor(x)
    for jb, tb in zip(jchain, tchain):
        jy, ty = jb(jy), tb(ty)
        _close(ty, jy)
    want = jsig.empirical_aclr(jchain[1](jchain[0](jnp.asarray(x))),
                               oversampling=sps)
    got = tsig.empirical_aclr(tr(tsig.Upsampling(sps)(torch.as_tensor(x))),
                              oversampling=sps)
    np.testing.assert_allclose(float(got), float(want), rtol=ACLR_RTOL)
