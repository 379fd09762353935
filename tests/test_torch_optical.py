"""The optical channel of the PyTorch port against the JAX package: the
split-step Fourier fiber (``SSFM``) in both step schedules, its Manakov
form and each ``with_*`` switch, and the ``EDFA``.

Tolerances, relative to the largest output magnitude:
- the fixed-step SSFM with the noise off (no amplification, or
  amplification with ``n_sp=0``): SSFM_RTOL in single precision (f32
  FFTs of another library, and the Kerr and dispersion phasors' cos/sin,
  over 50 steps; measured up to 6.1e-6 over 200 steps) and
  SSFM_RTOL_DOUBLE in double (measured 9.6e-14 over 200 steps);
- the adaptive SSFM on a smooth pulse: the same step count as JAX's
  loop, and the output within ADAPTIVE_RTOL / ADAPTIVE_RTOL_DOUBLE. The
  step size follows max |q|^2, so on a noise-like waveform the schedule
  amplifies rounding (JAX's own jitted and eager loops then differ by
  1e-3 of the output after about 220 steps); a pulse keeps it stable;
- the EDFA without noise (g = 1): bit-exact;
- the noise of the EDFA and of the SSFM's distributed amplification, by
  statistics: its power within 5 standard errors of the analytic ASE
  power.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.channel.optical as jopt
import sionna_tpu_torch.phy.channel.optical as topt
from sionna_tpu.phy.channel.utils import time_frequency_vector
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)

SSFM_RTOL = 2e-5
SSFM_RTOL_DOUBLE = 1e-12
ADAPTIVE_RTOL = 2e-5
ADAPTIVE_RTOL_DOUBLE = 1e-12
CDTYPES = {"single": np.complex64, "double": np.complex128}


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _waveform(shape, precision, seed=0, power=0.5e-3):
    """A Gaussian waveform of ``power`` W per sample and polarization."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) \
        * np.sqrt(power / 2)
    return x.astype(CDTYPES[precision])


def _close(got, want, rtol):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


SWITCHES = {
    "default": {},
    "no dispersion": dict(with_dispersion=False),
    "no attenuation": dict(with_attenuation=False),
    "no nonlinearity": dict(with_nonlinearity=False),
    "amplification, n_sp=0": dict(with_amplification=True, n_sp=0.0),
    "window": dict(half_window_length=20),
    "manakov": dict(with_manakov=True),
}


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("switch", list(SWITCHES))
def test_ssfm_fixed_step_matches_jax(switch, precision):
    kw = dict(length=40, n_ssfm=50, precision=precision, **SWITCHES[switch])
    x = _waveform((3, 2, 256), precision)
    want = jopt.SSFM(**kw)(jnp.asarray(x), key=jax.random.PRNGKey(0))
    port = topt.SSFM(**kw)
    got = port(torch.as_tensor(x))
    assert port.steps == 50
    _close(got, want, SSFM_RTOL if precision == "single"
           else SSFM_RTOL_DOUBLE)


def _jax_adaptive_steps(block, x):
    """The number of steps of the JAX package's adaptive loop on ``x``,
    its loop body replayed eagerly."""
    q = jnp.asarray(x)
    _, f = time_frequency_vector(x.shape[-1], block._sample_duration,
                                 precision=block.precision)
    window = block._window_for(x.shape[-1])
    remaining, steps = jnp.asarray(block._length, block.rdtype), 0
    while bool(remaining >= 1e-3):
        dz = jnp.minimum(block._phase_inc / block._gamma
                         / jnp.max(jnp.abs(q) ** 2), remaining)
        q = block._nonlinear(block._linear(q * window, dz, f), dz)
        remaining, steps = remaining - dz, steps + 1
    return steps


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("manakov", [False, True])
def test_ssfm_adaptive_matches_jax(precision, manakov):
    """A Gaussian pulse of 20 mW peak per polarization over 10 km."""
    t = np.arange(256) - 128
    pulse = np.sqrt(0.02) * np.exp(-t ** 2 / (2 * 12.0 ** 2))
    x = np.stack([pulse, 0.8 * pulse])[None].astype(CDTYPES[precision])
    kw = dict(length=10, n_ssfm="adaptive", phase_inc=1e-3,
              with_manakov=manakov, precision=precision)
    jblock = jopt.SSFM(**kw)
    want = jblock(jnp.asarray(x), key=jax.random.PRNGKey(0))
    port = topt.SSFM(**kw)
    got = port(torch.as_tensor(x))
    assert port.steps == _jax_adaptive_steps(jblock, x) > 20
    _close(got, want, ADAPTIVE_RTOL if precision == "single"
           else ADAPTIVE_RTOL_DOUBLE)


def _power_ok(noise, p):
    """The mean power of complex Gaussian noise samples within 5 standard
    errors of ``p`` (each |n|^2 has standard deviation p)."""
    noise = noise.numpy().astype(np.complex128)
    power = (np.abs(noise) ** 2).mean()
    assert abs(power - p) <= 5 * p / np.sqrt(noise.size), (power, p)


@pytest.mark.parametrize("dual", [False, True])
def test_edfa_matches_jax(dual):
    x = _waveform((4, 2, 64), "single")
    kw = dict(f=5.0, with_dual_polarization=dual)
    # no noise at g = 1 (n_sp = 0): bit-exact
    want = jopt.EDFA(g=1.0, **kw)(jnp.asarray(x), key=jax.random.PRNGKey(1))
    got = topt.EDFA(g=1.0, **kw)(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # gain sqrt(g) and ASE noise of the analytic power
    g = float(np.exp(0.046 * 80))
    jedfa, tedfa = jopt.EDFA(g=g, **kw), topt.EDFA(g=g, **kw)
    assert tedfa._p_n_ase == jedfa._p_n_ase
    big = torch.as_tensor(_waveform((2000, 2, 64), "single"))
    y = tedfa(big, generator=torch.Generator().manual_seed(2))
    _power_ok(y - big * np.sqrt(g), tedfa._p_n_ase)
    with pytest.raises(ValueError):
        topt.EDFA(with_dual_polarization=True)(torch.zeros(2, 3, 8))
    with pytest.raises(TypeError):
        topt.EDFA(with_dual_polarization=1)


@pytest.mark.parametrize("kw", [dict(), dict(with_manakov=True),
                                dict(n_ssfm="adaptive", phase_inc=0.05)])
def test_ssfm_noise_power(kw):
    """Distributed amplification: on a constant field (dispersion leaves
    it alone, the gain undoes the attenuation) the ASE noise adds up to
    the analytic power over the span, whatever the step schedule
    (dispersion rotates the noise); about 10 adaptive steps."""
    x = torch.full((400, 2, 128), 0.07, dtype=torch.complex64)
    kw = dict(dict(length=80, n_ssfm=40, with_amplification=True,
                   with_nonlinearity=False), **kw)
    port = topt.SSFM(**kw)
    y = port(x, generator=torch.Generator().manual_seed(3))
    clean = topt.SSFM(**dict(kw, n_sp=0.0))(x)
    assert port.steps > 1
    _power_ok(y - clean, port._p_n_ase)
    assert port._p_n_ase == jopt.SSFM(**kw)._p_n_ase


def test_ssfm_checks():
    with pytest.raises(ValueError):
        topt.SSFM(n_ssfm=0)
    with pytest.raises(ValueError):
        topt.SSFM(n_ssfm="fixed")
    with pytest.raises(ValueError):
        topt.SSFM(with_manakov=True)(torch.zeros(3, 8, dtype=torch.complex64))
