"""The MIMO-OFDM blocks of the PyTorch port against the JAX package: the
signal utilities, the OFDM modulator and demodulator, the time-domain
channel, the OFDM precoders, the OFDM detector wrappers, and BASELINE
config 3's two links as a whole at a small width (a 24-FFT grid, 2
streams, 2 x 4 cross-polarized antennas, batch 4): the uplink in the
frequency domain (``examples/03_mimo_ofdm_cdl.py``) and the downlink in
the time domain with RZF precoding (the ``Model`` of
``tests/test_integration_mimo_ofdm.py``), fed the same bits, the same
JAX-drawn CDL CIR and the same noise.

Tolerances, relative to the largest magnitude of what they bound:
- signal utilities, modulator, demodulator, ApplyTimeChannel: SIG_RTOL,
  f32 FFTs (pocketfft in both, other orders of the butterflies) and the
  time convolution's sums over taps and antennas in other orders
  (measured up to 3.0e-7; the received grids of the links 2.7e-6);
- precoders and the SINR: LIN_RTOL as in tests/test_torch_mimo.py;
- OFDM detectors: the tolerances of their MIMO detectors there, but
  the LMMSE detector's LMMSE_RTOL: its unbiased no_eff = 1/d - 1
  cancels at high SINR, so the f32 rounding of d grows in the LLRs
  (measured 1.8e-5 here);
- the links: the LLRs into the decoder within LMMSE_RTOL (LS divisions,
  the LMMSE solves and the demapper's logaddexp round differently;
  measured 2.2e-6 and 6.4e-6 at the points tested; the downlink's
  reached 4.8e-5 at 14 dB, where 1/d - 1 cancels more), the decoders'
  hard decisions identical, failed blocks included.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy as jphy
import sionna_tpu.phy.channel as jch
import sionna_tpu.phy.fec.ldpc as jldpc
import sionna_tpu.phy.mimo as jmimo
import sionna_tpu.phy.ofdm as jofdm
import sionna_tpu.phy.signal as jsig
from sionna_tpu.phy.channel.tr38901 import AntennaArray as JAntennaArray
from sionna_tpu.phy.channel.tr38901 import CDL as JCDL
import sionna_tpu_torch.phy as tphy
import sionna_tpu_torch.phy.channel as tch
import sionna_tpu_torch.phy.fec.ldpc as tldpc
import sionna_tpu_torch.phy.mimo as tmimo
import sionna_tpu_torch.phy.ofdm as tofdm
import sionna_tpu_torch.phy.signal as tsig
from sionna_tpu_torch.phy.channel.tr38901 import CDL, AntennaArray
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


SIG_RTOL = 4e-6
LIN_RTOL = 2e-5
EP_RTOL = 2e-3
PIC_RTOL = 4e-5
LMMSE_RTOL = 4e-5
BATCH, FFT, STREAMS, FC = 4, 24, 2, 3.5e9


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * np.abs(want).max() + 1e-30)


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _grid(pkg, cp=0, guards=(0, 0), dc_null=False, pilots=True,
          streams=STREAMS):
    kw = dict(pilot_pattern="kronecker",
              pilot_ofdm_symbol_indices=[2, 11]) if pilots else {}
    return pkg.ResourceGrid(num_ofdm_symbols=14, fft_size=FFT,
                            subcarrier_spacing=30e3, num_tx=1,
                            num_streams_per_tx=streams,
                            cyclic_prefix_length=cp,
                            num_guard_carriers=list(guards),
                            dc_null=dc_null, **kw)


@pytest.mark.parametrize("padding", ["full", "same", "valid"])
def test_signal_utils_match_jax(padding):
    rng = np.random.default_rng(0)
    x = _crandn(rng, 3, 2, 40)
    xr = rng.standard_normal((3, 40)).astype(np.float32)
    ker = _crandn(rng, 7)
    ker_r = rng.standard_normal(6).astype(np.float32)
    for inp, k, axis in ((x, ker, -1), (x, ker_r, -1), (xr, ker, -1),
                         (xr, ker_r, -1), (np.swapaxes(x, -1, 1), ker, 1)):
        _close(tsig.convolve(_t(inp), _t(k), padding, axis),
               jsig.convolve(inp, k, padding, axis), SIG_RTOL)
    _close(tsig.fft(_t(x)), jsig.fft(x), SIG_RTOL)
    _close(tsig.ifft(_t(x), axis=1), jsig.ifft(x, axis=1), SIG_RTOL)
    for got, want in zip(tsig.empirical_psd(_t(x), show=False,
                                            oversampling=2.0),
                         jsig.empirical_psd(x, show=False,
                                            oversampling=2.0)):
        _close(got, want, SIG_RTOL)
    assert float(tsig.empirical_aclr(_t(x), 2.0, -0.3, 0.3)) == \
        pytest.approx(float(jsig.empirical_aclr(x, 2.0, -0.3, 0.3)),
                      rel=SIG_RTOL)


@pytest.mark.parametrize("cp,l_min", [(0, 0), (6, -6),
                                      (np.array([4, 2, 2, 4]), -2)])
def test_ofdm_modulator_demodulator_match_jax(cp, l_min):
    """Scalar and per-symbol cyclic prefixes; the demodulator on the
    modulated signal plus trailing samples (a channel's l_tot - 1), with
    its phase compensation for l_min; with l_min = 0 it inverts the
    modulator."""
    rng = np.random.default_rng(1)
    x = _crandn(rng, 2, 3, 4, FFT)
    mod_t, mod_j = tofdm.OFDMModulator(cp), jofdm.OFDMModulator(cp)
    s_t, s_j = mod_t(_t(x)), np.asarray(mod_j(x))
    _close(s_t, s_j, SIG_RTOL)
    s_j = np.concatenate([s_j, _crandn(rng, 2, 3, 5)], axis=-1)
    got = tofdm.OFDMDemodulator(FFT, l_min, cp)(_t(s_j))
    want = jofdm.OFDMDemodulator(FFT, l_min, cp)(s_j)
    _close(got, want, SIG_RTOL)
    if l_min == 0:
        _close(got, x, SIG_RTOL)


@functools.lru_cache(maxsize=None)
def _jax_cir(direction, num_time_steps, sampling_frequency, seed=0):
    """(a, tau) drawn by the JAX package's CDL-B (UT 2, BS 4
    cross-polarized 38.901 antennas, 3 m/s), as NumPy."""
    def arr(cols):
        return JAntennaArray(1, cols, "dual", "cross", "38.901", FC)

    cdl = JCDL("B", 100e-9, FC, arr(1), arr(2), direction, min_speed=3.)
    a, tau = jax.jit(lambda key: cdl(BATCH, num_time_steps,
                                     sampling_frequency, key=key))(
        jax.random.PRNGKey(seed))
    return np.asarray(a), np.asarray(tau)


def _time_channel(rg):
    l_min, l_max = jch.time_lag_discrete_time_channel(rg.bandwidth)
    a, tau = _jax_cir("downlink", rg.num_time_samples + l_max - l_min,
                      rg.bandwidth)
    h_time = np.asarray(jch.cir_to_time_channel(rg.bandwidth, a, tau, l_min,
                                                l_max, normalize=True))
    return a, tau, h_time, l_min, l_max


def test_apply_time_channel_matches_jax():
    """A JAX-drawn CDL-B time channel (4 -> 2 antennas) applied to a
    modulated grid with cyclic prefix 6; the taps themselves match
    (cir_to_time_channel as a product over paths); GenerateTimeChannel
    and TimeChannel on the port's CDL give normalised taps of that
    shape."""
    rg = _grid(jofdm, cp=6)
    a, tau, h_time, l_min, l_max = _time_channel(rg)
    _close(tch.cir_to_time_channel(rg.bandwidth, _t(a), _t(tau), l_min,
                                   l_max, normalize=True), h_time, SIG_RTOL)
    l_tot = l_max - l_min + 1
    rng = np.random.default_rng(2)
    x = _crandn(rng, BATCH, 1, 4, rg.num_time_samples)
    got = tch.ApplyTimeChannel(rg.num_time_samples, l_tot)(_t(x),
                                                           _t(h_time))
    want = jch.ApplyTimeChannel(rg.num_time_samples, l_tot)(x, h_time)
    _close(got, want, SIG_RTOL)
    # the port's own channel: shapes and unit mean energy per link
    cdl = CDL("B", 100e-9, FC, AntennaArray(1, 1, "dual", "cross", "38.901",
                                            FC),
              AntennaArray(1, 2, "dual", "cross", "38.901", FC), "downlink",
              min_speed=3.)
    chan = tch.TimeChannel(cdl, rg.bandwidth, rg.num_time_samples,
                           normalize_channel=True, return_channel=True)
    y, h = chan(_t(x), 0.01, generator=torch.Generator().manual_seed(3))
    assert y.shape == (BATCH, 1, 2, rg.num_time_samples + l_tot - 1)
    assert h.shape == (BATCH, 1, 2, 1, 4, rg.num_time_samples + l_tot - 1,
                       l_tot)
    energy = torch.mean(torch.sum(torch.abs(h) ** 2, -1), dim=(2, 4, 5))
    np.testing.assert_allclose(energy.numpy(), 1.0, rtol=1e-5)


def _h_freq(direction, rg):
    a, tau = _jax_cir(direction, 14, 1 / rg.ofdm_symbol_duration)
    freqs = jch.subcarrier_frequencies(FFT, 30e3)
    return np.asarray(jch.cir_to_ofdm_channel(freqs, a, tau, normalize=True))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_subcarrier_frequencies_device(device):
    """subcarrier_frequencies builds on ``device``, by default on
    ``config.device`` (here the meta device, which only records where a
    tensor would live), with JAX's values on the CPU."""
    torch_config.device = "meta"
    try:
        freqs = tch.subcarrier_frequencies(FFT, 30e3, device=device)
    finally:
        torch_config.device = "cpu"
    assert freqs.device.type == ("meta" if device is None else device)
    if device is not None:
        np.testing.assert_array_equal(
            freqs.numpy(), np.asarray(jch.subcarrier_frequencies(FFT, 30e3)))


def test_precoders_match_jax():
    """RZF precoding of a grid with guard carriers and a DC null, the
    effective channels after RZF, CBF and identity precoding with a
    per-stream power, and the LMMSE post-equalization SINR of each."""
    rgs = (_grid(jofdm, guards=(2, 1), dc_null=True),
           _grid(tofdm, guards=(2, 1), dc_null=True))
    sms = (jmimo.StreamManagement(np.array([[1]]), STREAMS),
           tmimo.StreamManagement(np.array([[1]]), STREAMS))
    h = _h_freq("downlink", rgs[0])  # [b, 1, 2, 1, 4, 14, fft]
    rng = np.random.default_rng(4)
    x = _crandn(rng, BATCH, 1, STREAMS, 14, FFT)
    outs = []
    for pkg, rg, sm, arr in ((jofdm, rgs[0], sms[0], np.asarray),
                             (tofdm, rgs[1], sms[1], _t)):
        xp, h_eff = pkg.RZFPrecoder(rg, sm, return_effective_channel=True)(
            arr(x), arr(h), 0.1)
        xp0 = pkg.RZFPrecoder(rg, sm)(arr(x), arr(h))
        power = arr(np.array([[[1.0, 0.5]]], np.float32))
        effs = [h_eff,
                pkg.RZFPrecodedChannel(rg, sm)(arr(h), power, alpha=0.2),
                pkg.CBFPrecodedChannel(rg, sm)(arr(h), power),
                pkg.EyePrecodedChannel(rg, sm)(arr(h[:, :, :, :, :2]),
                                               power)]
        sinr = pkg.LMMSEPostEqualizationSINR(rg, sm)
        outs.append([xp, xp0] + effs + [sinr(e, arr(np.float32(0.1)))
                                        for e in effs])
    for got, want in zip(outs[1], outs[0]):
        _close(got, want, LIN_RTOL)


def _detectors(pkg, rg, sm):
    """Every OFDM detector wrapper on ``rg`` (16-QAM, or QPSK for ML):
    (name, detector, takes a prior)."""
    return [
        ("lmmse", pkg.LinearDetector("lmmse", "bit", "app", rg, sm, "qam",
                                     4), False),
        ("zf-symbol", pkg.LinearDetector("zf", "symbol", "maxlog", rg, sm,
                                         "qam", 4), False),
        ("ml", pkg.MaximumLikelihoodDetector("bit", "maxlog", rg, sm, "qam",
                                             2), False),
        ("ml-symbol", pkg.MaximumLikelihoodDetector(
            "symbol", "app", rg, sm, "qam", 2, hard_out=True), False),
        ("ml-prior", pkg.MaximumLikelihoodDetectorWithPrior(
            "bit", "app", rg, sm, "qam", 2), True),
        ("ml-prior-symbol", pkg.MaximumLikelihoodDetectorWithPrior(
            "symbol", "maxlog", rg, sm, "qam", 2), True),
        ("kbest", pkg.KBestDetector("bit", STREAMS, 8, rg, sm, "qam", 4),
         False),
        ("ep", pkg.EPDetector("bit", rg, sm, 4), False),
        ("mmsepic", pkg.MMSEPICDetector("bit", rg, sm, "app", 2,
                                        "qam", 4), True),
    ]


@pytest.mark.parametrize("prior_kind", ["none", "per_re", "per_stream"])
def test_ofdm_detectors_match_jax(prior_kind):
    """The wrappers on a grid with Kronecker pilots, a JAX-drawn uplink
    CDL-B channel as the estimate, an estimation error variance and
    noise; priors per data RE and per stream for those that take them
    (none otherwise)."""
    rgs = (_grid(jofdm), _grid(tofdm))
    sms = (jmimo.StreamManagement(np.array([[1]]), STREAMS),
           tmimo.StreamManagement(np.array([[1]]), STREAMS))
    h = _h_freq("uplink", rgs[0])  # [b, 1, 4, 1, 2, 14, fft]
    rng = np.random.default_rng(5)
    y = (np.einsum("brkxysf,bxysf->brksf", h,
                   _crandn(rng, BATCH, 1, STREAMS, 14, FFT))
         + 0.1 * _crandn(rng, BATCH, 1, 4, 14, FFT)).astype(np.complex64)
    err_var = np.float32(0.01)
    no = np.float32(0.05)
    n_data = rgs[0].num_data_symbols
    dets = zip(_detectors(jofdm, rgs[0], sms[0]),
               _detectors(tofdm, rgs[1], sms[1]))
    for (name, jdet, with_prior), (_, tdet, _) in dets:
        if (prior_kind != "none") != with_prior:
            continue
        nbps = 2 if name.startswith("ml") else 4
        prior = None
        if prior_kind != "none":
            symbols = name.endswith("symbol")
            d = 2 ** nbps if symbols else nbps
            if prior_kind == "per_stream":
                shape = (BATCH, 1, STREAMS, d)
            elif symbols:
                shape = (BATCH, 1, STREAMS, n_data, d)
            else:
                shape = (BATCH, 1, STREAMS, n_data * d)
            prior = rng.normal(0, 1.5, shape).astype(np.float32)
            want = jdet(y, h, prior, err_var, no)
            got = tdet(_t(y), _t(h), _t(prior), _t(err_var), _t(no))
        elif name == "mmsepic":
            want = jdet(y, h, None, err_var, no)
            got = tdet(_t(y), _t(h), None, _t(err_var), _t(no))
        else:
            want = jdet(y, h, err_var, no)
            got = tdet(_t(y), _t(h), _t(err_var), _t(no))
        want = np.asarray(want)
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            _close(got, want, {"lmmse": LMMSE_RTOL, "ep": EP_RTOL,
                               "mmsepic": PIC_RTOL}.get(name, LIN_RTOL))


class _Link:
    """One of config 3's links in the package ``p`` (``jax`` or
    ``torch``): "ul" (frequency domain, LS linear interpolation,
    LinearDetector LMMSE/APP, min-sum BP-12) or "dl" (time domain with
    RZF precoding, cyclic prefix 6, LS nearest-neighbour, LMMSE
    equalizer, APP demapper, boxplus-phi BP-20)."""

    def __init__(self, p, kind):
        self.p, self.kind = p, kind
        ofdm, ch, mimo, ldpc, phy = ((jofdm, jch, jmimo, jldpc, jphy)
                                     if p == "jax" else
                                     (tofdm, tch, tmimo, tldpc, tphy))
        if kind == "ul":
            self.rg = rg = _grid(ofdm)
        else:
            self.rg = rg = _grid(ofdm, cp=6, guards=(2, 1), dc_null=True)
        sm = mimo.StreamManagement(np.array([[1]]), STREAMS)
        n = int(rg.num_data_symbols) * 4
        self.k = n // 2
        self.enc = ldpc.LDPC5GEncoder(self.k, n)
        self.mapper = phy.Mapper("qam", 4)
        self.rg_mapper = ofdm.ResourceGridMapper(rg)
        self.freqs = ch.subcarrier_frequencies(FFT, 30e3)
        if kind == "ul":
            self.channel = ch.ApplyOFDMChannel()
            self.est = ofdm.LSChannelEstimator(rg, interpolation_type="lin")
            self.det = ofdm.LinearDetector("lmmse", "bit", "app", rg, sm,
                                           "qam", 4)
            self.dec = ldpc.LDPC5GDecoder(self.enc, num_iter=12,
                                          cn_update="minsum")
        else:
            self.l_min, self.l_max = ch.time_lag_discrete_time_channel(
                rg.bandwidth)
            l_tot = self.l_max - self.l_min + 1
            self.precoder = ofdm.RZFPrecoder(rg, sm,
                                             return_effective_channel=True)
            self.mod = ofdm.OFDMModulator(6)
            self.demod = ofdm.OFDMDemodulator(FFT, self.l_min, 6)
            self.channel = ch.ApplyTimeChannel(rg.num_time_samples, l_tot)
            self.est = ofdm.LSChannelEstimator(rg, interpolation_type="nn")
            self.equ = ofdm.LMMSEEqualizer(rg, sm)
            self.demapper = phy.Demapper("app", "qam", 4)
            self.dec = ldpc.LDPC5GDecoder(self.enc, hard_out=True)

    def __call__(self, b, a, tau, noise, no):
        """(y, llr, b_hat) of info bits ``b`` over the CIR (a, tau) with
        the noise samples ``noise`` (scaled by sqrt(no))."""
        ch = jch if self.p == "jax" else tch
        x_rg = self.rg_mapper(self.mapper(self.enc(b)))
        if self.kind == "ul":
            h = ch.cir_to_ofdm_channel(self.freqs, a, tau, normalize=True)
            y = self.channel(x_rg, h) + noise * no ** 0.5
            h_hat, err_var = self.est(y, no)
            llr = self.det(y, h_hat, err_var, no)
        else:
            rg, cp = self.rg, 6
            h_time = ch.cir_to_time_channel(rg.bandwidth, a, tau, self.l_min,
                                            self.l_max, normalize=True)
            a_freq = a[..., cp:-1:FFT + cp][..., :rg.num_ofdm_symbols]
            h = ch.cir_to_ofdm_channel(self.freqs, a_freq, tau,
                                       normalize=True)
            x_rg, _ = self.precoder(x_rg, h)
            y = self.demod(self.channel(self.mod(x_rg), h_time)
                           + noise * no ** 0.5)
            h_hat, err_var = self.est(y, no)
            x_hat, no_eff = self.equ(y, h_hat, err_var, no)
            llr = self.demapper(x_hat, no_eff)
        return y, llr, self.dec(llr)


@pytest.mark.parametrize("kind,ebno_db", [("ul", 0.0), ("dl", 2.0)])
def test_config3_links_match_jax(kind, ebno_db):
    """Uplink frequency domain and downlink time domain, CDL-B: the same
    bits, JAX-drawn CIR and noise through both packages (the JAX chain
    jitted once); received grids and LLRs to rounding, identical
    decisions, and some block errors and some error-free blocks."""
    jl, tl = _Link("jax", kind), _Link("torch", kind)
    rg = jl.rg
    if kind == "ul":
        a, tau = _jax_cir("uplink", 14, 1 / rg.ofdm_symbol_duration)
        noise_shape = (BATCH, 1, 4, 14, FFT)
    else:
        l_tot = jl.l_max - jl.l_min + 1
        a, tau = _jax_cir("downlink", rg.num_time_samples + l_tot - 1,
                          rg.bandwidth)
        noise_shape = (BATCH, 1, 2, rg.num_time_samples + l_tot - 1)
    rng = np.random.default_rng(6)
    b = rng.integers(0, 2, (BATCH, 1, STREAMS, jl.k)).astype(np.float32)
    noise = _crandn(rng, *noise_shape)
    no = np.float32(jphy.utils.ebnodb2no(ebno_db, 4, 0.5, rg))
    y_j, llr_j, b_hat_j = jax.jit(lambda *args: jl(*args, no))(
        b, a, tau, noise)
    y_t, llr_t, b_hat_t = tl(_t(b), _t(a), _t(tau), _t(noise), _t(no))
    _close(y_t, y_j, SIG_RTOL)
    _close(llr_t, llr_j, LMMSE_RTOL)
    b_hat_j = np.asarray(b_hat_j)
    np.testing.assert_array_equal(b_hat_t.numpy(), b_hat_j)
    errors = np.any(b_hat_j != b, axis=-1)
    assert 0 < errors.sum() < errors.size, errors
