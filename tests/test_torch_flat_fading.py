"""The flat-fading blocks of the PyTorch port against the JAX package:
spatial correlation (Kronecker, per column), the flat-fading channel,
Rayleigh block fading, ``CIRDataset`` into the OFDM channel, and a small
coded MIMO link over correlated flat fading (2 x 8, 16-QAM, k=256,
n=512, LMMSE, APP demapping, BP-20) through both packages on the same
bits, a JAX-drawn channel and the same noise.

Tolerances, relative to the largest magnitude of what they bound:
- correlation matrix square roots: bit-exact (the same NumPy ``eigh``);
- correlated channels, y = h x, the OFDM channel from replayed CIRs:
  LIN_RTOL, f32 products summed in other orders;
- the link's LLRs: LMMSE_RTOL (the LMMSE solve and the demapper's
  logaddexp round differently), its decisions identical;
- the port's own draws by statistics: each moment within 5 standard
  errors of its expectation.
"""

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
import sionna_tpu_torch.phy as tphy
import sionna_tpu_torch.phy.channel as tch
import sionna_tpu_torch.phy.fec.ldpc as tldpc
import sionna_tpu_torch.phy.mimo as tmimo
import sionna_tpu_torch.phy.ofdm as tofdm
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)

LIN_RTOL = 2e-6
LMMSE_RTOL = 4e-5


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want).max(initial=0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _crandn(rng, *shape):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            / np.sqrt(2)).astype(np.complex64)


def _corr(n, a):
    """An exponential correlation matrix (complex64, NumPy), the same
    array for both packages."""
    return np.asarray(jch.exp_corr_mat(a, n))


def test_kronecker_model_matches_jax():
    rng = np.random.default_rng(0)
    r_tx, r_rx = _corr(4, 0.4), _corr(16, 0.9 * np.exp(0.3j))
    h = _crandn(rng, 5, 3, 16, 4)
    for args in ((r_tx, r_rx), (None, r_rx), (r_tx, None)):
        jk = jch.KroneckerModel(*args)
        tk = tch.KroneckerModel(*args)
        for name in ("_r_tx_sqrt", "_r_rx_sqrt"):
            want = getattr(jk, name)
            got = getattr(tk, name)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got.numpy(), want)
        _close(tk(_t(h)), jk(jnp.asarray(h)), LIN_RTOL)
    # tensors on a device are accepted, and (r_tx, r_rx) is the order
    tk = tch.KroneckerModel(tch.exp_corr_mat(0.4, 4),
                            tch.exp_corr_mat(0.9, 16))
    assert tk._r_tx_sqrt.shape == (4, 4) and tk._r_rx_sqrt.shape == (16, 16)
    tk.r_tx = None
    np.testing.assert_array_equal(tk(_t(h)).numpy(),
                                  (tk._r_rx_sqrt @ _t(h)).numpy())


def test_per_column_model_matches_jax():
    rng = np.random.default_rng(1)
    m, k = 8, 3
    r_rx = np.stack([_corr(m, a) for a in (0.2, 0.6 * np.exp(1j), 0.95)])
    h = _crandn(rng, 4, m, k)
    jp, tp = jch.PerColumnModel(r_rx), tch.PerColumnModel(r_rx)
    np.testing.assert_array_equal(tp._r_rx_sqrt.numpy(), jp._r_rx_sqrt)
    _close(tp(_t(h)), jp(jnp.asarray(h)), LIN_RTOL)
    # each column through its own square root
    got = tp(_t(h)).numpy()
    for col in range(k):
        np.testing.assert_allclose(got[..., col],
                                   (jp._r_rx_sqrt[col] @ h[..., col, None]
                                    )[..., 0], atol=1e-6)
    # an indefinite matrix: negative eigenvalues clip to 0
    bad = np.array([[1., 2.], [2., 1.]], np.complex64)
    np.testing.assert_array_equal(tch.PerColumnModel(bad[None])
                                  ._r_rx_sqrt.numpy(),
                                  jch.PerColumnModel(bad[None])._r_rx_sqrt)


def _within(value, expected, stderr, what):
    assert abs(value - expected) <= 5 * stderr, (what, value, expected,
                                                 stderr)


def test_flat_fading_draws_statistics():
    """The port's draws: each part of variance 1/2 and mean 0, and with
    the Kronecker model E[h h^H] = tr(R_tx) R_rx."""
    n, nr, nt = 20000, 4, 2
    g = torch.Generator().manual_seed(3)
    gen = tch.GenerateFlatFadingChannel(nt, nr)
    h = gen(n, generator=g)
    assert h.shape == (n, nr, nt) and h.dtype == torch.complex64
    for part in (h.real, h.imag):
        x = part.double().reshape(-1).numpy()
        _within(x.mean(), 0.0, np.sqrt(0.5 / x.size), "mean")
        _within(x.var(), 0.5, np.sqrt(0.5 / x.size), "variance")
    r_tx, r_rx = _corr(nt, 0.5), _corr(nr, 0.8)
    gen.spatial_corr = tch.KroneckerModel(r_tx, r_rx)
    h = gen(n, generator=g).numpy().astype(np.complex128)
    cov = np.einsum("bik,bjk->ij", h, h.conj()) / n
    want = np.trace(r_tx).real * r_rx
    # each entry is a mean of n products of variance at most tr(R_tx)^2
    _within(np.abs(cov - want).max(), 0.0, nt / np.sqrt(n), "E[h h^H]")
    # the same generator seed gives the same draw, on the block's device
    a = tch.GenerateFlatFadingChannel(nt, nr)(
        8, generator=torch.Generator().manual_seed(4))
    b = tch.GenerateFlatFadingChannel(nt, nr)(
        8, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.device.type == "cpu"


def test_flat_fading_channel_matches_jax():
    rng = np.random.default_rng(5)
    x = _crandn(rng, 6, 4)
    h = np.asarray(jch.GenerateFlatFadingChannel(4, 8)(
        6, key=jax.random.PRNGKey(2)))
    want = jch.ApplyFlatFadingChannel()(jnp.asarray(x), jnp.asarray(h))
    app = tch.ApplyFlatFadingChannel()
    _close(app(_t(x), _t(h)), want, LIN_RTOL)
    # AWGN of variance no on top of h x
    no = 0.3
    big = torch.as_tensor(_crandn(rng, 4000, 4))
    hb = torch.as_tensor(_crandn(rng, 4000, 8, 4))
    y = app(big, hb, no, generator=torch.Generator().manual_seed(6))
    noise = (y - app(big, hb)).numpy().astype(np.complex128)
    _within((np.abs(noise) ** 2).mean(), no, no / np.sqrt(noise.size),
            "noise power")
    # the whole block: channel returned, y = h x without noise
    ch = tch.FlatFadingChannel(4, 8, add_awgn=False, return_channel=True)
    y, h = ch(_t(x), no, generator=torch.Generator().manual_seed(7))
    assert y.shape == (6, 8) and h.shape == (6, 8, 4)
    np.testing.assert_array_equal(y.numpy(), app(_t(x), h).numpy())
    assert ch.generate is ch._gen and ch.apply is ch._app
    ch.spatial_corr = tch.KroneckerModel(None, _corr(8, 0.5))
    assert ch.generate.spatial_corr is ch.spatial_corr
    y = tch.FlatFadingChannel(4, 8)(_t(x), no)
    assert y.shape == (6, 8) and y.dtype == torch.complex64


def test_rayleigh_block_fading():
    """Shapes, one draw constant over the time steps, zero delays, and
    the draws' statistics."""
    model = tch.RayleighBlockFading(2, 3, 1, 4)
    a, tau = model(5000, 7, generator=torch.Generator().manual_seed(8))
    assert a.shape == (5000, 2, 3, 1, 4, 1, 7) and a.dtype == torch.complex64
    assert tau.shape == (5000, 2, 1, 1) and not tau.any()
    assert torch.equal(a, a[..., :1].expand_as(a))
    x = a[..., 0].reshape(-1).numpy().astype(np.complex128)
    for part in (x.real, x.imag):
        _within(part.mean(), 0.0, np.sqrt(0.5 / part.size), "mean")
        _within(part.var(), 0.5, np.sqrt(0.5 / part.size), "variance")
    a64, _ = tch.RayleighBlockFading(1, 1, 1, 1, precision="double")(2, 3)
    assert a64.dtype == torch.complex128 and a64.device.type == "cpu"


def _rg(ofdm):
    return ofdm.ResourceGrid(num_ofdm_symbols=4, fft_size=12,
                             subcarrier_spacing=30e3, num_tx=1,
                             num_streams_per_tx=2)


def test_cir_dataset_feeds_the_ofdm_channel():
    """JAX-drawn Rayleigh CIRs replayed through CIRDataset into both
    packages' OFDM channels (no noise): to rounding; the generator
    restarts when it runs out, and the CIRs land on the model's device
    as one complex tensor."""
    a_j, tau_j = jch.RayleighBlockFading(1, 4, 1, 2)(
        3, 4, key=jax.random.PRNGKey(9))
    a_np, tau_np = np.asarray(a_j), np.asarray(tau_j)
    tau_np = tau_np + np.float32(1e-7) * np.arange(3, dtype=np.float32)[
        :, None, None, None]

    def examples():
        for i in range(3):
            yield a_np[i], tau_np[i]

    jd = jch.CIRDataset(examples, 3, 1, 4, 1, 2, 1, 4)
    td = tch.CIRDataset(examples, 3, 1, 4, 1, 2, 1, 4)
    a, tau = td(None, 4, 1.0)
    assert a.dtype == torch.complex64 and tau.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), a_np)
    np.testing.assert_array_equal(tau.numpy(), tau_np)
    # two examples more than the generator holds: it restarts
    td.batch_size = 5
    a5, _ = td()
    np.testing.assert_array_equal(a5.numpy()[3:], a_np[:2])
    td.batch_size = 3
    td._iter = None
    x = _crandn(np.random.default_rng(10), 3, 1, 2, 4, 12)
    jo = jch.OFDMChannel(jd, _rg(jofdm), add_awgn=False,
                         return_channel=True)
    to = tch.OFDMChannel(td, _rg(tofdm), add_awgn=False,
                         return_channel=True)
    y_j, h_j = jo(jnp.asarray(x))
    y_t, h_t = to(_t(x))
    _close(h_t, h_j, LIN_RTOL)
    _close(y_t, y_j, LIN_RTOL)
    # the port's own Rayleigh draws through the OFDM channel
    ray = tch.RayleighBlockFading(1, 4, 1, 2)
    y, h = tch.OFDMChannel(ray, _rg(tofdm), return_channel=True)(_t(x), 0.1)
    assert y.shape == (3, 1, 4, 4, 12) and h.shape == (3, 1, 4, 1, 2, 4, 12)


class _Link:
    """The coded flat-fading MIMO link of
    ``tests/test_integration_extra.py`` (2 x 8, 16-QAM, k=256, n=512,
    LMMSE, APP, BP-20 hard decisions) in one package, from the channel
    on: ``(llr, b_hat)`` of info bits over the channel ``h`` with noise
    samples ``noise`` (scaled by sqrt(no))."""

    def __init__(self, p, nt=2, nr=8, k=256, n=512):
        phy, ch, mimo, ldpc = ((jphy, jch, jmimo, jldpc) if p == "jax"
                               else (tphy, tch, tmimo, tldpc))
        self.p, self.nt, self.nr = p, nt, nr
        self.enc = ldpc.LDPC5GEncoder(k, n)
        self.dec = ldpc.LDPC5GDecoder(self.enc, hard_out=True)
        self.mapper = phy.Mapper("qam", 4)
        self.demapper = phy.Demapper("app", "qam", 4)
        self.apply = ch.ApplyFlatFadingChannel()
        self.mimo = mimo

    def __call__(self, b, h, noise, no):
        xp = jnp if self.p == "jax" else torch
        x = self.mapper(self.enc(b))
        shape = x.shape
        x = x.reshape(-1, self.nt)
        y = self.apply(x, h) + noise * no ** 0.5
        s = (no * xp.eye(self.nr)).astype(xp.complex64) \
            if self.p == "jax" else (no * torch.eye(self.nr)).to(
                torch.complex64)
        x_hat, no_eff = self.mimo.lmmse_equalizer(y, h, s)
        llr = self.demapper(x_hat.reshape(shape), no_eff.reshape(shape))
        return llr, self.dec(llr)


def test_flat_fading_coded_link_matches_jax():
    """The same bits, the JAX-drawn correlated channel (Kronecker, 0.4 at
    the transmitter, 0.7 at the receiver) and the same noise through both
    packages (the JAX chain jitted once): the LLRs to rounding, the
    decisions identical, some block errors and some error-free blocks."""
    batch, nt, nr, k = 8, 2, 8, 256
    jl, tl = _Link("jax"), _Link("torch")
    rng = np.random.default_rng(11)
    b = rng.integers(0, 2, (batch, nt, k)).astype(np.float32)
    m = batch * 512 // 4
    corr = jch.KroneckerModel(_corr(nt, 0.4), _corr(nr, 0.7))
    h = np.asarray(jch.GenerateFlatFadingChannel(nt, nr, corr)(
        m, key=jax.random.PRNGKey(12)))
    noise = _crandn(rng, m, nr)
    no = np.float32(jphy.utils.ebnodb2no(1.0, 4, 0.5) * np.sqrt(nr))
    llr_j, b_hat_j = jax.jit(lambda *args: jl(*args, no))(b, h, noise)
    llr_t, b_hat_t = tl(_t(b), _t(h), _t(noise), _t(no))
    _close(llr_t, llr_j, LMMSE_RTOL)
    b_hat_j = np.asarray(b_hat_j)
    np.testing.assert_array_equal(b_hat_t.numpy(), b_hat_j)
    errors = np.any(b_hat_j != b, axis=-1)
    assert 0 < errors.sum() < errors.size, errors
