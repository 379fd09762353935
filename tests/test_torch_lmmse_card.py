"""The whitened-LMMSE kernel (``csrc/lmmse_whitened.cu``) on a card
(marked ``card``; skipped without one): ``lmmse_equalizer`` through the
kernel and through its plain path (``lmmse_equalizer_plain``, the library
calls it replaces) against a complex128 NumPy evaluation of the same
formula, at the flat MIMO link's shape (N = 1,048,576 channel uses of a
16 x 4 system, S = N0 I) and on one MC iteration's own channel uses of
that link, with a general positive-definite S, at M in
{1, 5, 8, 16} and K in {1, 2, 4}, at an N that is no multiple of the
kernel's tile, with S expanded over the batch, with more than one batch
dimension and over badly conditioned channels; one launch per call and no
host sync; the plain path (and its gradient) where S is per channel use,
without whitening, or an input requires a gradient. Imports no JAX, so
that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lmmse_card.py

Tolerances: each gap is the largest |error| over the largest |value| of
the complex128 evaluation. The kernel and the plain path round the same
float32 steps in other orders, so the kernel's gap may be at most twice
the plain path's plus PLAIN_SLACK (a few float32 roundings of the unit
values); and at the flat link's shape both lie under FLAT_RTOL, the
tolerance of ``tests/test_torch_flat_mimo.py`` for the same equalizer
against complex128 (float32 whitening and a 4 x 4 Cholesky solve over
channels of condition number up to about 20).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sionna_tpu_torch.phy import BinarySource, Mapper
from sionna_tpu_torch.phy.channel import FlatFadingChannel, KroneckerModel
from sionna_tpu_torch.phy.channel.utils import exp_corr_mat
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GEncoder
from sionna_tpu_torch.phy.mimo.equalization import (
    LMMSE_WHITENED_KERNEL, lmmse_equalizer, lmmse_equalizer_plain)
from sionna_tpu_torch.phy.utils import ebnodb2no

ROOT = Path(__file__).resolve().parents[1]
C64 = torch.complex64
FLAT_RTOL = 4e-5
PLAIN_SLACK = 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _c128(y, h, s):
    """x_hat and no_eff in complex128 NumPy: L^-1 whitening, G = (H_w^H
    H_w + I)^-1 H_w^H, d = diag(G H_w), x_hat = G y_w / d, no_eff =
    Re(1/d - 1); y [..., M], h [..., M, K], s [M, M]."""
    y, h, s = (np.asarray(t.cpu(), np.complex128) for t in (y, h, s))
    l_inv = np.linalg.inv(np.linalg.cholesky(s))
    hw, yw = l_inv @ h, (l_inv @ y[..., None])[..., 0]
    hwh = np.conj(np.swapaxes(hw, -1, -2))
    g = np.linalg.solve(hwh @ hw + np.eye(h.shape[-1]), hwh)
    d = np.diagonal(g @ hw, axis1=-2, axis2=-1)
    return (g @ yw[..., None])[..., 0] / d, (1 / d - 1).real


def _gap(got, want):
    got = np.asarray(got.cpu(), np.complex128)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _system(dev, batch, m, k, seed, corr=True):
    """y = h x + n over Kronecker-correlated channels (the flat link's
    correlations, cut to m x k) at N0 = 0.3."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def cn(shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev,
                                         generator=gen)) * 0.5 ** 0.5

    h = cn(batch + (m, k))
    if corr:
        h = KroneckerModel(exp_corr_mat(0.4, k, device=dev),
                           exp_corr_mat(0.9, m, device=dev))(h)
    x = cn(batch + (k,))
    y = (h @ x[..., None])[..., 0] + cn(batch + (m,)) * 0.3 ** 0.5
    return y, h


def _equalize(y, h, s, **kw):
    """lmmse_equalizer's outputs and its launches of the kernel."""
    LMMSE_WHITENED_KERNEL.reset()
    out = lmmse_equalizer(y, h, s, **kw)
    torch.cuda.synchronize()
    return out, LMMSE_WHITENED_KERNEL.launches


def _check(y, h, s, sample=None, flat=False):
    """The kernel (one launch) and the plain path against complex128 on
    the channel uses ``sample`` of the flattened batch (all if None)."""
    (x_k, n_k), launches = _equalize(y, h, s)
    assert launches == 1
    x_p, n_p = lmmse_equalizer_plain(y, h, s)
    assert x_k.shape == x_p.shape and n_k.shape == n_p.shape
    assert x_k.dtype == C64 and n_k.dtype == torch.float32
    m, k = h.shape[-2:]
    flat_args = (y.reshape(-1, m), h.reshape(-1, m, k), x_k.reshape(-1, k),
                 n_k.reshape(-1, k), x_p.reshape(-1, k), n_p.reshape(-1, k))
    if sample is not None:
        flat_args = tuple(t[sample] for t in flat_args)
    yy, hh, xk, nk, xp, np_ = flat_args
    want_x, want_n = _c128(yy, hh, s.reshape(-1, m, m)[0])
    for kern, plain, want in ((xk, xp, want_x), (nk, np_, want_n)):
        gk, gp = _gap(kern, want), _gap(plain, want)
        assert np.isfinite(gk) and gk <= 2 * gp + PLAIN_SLACK, (gk, gp)
        if flat:
            assert gk < FLAT_RTOL and gp < FLAT_RTOL, (gk, gp)


@pytest.mark.card
def test_flat_link_shape():
    """N = 1,048,576 channel uses of the 16 x 4 system with S = N0 I, as
    the flat link calls it; every 97th channel use against complex128."""
    dev = _card()
    y, h = _system(dev, (1 << 20,), 16, 4, seed=1)
    s = (0.3 * torch.eye(16, device=dev)).to(C64)
    _check(y, h, s, sample=torch.arange(0, 1 << 20, 97, device=dev),
           flat=True)


@pytest.mark.card
def test_flat_link_own_channel_uses():
    """One MC iteration of the benchmark's flat MIMO link up to its
    equalizer (batch 4096 at Eb/No 3.5 dB: coded 16-QAM over
    ``FlatFadingChannel`` with the configuration's Kronecker correlation,
    N0 = ebnodb2no(3.5, 4, k / n) sqrt(16), S = N0 I), as the link calls
    ``lmmse_equalizer``: no host sync (the plain path's Cholesky would
    raise), one launch, and the kernel and the plain path against
    complex128 on every 97th channel use."""
    dev = _card()
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "flat_mimo_4x16.json").read_text())
    m, k = cfg["num_rx_ant"], cfg["num_tx_ant"]
    nbps, code = cfg["num_bits_per_symbol"], cfg["code"]
    gen = torch.Generator(device=dev).manual_seed(26)
    bits = BinarySource(device=dev)([4096, k, code["k"]], generator=gen)
    x = Mapper("qam", nbps, device=dev)(
        LDPC5GEncoder(code["k"], code["n"], device=dev)(bits))
    corr = KroneckerModel(
        exp_corr_mat(cfg["channel"]["tx_exp_corr"], k, device=dev),
        exp_corr_mat(cfg["channel"]["rx_exp_corr"], m, device=dev))
    no = ebnodb2no(3.5, nbps, code["k"] / code["n"]).to(dev) * m ** 0.5
    y, h = FlatFadingChannel(k, m, spatial_corr=corr, return_channel=True,
                             device=dev)(x.reshape(-1, k), no, generator=gen)
    s = (no * torch.eye(m, device=dev)).to(C64)
    assert y.shape == (1 << 20, m) and h.shape == (1 << 20, m, k)
    lmmse_equalizer(y, h, s)  # built and loaded before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lmmse_equalizer(y, h, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check(y, h, s, sample=torch.arange(0, 1 << 20, 97, device=dev),
           flat=True)


@pytest.mark.card
def test_general_positive_definite_s():
    """A correlated S: exp_corr_mat(0.9, 16) plus a diagonal."""
    dev = _card()
    y, h = _system(dev, (4096,), 16, 4, seed=2)
    s = (exp_corr_mat(0.9, 16, device=dev)
         + 0.2 * torch.eye(16, device=dev)).to(C64)
    _check(y, h, s)


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("m", [1, 5, 8, 16])
def test_sizes(m, k):
    """M below and at its limit of 16 (the kernel leaves the rows past M
    unread) and each K variant, with a correlated S, at an N that is no
    multiple of the 128-use tile."""
    dev = _card()
    y, h = _system(dev, (128 * 7 + 37,), m, k, seed=10 * m + k)
    s = (exp_corr_mat(0.5, m, device=dev)
         + 0.3 * torch.eye(m, device=dev)).to(C64)
    _check(y, h, s)


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 127, 129, 128 * 5000 + 3])
def test_ragged_batches(n):
    """Batches of one use, around one tile, and more tiles than the grid
    holds blocks (so blocks walk several tiles)."""
    dev = _card()
    y, h = _system(dev, (n,), 16, 4, seed=n)
    s = (0.5 * torch.eye(16, device=dev)).to(C64)
    _check(y, h, s, sample=torch.arange(0, n, 13, device=dev))


@pytest.mark.card
def test_s_expanded_and_batch_shape():
    """S given as a stride-0 expand to [N, M, M], and batches of three
    dimensions with S [1, 1, 1, M, M]."""
    dev = _card()
    y, h = _system(dev, (999,), 16, 4, seed=3)
    s = (0.2 * torch.eye(16, device=dev)
         + 0.1 * exp_corr_mat(0.7, 16, device=dev)).to(C64)
    _check(y, h, s.expand(999, 16, 16))
    y, h = _system(dev, (3, 7, 11), 8, 2, seed=4)
    s8 = (0.4 * torch.eye(8, device=dev)).to(C64)
    _check(y, h, s8.reshape(1, 1, 1, 8, 8))
    (x_hat, no_eff), _ = _equalize(y, h, s8.reshape(1, 1, 1, 8, 8))
    assert x_hat.shape == no_eff.shape == (3, 7, 11, 2)


@pytest.mark.card
@pytest.mark.parametrize("gains", ["rising", "falling"])
def test_badly_conditioned_channels(gains):
    """Channels whose columns are nearly collinear (a second column 1e-3
    from the first) and whose rows' gains span three decades, rising or
    falling with the row (the order of the sums over the rows shows in
    the result)."""
    dev = _card()
    y, h = _system(dev, (8192,), 16, 4, seed=5, corr=False)
    h = h.clone()
    h[..., 1] = h[..., 0] + 1e-3 * h[..., 1]
    gain = torch.logspace(-2, 1, 16, device=dev)
    h = h * (gain if gains == "rising" else gain.flip(0))[:, None]
    x = torch.ones((8192, 4), dtype=C64, device=dev)
    y = (h @ x[..., None])[..., 0] + 0.05 * y
    s = (0.01 * torch.eye(16, device=dev)).to(C64)
    _check(y, h, s)


@pytest.mark.card
def test_no_host_sync():
    """A call that launches the kernel makes the host wait on nothing
    (the plain path's ``torch.linalg.cholesky`` does)."""
    dev = _card()
    y, h = _system(dev, (4096,), 16, 4, seed=6)
    s = (0.3 * torch.eye(16, device=dev)).to(C64)
    lmmse_equalizer(y, h, s)  # built and loaded before the check
    LMMSE_WHITENED_KERNEL.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lmmse_equalizer(y, h, s)
        with pytest.raises(RuntimeError):
            lmmse_equalizer_plain(y, h, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert LMMSE_WHITENED_KERNEL.launches == 1


@pytest.mark.card
@pytest.mark.parametrize("case", ["s_per_element", "no_whitening",
                                  "requires_grad"])
def test_plain_path_where_the_kernel_does_not_apply(case):
    """A per-channel-use S, no whitening, or an input that requires a
    gradient: no launch, the plain path's outputs, and the gradient flows
    into y and h."""
    dev = _card()
    y, h = _system(dev, (300,), 8, 2, seed=7)
    s = (0.3 * torch.eye(8, device=dev)).to(C64)
    kw = {}
    if case == "s_per_element":
        s = s.repeat(300, 1, 1)
    elif case == "no_whitening":
        kw["whiten_interference"] = False
    y = y.clone().requires_grad_(True)
    h = h.clone().requires_grad_(True)
    (x_hat, no_eff), launches = _equalize(
        y if case == "requires_grad" else y.detach(),
        h if case == "requires_grad" else h.detach(), s, **kw)
    assert launches == 0
    want = lmmse_equalizer_plain(y.detach(), h.detach(), s, **kw)
    assert torch.equal(x_hat, want[0]) and torch.equal(no_eff, want[1])
    x_hat, no_eff = lmmse_equalizer(y, h, s, **kw)
    gy, gh = torch.autograd.grad(x_hat.abs().sum() + no_eff.sum(), (y, h))
    assert gy.shape == y.shape and gh.shape == h.shape
    assert bool(torch.isfinite(gh).all()) and float(gh.abs().max()) > 0


@pytest.mark.card
def test_non_positive_definite_s_gives_nan():
    """An S that is not positive definite: NaN outputs, no error."""
    dev = _card()
    y, h = _system(dev, (256,), 4, 2, seed=8)
    s = -torch.eye(4, device=dev).to(C64)
    (x_hat, no_eff), launches = _equalize(y, h, s)
    assert launches == 1
    assert bool(torch.isnan(x_hat).all()) and bool(torch.isnan(no_eff).all())
