"""The per-RE whitened-LMMSE kernel (``csrc/lmmse_per_re.cu``) on a card
(marked ``card``; skipped without one): ``lmmse_equalizer`` through the
kernel and through its plain path (``lmmse_equalizer_plain``, the unrolled
tensor operations it replaces) against a complex128 NumPy evaluation of
the same formula, with an S of its own at each resource element (RE), at
the 273-PRB PUSCH's shape laid out as the OFDM detectors hand it (N =
2,935,296 REs of a 4 x 2 system, y and h permuted views, S = N0 I +
diag(error variances)), at the flagship's 1 x 1, at every M and K up to
4, with a full Hermitian S (H_u H_u^H of interfering streams), at batches
of 0, 1 and no multiple of the kernel's tile, over badly conditioned
channels and a non-positive-definite S; one launch per call and no host
sync; the plain path (and its gradient) where an input requires a
gradient. Imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lmmse_per_re_card.py

Tolerances: each gap is the largest |error| over the largest |value| of
the complex128 evaluation. The kernel and the plain path round the same
float32 steps in other orders (the kernel fuses each product into its
sum), so the kernel's gap may be at most twice the plain path's plus
PLAIN_SLACK (a few float32 roundings of the unit values). At the PUSCH's
shape both also lie under PUSCH_RTOL, the flat link's bound for the same
equalizer against complex128 (``tests/test_torch_lmmse_card.py``'s
FLAT_RTOL: float32 whitening and a small Cholesky solve over channels of
moderate condition number).
"""

import numpy as np
import pytest
import torch

from sionna_tpu_torch.phy.mimo.equalization import (
    LMMSE_PER_RE_KERNEL, LMMSE_WHITENED_KERNEL, lmmse_equalizer,
    lmmse_equalizer_plain, lmmse_per_re_cuda)

C64 = torch.complex64
PUSCH_RTOL = 4e-5
PLAIN_SLACK = 1e-6
# the 273-PRB PUSCH: batch 64, 14 OFDM symbols, 3,276 subcarriers, 4
# receive antennas (a 1 x 2 dual-polarised array), 2 layers
PUSCH = dict(batch=64, sym=14, sc=3276, m=4, k=2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _c128(y, h, s):
    """x_hat and no_eff in complex128 NumPy: L^-1 whitening, G = (H_w^H
    H_w + I)^-1 H_w^H, d = diag(G H_w), x_hat = G y_w / d, no_eff =
    Re(1/d - 1); y [N, M], h [N, M, K], s [N, M, M]."""
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


def _cn(gen, dev, shape):
    return torch.complex(torch.randn(shape, device=dev, generator=gen),
                         torch.randn(shape, device=dev,
                                     generator=gen)) * 0.5 ** 0.5


def _grid(dev, batch, sym, sc, m, k, seed, interferers=0, no=0.3):
    """y, h and S laid out as the OFDM detectors hand them (y and h
    permuted views of the grid, one plane per antenna and stream; S a
    fresh [batch, 1, sym, sc, m, m] tensor): y = h x + n, S = N0 I +
    diag(error variances) + H_u H_u^H over ``interferers`` streams."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = _cn(gen, dev, (k, batch, m, sym, sc)).reshape(
        1, k, batch, m, sym, sc).permute(2, 0, 4, 5, 3, 1)
    x = _cn(gen, dev, (batch, 1, sym, sc, k))
    n = _cn(gen, dev, (batch, 1, m, sym, sc)).permute(0, 1, 3, 4, 2)
    err = 0.05 * torch.rand((batch, 1, sym, sc, 1), device=dev,
                            generator=gen)
    eye = torch.eye(m, device=dev)
    s = ((no + err)[..., None] * eye).to(C64)
    if interferers:
        hu = _cn(gen, dev, (batch, 1, sym, sc, m, interferers))
        s = s + hu @ hu.conj().transpose(-1, -2)
        n = n + (hu @ _cn(gen, dev, (batch, 1, sym, sc, interferers, 1))
                 )[..., 0]
    y = ((h @ x[..., None])[..., 0] + n * (no ** 0.5)).permute(
        0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
    return y, h, s


def _equalize(y, h, s, equalizer=lmmse_equalizer, **kw):
    """``equalizer``'s outputs and its launches of each kernel."""
    LMMSE_PER_RE_KERNEL.reset()
    LMMSE_WHITENED_KERNEL.reset()
    out = equalizer(y, h, s, **kw)
    torch.cuda.synchronize()
    return out, LMMSE_PER_RE_KERNEL.launches, LMMSE_WHITENED_KERNEL.launches


def _check(y, h, s, sample=None, rtol=None, equalizer=lmmse_equalizer):
    """The kernel (one launch, none of the shared-S kernel), through
    ``equalizer``, and the plain path against complex128 on the REs
    ``sample`` of the flattened batch (all if None); returns the two gaps
    of x_hat and of no_eff."""
    (x_k, n_k), per_re, shared = _equalize(y, h, s, equalizer)
    assert (per_re, shared) == (1, 0)
    x_p, n_p = lmmse_equalizer_plain(y, h, s)
    assert x_k.shape == x_p.shape and n_k.shape == n_p.shape
    assert x_k.dtype == C64 and n_k.dtype == torch.float32
    m, k = h.shape[-2:]
    batch = x_k.shape[:-1]
    flat = (y.expand(batch + (m,)).reshape(-1, m),
            h.expand(batch + (m, k)).reshape(-1, m, k),
            s.expand(batch + (m, m)).reshape(-1, m, m),
            x_k.reshape(-1, k), n_k.reshape(-1, k), x_p.reshape(-1, k),
            n_p.reshape(-1, k))
    if sample is not None:
        flat = tuple(t[sample] for t in flat)
    yy, hh, ss, xk, nk, xp, np_ = flat
    want_x, want_n = _c128(yy, hh, ss)
    gaps = []
    for kern, plain, want in ((xk, xp, want_x), (nk, np_, want_n)):
        gk, gp = _gap(kern, want), _gap(plain, want)
        assert np.isfinite(gk) and gk <= 2 * gp + PLAIN_SLACK, (gk, gp)
        if rtol is not None:
            assert gk < rtol and gp < rtol, (gk, gp)
        gaps.append((gk, gp))
    return gaps


@pytest.mark.card
def test_pusch_shape():
    """The 273-PRB PUSCH's 2,935,296 REs of a 4 x 2 system with a
    diagonal S at each RE (N0 I + the error variances), as its detector
    hands them; every 97th RE against complex128."""
    dev = _card()
    p = PUSCH
    y, h, s = _grid(dev, p["batch"], p["sym"], p["sc"], p["m"], p["k"],
                    seed=1)
    n = p["batch"] * p["sym"] * p["sc"]
    _check(y, h, s, sample=torch.arange(0, n, 97, device=dev),
           rtol=PUSCH_RTOL)


@pytest.mark.card
def test_flagship_shape():
    """The flagship's SISO grid (M = K = 1): batch 2048 of 14 x 256 REs,
    one sample of 4,096 against complex128."""
    dev = _card()
    y, h, s = _grid(dev, 2048, 14, 256, 1, 1, seed=2)
    _check(y, h, s, sample=torch.arange(0, 2048 * 14 * 256, 1789,
                                        device=dev))


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_sizes(m, k):
    """Every instance of the kernel, with a full Hermitian S (two
    interfering streams) at each RE, on a grid whose rows (3 x 7 x 61
    REs) are no multiple of the 128-RE tile."""
    dev = _card()
    y, h, s = _grid(dev, 3, 7, 61, m, k, seed=10 * m + k, interferers=2)
    _check(y, h, s)


@pytest.mark.card
@pytest.mark.parametrize("n", [0, 1, 127, 129, 128 * 5000 + 3])
def test_ragged_batches(n):
    """Contiguous batches of no RE, one, around one tile, and more tiles
    than the grid holds blocks (so blocks walk several tiles). A batch of
    one RE has one S for the batch, so ``lmmse_equalizer`` gives it to the
    shared-S kernel; the per-RE kernel is checked on it directly."""
    dev = _card()
    y, h, s = (t.reshape((-1,) + t.shape[-e:])[:n].contiguous()
               for t, e in zip(_grid(dev, 1, 1, max(n, 1), 4, 2, seed=n,
                                     interferers=1), (1, 2, 2)))
    if n == 0:
        (x_hat, no_eff), per_re, _ = _equalize(y, h, s)
        assert per_re == 0 and x_hat.shape == no_eff.shape == (0, 2)
        return
    if n == 1:
        assert _equalize(y, h, s)[1:] == (0, 1)
        _check(y, h, s, equalizer=lmmse_per_re_cuda)
        return
    _check(y, h, s, sample=torch.arange(0, n, 13, device=dev))


@pytest.mark.card
@pytest.mark.parametrize("layout", ["contiguous", "s_broadcast",
                                    "many_dims"])
def test_layouts(layout):
    """Contiguous inputs; an S expanded over the subcarriers (stride 0,
    one per OFDM symbol); and a batch of five dimensions that do not merge
    (the wrapper copies it to contiguous). Each with its own outputs'
    shape."""
    dev = _card()
    y, h, s = _grid(dev, 4, 14, 300, 4, 2, seed=3, interferers=1)
    if layout == "contiguous":
        y, h, s = (t.contiguous() for t in (y, h, s))
    elif layout == "s_broadcast":
        s = s[:, :, :, :1].expand(s.shape)
    else:
        y, h, s = (t.reshape((4, 14, 3, 10, 10) + t.shape[4:]).permute(
            4, 3, 2, 1, 0, *range(5, t.dim() + 1)) for t in (y, h, s))
    _check(y, h, s)


@pytest.mark.card
@pytest.mark.parametrize("gains", ["rising", "falling"])
def test_badly_conditioned_channels(gains):
    """4 x 2 channels whose columns are nearly collinear (the second 1e-3
    from the first) and whose rows' gains span three decades, rising or
    falling with the row (the order of the sums over the rows shows in
    the result), with a full Hermitian S at each RE."""
    dev = _card()
    y, h, s = _grid(dev, 8, 14, 100, 4, 2, seed=5, interferers=1, no=0.01)
    h = h.clone()
    h[..., 1] = h[..., 0] + 1e-3 * h[..., 1]
    gain = torch.logspace(-2, 1, 4, device=dev)
    h = h * (gain if gains == "rising" else gain.flip(0))[:, None]
    x = torch.ones(h.shape[:-2] + (2,), dtype=C64, device=dev)
    y = (h @ x[..., None])[..., 0] + 0.05 * y
    _check(y, h, s)


@pytest.mark.card
def test_one_launch_no_host_sync():
    """At the PUSCH's shape, a call launches the kernel once and makes
    the host wait on nothing."""
    dev = _card()
    p = PUSCH
    y, h, s = _grid(dev, p["batch"], p["sym"], p["sc"], p["m"], p["k"],
                    seed=6)
    lmmse_equalizer(y, h, s)  # built and loaded before the check
    LMMSE_PER_RE_KERNEL.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_hat, no_eff = lmmse_equalizer(y, h, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert LMMSE_PER_RE_KERNEL.launches == 1
    assert LMMSE_PER_RE_KERNEL.variant_launches == {"4x2": 1}
    assert x_hat.shape == no_eff.shape == (p["batch"], 1, p["sym"],
                                           p["sc"], p["k"])


@pytest.mark.card
def test_non_positive_definite_s_gives_nan():
    """An S that is not positive definite at some REs: NaN outputs there,
    no error, the other REs as the plain path gives them (which gives NaN
    at the same REs)."""
    dev = _card()
    y, h, s = _grid(dev, 2, 3, 50, 4, 2, seed=8)
    s = s.clone()
    s[:, :, 1] = -s[:, :, 1]
    (x_hat, no_eff), per_re, _ = _equalize(y, h, s)
    assert per_re == 1
    x_p, n_p = lmmse_equalizer_plain(y, h, s)
    bad = torch.zeros(x_hat.shape[:-1], dtype=torch.bool, device=dev)
    bad[:, :, 1] = True
    for got, plain in ((x_hat, x_p), (no_eff, n_p)):
        assert bool(torch.isnan(got[bad]).all())
        assert bool(torch.isnan(plain[bad]).all())
        assert bool(torch.isfinite(got[~bad]).all())
        assert torch.allclose(got[~bad], plain[~bad], rtol=1e-4, atol=1e-5)


@pytest.mark.card
def test_plain_path_under_grad():
    """Inputs that require a gradient: no launch, the plain path's
    outputs, and the gradient reaches y and h."""
    dev = _card()
    y, h, s = _grid(dev, 2, 14, 48, 4, 2, seed=7, interferers=1)
    y = y.detach().clone().requires_grad_(True)
    h = h.detach().clone().requires_grad_(True)
    (x_hat, no_eff), per_re, shared = _equalize(y, h, s)
    assert (per_re, shared) == (0, 0)
    want = lmmse_equalizer_plain(y.detach(), h.detach(), s)
    assert torch.equal(x_hat.detach(), want[0])
    assert torch.equal(no_eff.detach(), want[1])
    gy, gh = torch.autograd.grad(x_hat.abs().sum() + no_eff.sum(), (y, h))
    assert gy.shape == y.shape and gh.shape == h.shape
    assert bool(torch.isfinite(gh).all()) and float(gh.abs().max()) > 0
    assert float(gy.abs().max()) > 0
