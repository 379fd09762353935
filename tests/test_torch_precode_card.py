"""The channel-precoding kernel (``csrc/precode_channel.cu``) on a card
(marked ``card``; skipped without one): ``precode_channel`` through the
kernel and through its plain path (``precode_channel_plain``: the permute,
the cuBLAS matrix product and the permute back it replaces) against a
complex128 evaluation of the same sum, at the 273-PRB PUSCH's shape (h [64,
1, 4, 1, 2, 14, 3276], TPMI 1), with two transmitters of their own
precoding matrices, at P = 4 with L = 1 to 4, on h laid out in other
ways (rows that do not merge, broadcast, a slice of the ports, sym and sc
that do not merge, an odd column count, 8 bytes past a 16-byte
boundary), at batches of 0 and 1, and on the time-domain path's
h (``time_to_ofdm_channel``); one launch and one ``pusch.precode_kernel``
span per perfect-CSI receiver call, and no host sync; the plain path
where an input requires a gradient or is complex128. Imports no JAX, so
that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_precode_card.py

Tolerance: each output is a float32 sum of P complex products; both the
kernel and the plain path lie within ERR_ULPS * P float32 roundings (u =
2^-24) of sum_p |h_p| |w_pl| from the complex128 value, at every output
value.
"""

import numpy as np
import pytest
import torch

from sionna_tpu_torch.phy.channel import time_to_ofdm_channel
from sionna_tpu_torch.phy.nr import PUSCHConfig, PUSCHReceiver, \
    PUSCHTransmitter
from sionna_tpu_torch.phy.nr.pusch_receiver import (
    PRECODE_CHANNEL_KERNEL, precode_channel, precode_channel_cuda,
    precode_channel_plain)
from sionna_tpu_torch.phy.utils import Profiler

C64 = torch.complex64
ERR_ULPS = 4
U32 = 2.0 ** -24
# the 273-PRB PUSCH: batch 64, one receiver of 4 antennas (a 1 x 2
# dual-polarised array), one transmitter of 2 ports, 14 OFDM symbols,
# 3,276 subcarriers
PUSCH_H = (64, 1, 4, 1, 2, 14, 3276)
# TPMI 1 of 2 ports and 2 layers (TS 38.211 Table 6.3.1.5-4)
TPMI_1 = [[0.5, 0.5], [0.5, -0.5]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _cn(gen, dev, shape):
    return torch.complex(torch.randn(shape, device=dev, generator=gen),
                         torch.randn(shape, device=dev,
                                     generator=gen)) * 0.5 ** 0.5


def _w(gen, dev, tx, p, l):
    """Precoding matrices [tx, p, l] of unit-magnitude entries over
    sqrt(p l), a phase of its own each."""
    phase = 2 * np.pi * torch.rand((tx, p, l), device=dev, generator=gen)
    return (torch.polar(torch.ones_like(phase), phase)
            / (p * l) ** 0.5).to(C64)


def _launch(h, w):
    """``precode_channel``'s output (synchronised) and the kernel's
    launches."""
    PRECODE_CHANNEL_KERNEL.reset()
    out = precode_channel(h, w)
    torch.cuda.synchronize()
    return out, dict(PRECODE_CHANNEL_KERNEL.variant_launches)


def _check(h, w):
    """The kernel (one launch) and the plain path against complex128 at
    every output value; returns the kernel's output."""
    p, l = w.shape[1:]
    out, launches = _launch(h, w)
    assert launches == {f"{p}x{l}": 1}
    assert out.is_contiguous() and out.dtype == C64
    assert out.shape == h.shape[:4] + (l,) + h.shape[5:]
    plain = precode_channel_plain(h, w)
    eq = "brxtpsc,tpl->brxtlsc"
    want = torch.einsum(eq, h.to(torch.complex128), w.to(torch.complex128))
    mag = torch.einsum(eq, h.abs().double(), w.abs().double())
    bound = ERR_ULPS * p * U32 * mag
    for got in (out, plain):
        err = (got.to(torch.complex128) - want).abs()
        assert bool((err <= bound).all()), float((err / bound).max())
    return out


@pytest.mark.card
def test_pusch_shape():
    """The 273-PRB PUSCH's h (187.9 MB of complex64) through TPMI 1."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    h = _cn(gen, dev, PUSCH_H)
    w = torch.tensor(TPMI_1, dtype=C64, device=dev)[None]
    _check(h, w)


@pytest.mark.card
def test_two_transmitters():
    """Two transmitters, each through its own precoding matrix, on a
    grid whose rows are no multiple of the kernel's tile."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    w = _w(gen, dev, 2, 2, 2)
    assert not torch.equal(w[0], w[1])
    _check(_cn(gen, dev, (5, 1, 4, 2, 2, 14, 300)), w)


@pytest.mark.card
@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_four_ports(l):
    """P = 4 ports with L = 1 to 4 layers, two receivers."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(10 + l)
    _check(_cn(gen, dev, (3, 2, 4, 1, 4, 14, 612)), _w(gen, dev, 1, 4, l))


@pytest.mark.card
@pytest.mark.parametrize("kind", ["rxa_outermost", "b_broadcast",
                                  "port_slice", "sym_sc_split",
                                  "odd_columns", "misaligned"])
def test_layouts(kind):
    """h laid out otherwise than contiguous: its rxa axis outermost in
    memory (the rows do not merge), expanded over the batch (stride 0),
    the first two of four ports, sym and sc that do not merge (the
    wrapper copies it); and contiguous h that the kernel reads 8 bytes a
    load: an odd column count (3 x 7), and an h 8 bytes past a 16-byte
    boundary."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (4, 1, 4, 2, 2) + ((3, 7) if kind == "odd_columns" else (14, 96))
    h = _cn(gen, dev, shape)
    if kind == "misaligned":
        buf = torch.empty(h.numel() + 1, dtype=C64, device=dev)
        h = buf[1:].view(shape).copy_(h)
        assert h.data_ptr() % 16 == 8
    if kind == "rxa_outermost":
        h = h.permute(2, 0, 1, 3, 4, 5, 6).contiguous().permute(
            1, 2, 0, 3, 4, 5, 6)
    elif kind == "b_broadcast":
        h = h[:1].expand(shape)
    elif kind == "port_slice":
        h = _cn(gen, dev, shape[:4] + (4,) + shape[5:])[:, :, :, :, :2]
    elif kind == "sym_sc_split":
        h = h.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert kind in ("odd_columns", "misaligned") or not h.is_contiguous()
    _check(h, _w(gen, dev, 2, 2, 2))


@pytest.mark.card
@pytest.mark.parametrize("batch", [0, 1])
def test_small_batches(batch):
    """A batch of no element (no launch) and of one."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    h = _cn(gen, dev, (batch, 1, 4, 1, 2, 14, 3276))
    w = torch.tensor(TPMI_1, dtype=C64, device=dev)[None]
    if batch == 0:
        out, launches = _launch(h, w)
        assert launches == {} and out.shape == (0, 1, 4, 1, 2, 14, 3276)
        return
    _check(h, w)


@pytest.mark.card
def test_time_domain_channel():
    """The time-domain receiver's h: discrete-time taps through
    ``time_to_ofdm_channel`` at 16 PRBs."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    tx = _transmitter(dev, output_domain="time")
    rg, l_min, l_max = tx.resource_grid, -6, 20
    h_t = _cn(gen, dev, (8, 1, 4, 1, 2, rg.num_time_samples,
                         l_max - l_min + 1))
    h = time_to_ofdm_channel(h_t, rg, l_min)
    _check(h, tx._precoder._w.to(dev))


def _transmitter(dev, **kw):
    """The PUSCH tutorial's transmitter at 16 PRBs: 2 ports, 2 layers,
    TPMI 1."""
    pc = PUSCHConfig()
    pc.carrier.subcarrier_spacing = 30
    pc.carrier.n_size_grid = 16
    pc.num_antenna_ports = 2
    pc.num_layers = 2
    pc.precoding = "codebook"
    pc.tpmi = 1
    pc.dmrs.additional_position = 1
    pc.tb.mcs_index = 14
    return PUSCHTransmitter(pc, return_bits=False, device=dev, **kw)


@pytest.mark.card
def test_receiver_one_launch_one_span():
    """The perfect-CSI receiver on the card: one launch ("2x2") and one
    ``pusch.precode_kernel`` span a call, the detector fed the kernel's
    output, and every TB decoded at a high SNR."""
    dev = _card()
    tx = _transmitter(dev)
    rx = PUSCHReceiver(tx, channel_estimator="perfect", device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    rg = tx.resource_grid
    h = _cn(gen, dev, (4, 1, 4, 1, 2, rg.num_ofdm_symbols, rg.fft_size))
    bits = torch.randint(0, 2, (4, 1, tx._tb_size), device=dev,
                         generator=gen).to(torch.float32)
    y = torch.sum(h * tx(bits)[:, None, None], dim=(3, 4))
    seen = {}
    rx._mimo_detector.register_forward_pre_hook(
        lambda module, args: seen.__setitem__("h_hat", args[1]))
    PRECODE_CHANNEL_KERNEL.reset()
    with torch.no_grad(), Profiler() as prof:
        b_hat = rx(y, torch.tensor(1e-4, device=dev), h)
    torch.cuda.synchronize()
    assert PRECODE_CHANNEL_KERNEL.variant_launches == {"2x2": 1}
    assert prof.counts["pusch.precode_kernel"] == 1
    assert seen["h_hat"].is_contiguous()
    assert torch.equal(seen["h_hat"],
                       precode_channel_cuda(h, tx._precoder._w.to(dev)))
    assert torch.equal(b_hat, bits)


@pytest.mark.card
def test_no_host_sync():
    """At the PUSCH's shape a call launches the kernel once and makes the
    host wait on nothing."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    h = _cn(gen, dev, PUSCH_H)
    w = torch.tensor(TPMI_1, dtype=C64, device=dev)[None]
    precode_channel(h, w)  # built and loaded before the check
    PRECODE_CHANNEL_KERNEL.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = precode_channel(h, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert PRECODE_CHANNEL_KERNEL.variant_launches == {"2x2": 1}
    assert out.shape == PUSCH_H


@pytest.mark.card
@pytest.mark.parametrize("kind", ["h_grad", "w_grad", "complex128"])
def test_plain_path(kind):
    """An input that requires a gradient, or complex128 inputs: no launch,
    the plain path's output, and the gradient reaches the input."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    h = _cn(gen, dev, (2, 1, 4, 1, 2, 14, 48))
    w = torch.tensor(TPMI_1, dtype=C64, device=dev)[None]
    if kind == "complex128":
        h, w = h.to(torch.complex128), w.to(torch.complex128)
    else:
        h, w = h.clone(), w.clone()
        (h if kind == "h_grad" else w).requires_grad_(True)
    out, launches = _launch(h, w)
    assert launches == {}
    assert torch.equal(out.detach(), precode_channel_plain(
        h.detach(), w.detach()))
    if kind == "complex128":
        return
    leaf = h if kind == "h_grad" else w
    (grad,) = torch.autograd.grad(out.abs().sum(), (leaf,))
    assert grad.shape == leaf.shape and float(grad.abs().max()) > 0
