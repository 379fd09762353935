"""The dispatch of ``precode_channel`` (the perfect-CSI receiver's
precoding of h) between the kernel ``csrc/precode_channel.cu`` and its
plain path, on the CPU: the rule ``precoding_kernel_applies`` on each of
its conditions (the inputs' metadata as a card's tensors would carry it),
``precode_channel_cuda`` refusing what the kernel does not take, the
kernel's walk of h (``precode_layout``) reaching every value of h, and
``PUSCHReceiver``'s precoded channel on the CPU: the plain path, equal to
a complex128 einsum over the transmit antennas for one and two
transmitters, with no launch and no ``pusch.precode_kernel`` span. The
kernel itself is tested on a card by ``tests/test_torch_precode_card.py``.
Imports no JAX.
"""

import numpy as np
import pytest
import torch

from sionna_tpu_torch.phy import config
from sionna_tpu_torch.phy import nr
from sionna_tpu_torch.phy.nr.pusch_receiver import (
    PRECODE_CHANNEL_KERNEL, precode_channel, precode_channel_cuda,
    precode_channel_plain, precode_layout, precoding_kernel_applies)
from sionna_tpu_torch.phy.utils import Profiler

C64 = torch.complex64
# float32 rounding of a sum of at most four complex products of unit
# magnitude, against complex128
F32_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu_blocks():
    """The port's blocks default to the card (``config.device``); these
    tests build them on the CPU."""
    device = config.device
    config.device = "cpu"
    yield
    config.device = device


class _Meta:
    """A tensor's device, dtype, shape and ``requires_grad``, as the rule
    reads them, on a device of our choosing (a card's here)."""

    def __init__(self, t, device="cuda"):
        self.shape, self.dtype = t.shape, t.dtype
        self.requires_grad = t.requires_grad
        self.device = torch.device(device)


def _inputs(b=2, rxa=4, tx=1, p=2, l=2, sym=3, sc=12, dtype=C64):
    """h [b, 1, rxa, tx, p, sym, sc] and w [tx, p, l] of zeros."""
    return (torch.zeros((b, 1, rxa, tx, p, sym, sc), dtype=dtype),
            torch.zeros((tx, p, l), dtype=dtype))


# case -> ((h, w), whether the kernel runs)
CASES = {
    "pusch_cell": (_inputs(), True),
    "two_tx": (_inputs(tx=2), True),
    "p_1_l_1": (_inputs(p=1, l=1), True),
    "p_4_l_1": (_inputs(p=4, l=1), True),
    "p_4_l_2": (_inputs(p=4, l=2), True),
    "p_4_l_3": (_inputs(p=4, l=3), True),
    "p_4_l_4": (_inputs(p=4, l=4), True),
    "p_5_l_2": (_inputs(p=5, l=2), False),
    "p_5_l_5": (_inputs(p=5, l=5), False),
    "l_above_p": (_inputs(p=2, l=3), False),
    "h_complex128": ((_inputs()[0].to(torch.complex128), _inputs()[1]),
                     False),
    "w_complex128": ((_inputs()[0], _inputs()[1].to(torch.complex128)),
                     False),
    "both_complex128": (_inputs(dtype=torch.complex128), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rule(case):
    (h, w), want = CASES[case]
    assert precoding_kernel_applies(_Meta(h), _Meta(w)) is want


def test_rule_without_w():
    """No codebook precoding: nothing to precode, no kernel."""
    h, _ = _inputs()
    assert precoding_kernel_applies(_Meta(h), None) is False


@pytest.mark.parametrize("off", ["h", "w"])
def test_rule_on_cpu_and_another_device(off):
    """An input off the card keeps the plain path (the CPU: the JAX
    parity tests' path)."""
    h, w = _inputs()
    for device in ("cpu", "meta"):
        metas = [_Meta(t, device if name == off else "cuda")
                 for name, t in (("h", h), ("w", w))]
        assert precoding_kernel_applies(*metas) is False
    assert precoding_kernel_applies(h, w) is False


@pytest.mark.parametrize("where", ["h", "w"])
@pytest.mark.parametrize("grad_mode", [True, False])
def test_rule_with_an_input_that_requires_grad(where, grad_mode):
    """An input that requires a gradient keeps the plain path (whose
    gradient flows), unless grad mode is off."""
    inputs = dict(zip("hw", _inputs()))
    inputs[where] = inputs[where].clone().requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        got = precoding_kernel_applies(_Meta(inputs["h"]),
                                       _Meta(inputs["w"]))
    assert got is not grad_mode


@pytest.mark.parametrize("case", [
    "cpu", "complex128", "w_complex128", "tx_mismatch", "port_mismatch",
    "l_above_p", "p_5", "h_rank_6", "w_rank_2"])
def test_wrapper_refuses(case):
    """``precode_channel_cuda`` raises ``ValueError`` (before it builds or
    launches anything) on what its kernel does not take."""
    h, w = _inputs()
    if case == "complex128":
        h, w = (t.to(torch.complex128) for t in (h, w))
    elif case == "w_complex128":
        w = w.to(torch.complex128)
    elif case == "tx_mismatch":
        w = _inputs(tx=2)[1]
    elif case == "port_mismatch":
        w = _inputs(p=4)[1]
    elif case == "l_above_p":
        w = _inputs(l=3)[1]
    elif case == "p_5":
        h, w = _inputs(p=5)
    elif case == "h_rank_6":
        h = h[0]
    elif case == "w_rank_2":
        w = w[0]
    launches = PRECODE_CHANNEL_KERNEL.launches
    with pytest.raises(ValueError, match="not a layout the kernel takes"):
        precode_channel_cuda(h, w)
    assert PRECODE_CHANNEL_KERNEL.launches == launches


def _cn(gen, shape):
    return torch.complex(torch.randn(shape, generator=gen),
                         torch.randn(shape, generator=gen))


def _kernel_view(h, layout):
    """h's values as the kernel reads them through ``layout`` (its storage,
    from the tensor's own offset): [rows, tx, P, cols], the rows in the
    row-major order of (b, rx, rxa): a CPU emulation of the kernel's
    addressing."""
    cols, col = layout[:2]
    sizes, strides = layout[2:5], layout[5:8]
    num_tx, st_tx, st_port = layout[8:]
    size = tuple(reversed(sizes)) + (num_tx, h.shape[4], cols)
    stride = tuple(reversed(strides)) + (st_tx, st_port, col)
    return torch.as_strided(h, size, stride, h.storage_offset()).reshape(
        (-1, num_tx, h.shape[4], cols))


@pytest.mark.parametrize("kind", ["contiguous", "two_tx", "rxa_outermost",
                                  "b_broadcast", "port_slice",
                                  "sym_sc_split", "one_sym"])
def test_layout_reaches_every_value(kind):
    """The kernel's walk of h (``precode_layout``), emulated on the CPU,
    reads h's values in the order of the contiguous [rows, tx, P, sym x sc]:
    a contiguous h (the (b, rx, rxa) rows merge into one), two
    transmitters, an h whose rxa axis lies outermost in memory (the rows do
    not merge), an h expanded over the batch (stride 0), the first ports
    of a wider h, one symbol; and an h whose sym and sc axes do not merge
    (no layout: the wrapper copies it to contiguous)."""
    gen = torch.Generator().manual_seed(27)
    shape = (3, 1, 4, 2 if kind == "two_tx" else 1, 2,
             1 if kind == "one_sym" else 5, 12)
    h = _cn(gen, shape)
    if kind == "rxa_outermost":
        h = h.permute(2, 0, 1, 3, 4, 5, 6).contiguous().permute(
            1, 2, 0, 3, 4, 5, 6)
    elif kind == "b_broadcast":
        h = h[:1].expand(shape)
    elif kind == "port_slice":
        h = _cn(gen, shape[:4] + (4,) + shape[5:])[:, :, :, :, :2]
    elif kind == "sym_sc_split":
        h = h.transpose(-1, -2).contiguous().transpose(-1, -2)
    layout = precode_layout(h)
    if kind == "sym_sc_split":
        assert layout is None
        h = h.contiguous()
        layout = precode_layout(h)
    assert len(layout) == 11
    b, rx, rxa, tx, p, sym, sc = h.shape
    assert layout[0] == sym * sc and layout[8] == tx
    assert layout[2] * layout[3] * layout[4] == b * rx * rxa
    if kind in ("contiguous", "two_tx", "one_sym", "port_slice"):
        assert layout[2:5] == [b * rx * rxa, 1, 1]  # the rows merged
    if kind == "rxa_outermost":
        assert layout[2:5] == [4, 3, 1]
    want = h.reshape(b * rx * rxa, tx, p, sym * sc)
    assert torch.equal(_kernel_view(h, layout), want)


def _pusch_configs(num_tx):
    """The PUSCH tutorial's settings at one PRB (2 ports, 2 layers,
    codebook precoding) for ``num_tx`` UEs on their own DMRS ports, each
    with a TPMI of its own (1 and 2: different precoding matrices)."""
    pcs = []
    for tpmi, ports, rnti in ((1, [0, 1], 101), (2, [2, 3], 202))[:num_tx]:
        pc = nr.PUSCHConfig()
        pc.carrier.subcarrier_spacing = 30
        pc.carrier.n_size_grid = 1
        pc.num_antenna_ports = 2
        pc.num_layers = 2
        pc.precoding = "codebook"
        pc.tpmi = tpmi
        pc.dmrs.config_type = 1
        pc.dmrs.additional_position = 1
        pc.dmrs.dmrs_port_set = ports
        pc.n_rnti = rnti
        pc.tb.mcs_index = 14
        pcs.append(pc)
    return pcs


@pytest.mark.parametrize("num_tx", [1, 2])
def test_receiver_plain_path_matches_complex128(num_tx):
    """The perfect-CSI receiver on the CPU: the channel its detector gets
    is the plain path's (bit for bit ``precode_channel_plain``, the
    permute, matrix product and permute back it always ran) and within
    float32 rounding of a complex128 einsum of h and each transmitter's
    own precoding matrix over the transmit antennas; no kernel launch, no
    ``pusch.precode_kernel`` span."""
    tx = nr.PUSCHTransmitter(_pusch_configs(num_tx), return_bits=False)
    rx = nr.PUSCHReceiver(tx, channel_estimator="perfect")
    w = tx._precoder._w
    assert w.shape == (num_tx, 2, 2)
    if num_tx == 2:
        assert not torch.equal(w[0], w[1])
    gen = torch.Generator().manual_seed(num_tx)
    rg = tx.resource_grid
    b, rxa = 3, 4
    h = _cn(gen, (b, 1, rxa, num_tx, 2, rg.num_ofdm_symbols,
                  rg.fft_size)).to(C64) * 0.5 ** 0.5
    bits = torch.randint(0, 2, (b, num_tx, tx._tb_size), generator=gen)
    x = tx(bits.to(torch.float32))
    y = torch.sum(h * x[:, None, None], dim=(3, 4))
    seen = {}
    rx._mimo_detector.register_forward_pre_hook(
        lambda module, args: seen.__setitem__("h_hat", args[1]))
    launches = PRECODE_CHANNEL_KERNEL.launches
    with Profiler() as prof:
        rx(y, torch.tensor(1e-3), h)
    h_hat = seen["h_hat"]
    assert PRECODE_CHANNEL_KERNEL.launches == launches
    assert "pusch.precode_kernel" not in prof.counts
    assert h_hat.shape == (b, 1, rxa, num_tx, 2, rg.num_ofdm_symbols,
                           rg.fft_size) and h_hat.dtype == C64
    assert torch.equal(h_hat, precode_channel_plain(h, w))
    assert torch.equal(h_hat, precode_channel(h, w))
    want = np.einsum("brxtpsc,tpl->brxtlsc", h.numpy().astype(np.complex128),
                     w.numpy().astype(np.complex128))
    gap = np.abs(h_hat.numpy() - want).max() / np.abs(want).max()
    assert gap < F32_RTOL, gap
