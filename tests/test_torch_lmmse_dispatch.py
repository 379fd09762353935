"""The dispatch of ``lmmse_equalizer`` between the whitened-LMMSE kernel
(``csrc/lmmse_whitened.cu``) and its plain path, on the CPU: the rule
``lmmse_kernel_applies`` on each of its conditions (the inputs' metadata
as a card's tensors would carry it), ``lmmse_whitened_cuda`` refusing what
the kernel does not take, and ``lmmse_equalizer``'s CPU outputs bit for
bit those of the plain formula (the whitening, then the 4 x 4 LMMSE) at
the flat MIMO link's shapes. The kernel itself is tested on a card by
``tests/test_torch_lmmse_card.py``. Imports no JAX.
"""

import pytest
import torch

from sionna_tpu_torch.phy.channel.utils import exp_corr_mat
from sionna_tpu_torch.phy.mimo import equalization
from sionna_tpu_torch.phy.mimo.equalization import (
    LMMSE_WHITENED_KERNEL, lmmse_equalizer, lmmse_kernel_applies,
    lmmse_matrix, lmmse_whitened_cuda)
from sionna_tpu_torch.phy.mimo.utils import whiten_channel
from sionna_tpu_torch.phy.utils import Profiler
from sionna_tpu_torch.phy.utils.linalg import _matmul

C64 = torch.complex64


class _Meta:
    """A tensor's device, dtype, shape, strides and ``requires_grad``, as
    the rule reads them, on a device of our choosing (a card's here)."""

    def __init__(self, t, device="cuda"):
        self.shape, self.dtype = t.shape, t.dtype
        self.requires_grad = t.requires_grad
        self.device = torch.device(device)
        self._stride = t.stride()

    def stride(self):
        return self._stride


def _inputs(n=6, m=16, k=4, s_shape=None, dtype=C64):
    y = torch.zeros((n, m), dtype=dtype)
    h = torch.zeros((n, m, k), dtype=dtype)
    s = torch.eye(m, dtype=dtype)
    if s_shape is not None:
        s = s.expand(s_shape)
    return y, h, s


def _materialised(shape):
    """An S with batch dimensions that hold their own entries."""
    return torch.eye(shape[-1], dtype=C64).repeat(shape[:-2] + (1, 1))


# case -> ((y, h, s), whiten_interference, whether the kernel runs)
CASES = {
    "flat_link": (_inputs(), True, True),
    "no_whitening": (_inputs(), False, False),
    "s_batch_ones": (_inputs(s_shape=(1, 1, 16, 16)), True, True),
    "s_expanded": (_inputs(s_shape=(6, 16, 16)), True, True),
    "s_expanded_and_ones": (_inputs(s_shape=(1, 6, 16, 16)), True, True),
    "s_per_element": ((*_inputs()[:2], _materialised((6, 16, 16))), True,
                      False),
    "s_per_element_size_2": ((*_inputs()[:2], _materialised((2, 1, 16, 16))),
                             True, False),
    "m_1_k_1": (_inputs(m=1, k=1), True, True),
    "m_16_k_4": (_inputs(m=16, k=4), True, True),
    "m_17": (_inputs(m=17), True, False),
    "k_5": (_inputs(k=5), True, False),
    "complex128": (_inputs(dtype=torch.complex128), True, False),
    "y_complex128": ((_inputs()[0].to(torch.complex128), *_inputs()[1:]),
                     True, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rule(case):
    (y, h, s), whiten, want = CASES[case]
    assert lmmse_kernel_applies(_Meta(y), _Meta(h), _Meta(s),
                                whiten) is want


@pytest.mark.parametrize("where", ["y", "h", "s"])
def test_rule_on_cpu_and_another_device(where):
    """Any input off the card keeps the plain path."""
    for device in ("cpu", "meta"):
        metas = {name: _Meta(t, device if name == where else "cuda")
                 for name, t in zip("yhs", _inputs())}
        assert not lmmse_kernel_applies(metas["y"], metas["h"], metas["s"],
                                        True)


@pytest.mark.parametrize("where", ["y", "h", "s"])
@pytest.mark.parametrize("grad_mode", [True, False])
def test_rule_with_an_input_that_requires_grad(where, grad_mode):
    """An input that requires a gradient keeps the plain path (whose
    gradient flows), unless grad mode is off."""
    inputs = dict(zip("yhs", _inputs()))
    inputs[where] = inputs[where].clone().requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        got = lmmse_kernel_applies(*(_Meta(inputs[n]) for n in "yhs"), True)
    assert got is not grad_mode


@pytest.mark.parametrize("case", ["cpu", "complex128", "s_batch", "m_17",
                                  "k_5", "mismatch", "strided"])
def test_wrapper_refuses(case):
    """``lmmse_whitened_cuda`` raises ``ValueError`` (before it builds or
    launches anything) on what the kernel does not take."""
    y, h, s = _inputs()
    if case == "complex128":
        y, h, s = (t.to(torch.complex128) for t in (y, h, s))
    elif case == "s_batch":
        s = s[None]
    elif case == "m_17":
        y, h, s = _inputs(m=17)
    elif case == "k_5":
        y, h, s = _inputs(k=5)
    elif case == "mismatch":
        h = h[:-1]
    elif case == "strided":
        h = h.transpose(0, 1).contiguous().transpose(0, 1)
    launches = LMMSE_WHITENED_KERNEL.launches
    with pytest.raises(ValueError, match="not a layout the kernel takes"):
        lmmse_whitened_cuda(y, h, s)
    assert LMMSE_WHITENED_KERNEL.launches == launches


def _parent_formula(y, h, s):
    """The equalizer's whitened path as it stood before the kernel."""
    y, h = whiten_channel(y, h, s, return_s=False)
    g = lmmse_matrix(h, s=None)
    d = torch.diagonal(_matmul(g, h), dim1=-2, dim2=-1)
    return _matmul(g, y[..., None])[..., 0] / d, (1 / d - 1).real


@pytest.mark.parametrize("s_kind", ["n0_eye", "correlated", "expanded"])
def test_cpu_outputs_unchanged_at_the_flat_link_shapes(s_kind):
    """At the flat link's 16 x 4 systems (S = N0 I, as it passes; a
    correlated S; S expanded over the batch), on the CPU: the plain path,
    bit for bit, no kernel launch, no ``lmmse.kernel`` span."""
    g = torch.Generator().manual_seed(22)
    n, m, k = 512, 16, 4
    h = torch.complex(torch.randn((n, m, k), generator=g),
                      torch.randn((n, m, k), generator=g))
    y = torch.complex(torch.randn((n, m), generator=g),
                      torch.randn((n, m), generator=g))
    no = 0.3
    s = (no * torch.eye(m)).to(C64) if s_kind != "correlated" else \
        (exp_corr_mat(0.9, m, device="cpu") + 0.1 * torch.eye(m)).to(C64)
    if s_kind == "expanded":
        s = s.expand(n, m, m)
    launches = LMMSE_WHITENED_KERNEL.launches
    with Profiler() as prof:
        x_hat, no_eff = lmmse_equalizer(y, h, s)
    want_x, want_no = _parent_formula(y, h, s)
    assert torch.equal(x_hat, want_x) and torch.equal(no_eff, want_no)
    assert x_hat.dtype == C64 and no_eff.dtype == torch.float32
    assert LMMSE_WHITENED_KERNEL.launches == launches
    assert "lmmse.kernel" not in prof.counts
    assert equalization.lmmse_equalizer_plain(y, h, s)[0].equal(x_hat)
