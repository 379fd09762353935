"""The dispatch of ``lmmse_equalizer`` between the whitened-LMMSE kernels
(``csrc/lmmse_whitened.cu`` for an S shared by the batch,
``csrc/lmmse_per_re.cu`` for an S at each batch element) and its plain
path, on the CPU: the rules ``lmmse_kernel_applies`` and
``lmmse_per_re_kernel_applies`` on each of their conditions (the inputs'
metadata as a card's tensors would carry it), ``lmmse_whitened_cuda`` and
``lmmse_per_re_cuda`` refusing what the kernels do not take, the per-RE
kernel's walk of the batch (``per_re_layout``) reaching every value of
each input, and ``lmmse_equalizer``'s CPU outputs bit for bit those of the
plain formula (the whitening, then the LMMSE) at the flat MIMO link's
shapes and at the PUSCH's per-RE systems. The kernels themselves are
tested on a card by ``tests/test_torch_lmmse_card.py`` and
``tests/test_torch_lmmse_per_re_card.py``. Imports no JAX.
"""

import pytest
import torch

from sionna_tpu_torch.phy.channel.utils import exp_corr_mat
from sionna_tpu_torch.phy.mimo import equalization
from sionna_tpu_torch.phy.mimo.equalization import (
    LMMSE_PER_RE_KERNEL, LMMSE_WHITENED_KERNEL, lmmse_equalizer,
    lmmse_kernel_applies, lmmse_matrix, lmmse_per_re_cuda,
    lmmse_per_re_kernel_applies, lmmse_whitened_cuda, per_re_layout)
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


def _per_re(n=6, m=4, k=2, dtype=C64):
    """The PUSCH's per-RE systems (M = 4, K = 2 by default): an S of its
    own at each of the n batch elements."""
    y, h, _ = _inputs(n, m, k, dtype=dtype)
    return y, h, _materialised((n, m, m)).to(dtype)


# case -> ((y, h, s), whiten_interference, the path: "shared" (the kernel
# for a shared S), "per_re" (the kernel for an S at each element) or
# "plain"). True and False: "shared" and "plain", as the cases of the
# shared-S kernel's rule alone were written.
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
    "pusch_per_re": (_per_re(), True, "per_re"),
    "per_re_m_1_k_1": (_per_re(m=1, k=1), True, "per_re"),
    "per_re_m_4_k_4": (_per_re(m=4, k=4), True, "per_re"),
    "per_re_m_3_k_1": (_per_re(m=3, k=1), True, "per_re"),
    "per_re_s_partly_expanded": (
        (*_inputs(m=4, k=2)[:2],
         _materialised((2, 1, 4, 4)).expand(2, 3, 4, 4)), True, "per_re"),
    "per_re_m_5": (_per_re(m=5), True, "plain"),
    "per_re_m_8": (_per_re(m=8), True, "plain"),
    "per_re_m_16": (_per_re(m=16), True, "plain"),
    "per_re_k_5": (_per_re(k=5), True, "plain"),
    "per_re_no_whitening": (_per_re(), False, "plain"),
    "per_re_complex128": (_per_re(dtype=torch.complex128), True, "plain"),
    "per_re_s_complex128": ((*_per_re()[:2],
                             _per_re()[2].to(torch.complex128)), True,
                            "plain"),
    "shared_m_4_k_2": (_inputs(m=4, k=2), True, "shared"),
    "shared_m_4_k_2_expanded": (_inputs(m=4, k=2, s_shape=(6, 4, 4)), True,
                                "shared"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rule(case):
    (y, h, s), whiten, want = CASES[case]
    want = {True: "shared", False: "plain"}.get(want, want)
    metas = (_Meta(y), _Meta(h), _Meta(s), whiten)
    assert lmmse_kernel_applies(*metas) is (want == "shared")
    assert lmmse_per_re_kernel_applies(*metas) is (want == "per_re")


# where -> (the input off the card or requiring a gradient, its system):
# the flat link's with a shared S, the PUSCH's with an S at each element
_WHERE = {"y": ("y", _inputs), "h": ("h", _inputs), "s": ("s", _inputs),
          "y_per_re": ("y", _per_re), "h_per_re": ("h", _per_re),
          "s_per_re": ("s", _per_re)}


@pytest.mark.parametrize("where", list(_WHERE))
def test_rule_on_cpu_and_another_device(where):
    """Any input off the card keeps the plain path."""
    name_off, system = _WHERE[where]
    for device in ("cpu", "meta"):
        metas = {name: _Meta(t, device if name == name_off else "cuda")
                 for name, t in zip("yhs", system())}
        for rule in (lmmse_kernel_applies, lmmse_per_re_kernel_applies):
            assert not rule(metas["y"], metas["h"], metas["s"], True)


@pytest.mark.parametrize("where", list(_WHERE))
@pytest.mark.parametrize("grad_mode", [True, False])
def test_rule_with_an_input_that_requires_grad(where, grad_mode):
    """An input that requires a gradient keeps the plain path (whose
    gradient flows), unless grad mode is off."""
    name_grad, system = _WHERE[where]
    rule = lmmse_kernel_applies if system is _inputs \
        else lmmse_per_re_kernel_applies
    inputs = dict(zip("yhs", system()))
    inputs[name_grad] = inputs[name_grad].clone().requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        got = rule(*(_Meta(inputs[n]) for n in "yhs"), True)
    assert got is not grad_mode


@pytest.mark.parametrize("case", [
    "cpu", "complex128", "s_batch", "m_17", "k_5", "mismatch", "strided",
    "per_re_cpu", "per_re_complex128", "per_re_s_complex128", "per_re_m_5",
    "per_re_k_5", "per_re_mismatch", "per_re_s_shared", "per_re_no_batch"])
def test_wrapper_refuses(case):
    """``lmmse_whitened_cuda`` and ``lmmse_per_re_cuda`` raise
    ``ValueError`` (before they build or launch anything) on what their
    kernels do not take."""
    if case.startswith("per_re"):
        _per_re_wrapper_refuses(case)
        return
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


def _per_re_wrapper_refuses(case):
    y, h, s = _per_re()
    if case == "per_re_complex128":
        y, h, s = (t.to(torch.complex128) for t in (y, h, s))
    elif case == "per_re_s_complex128":
        s = s.to(torch.complex128)
    elif case == "per_re_m_5":
        y, h, s = _per_re(m=5)
    elif case == "per_re_k_5":
        y, h, s = _per_re(k=5)
    elif case == "per_re_mismatch":
        h = h[:-1]
    elif case == "per_re_s_shared":
        s = s[0]
    elif case == "per_re_no_batch":
        y, h, s = y[0], h[0], s[0]
    launches = LMMSE_PER_RE_KERNEL.launches
    with pytest.raises(ValueError, match="not a layout the kernel takes"):
        lmmse_per_re_cuda(y, h, s)
    assert LMMSE_PER_RE_KERNEL.launches == launches


def _kernel_view(t, layout, which, elem):
    """t's values as the per-RE kernel reads them through ``layout`` (its
    storage, from the tensor's own offset), [N, *elem] in the rows'
    row-major order: a CPU emulation of the kernel's addressing."""
    cols, rows = layout[0], layout[1:4]
    st = layout[4 + 6 * which:10 + 6 * which]
    size = tuple(reversed(rows)) + (cols,) + elem
    stride = tuple(reversed(st[1:4])) + (st[0],) + tuple(st[4:4 + len(elem)])
    return torch.as_strided(t, size, stride, t.storage_offset()).reshape(
        (-1,) + elem)


def _pusch_views(b=3, sym=5, eff=7, m=4, k=2, gen=None):
    """y, h and S laid out as the OFDM detectors hand them: y and h
    permuted views of the grid (one plane per antenna and stream, the
    subcarriers innermost), S a fresh [b, 1, sym, eff, m, m] tensor."""
    def cn(shape):
        return torch.complex(torch.randn(shape, generator=gen),
                             torch.randn(shape, generator=gen))
    y = cn((b, 1, m, sym, eff)).permute(0, 1, 3, 4, 2)
    h = cn((k, b, m, sym, eff)).reshape(1, k, b, m, sym, eff) \
        .permute(2, 0, 4, 5, 3, 1)
    hu = cn((b, 1, sym, eff, m, 1))
    s = hu @ hu.conj().transpose(-1, -2) + (0.5 + torch.rand(
        (b, 1, sym, eff, 1, 1), generator=gen)) * torch.eye(m)
    return y, h, s.to(C64)


@pytest.mark.parametrize("kind", ["pusch_views", "contiguous",
                                  "s_broadcast", "many_dims"])
def test_per_re_layout_reaches_every_value(kind):
    """The per-RE kernel's walk of the batch (``per_re_layout``), emulated
    on the CPU, reads each input's values in the batch's row-major order:
    the OFDM detectors' permuted views (two batch dimensions remain,
    nothing copied), contiguous inputs (one), an S expanded over a
    dimension (stride 0), and a batch of five dimensions that do not merge
    (the wrapper's copy)."""
    gen = torch.Generator().manual_seed(24)
    y, h, s = _pusch_views(gen=gen)
    if kind == "contiguous":
        y, h, s = (t.contiguous() for t in (y, h, s))
    elif kind == "s_broadcast":
        s = s[:, :, :1].expand(s.shape)
    elif kind == "many_dims":
        # five batch dimensions in reverse memory order: none merge
        y, h, s = (torch.randn((2, 3, 5, 7, 2) + e, generator=gen).to(C64)
                   .permute(4, 3, 2, 1, 0, *range(5, 5 + len(e)))
                   for e in ((4,), (4, 2), (4, 4)))
    layout = per_re_layout(y, h, s)
    if kind == "many_dims":
        assert layout is None
        y, h, s = (t.contiguous() for t in (y, h, s))
        layout = per_re_layout(y, h, s)
    assert len(layout) == 22
    m, k = h.shape[-2:]
    n = y[..., 0].numel()
    assert layout[0] * layout[1] * layout[2] * layout[3] == n
    if kind == "pusch_views":
        assert layout[:4] == [35, 3, 1, 1]  # sym x eff merged, b outside
    for which, (t, elem) in enumerate(((y, (m,)), (h, (m, k)),
                                       (s, (m, m)))):
        got = _kernel_view(t, layout, which, elem)
        assert torch.equal(got, t.reshape((n,) + elem)), which


def _parent_formula(y, h, s):
    """The equalizer's whitened path as it stood before the kernel."""
    y, h = whiten_channel(y, h, s, return_s=False)
    g = lmmse_matrix(h, s=None)
    d = torch.diagonal(_matmul(g, h), dim1=-2, dim2=-1)
    return _matmul(g, y[..., None])[..., 0] / d, (1 / d - 1).real


@pytest.mark.parametrize("layout", ["pusch_views", "contiguous"])
def test_cpu_outputs_unchanged_at_the_pusch_shapes(layout):
    """At the PUSCH's per-RE 4 x 2 systems (S = N0 I + diag(error
    variances) + H_u H_u^H, an S at each RE), laid out as the OFDM
    detectors hand them or contiguous, on the CPU: the plain path, bit for
    bit, no kernel launch, no ``lmmse.kernel_per_re`` span."""
    gen = torch.Generator().manual_seed(24)
    y, h, s = _pusch_views(b=2, sym=14, eff=48, gen=gen)
    if layout == "contiguous":
        y, h, s = (t.contiguous() for t in (y, h, s))
    launches = LMMSE_PER_RE_KERNEL.launches
    with Profiler() as prof:
        x_hat, no_eff = lmmse_equalizer(y, h, s)
    want_x, want_no = _parent_formula(y, h, s)
    assert torch.equal(x_hat, want_x) and torch.equal(no_eff, want_no)
    assert x_hat.shape == (2, 1, 14, 48, 2) and x_hat.dtype == C64
    assert no_eff.dtype == torch.float32
    assert LMMSE_PER_RE_KERNEL.launches == launches
    assert "lmmse.kernel_per_re" not in prof.counts
    assert "lmmse.kernel" not in prof.counts


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
