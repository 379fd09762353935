"""Discrete memoryless channels with differentiable (Gumbel-softmax)
sampling (counterpart of ``sionna_tpu/phy/channel/discrete_channel.py``).

Gradients flow through the error sampling by the Gumbel-softmax trick
with a straight-through binarizer, and through the XOR of input and
errors by a straight-through estimator, as in the JAX package's custom
VJPs. A sampler is two parts: the draw of two uniform tensors
(``_draw_uniforms``) and a function of (pb, u1, u2) (``_errors``).
"""

import torch

from ..block import Block
from ..config import config
from ..utils.tensors import expand_to_rank

__all__ = ["BinaryMemorylessChannel", "BinarySymmetricChannel",
           "BinaryErasureChannel", "BinaryZChannel"]


class _SteBinarizer(torch.autograd.Function):
    """Hard decision at 0.5 with the identity as its gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.where(x < 0.5, 0., 1.).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _XorSte(torch.autograd.Function):
    """XOR as |a - b|, the gradient passed unchanged to both inputs."""

    @staticmethod
    def forward(ctx, a, b):
        return torch.abs(a - b)

    @staticmethod
    def backward(ctx, g):
        return g, g


class BinaryMemorylessChannel(Block):
    """Binary channel with asymmetric flip probabilities pb = (p0, p1).

    Call: (x, pb[, generator]). Returns bits (or LLRs in the logit
    convention if ``return_llrs``). The uniforms come from ``generator``
    when given, else from ``config.generator`` of ``x``'s device.
    """

    def __init__(self, return_llrs=False, bipolar_input=False,
                 llr_max=100., precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._return_llrs = bool(return_llrs)
        self._bipolar_input = bool(bipolar_input)
        self._llr_max = float(llr_max)
        self._temperature = 0.1
        self._eps = 1e-9

    @property
    def llr_max(self):
        return self._llr_max

    @llr_max.setter
    def llr_max(self, value):
        if value < 0:
            raise ValueError("llr_max cannot be negative.")
        self._llr_max = float(value)

    @property
    def temperature(self):
        return self._temperature

    @temperature.setter
    def temperature(self, value):
        if value < 0:
            raise ValueError("temperature cannot be negative.")
        self._temperature = float(value)

    def _draw_uniforms(self, shape, generator, device):
        """Two uniform tensors of ``shape`` in [0, 1)."""
        return tuple(torch.rand(shape, generator=generator,
                                dtype=self.rdtype, device=device)
                     for _ in range(2))

    def _errors(self, pb, u1, u2):
        """Differentiable Bernoulli(pb) errors from the uniforms: Gumbel
        softmax, then the straight-through binarizer."""
        eps = self._eps
        u = torch.stack((u1, u2), dim=-1)
        q = -torch.log(-torch.log(u + eps) + eps)
        p = torch.stack((pb, 1 - pb), dim=-1)
        p = expand_to_rank(p, q.dim(), axis=0)
        a = (torch.log(p + eps) + q) / self._temperature
        e_cat = torch.softmax(a, dim=-1)
        return _SteBinarizer.apply(e_cat[..., 0])

    def _sample_errors(self, pb, x, generator):
        if generator is None:
            generator = config.generator(x.device)
        return self._errors(pb, *self._draw_uniforms(x.shape, generator,
                                                     x.device))

    def _pb_pair(self, pb, device):
        if isinstance(pb, (tuple, list)):
            pb0, pb1 = pb
        else:
            pb = torch.as_tensor(pb, device=device).to(self.rdtype)
            pb0, pb1 = pb[..., 0], pb[..., 1]
        return tuple(torch.clamp(torch.as_tensor(p, device=device)
                                 .to(self.rdtype), 0., 1.)
                     for p in (pb0, pb1))

    def forward(self, x, pb, generator=None):
        x = x.to(self.rdtype)
        pb0, pb1 = self._pb_pair(pb, x.device)
        e0 = self._sample_errors(pb0, x, generator)
        e1 = self._sample_errors(pb1, x, generator)
        neutral = -1. if self._bipolar_input else 0.
        e = torch.where(x == neutral, e0, e1)
        if self._bipolar_input:
            y = x * (-2 * e + 1)
        else:
            y = _XorSte.apply(x, e)
        if self._return_llrs:
            if not self._bipolar_input:
                y = 2 * y - 1
            eps = self._eps
            y0 = -(torch.log(pb1 + eps) - torch.log(1 - pb0 - eps))
            y1 = torch.log(1 - pb1 - eps) - torch.log(pb0 + eps)
            y = torch.where(y == 1, y1, y0).to(y.dtype) * y
            y = torch.clamp(y, -self._llr_max, self._llr_max)
        return y


class BinarySymmetricChannel(BinaryMemorylessChannel):
    """BSC: symmetric flips with probability pb."""

    def forward(self, x, pb, generator=None):
        pb = torch.as_tensor(pb, device=x.device).to(self.rdtype)
        return super().forward(x, torch.stack((pb, pb), dim=-1),
                               generator=generator)


class BinaryZChannel(BinaryMemorylessChannel):
    """Z-channel: only 1 -> 0 errors, with probability pb."""

    def forward(self, x, pb, generator=None):
        pb = torch.as_tensor(pb, device=x.device).to(self.rdtype)
        return super().forward(
            x, torch.stack((torch.zeros_like(pb), pb), dim=-1),
            generator=generator)


class BinaryErasureChannel(BinaryMemorylessChannel):
    """BEC: erases with probability pb; erasures are -1 (binary input)
    or 0 (bipolar input), and 0 as LLRs."""

    def forward(self, x, pb, generator=None):
        x = x.to(self.rdtype)
        pb = torch.clamp(torch.as_tensor(pb, device=x.device)
                         .to(self.rdtype), 0., 1.)
        e = self._sample_errors(pb, x, generator)
        if self._return_llrs:
            if not self._bipolar_input:
                x = 2 * x - 1
            x = x * self._llr_max
            return torch.where(e == 1, torch.zeros_like(x), x)
        erased = 0. if self._bipolar_input else -1.
        return torch.where(e == 0, x, torch.full_like(x, erased))
