"""Mapping: constellations, (de)mappers and the binary source.

PyTorch counterpart of ``sionna_tpu/phy/mapping.py``. LLRs follow the
*logit* convention ``LLR = log(P(b=1)/P(b=0))``.

The mapper and demapper use the plain table formulation: the mapper
gathers from the point table, and the demapper reduces dense
``[..., num_points]`` logits with masked logsumexp (or max). The JAX
package's separable per-axis fast paths are layout work for the TPU and
are not ported.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import config, dtypes
from .block import Block
from .utils.tensors import expand_to_rank

__all__ = ["pam_gray", "qam", "pam", "Constellation", "Mapper", "Demapper",
           "SymbolLogits2LLRs", "BinarySource"]


def pam_gray(b):
    """Maps a binary vector to a Gray-labeled PAM point in
    {+-1, +-3, ..., +-(2^n - 1)} per 3GPP TS 38.211 Section 5.1."""
    if len(b) > 1:
        return (1 - 2 * b[0]) * (2 ** len(b[1:]) - pam_gray(b[1:]))
    return 1 - 2 * b[0]


def qam(num_bits_per_symbol, normalize=True, precision=None):
    """Gray-labeled QAM constellation (NumPy); the label of the n-th
    point is the binary representation of n, even bits -> real PAM,
    odd bits -> imaginary PAM."""
    if num_bits_per_symbol % 2 != 0 or num_bits_per_symbol <= 0:
        raise ValueError("num_bits_per_symbol must be a multiple of 2")
    if precision is None:
        rdtype, cdtype = config.np_rdtype, config.np_cdtype
    else:
        rdtype = dtypes[precision]["np"]["rdtype"]
        cdtype = dtypes[precision]["np"]["cdtype"]

    c = np.zeros([2 ** num_bits_per_symbol], dtype=cdtype)
    for i in range(2 ** num_bits_per_symbol):
        b = np.array(list(np.binary_repr(i, num_bits_per_symbol)),
                     dtype=np.int32)
        c[i] = pam_gray(b[0::2]) + 1j * pam_gray(b[1::2])

    if normalize:
        n = num_bits_per_symbol // 2
        qam_var = 1 / (2 ** (n - 2)) * np.sum(
            np.linspace(1, 2 ** n - 1, 2 ** (n - 1), dtype=rdtype) ** 2)
        c /= np.sqrt(qam_var)
    return c


def pam(num_bits_per_symbol, normalize=True, precision=None):
    """Gray-labeled PAM constellation (NumPy)."""
    if num_bits_per_symbol <= 0:
        raise ValueError("num_bits_per_symbol must be positive")
    if precision is None:
        rdtype, cdtype = config.np_rdtype, config.np_cdtype
    else:
        rdtype = dtypes[precision]["np"]["rdtype"]
        cdtype = dtypes[precision]["np"]["cdtype"]

    c = np.zeros([2 ** num_bits_per_symbol], dtype=cdtype)
    for i in range(2 ** num_bits_per_symbol):
        b = np.array(list(np.binary_repr(i, num_bits_per_symbol)),
                     dtype=np.int32)
        c[i] = pam_gray(b)

    if normalize:
        n = num_bits_per_symbol
        pam_var = 1 / (2 ** (n - 1)) * np.sum(
            np.linspace(1, 2 ** n - 1, 2 ** (n - 1), dtype=rdtype) ** 2)
        c /= np.sqrt(pam_var)
    return c


class Constellation(Block):
    """Constellation container: "qam" | "pam" | "custom".

    The raw points are the parameter ``raw_points``; calling the block
    (or reading ``points``) applies centering and normalization. To
    train the points, call ``raw_points.requires_grad_()`` and optimize
    as usual; the JAX package instead passes updated points as a
    call-time ``points`` override, which :class:`Mapper` and
    :class:`Demapper` accept here too.
    """

    def __init__(self, constellation_type, num_bits_per_symbol,
                 points=None, normalize=True, center=False,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if constellation_type not in ("qam", "pam", "custom"):
            raise ValueError("Unknown constellation_type")
        self._constellation_type = constellation_type
        self._num_bits_per_symbol = int(num_bits_per_symbol)
        self.normalize = bool(normalize)
        self.center = bool(center)

        if constellation_type == "qam":
            if points is not None:
                raise ValueError("points cannot be provided for qam")
            points = qam(self._num_bits_per_symbol, normalize=False,
                         precision=self.precision)
        elif constellation_type == "pam":
            if points is not None:
                raise ValueError("points cannot be provided for pam")
            points = pam(self._num_bits_per_symbol, normalize=False,
                         precision=self.precision)
        elif points is None:
            raise ValueError("points must be provided for custom")
        points = torch.as_tensor(np.asarray(points, self.np_cdtype),
                                 device=self.device)
        if points.shape[0] != 2 ** self._num_bits_per_symbol:
            raise ValueError("points has wrong number of elements")
        self.raw_points = nn.Parameter(points, requires_grad=False)

    @property
    def constellation_type(self):
        return self._constellation_type

    @property
    def num_bits_per_symbol(self):
        return self._num_bits_per_symbol

    @property
    def num_points(self):
        return 2 ** self._num_bits_per_symbol

    @property
    def points(self):
        """Normalized/centered points (what mappers consume)."""
        return self()

    @points.setter
    def points(self, v):
        with torch.no_grad():
            self.raw_points.copy_(torch.as_tensor(v).to(self.cdtype))

    def forward(self, points=None):
        """Applies centering/normalization to the (possibly overridden)
        raw points and returns the effective constellation."""
        if points is None:
            points = self.raw_points
        points = torch.as_tensor(points).to(self.cdtype)
        if self.center:
            points = points - torch.mean(points)
        if self.normalize:
            # divide each part by the real norm: correctly rounded, as
            # NumPy's complex-by-real division (a complex divisor would
            # round differently)
            norm = torch.sqrt(torch.mean(torch.abs(points) ** 2))
            points = torch.complex(points.real / norm, points.imag / norm)
        return points

    @staticmethod
    def check_or_create(*, constellation_type=None, num_bits_per_symbol=None,
                        constellation=None, precision=None, device=None):
        """Returns an existing constellation or creates one."""
        if constellation is not None:
            if precision is not None and \
                    constellation.precision != precision:
                raise ValueError("Constellation has wrong precision.")
            return constellation
        return Constellation(constellation_type, num_bits_per_symbol,
                             precision=precision, device=device)


def _binary_labels(num_bits_per_symbol):
    """[2^K, K] array of bit labels, MSB first."""
    n = 2 ** num_bits_per_symbol
    ints = np.arange(n)
    shifts = np.arange(num_bits_per_symbol - 1, -1, -1)
    return ((ints[:, None] >> shifts[None, :]) & 1).astype(np.int32)


class Mapper(Block):
    """Maps a tensor of bits [..., n*K] to constellation symbols
    [..., n]."""

    def __init__(self, constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, return_indices=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self.constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision,
            device=device)
        self._return_indices = bool(return_indices)
        k = self.constellation.num_bits_per_symbol
        self.register_buffer(
            "_bit_weights",
            torch.as_tensor(2 ** np.arange(k - 1, -1, -1),
                            dtype=torch.int64, device=self.device),
            persistent=False)

    def forward(self, bits, points=None):
        k = self.constellation.num_bits_per_symbol
        bits = torch.as_tensor(bits)
        new_shape = bits.shape[:-1] + (bits.shape[-1] // k, k)
        bits_int = bits.reshape(new_shape).to(torch.int64)
        ind = torch.sum(bits_int * self._bit_weights, dim=-1)
        x = self.constellation(points)[ind]
        if self._return_indices:
            return x, ind
        return x


class SymbolLogits2LLRs(Block):
    """Computes per-bit LLRs from symbol logits, "app" (logsumexp) or
    "maxlog", with optional priors."""

    def __init__(self, method, num_bits_per_symbol, hard_out=False,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if method not in ("app", "maxlog"):
            raise ValueError("Unknown demapping method")
        self._method = method
        self._hard_out = bool(hard_out)
        self._num_bits_per_symbol = int(num_bits_per_symbol)
        labels = _binary_labels(num_bits_per_symbol)  # [2^K, K]
        # mask[c, k] = True where bit k of label(c) == 1
        self.register_buffer(
            "_bit1_mask", torch.as_tensor(labels == 1, device=self.device),
            persistent=False)
        # +-1 labels for the prior
        self.register_buffer(
            "_pm1", torch.as_tensor(2 * labels - 1, device=self.device),
            persistent=False)

    @property
    def num_bits_per_symbol(self):
        return self._num_bits_per_symbol

    def forward(self, logits, prior=None):
        logits = torch.as_tensor(logits).to(self.rdtype)  # [..., 2^K]
        if prior is not None:
            prior = torch.as_tensor(prior).to(self.rdtype)
            # log Pr(c | p) = sum_k logsigmoid(p_k * l(c)_k)
            prior_e = expand_to_rank(prior, logits.dim(), axis=0)
            lp = F.logsigmoid(prior_e[..., None, :] * self._pm1)
            logits = logits + torch.sum(lp, dim=-1)

        # Split into bit=1 / bit=0 reductions per bit position.
        x = logits[..., None]  # [..., 2^K, 1]
        neg_inf = torch.tensor(-np.inf, dtype=self.rdtype,
                               device=logits.device)
        logits1 = torch.where(self._bit1_mask, x, neg_inf)
        logits0 = torch.where(self._bit1_mask, neg_inf, x)
        if self._method == "app":
            llr = (torch.logsumexp(logits1, dim=-2)
                   - torch.logsumexp(logits0, dim=-2))
        else:
            llr = (torch.amax(logits1, dim=-2)
                   - torch.amax(logits0, dim=-2))
        if self._hard_out:
            return (llr > 0).to(self.rdtype)
        return llr


class Demapper(Block):
    """Computes LLRs (or hard bits) for received symbols."""

    def __init__(self, demapping_method, constellation_type=None,
                 num_bits_per_symbol=None, constellation=None,
                 hard_out=False, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self.constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision,
            device=device)
        self._logits2llrs = SymbolLogits2LLRs(
            demapping_method, self.constellation.num_bits_per_symbol,
            hard_out=hard_out, precision=precision, device=device)
        self._no_threshold = float(np.finfo(self.np_rdtype).tiny)

    def forward(self, y, no, prior=None, points=None):
        y = torch.as_tensor(y).to(self.cdtype)
        nbps = self.constellation.num_bits_per_symbol
        no = torch.as_tensor(no).to(device=y.device, dtype=self.rdtype)
        no = torch.clamp_min(expand_to_rank(no, y.dim(), axis=0)[..., None],
                             self._no_threshold)
        # one reciprocal instead of a division per constellation point
        neg_inv_no = -1. / no
        out_shape = y.shape[:-1] + (y.shape[-1] * nbps,)
        pts = self.constellation(points)
        pts_b = expand_to_rank(pts, y.dim() + 1, axis=0)
        squared_dist = torch.abs(y[..., None] - pts_b) ** 2
        llr = self._logits2llrs(squared_dist * neg_inv_no, prior)
        return llr.reshape(out_shape)


class BinarySource(Block):
    """Random binary tensor source.

    Call with a shape. Bits come from ``generator`` when given, else
    from a generator seeded with ``seed`` (when set), else from
    ``config.generator(device)``.
    """

    def __init__(self, precision=None, seed=None, device=None):
        super().__init__(precision=precision, device=device)
        self._seed = seed
        self._generator = None

    def forward(self, inputs, generator=None):
        shape = [int(s) for s in torch.as_tensor(inputs).reshape(-1)]
        if generator is None:
            if self._seed is None:
                generator = config.generator(self.device)
            else:
                if (self._generator is None
                        or self._generator.device != self.device):
                    self._generator = torch.Generator(self.device)
                    self._generator.manual_seed(self._seed)
                generator = self._generator
        return torch.randint(0, 2, shape, generator=generator,
                             device=self.device, dtype=self.rdtype)
