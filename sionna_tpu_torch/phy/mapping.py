"""Mapping: constellations, (de)mappers and random sources.

PyTorch counterpart of ``sionna_tpu/phy/mapping.py``. LLRs follow the
*logit* convention ``LLR = log(P(b=1)/P(b=0))``.

For a constellation that factors exactly into two Gray-labelled PAM
axes (Gray QAM), the mapper and the demapper take the JAX package's
separable paths: the mapper selects each axis value with a where-tree
over its bits, and the demapper demaps each axis on its own, with the
``2^(K/2)`` points of an axis unrolled as constants. Otherwise (custom
or trainable points, a call-time ``points`` override, or
``return_indices``) they use the table formulation: the mapper gathers
from the point table, and the demapper reduces dense
``[..., num_points]`` logits with masked logsumexp (or max).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import config, dtypes
from .block import Block, Object
from .utils.tensors import expand_to_rank

__all__ = ["pam_gray", "qam", "pam", "Constellation", "Mapper", "Demapper",
           "SymbolDemapper", "SymbolLogits2LLRs", "LLRs2SymbolLogits",
           "SymbolLogits2Moments", "SymbolInds2Bits", "QAM2PAM", "PAM2QAM",
           "BinarySource", "SymbolSource", "QAMSource", "PAMSource"]


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

    @property
    def points_host(self):
        """NumPy copy of the effective points, centered and normalized
        in NumPy as the JAX package's ``points_host`` does."""
        pts = self.raw_points.detach().cpu().numpy().astype(self.np_cdtype)
        if self.center:
            pts = pts - np.mean(pts)
        if self.normalize:
            pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
        return pts.astype(self.np_cdtype)

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

    def show(self, labels=True, figsize=(7, 7)):
        """Scatter plot of the constellation (matplotlib, imported
        here); returns the figure."""
        import matplotlib.pyplot as plt
        pts = self.points.detach().cpu().numpy()
        maxval = np.max(np.abs(pts)) * 1.05
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111)
        plt.xlim(-maxval, maxval)
        plt.ylim(-maxval, maxval)
        plt.scatter(np.real(pts), np.imag(pts))
        ax.set_aspect("equal", adjustable="box")
        plt.xlabel("Real Part")
        plt.ylabel("Imaginary Part")
        plt.grid(True, which="both", axis="both")
        plt.title("Constellation Plot")
        if labels:
            for j, p in enumerate(pts):
                plt.annotate(np.binary_repr(j, self.num_bits_per_symbol),
                             (np.real(p), np.imag(p)))
        return fig

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


def _separable_pam_tables(constellation, np_rdtype):
    """(pr, pi) per-axis PAM point tables when the constellation
    factors exactly (bit for bit) into two independent Gray-labelled PAM
    axes (even symbol bits index the real axis, odd bits the imaginary
    axis), else None."""
    kbits = constellation.num_bits_per_symbol
    if kbits % 2 != 0:
        return None
    pts = constellation.points_host
    h = kbits // 2

    def interleave(e, o):
        i = 0
        for j in range(h):
            i |= (((e >> (h - 1 - j)) & 1) << (kbits - 1 - 2 * j))
            i |= (((o >> (h - 1 - j)) & 1) << (kbits - 2 - 2 * j))
        return i

    pr = np.array([pts[interleave(e, 0)].real for e in range(2 ** h)])
    pi = np.array([pts[interleave(0, o)].imag for o in range(2 ** h)])
    recon = np.array([[pr[e] + 1j * pi[o] for o in range(2 ** h)]
                      for e in range(2 ** h)])
    idx = np.array([[interleave(e, o) for o in range(2 ** h)]
                    for e in range(2 ** h)])
    if not np.array_equal(recon, pts[idx]):
        return None
    return pr.astype(np_rdtype), pi.astype(np_rdtype)


class _SeparableTables:
    """The per-axis tables of a constellation as 0-dim tensors per
    device, recomputed when its raw points change (their version
    counter, identity, centering or normalization). None while the
    points are trainable (``requires_grad``): the separable paths hold
    the points as constants, so gradients take the table path."""

    def __init__(self, np_rdtype, rdtype):
        self._np_rdtype, self._rdtype = np_rdtype, rdtype
        self._key = self._tables = None
        self._consts = {}

    def get(self, constellation, device):
        raw = constellation.raw_points
        if raw.requires_grad:
            return None
        key = (id(raw), raw._version, constellation.center,
               constellation.normalize)
        if key != self._key:
            self._key = key
            self._tables = _separable_pam_tables(constellation,
                                                 self._np_rdtype)
            self._consts = {}
        if self._tables is None:
            return None
        if device not in self._consts:
            self._consts[device] = tuple(
                [torch.tensor(float(v), dtype=self._rdtype, device=device)
                 for v in table] for table in self._tables)
        return self._consts[device]


def _select_tree(bits_h, vals):
    """Selects vals[label(bits)] with a where-tree: bits_h [..., h] bool
    (MSB-first label bits), vals 2^h 0-dim tensors. 2^h - 1 selects, no
    gather; bit-exact against an indexed lookup."""
    h = bits_h.shape[-1]
    for j in range(h - 1, -1, -1):
        b = bits_h[..., j]
        vals = [torch.where(b, vals[2 * i + 1], vals[2 * i])
                for i in range(len(vals) // 2)]
    return vals[0]


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
        self._sep = _SeparableTables(self.np_rdtype, self.rdtype)

    def forward(self, bits, points=None):
        k = self.constellation.num_bits_per_symbol
        bits = torch.as_tensor(bits)
        new_shape = bits.shape[:-1] + (bits.shape[-1] // k, k)
        # Separable path: each axis value selected by a where-tree over
        # its h bits, the axis tables normalized in NumPy as the JAX
        # package's are (the table path normalizes in torch: 1 ULP apart
        # at 64-QAM, as JAX's two paths are)
        sep = (self._sep.get(self.constellation, bits.device)
               if points is None and not self._return_indices else None)
        if sep is not None:
            pr, pi = sep
            b = bits.reshape(new_shape) > 0.5
            return torch.complex(_select_tree(b[..., 0::2], pr),
                                 _select_tree(b[..., 1::2], pi))
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
        nbps = self.constellation.num_bits_per_symbol
        self._method = demapping_method
        self._hard_out = bool(hard_out)
        self._logits2llrs = SymbolLogits2LLRs(
            demapping_method, nbps, hard_out=hard_out, precision=precision,
            device=device)
        self._no_threshold = float(np.finfo(self.np_rdtype).tiny)
        self._sep = _SeparableTables(self.np_rdtype, self.rdtype)
        if nbps % 2 == 0:
            self._logits2llrs_half = SymbolLogits2LLRs(
                demapping_method, nbps // 2, hard_out=hard_out,
                precision=precision, device=device)

    def _pam_llrs_unrolled(self, v, ninv, table):
        """Per-axis LLRs with the 2^h points unrolled as constants: v
        [...], ninv [...] (= -1/no), table 2^h 0-dim tensors. Returns
        [..., h] LLRs (method and hard_out applied). The points are
        folded left to right in index order, as in the JAX package."""
        h = int(np.log2(len(table)))
        d = []
        for p in table:
            t = v - p
            d.append(t * t * ninv)
        red = torch.logaddexp if self._method == "app" else torch.maximum

        def reduce(vals):
            acc = vals[0]
            for x in vals[1:]:
                acc = red(acc, x)
            return acc

        llrs = []
        for kbit in range(h):
            ones = [d[i] for i in range(len(d)) if (i >> (h - 1 - kbit)) & 1]
            zeros = [d[i] for i in range(len(d))
                     if not (i >> (h - 1 - kbit)) & 1]
            llrs.append(reduce(ones) - reduce(zeros))
        llr = torch.stack(llrs, dim=-1)
        if self._hard_out:
            return (llr > 0).to(self.rdtype)
        return llr

    def forward(self, y, no, prior=None, points=None):
        y = torch.as_tensor(y).to(self.cdtype)
        nbps = self.constellation.num_bits_per_symbol
        no = torch.as_tensor(no).to(device=y.device, dtype=self.rdtype)
        no = torch.clamp_min(expand_to_rank(no, y.dim(), axis=0)[..., None],
                             self._no_threshold)
        # one reciprocal instead of a division per constellation point
        neg_inv_no = -1. / no
        out_shape = y.shape[:-1] + (y.shape[-1] * nbps,)

        sep = (self._sep.get(self.constellation, y.device)
               if points is None else None)
        if sep is not None:
            pr_c, pi_c = sep
            if prior is None:
                ninv = neg_inv_no[..., 0]
                le = self._pam_llrs_unrolled(y.real, ninv, pr_c)
                lo = self._pam_llrs_unrolled(y.imag, ninv, pi_c)
            else:
                prior = torch.as_tensor(prior).to(device=y.device,
                                                  dtype=self.rdtype)
                prior_e = expand_to_rank(prior, y.dim() + 1, axis=0)
                pr_t, pi_t = torch.stack(pr_c), torch.stack(pi_c)
                le = self._logits2llrs_half(
                    (y.real[..., None] - pr_t) ** 2 * neg_inv_no,
                    prior_e[..., 0::2])
                lo = self._logits2llrs_half(
                    (y.imag[..., None] - pi_t) ** 2 * neg_inv_no,
                    prior_e[..., 1::2])
            llr = torch.stack([le, lo], dim=-1).reshape(
                le.shape[:-1] + (nbps,))
            return llr.reshape(out_shape)

        pts = self.constellation(points)
        pts_b = expand_to_rank(pts, y.dim() + 1, axis=0)
        squared_dist = torch.abs(y[..., None] - pts_b) ** 2
        llr = self._logits2llrs(squared_dist * neg_inv_no, prior)
        return llr.reshape(out_shape)


class SymbolDemapper(Block):
    """Computes symbol-level logits (or hard symbol decisions) for
    received symbols."""

    def __init__(self, constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, hard_out=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self.constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision,
            device=device)
        self._hard_out = bool(hard_out)

    def forward(self, y, no, prior=None, points=None):
        y = torch.as_tensor(y).to(self.cdtype)
        pts = self.constellation(points)
        pts_b = expand_to_rank(pts, y.dim() + 1, axis=0)
        squared_dist = torch.abs(y[..., None] - pts_b) ** 2
        no = torch.as_tensor(no).to(device=y.device, dtype=self.rdtype)
        no = expand_to_rank(no, y.dim(), axis=0)[..., None]
        logits = -squared_dist / no
        if prior is not None:
            prior = torch.as_tensor(prior).to(device=y.device,
                                              dtype=self.rdtype)
            logits = logits + expand_to_rank(prior, logits.dim(), axis=0)
        if self._hard_out:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.log_softmax(logits, dim=-1)


class LLRs2SymbolLogits(Block):
    """Computes symbol logits from per-bit LLRs."""

    def __init__(self, num_bits_per_symbol, hard_out=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self._num_bits_per_symbol = int(num_bits_per_symbol)
        self._hard_out = bool(hard_out)
        labels = _binary_labels(num_bits_per_symbol)
        self.register_buffer(
            "_pm1", torch.as_tensor(2 * labels - 1, device=self.device),
            persistent=False)

    @property
    def num_bits_per_symbol(self):
        return self._num_bits_per_symbol

    def forward(self, llrs):
        llrs = torch.as_tensor(llrs).to(self.rdtype)  # [..., n, K]
        logits = torch.sum(F.logsigmoid(llrs[..., None, :] * self._pm1),
                           dim=-1)
        if self._hard_out:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return logits


class SymbolLogits2Moments(Block):
    """Computes mean and variance of a constellation given symbol
    logits."""

    def __init__(self, constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self.constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision,
            device=device)

    def forward(self, logits, points=None):
        logits = torch.as_tensor(logits).to(self.rdtype)
        pts = self.constellation(points)
        p = torch.softmax(logits, dim=-1)
        mean = torch.sum(p.to(self.cdtype) * pts, dim=-1)
        var = torch.sum(p * torch.abs(pts[None, :] - mean[..., None]) ** 2,
                        dim=-1)
        return mean, var


class SymbolInds2Bits(Block):
    """Maps symbol indices to their binary labels."""

    def __init__(self, num_bits_per_symbol, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self.register_buffer(
            "_labels", torch.as_tensor(_binary_labels(num_bits_per_symbol),
                                       device=self.device).to(self.rdtype),
            persistent=False)

    def forward(self, symbol_ind):
        ind = torch.as_tensor(symbol_ind, device=self._labels.device)
        return self._labels[ind.to(torch.int64)]


class QAM2PAM(Object):
    """Splits QAM symbol indices into two PAM indices (real, imag)."""

    def __init__(self, num_bits_per_symbol):
        super().__init__()
        if num_bits_per_symbol % 2 != 0:
            raise ValueError("num_bits_per_symbol must be even")
        labels = _binary_labels(num_bits_per_symbol)
        w = 2 ** np.arange(num_bits_per_symbol // 2 - 1, -1, -1)
        self._ind1 = torch.as_tensor((labels[:, 0::2] * w).sum(-1))
        self._ind2 = torch.as_tensor((labels[:, 1::2] * w).sum(-1))

    def __call__(self, ind_qam):
        ind_qam = torch.as_tensor(ind_qam).to(torch.int64)
        dev = ind_qam.device
        return (self._ind1.to(dev)[ind_qam].to(torch.int32),
                self._ind2.to(dev)[ind_qam].to(torch.int32))


class PAM2QAM(Object):
    """Combines two PAM indices (or logit vectors) into QAM indices (or
    logits)."""

    def __init__(self, num_bits_per_symbol, hard_in_out=True):
        super().__init__()
        if num_bits_per_symbol % 2 != 0:
            raise ValueError("num_bits_per_symbol must be even")
        self._hard = bool(hard_in_out)
        k = num_bits_per_symbol
        n_half = 2 ** (k // 2)
        labels_half = _binary_labels(k // 2)
        # qam_ind[p1, p2]: the bits of p1 at even positions, p2 at odd
        qam_ind = np.zeros((n_half, n_half), np.int64)
        for p1 in range(n_half):
            for p2 in range(n_half):
                bits = np.zeros(k, np.int64)
                bits[0::2] = labels_half[p1]
                bits[1::2] = labels_half[p2]
                qam_ind[p1, p2] = int((bits * 2 ** np.arange(k - 1, -1, -1)
                                       ).sum())
        self._qam_ind = torch.as_tensor(qam_ind)
        self._inv = torch.as_tensor(np.argsort(qam_ind.reshape(-1)))
        self._num_points = 2 ** k

    def __call__(self, pam1, pam2):
        pam1, pam2 = torch.as_tensor(pam1), torch.as_tensor(pam2)
        dev = pam1.device
        if self._hard:
            return self._qam_ind.to(dev)[pam1.to(torch.int64),
                                         pam2.to(torch.int64)].to(torch.int32)
        # soft: logits over the PAM points combined into QAM logits
        logits = pam1[..., :, None] + pam2[..., None, :]
        flat = logits.reshape(logits.shape[:-2] + (self._num_points,))
        return flat[..., self._inv.to(dev)]


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


class SymbolSource(Block):
    """Random constellation symbol source: random bits (as
    :class:`BinarySource` draws them) mapped by :class:`Mapper`.

    Call with a shape ``[..., n]``; returns the symbols, then (if asked
    for) their indices and bits.
    """

    def __init__(self, constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, return_indices=False,
                 return_bits=False, seed=None, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision,
            device=device)
        self._num_bits_per_symbol = constellation.num_bits_per_symbol
        self._return_indices = bool(return_indices)
        self._return_bits = bool(return_bits)
        self._binary_source = BinarySource(seed=seed, precision=precision,
                                           device=device)
        self._mapper = Mapper(constellation=constellation,
                              return_indices=True, precision=precision,
                              device=device)

    def forward(self, inputs, generator=None):
        shape = [int(s) for s in torch.as_tensor(inputs).reshape(-1)]
        bit_shape = shape[:-1] + [shape[-1] * self._num_bits_per_symbol]
        b = self._binary_source(bit_shape, generator=generator)
        x, ind = self._mapper(b)
        result = (x,)
        if self._return_indices:
            result += (ind.to(torch.int32),)
        if self._return_bits:
            result += (b,)
        return result[0] if len(result) == 1 else result


class QAMSource(SymbolSource):
    """Random QAM symbol source."""

    def __init__(self, num_bits_per_symbol=None, return_indices=False,
                 return_bits=False, seed=None, precision=None, device=None):
        super().__init__(constellation_type="qam",
                         num_bits_per_symbol=num_bits_per_symbol,
                         return_indices=return_indices,
                         return_bits=return_bits, seed=seed,
                         precision=precision, device=device)


class PAMSource(SymbolSource):
    """Random PAM symbol source."""

    def __init__(self, num_bits_per_symbol=None, return_indices=False,
                 return_bits=False, seed=None, precision=None, device=None):
        super().__init__(constellation_type="pam",
                         num_bits_per_symbol=num_bits_per_symbol,
                         return_indices=return_indices,
                         return_bits=return_bits, seed=seed,
                         precision=precision, device=device)
