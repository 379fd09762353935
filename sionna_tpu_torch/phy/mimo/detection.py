"""MIMO detectors (counterpart of ``sionna_tpu/phy/mimo/detection.py``):
linear, maximum likelihood, K-best, expectation propagation and
MMSE-PIC. None of them has trainable parameters.

- ML enumerates all ``num_points ** K`` joint symbol vectors. Its bit and
  symbol reductions gather, for every (stream, bit) or (stream, point),
  the fixed set of joint vectors that have it (index tables made on the
  host), where the JAX package masks a one-hot ``[L, K, P]`` table: the
  same values in the max-log case, the same sets summed in another order
  in the APP case.
- K-best prunes its list with a stable sort, as XLA's TopK does (the
  lower index first among equal distances); the streams are ordered by
  a stable argsort of the column norms, as there. Its QR decomposition
  is modified Gram-Schmidt on [H | y] in elementwise tensor operations
  (a batched library QR of 10^5 small matrices runs one factorization
  at a time on the card). Its R has a positive diagonal where LAPACK's
  Householder R may have a negative one: each level's distances are the
  same up to rounding.
- EP and MMSE-PIC run their fixed iterations as a Python loop over the
  port's batched Cholesky (``utils.linalg``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..block import Block
from ..mapping import (Constellation, Demapper, LLRs2SymbolLogits, PAM2QAM,
                       SymbolDemapper, SymbolLogits2LLRs,
                       SymbolLogits2Moments, pam)
from ..utils.linalg import _adjoint, _matmul, batched_cholesky, \
    cholesky_solve
from ..utils.tensors import expand_to_rank
from .equalization import lmmse_equalizer, mf_equalizer, zf_equalizer
from .utils import (List2LLRSimple, complex2real_channel,
                    complex2real_matrix, complex2real_vector,
                    whiten_channel)

__all__ = ["LinearDetector", "MaximumLikelihoodDetector",
           "KBestDetector", "EPDetector", "MMSEPICDetector"]


def _pam_variance(n):
    """The variance of the unnormalized 2^n-PAM half of a QAM
    constellation."""
    return 1 / (2 ** (n - 2)) * np.sum(
        np.linspace(1, 2 ** n - 1, 2 ** (n - 1)) ** 2) / 2


def _qr_mgs(h, y):
    """R and Q^H y of the reduced QR decomposition H = QR of
    [..., M, S] matrices (M >= S), by modified Gram-Schmidt on the
    columns of [H | y], y [..., M]: (r [..., S, S] upper triangular
    with a real positive diagonal, y_eff [..., S])."""
    num_cols = h.shape[-1]
    cols = [h[..., j] for j in range(num_cols)] + [y]
    zero = torch.zeros_like(h[..., 0, 0])
    r = [[zero] * num_cols for _ in range(num_cols)]
    y_eff = []
    for j in range(num_cols):
        norm = torch.sqrt(torch.sum(torch.abs(cols[j]) ** 2, dim=-1))
        q = cols[j] / norm[..., None].to(h.dtype)
        r[j][j] = norm.to(h.dtype)
        for k in range(j + 1, num_cols + 1):
            r_jk = torch.sum(torch.conj(q) * cols[k], dim=-1)
            cols[k] = cols[k] - r_jk[..., None] * q
            if k < num_cols:
                r[j][k] = r_jk
            else:
                y_eff.append(r_jk)
    return (torch.stack([torch.stack(row, dim=-1) for row in r], dim=-2),
            torch.stack(y_eff, dim=-1))


class LinearDetector(Block):
    """Equalizer and per-stream demapper: ``(y, h, s)`` -> LLRs
    [..., num_streams, num_bits_per_symbol] (or symbol logits / hard
    decisions)."""

    def __init__(self, equalizer, output, demapping_method,
                 constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, hard_out=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if isinstance(equalizer, str):
            if equalizer not in ("lmmse", "zf", "mf"):
                raise ValueError("Unknown equalizer.")
            self._equalizer = {"lmmse": lmmse_equalizer,
                               "zf": zf_equalizer,
                               "mf": mf_equalizer}[equalizer]
        else:
            self._equalizer = equalizer
        if output not in ("bit", "symbol"):
            raise ValueError("Unknown output")
        if demapping_method not in ("app", "maxlog"):
            raise ValueError("Unknown demapping method")
        self._output = output
        self._hard_out = bool(hard_out)
        self._constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision, device=device)
        if output == "bit":
            self._demapper = Demapper(
                demapping_method, constellation=self._constellation,
                hard_out=hard_out, precision=precision, device=device)
        else:
            self._demapper = SymbolDemapper(
                constellation=self._constellation, hard_out=hard_out,
                precision=precision, device=device)

    def forward(self, y, h, s):
        x_hat, no_eff = self._equalizer(y, h, s, precision=self.precision)
        out = self._demapper(x_hat, no_eff)
        if self._output == "bit":
            k = self._constellation.num_bits_per_symbol
            out = out.reshape(out.shape[:-1] + (x_hat.shape[-1], k))
        return out


class MaximumLikelihoodDetector(Block):
    """Exact ML detection over all joint symbol vectors: ``(y, h, s,
    prior=None)`` -> LLRs [..., num_streams, num_bits_per_symbol] or
    symbol logits [..., num_streams, num_points] (hard decisions with
    ``hard_out``)."""

    def __init__(self, output, demapping_method, num_streams,
                 constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, hard_out=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if output not in ("bit", "symbol"):
            raise ValueError("Unknown output")
        if demapping_method not in ("app", "maxlog"):
            raise ValueError("Unknown demapping method")
        self._output = output
        self._demapping_method = demapping_method
        self._hard_out = bool(hard_out)
        self._num_streams = int(num_streams)
        self._constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision, device=device)
        num_points = self._constellation.num_points
        k = self._num_streams
        nbps = self._constellation.num_bits_per_symbol

        # all joint symbol index vectors: [L, K], the first stream slowest
        grids = np.meshgrid(*[np.arange(num_points)] * k, indexing="ij")
        vecs = np.stack([g.reshape(-1) for g in grids], axis=-1)
        # bits of each stream of each joint vector: [L, K, nbps]
        vecs_bits = (vecs[..., None] >> np.arange(nbps - 1, -1, -1)) & 1
        # the joint vectors with bit i of stream k at 1 (0): [K, nbps, L/2]
        ind1 = np.stack([[np.flatnonzero(vecs_bits[:, j, i] == 1)
                          for i in range(nbps)] for j in range(k)])
        ind0 = np.stack([[np.flatnonzero(vecs_bits[:, j, i] == 0)
                          for i in range(nbps)] for j in range(k)])
        # the joint vectors with point p at stream k: [K, P, L/P]
        ind_sym = np.stack([[np.flatnonzero(vecs[:, j] == p)
                             for p in range(num_points)] for j in range(k)])

        def buf(name, values):
            self.register_buffer(name, torch.as_tensor(
                values, dtype=torch.int64, device=self.device),
                persistent=False)

        buf("_vecs_ind", vecs)
        buf("_pm1", 2 * vecs_bits - 1)
        buf("_ind1", ind1)
        buf("_ind0", ind0)
        buf("_ind_sym", ind_sym)

    def _reduce(self, exponents, ind):
        """max (maxlog) or logsumexp (app) over the joint vectors of each
        index set: exponents [..., L], ind [K, n, m] -> [..., K, n]."""
        x = exponents[..., ind]
        if self._demapping_method == "app":
            return torch.logsumexp(x, dim=-1)
        return torch.amax(x, dim=-1)

    def forward(self, y, h, s, prior=None):
        y = torch.as_tensor(y).to(self.cdtype)
        h = torch.as_tensor(h).to(self.cdtype)
        s = torch.as_tensor(s).to(self.cdtype)
        y, h = whiten_channel(y, h, s, return_s=False)
        dev = y.device

        points = self._constellation()
        x_vecs = points[self._vecs_ind.to(dev)]           # [L, K]
        # hx: [..., M, L] = h [..., M, K] @ x^T [K, L]
        hx = torch.matmul(h, x_vecs.transpose(0, 1))
        exponents = -torch.sum(torch.abs(y[..., None] - hx) ** 2,
                               dim=-2)                    # [..., L]

        if prior is not None:
            prior = torch.as_tensor(prior).to(device=dev, dtype=self.rdtype)
            prior_e = expand_to_rank(prior, exponents.dim() + 1, axis=0)
            if self._output == "bit":
                # prior: [..., K, nbps] LLRs -> log Pr(x)
                lp = F.logsigmoid(prior_e[..., None, :, :]
                                  * self._pm1.to(dev))
                exponents = exponents + torch.sum(lp, dim=(-2, -1))
            else:
                # prior: [..., K, num_points] logits; the raw
                # (unnormalized) logits are added, as in the JAX package
                k_ind = torch.arange(self._num_streams, device=dev)
                sel = prior_e[..., k_ind, self._vecs_ind.to(dev)]
                exponents = exponents + torch.sum(sel, dim=-1)

        if self._output == "symbol":
            logits = self._reduce(exponents, self._ind_sym.to(dev))
            if self._hard_out:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            return logits

        llr = (self._reduce(exponents, self._ind1.to(dev))
               - self._reduce(exponents, self._ind0.to(dev)))
        if self._hard_out:
            return (llr > 0).to(self.rdtype)
        return llr


class KBestDetector(Block):
    """K-best tree-search detector: whitens the channel, optionally
    takes the real-valued representation, orders the streams by
    increasing column norm, QR-decomposes and keeps the ``k`` best
    partial paths per level. ``(y, h, s)`` -> LLRs [..., num_streams,
    num_bits_per_symbol] through ``list2llr``, or hard symbol indices."""

    def __init__(self, output, num_streams, k, constellation_type=None,
                 num_bits_per_symbol=None, constellation=None,
                 hard_out=False, use_real_rep=False, list2llr=None,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if output not in ("bit", "symbol"):
            raise ValueError("Unknown output")
        self._output = output
        self._hard_out = bool(hard_out)
        self._use_real_rep = bool(use_real_rep)
        self._constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision, device=device)
        nbps = self._constellation.num_bits_per_symbol

        if self._use_real_rep:
            if self._constellation.constellation_type != "qam":
                raise ValueError(
                    "The real-valued representation is only supported "
                    "for QAM constellations")
            self._num_streams = 2 * int(num_streams)
            self._nbps_search = nbps // 2
            # the PAM half, normalized like the parent QAM constellation
            points = np.real(pam(nbps // 2, normalize=False)).astype(
                self.np_rdtype) / np.sqrt(_pam_variance(nbps // 2))
            self.register_buffer("_points_search", torch.as_tensor(
                points.astype(self.np_rdtype), device=self.device),
                persistent=False)
            self._pam2qam = PAM2QAM(nbps)
        else:
            self._num_streams = int(num_streams)
            self._nbps_search = nbps
            self._points_search = None  # the complex points at call time
        self._num_points_search = 2 ** self._nbps_search
        self._k = int(min(k, self._num_points_search
                          ** min(self._num_streams, 5)))

        if output == "bit":
            if list2llr is None:
                list2llr = List2LLRSimple(nbps, precision=precision,
                                          device=device)
            self._list2llr = list2llr
        else:
            self._list2llr = None

    @property
    def k(self):
        return self._k

    def _search(self, y, r, points):
        """Runs the K-best search.

        y: [..., S] (real or complex), r: [..., S, S] upper triangular,
        points: [P] candidates. Returns (dists [..., K], path_inds
        [..., K, S], path_syms [..., K, S]), the paths in increasing
        distance, equal distances in the order XLA's TopK gives them."""
        p = self._num_points_search
        batch_shape = y.shape[:-1]
        dev = y.device

        dists = torch.zeros(batch_shape + (1,), dtype=self.rdtype,
                            device=dev)
        path_inds = torch.zeros(batch_shape + (1, 0), dtype=torch.int64,
                                device=dev)
        path_syms = torch.zeros(batch_shape + (1, 0), dtype=points.dtype,
                                device=dev)
        for level in range(self._num_streams - 1, -1, -1):
            num_paths = path_inds.shape[-2]
            # interference of the streams already detected
            if path_syms.shape[-1] > 0:
                r_row = r[..., level, level + 1:]
                interf = torch.sum(r_row[..., None, :] * path_syms, dim=-1)
            else:
                interf = torch.zeros(batch_shape + (num_paths,),
                                     dtype=points.dtype, device=dev)
            y_l = y[..., level, None, None]
            r_ll = r[..., level, level, None, None]
            # distances of all (path, point) extensions: [..., paths, P]
            e = y_l - interf[..., None] - r_ll * points
            d_new = dists[..., None] + torch.abs(e) ** 2
            d_flat = d_new.reshape(batch_shape + (num_paths * p,))
            keep = min(self._k, num_paths * p)
            dists, top_idx = torch.sort(d_flat, dim=-1, stable=True)
            dists, top_idx = dists[..., :keep], top_idx[..., :keep]
            parent = top_idx // p
            point_idx = top_idx % p
            # the parent paths with the new symbol in front
            idx = parent[..., None].expand(parent.shape
                                           + (path_inds.shape[-1],))
            path_inds = torch.cat([point_idx[..., None],
                                   torch.gather(path_inds, -2, idx)], dim=-1)
            path_syms = torch.cat([points[point_idx][..., None],
                                   torch.gather(path_syms, -2, idx)], dim=-1)
        return dists, path_inds, path_syms

    def forward(self, y, h, s):
        y = torch.as_tensor(y).to(self.cdtype)
        h = torch.as_tensor(h).to(self.cdtype)
        s = torch.as_tensor(s).to(self.cdtype)
        y, h = whiten_channel(y, h, s, return_s=False)

        if self._use_real_rep:
            # the real noise has covariance I/2: rescale to unit. The
            # JAX package scales by a NumPy float64, which promotes the
            # search to float64: so does the port
            y = complex2real_vector(y).to(torch.float64) * np.sqrt(2.)
            h = complex2real_matrix(h).to(torch.float64) * np.sqrt(2.)
            points = self._points_search.to(y.device, torch.float64)
        else:
            points = self._constellation()

        # streams by increasing column norm: the strongest is detected
        # first (the last QR level)
        col_norms = torch.sum(torch.abs(h) ** 2, dim=-2)
        order = torch.argsort(col_norms, dim=-1, stable=True)
        h_sorted = torch.gather(h, -1, order[..., None, :].expand(h.shape))

        r, y_eff = _qr_mgs(h_sorted, y)
        if self._use_real_rep:
            y_eff, r = y_eff.real, r.real

        dists, path_inds, _ = self._search(y_eff, r, points)

        # back to the streams' order: entry j of a path is sorted
        # stream j
        inv_order = torch.argsort(order, dim=-1, stable=True)
        half = self._num_streams // 2
        if self._output == "symbol":
            if not self._hard_out:
                raise NotImplementedError(
                    "Soft symbol output requires hard_out=True for "
                    "KBestDetector")
            best = torch.gather(path_inds[..., 0, :], -1, inv_order)
            if self._use_real_rep:
                best = self._pam2qam(best[..., :half], best[..., half:])
            return best

        pi = torch.gather(path_inds, -1,
                          inv_order[..., None, :].expand(path_inds.shape))
        if self._use_real_rep:
            # PAM pairs into QAM indices, per path
            pi = self._pam2qam(pi[..., :half], pi[..., half:])
        return self._list2llr(None, None, dists, pi, None)


class EPDetector(Block):
    """Expectation-propagation detector on the real-valued channel with
    PAM half-constellations: ``l`` iterations with damping ``beta``.
    ``(y, h, s)`` -> LLRs [..., num_streams, num_bits_per_symbol] (or
    QAM logits / hard indices)."""

    def __init__(self, output, num_bits_per_symbol, hard_out=False,
                 l=10, beta=0.9, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if output not in ("bit", "symbol"):
            raise ValueError("Unknown output")
        self._output = output
        self._hard_out = bool(hard_out)
        if not 1 <= l:
            raise ValueError("l must be >= 1")
        if not 0 < beta <= 1:
            raise ValueError("beta must be in (0, 1]")
        self._l = int(l)
        self._beta = float(beta)
        self._num_bits_per_symbol = int(num_bits_per_symbol)
        nbps_pam = self._num_bits_per_symbol // 2
        # the normalized PAM half-constellation (QAM's scaling)
        p = np.real(pam(nbps_pam, normalize=False))
        pam_points = (p / np.sqrt(_pam_variance(nbps_pam) * 2)).astype(
            self.np_rdtype)
        self.register_buffer("_pam_points", torch.as_tensor(
            pam_points, device=self.device), persistent=False)
        self._es = float(np.mean(pam_points ** 2))
        self._pam2qam = PAM2QAM(self._num_bits_per_symbol, hard_in_out=False)
        self._symbollogits2llrs = SymbolLogits2LLRs(
            "maxlog", self._num_bits_per_symbol, hard_out=hard_out,
            precision=precision, device=device)
        # the floor of the variances (the paragraph after Eq. (38) of
        # the EP detection paper: 1e-6 single, 1e-12 double)
        self._prec = 1e-12 if self.rdtype == torch.float64 else 1e-6

    def _moments(self, mean_cav, var_cav, points):
        """The discrete posterior's mean and variance over the PAM
        points, and its logits."""
        logits = -(mean_cav[..., None] - points) ** 2 \
            / (2 * var_cav[..., None])
        p_post = torch.softmax(logits, dim=-1)
        mu = torch.sum(p_post * points, dim=-1)
        var = torch.sum(p_post * (points - mu[..., None]) ** 2, dim=-1)
        return mu, torch.clamp_min(var, self._prec), logits

    def forward(self, y, h, s):
        y = torch.as_tensor(y).to(self.cdtype)
        h = torch.as_tensor(h).to(self.cdtype)
        s = torch.as_tensor(s).to(self.cdtype)
        y, h, s = whiten_channel(y, h, s)
        y, h, s = complex2real_channel(y, h, s)
        # after whitening and the real conversion the noise is I/2
        sigma2 = 0.5
        k2 = h.shape[-1]  # 2 * num_streams
        dev, rdtype = y.device, self.rdtype
        points = self._pam_points.to(dev)

        hth = _matmul(h.transpose(-2, -1), h) / sigma2
        hty = _matmul(h.transpose(-2, -1), y[..., None])[..., 0] / sigma2
        eye = torch.eye(k2, dtype=rdtype, device=dev)
        lam = torch.ones(y.shape[:-1] + (k2,), dtype=rdtype,
                         device=dev) / self._es
        gam = torch.zeros(y.shape[:-1] + (k2,), dtype=rdtype, device=dev)
        beta = self._beta
        for _ in range(self._l):
            a = hth + lam[..., None, :] * eye
            ainv = cholesky_solve(batched_cholesky(a), eye.expand(a.shape))
            sig_diag = torch.diagonal(ainv, dim1=-2, dim2=-1)
            mu = _matmul(ainv, (hty + gam)[..., None])[..., 0]
            # cavity: the result is floored (a negative 1/sigma - lam
            # floors to the floor, not to 1/eps)
            var_cav = torch.clamp_min(1 / (1 / sig_diag - lam), self._prec)
            mean_cav = var_cav * (mu / sig_diag - gam)
            mu_p, var_p, logits = self._moments(mean_cav, var_cav, points)
            lam_new = 1 / var_p - 1 / var_cav
            gam_new = mu_p / var_p - mean_cav / var_cav
            # only negative lambda updates are rejected
            valid = lam_new >= 0
            lam_new = torch.where(valid, lam_new, lam)
            gam_new = torch.where(valid, gam_new, gam)
            # damping: beta weights the old value
            lam = (1 - beta) * lam_new + beta * lam
            gam = (1 - beta) * gam_new + beta * gam

        # the two PAM dimensions of each stream into QAM logits
        half = k2 // 2
        logits_qam = self._pam2qam(logits[..., :half, :],
                                   logits[..., half:, :])
        if self._output == "symbol":
            if self._hard_out:
                return torch.argmax(logits_qam, dim=-1).to(torch.int32)
            return logits_qam
        return self._symbollogits2llrs(logits_qam)


class MMSEPICDetector(Block):
    """MMSE parallel-interference-cancellation detector, soft in and
    soft out: ``(y, h, s, prior=None)`` with priors as LLRs (bit output)
    or symbol logits; ``num_iter`` self-iterations, each demapping with
    the previous one's LLRs as prior; returns the extrinsic LLRs
    [..., num_streams, num_bits_per_symbol] (or symbol logits)."""

    def __init__(self, output, demapping_method="maxlog", num_iter=1,
                 constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, hard_out=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if output not in ("bit", "symbol"):
            raise ValueError("Unknown output")
        if demapping_method not in ("app", "maxlog"):
            raise ValueError("Unknown demapping method")
        self._output = output
        self._demapping_method = demapping_method
        self._num_iter = int(num_iter)
        self._hard_out = bool(hard_out)
        self._constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision, device=device)
        nbps = self._constellation.num_bits_per_symbol
        kw = dict(precision=precision, device=device)
        self._llrs2logits = LLRs2SymbolLogits(nbps, **kw)
        self._logits2moments = SymbolLogits2Moments(
            constellation=self._constellation, **kw)
        self._logits2llrs = SymbolLogits2LLRs("maxlog", nbps, hard_out=False,
                                              **kw)
        self._llrs2logits_out = LLRs2SymbolLogits(nbps, hard_out=hard_out,
                                                  **kw)
        self._bit_demapper = Demapper(demapping_method,
                                      constellation=self._constellation,
                                      **kw)
        self._epsilon = 1e-4

    def _one_iter(self, y, h, llr_a):
        """One detection round with the prior LLRs ``llr_a``."""
        x_hat, var_x = self._logits2moments(self._llrs2logits(llr_a))
        x_hat = x_hat.to(self.cdtype)
        # the residual after cancelling every soft estimate
        y_res = y - _matmul(h, x_hat[..., None])[..., 0]
        # A = H diag(var) H^H + I
        he = h * var_x[..., None, :].to(self.cdtype)
        a = _matmul(he, _adjoint(h)) + torch.eye(
            h.shape[-2], dtype=self.cdtype, device=h.device)
        ainv_h = cholesky_solve(batched_cholesky(a), h)
        # mu_k = h_k^H A^-1 h_k
        mu = torch.sum(torch.conj(h) * ainv_h, dim=-2).real
        # each stream's filter output with its own soft symbol added
        # back: z_k = h_k^H A^-1 (y_res + h_k x_hat_k)
        z = torch.sum(torch.conj(ainv_h) * y_res[..., None], dim=-2)
        z = z + mu.to(self.cdtype) * x_hat
        # unbiased: rho = mu / (1 - var mu), no_eff = 1 / rho, floored
        x_eq = z / mu.to(self.cdtype)
        no_eff = torch.clamp_min(1. - var_x * mu, self._epsilon) / mu
        llr = self._bit_demapper(x_eq, no_eff, llr_a)
        return llr.reshape(llr_a.shape)

    def forward(self, y, h, s, prior=None):
        y = torch.as_tensor(y).to(self.cdtype)
        h = torch.as_tensor(h).to(self.cdtype)
        s = torch.as_tensor(s).to(self.cdtype)
        y, h = whiten_channel(y, h, s, return_s=False)
        k = h.shape[-1]
        nbps = self._constellation.num_bits_per_symbol
        if prior is None:
            d = nbps if self._output == "bit" \
                else self._constellation.num_points
            prior = torch.zeros(y.shape[:-1] + (k, d), dtype=self.rdtype,
                                device=y.device)
        else:
            prior = torch.as_tensor(prior).to(device=y.device,
                                              dtype=self.rdtype)
        llr_d = self._logits2llrs(prior) if self._output == "symbol" \
            else prior
        llr_a = torch.zeros_like(llr_d)
        for _ in range(self._num_iter):
            llr_a = llr_d
            llr_d = self._one_iter(y, h, llr_a)

        llr_e = llr_d - llr_a
        if self._output == "symbol":
            return self._llrs2logits_out(llr_e)
        if self._hard_out:
            return (llr_e > 0).to(self.rdtype)
        return llr_e
