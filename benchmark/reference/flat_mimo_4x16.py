"""Plain reference of the coded MIMO link over spatially correlated flat
fading (configs/flat_mimo_4x16.json), and the readings that compare a
run of the program with it.

Written from the tutorial's definitions: each of the 4 transmit antennas
sends its own 5G LDPC codeword (``ldpc5g.Code``, here BG2 Z=64) in Gray
16-QAM (``ofdm.map_bits``); the symbols [B, 4, n / m] are read as
[B * n / m, 4] channel uses, row-major; the channel is an i.i.d.
Rayleigh draw H [.., 16, 4] correlated as R_rx^{1/2} H R_tx^{1/2} with
exponential correlation matrices R[i, j] = a^|i-j| and their square
roots by a float64 eigendecomposition; the receiver whitens with the
Cholesky factor of S = N0 I_16, applies the LMMSE filter
G = (H^H H + I)^{-1} H^H of the whitened channel, scales by
diag(G H)^{-1} (effective noise 1 / diag(G H) - 1), and demaps exactly
(``ofdm.app_demap``); the decoder is the flooding BP of ``ldpc5g``.

The program's run hands over, for each sampled MC iteration, its inputs
(the source bits ``b``, the uncorrelated draw ``h_iid``) and its
outputs (the symbols ``x``, the correlated channel ``h``, the received
signal ``y``, the decoder's input LLRs ``llr`` and the decoded bits
``b_hat``). The readings, as for the other configurations:

* ``tx_grid_gap``: the symbols from the bits;
* ``channel_gap``: the correlated channel from the draw;
* ``llr_gap``: whitening, LMMSE and APP demapping in complex128 of the
  program's ``y`` and ``h``, with N0 from Eb/N0;
* ``decode_cw_diff``: the codewords whose decoded info bits differ
  from the program's, the reference decoder (float32) run on the
  program's own LLRs.
"""

import numpy as np
import torch

from . import ofdm
from .compare import Gap, identity
from .ldpc5g import Code


def exp_corr(a, n):
    """[n, n] float64 exponential correlation matrix a^|i-j| of a real
    coefficient ``a``."""
    i = np.arange(n)
    return float(a) ** np.abs(i[:, None] - i[None, :]).astype(np.float64)


def sqrtm_psd(r):
    """Square root of a symmetric positive semi-definite matrix by its
    float64 eigendecomposition (negative eigenvalues clipped to 0)."""
    w, v = np.linalg.eigh(np.asarray(r, np.float64))
    return (v * np.sqrt(np.maximum(w, 0))) @ v.T


def correlate(h_iid, r_tx_sqrt, r_rx_sqrt, q=identity):
    """R_rx^{1/2} H R_tx^{1/2} of draws ``h_iid`` [..., num_rx, num_tx],
    in ``h_iid``'s dtype."""
    rx = q(torch.as_tensor(r_rx_sqrt, device=h_iid.device).to(h_iid.dtype))
    tx = q(torch.as_tensor(r_tx_sqrt, device=h_iid.device).to(h_iid.dtype))
    return q(q(rx @ h_iid) @ tx)


def whitened_lmmse(y, h, no, q=identity):
    """(x_hat, no_eff) [..., num_tx] of received vectors ``y`` [...,
    num_rx] through channels ``h`` [..., num_rx, num_tx] with noise
    covariance S = ``no`` I: whitening by the Cholesky factor L of S
    (S = L L^H), then G = (H_w^H H_w + I)^{-1} H_w^H, x_hat =
    G y_w / diag(G H_w) and no_eff = 1 / diag(G H_w) - 1."""
    m, k = h.shape[-2], h.shape[-1]
    eye_rx = torch.eye(m, dtype=h.dtype, device=h.device)
    chol = torch.linalg.cholesky(q(no * eye_rx))
    yw = q(torch.linalg.solve_triangular(chol, y[..., None], upper=False))
    hw = q(torch.linalg.solve_triangular(chol, h, upper=False))
    hh = hw.conj().transpose(-1, -2)
    a = q(q(hh @ hw) + torch.eye(k, dtype=h.dtype, device=h.device))
    g = q(torch.linalg.solve(a, hh))
    d = q(torch.diagonal(g @ hw, dim1=-2, dim2=-1))
    x_hat = q(q((g @ yw)[..., 0]) / d)
    no_eff = q((1 / d - 1).real)
    return x_hat, no_eff


class FlatMimoReference:
    """The link of ``cfg`` (configs/flat_mimo_4x16.json) under the
    cell's ``traffic`` (its Eb/No)."""

    def __init__(self, cfg, traffic):
        self.m = cfg["num_bits_per_symbol"]
        self.num_tx, self.num_rx = cfg["num_tx_ant"], cfg["num_rx_ant"]
        code = cfg["code"]
        self.code = Code(code["k"], code["n"], code["llr_max"])
        self.k, self.n = self.code.k, self.code.n
        self.sym = self.n // self.m
        ch = cfg["channel"]
        self.r_tx_sqrt = sqrtm_psd(exp_corr(ch["tx_exp_corr"], self.num_tx))
        self.r_rx_sqrt = sqrtm_psd(exp_corr(ch["rx_exp_corr"], self.num_rx))
        # N0 per receive antenna: Eb/N0 at the code rate and the
        # constellation, times sqrt(num_rx) as the tutorial sets it
        ebno = 10 ** (traffic["ebno_db"] / 10)
        self.no = np.sqrt(self.num_rx) / (ebno * self.k / self.n * self.m)
        self.num_iter = cfg["receiver"]["decoder"]["num_iter"]

    # the chain ----------------------------------------------------------
    def transmit(self, b, q=identity):
        """[B, num_tx, n / m] complex128 symbols of info bits ``b``
        [B, num_tx, k]."""
        bits = self.code.rate_match(self.code.encode(b.reshape(-1, self.k)))
        sym = q(ofdm.map_bits(bits, self.m, torch.complex128))
        return sym.reshape(b.shape[0], self.num_tx, self.sym)

    def uses(self, x):
        """[B * n / m, num_tx] channel uses of symbols [B, num_tx, n / m]
        (the tutorial's reshape)."""
        return x.reshape(-1, self.num_tx)

    def channel(self, h_iid, q=identity):
        """[uses, num_rx, num_tx] complex128 correlated channel."""
        return correlate(h_iid.to(torch.complex128), self.r_tx_sqrt,
                         self.r_rx_sqrt, q)

    def receive(self, y, h, q=identity):
        """[B, num_tx, n] logit LLRs of received vectors ``y`` [uses,
        num_rx] through ``h`` [uses, num_rx, num_tx] (complex128)."""
        x_hat, no_eff = whitened_lmmse(y, h, self.no, q)
        shape = (-1, self.num_tx, self.sym)
        return ofdm.app_demap(x_hat.reshape(shape), no_eff.reshape(shape),
                              self.m, q=q)

    def decode(self, llr, dtype=torch.float32):
        """Info bits [B * num_tx, k] decoded from logit LLRs [..., n]."""
        ch = self.code.rate_recover(llr.reshape(-1, self.n).to(dtype))
        return self.code.decode_flooding(ch, self.num_iter, dtype)

    # the comparison -----------------------------------------------------
    def _rows(self, s, sl):
        """The sample's tensors of the batch elements ``sl``: b, x
        (complex128), and the draw, h and y of their channel uses."""
        uses = slice(sl.start * self.sym, sl.stop * self.sym)
        c128 = torch.complex128
        return (s["b"][sl], s["x"][sl].to(c128), s["h_iid"][uses],
                s["h"][uses].to(c128), s["y"][uses].to(c128))

    def readings(self, s, block=512):
        """The four readings of one sampled iteration ``s`` (a dict of the
        program's tensors), in blocks of ``block`` batch elements."""
        gaps = {"tx_grid_gap": Gap(), "channel_gap": Gap(),
                "llr_gap": Gap()}
        diff = 0
        batch = s["b"].shape[0]
        for lo in range(0, batch, block):
            sl = slice(lo, min(lo + block, batch))
            b, x, h_iid, h, y = self._rows(s, sl)
            gaps["tx_grid_gap"].add(x, self.transmit(b))
            gaps["channel_gap"].add(h, self.channel(h_iid))
            llr = s["llr"][sl]
            gaps["llr_gap"].add(llr, self.receive(y, h))
            b_ref = self.decode(llr)
            b_hat = s["b_hat"][sl].reshape(b_ref.shape).to(torch.int64)
            diff += int((b_ref != b_hat).any(1).sum())
        out = {k: g.value for k, g in gaps.items()}
        out["decode_cw_diff"] = diff
        return out

    def control(self, s, q, dtype, block=512):
        """The reference in the program's place, rounded by ``q`` and
        decoding in ``dtype``: a sample of its outputs on the inputs of
        ``s`` (the same bits, draw and noise)."""
        out = {k: [] for k in ("x", "h", "y", "llr", "b_hat")}
        batch = s["b"].shape[0]
        for lo in range(0, batch, block):
            sl = slice(lo, min(lo + block, batch))
            b, x, h_iid, h, y = self._rows(s, sl)
            xc = self.transmit(b, q)
            hc = self.channel(h_iid, q)
            noise = y - (h @ self.uses(x)[..., None])[..., 0]
            yc = q(q((hc @ self.uses(xc)[..., None])[..., 0]) + noise)
            llr = self.receive(yc, hc, q)
            out["x"].append(xc)
            out["h"].append(hc)
            out["y"].append(yc)
            out["llr"].append(llr)
            out["b_hat"].append(self.decode(llr, dtype).reshape(
                s["b_hat"][sl].shape))
        res = dict(s)
        res.update({k: torch.cat(v) for k, v in out.items()})
        return res
