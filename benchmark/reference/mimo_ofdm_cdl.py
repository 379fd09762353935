"""Plain reference of the 4 x 4 MIMO-OFDM uplink over CDL-B of BASELINE
config 3 (configs/mimo_ofdm_cdl.json), the work of its min-sum decoder,
and the readings that compare a run of the program with it.

Written from the example's definitions: each of the 4 streams sends its
own 5G LDPC codeword (``ldpc5g.Code``, here BG2 Z=320) in Gray 16-QAM on
the data resource elements of a 14 x 128 grid (symbol-then-subcarrier
order), Kronecker pilots on symbols 2 and 11 (stream s on subcarriers s,
s+4, ..., zeros elsewhere on those symbols; ``ofdm.kronecker_pilots``);
the frequency response of the CDL draw (a, tau) normalized to unit mean
energy per grid over the 4 x 4 antenna pairs (``ofdm.ofdm_channel``);
LS at each stream's non-zero pilots, the estimation error variance N0 /
|p|^2 there, both interpolated linearly over frequency within each pilot
symbol and then over time (extrapolated linearly from the two nearest
pilots at the edges); the LMMSE of the 4 streams at each resource element
with the noise plus the summed error variances as S = s2 I, whitened:
G = (H_w^H H_w + I)^{-1} H_w^H, x_hat = G y_w / diag(G H_w), no_eff =
1 / diag(G H_w) - 1, all in complex128; exact APP demapping
(``ofdm.app_demap``); the flooding decoder with the min-sum check node
(``MinSumCode``), 12 iterations, in float32.

Departures from the example: the example's ``OFDMChannel`` returns y
alone; the program asks it for h as well (``return_channel=True``), the
same h it draws anyway, so that the check can compare it.

Not checked here: the CDL draw itself (the ray angles, the 38.901
element pattern, the cross-polarization of the 4 x 4 arrays). Both
sides start from the program's own (a, tau), so a wrong draw passes
every reading.

The program's run hands over, for each sampled MC iteration, its inputs
(the source bits ``b``, the CDL draws ``a`` and ``tau``, and through
``y - h x`` the noise it added) and its outputs (the grid ``x``, the
frequency response ``h``, the received grid ``y``, the decoder's input
LLRs ``llr`` and the decoded bits ``b_hat``). The readings, as for the
other configurations:

* ``tx_grid_gap``: the grid from the bits;
* ``channel_gap``: the frequency response from the draws;
* ``llr_gap``: the received grid (the reference's grid and channel plus
  the program's noise), LS "lin" estimation, LMMSE and APP demapping;
* ``decode_cw_diff``: the codewords whose decoded info bits differ from
  the program's, the min-sum decoder run on the program's own LLRs.
"""

import numpy as np
import torch

from . import ofdm
from .compare import Gap, identity
from .ldpc5g import Code

# Operations per edge and iteration of the min-sum check node, c2v =
# sign * min(least other |v2c|, llr_max), counted as ``work.py`` counts
# the tanh rule's (each arithmetic operation and comparison-select 1):
#   |v2c| 1, its sign 1, the least and the second least |v2c| of the row
#   kept by comparison-selects 3 (the least: a min; the second: a max of
#   the old least and |v2c|, then a min), the extrinsic choice (the second
#   least on the edge that holds the least, else the least) 2 (a compare
#   and a select), the clip at llr_max 1, the row's sign product and
#   applying both signs 3: 11.
CN_OPS_MINSUM = 11
# The variable node of the flooding schedule, as ``work.py`` counts it:
# the sum 1, the extrinsic difference 1, the clip 2 an edge; the
# marginal's clip 2 a variable node.
VN_OPS_FLOODING = 4
VN_MARGINAL_OPS = 2


def minsum_work(code, batch, num_iter):
    """{"flops", "bytes"} of one flooding min-sum decode of ``batch``
    codewords of ``code`` (a ``ldpc5g.Code``), ``num_iter`` iterations:
    (11 + 4) E + 2 N operations an iteration for E edges and N variable
    nodes of a codeword, no early stop; bytes as ``work.py`` counts them,
    the float32 channel LLRs in and marginals out, 8 B a variable node
    and codeword."""
    e, n = code.num_edges, code.num_vns
    per_iter = (CN_OPS_MINSUM + VN_OPS_FLOODING) * e + VN_MARGINAL_OPS * n
    return {"flops": float(num_iter * batch * per_iter),
            "bytes": float(8 * batch * n)}


class MinSumCode(Code):
    """``ldpc5g.Code`` with the min-sum check node: c2v = sign of the
    other v2c messages times the least other |v2c|, clipped at
    ``llr_max``. A minimum is exact in any precision and any order, so
    this is K1's min-sum mode op for op."""

    def _cn_update(self, v2c, pad, dt):
        """Min-sum check-node rule over [dc_max, B, num_cns] v2c messages
        (pads hold +inf: never the least, sign +1); the least other |v2c|
        of edge j is the least of the prefix and the suffix minima."""
        one = torch.ones((), dtype=dt, device=v2c.device)
        mag = torch.abs(v2c)
        sgn = torch.where(v2c < 0, -one, one)
        d = v2c.shape[0]
        none = torch.full_like(mag[0], float("inf"))
        pre = [none]
        for j in range(d - 1):
            pre.append(torch.minimum(pre[-1], mag[j]))
        suf = [none] * d
        for j in range(d - 1, 0, -1):
            suf[j - 1] = torch.minimum(suf[j], mag[j])
        sign_tot = sgn[0]
        for j in range(1, d):
            sign_tot = sign_tot * sgn[j]
        return torch.stack([
            sign_tot * sgn[j] * torch.clamp(torch.minimum(pre[j], suf[j]),
                                            max=self.llr_max)
            for j in range(d)])


def _lerp(x, xs):
    """(left, right, weight) of the linear interpolation of the points
    ``x`` among the sorted positions ``xs``, from the two nearest outside
    their span (extrapolation): value = (1 - w) v[left] + w v[right]."""
    r = np.clip(np.searchsorted(xs, x), 1, len(xs) - 1)
    left = r - 1
    return left, r, (x - xs[left]) / (xs[r] - xs[left])


class MimoOfdmCdlReference:
    """The link of ``cfg`` (configs/mimo_ofdm_cdl.json) under the cell's
    ``traffic`` (its Eb/No)."""

    def __init__(self, cfg, traffic):
        rg = cfg["resource_grid"]
        self.t, self.f = rg["num_ofdm_symbols"], rg["fft_size"]
        self.s = rg["num_streams_per_tx"]
        self.pilot_syms = list(rg["pilot_ofdm_symbol_indices"])
        mask, self.pilots = ofdm.kronecker_pilots(
            self.s, self.t, self.f, self.pilot_syms, rg["pilot_seed"])
        self.data_pos, self.pilot_pos = ofdm.grid_positions(mask[0])
        self.m = cfg["num_bits_per_symbol"]
        self.code = MinSumCode(cfg["code"]["k"], cfg["code"]["n"],
                               cfg["llr_max"])
        self.k, self.n = self.code.k, self.code.n
        self.freqs = ofdm.subcarrier_frequencies(
            self.f, rg["subcarrier_spacing_hz"])
        # N0 from Eb/N0 with the grid's overheads, per stream
        cp = rg["cyclic_prefix_length"] / self.f
        es = self.t * (1 + cp) * self.f / len(self.data_pos) / self.s
        ebno = 10 ** (traffic["ebno_db"] / 10)
        self.no = es / (ebno * cfg["coderate"] * self.m)
        self.num_iter = cfg["receiver"]["decoder"]["num_iter"]
        self._lin = [self._lin_taps(s) for s in range(self.s)]

    # the chain ----------------------------------------------------------
    def transmit(self, b, q=identity):
        """[B, S, T * F] complex128 grid of info bits ``b`` [B, 1, S, k]."""
        bsz = b.shape[0]
        bits = self.code.rate_match(self.code.encode(b.reshape(-1, self.k)))
        sym = q(ofdm.map_bits(bits, self.m, torch.complex128))
        grid = torch.zeros((bsz, self.s, self.t * self.f),
                           dtype=torch.complex128, device=b.device)
        grid[:, :, self.data_pos] = sym.reshape(bsz, self.s, -1)
        grid[:, :, self.pilot_pos] = q(torch.as_tensor(self.pilots,
                                                       device=b.device))
        return grid

    def channel(self, a, tau, q=identity):
        """[B, rx_ant, tx_ant, T * F] complex128 response of the draws."""
        h = ofdm.ofdm_channel(a.to(torch.complex128), tau.to(torch.float64),
                              self.freqs, q=q)
        h = h[:, 0, :, 0]                        # [B, rxa, txa, T, F]
        return h.reshape(h.shape[:3] + (-1,))

    def _lin_taps(self, s):
        """Stream s's linear interpolation: per pilot symbol, (left,
        right, weight) into its non-zero pilots (indices into the pilot
        axis) for every subcarrier; and (left, right, weight) over the
        pilot symbols for every symbol."""
        valid = np.abs(self.pilots[s]) != 0
        sym = self.pilot_pos // self.f
        sc = self.pilot_pos % self.f
        freq = {}
        for l in self.pilot_syms:
            idx = np.nonzero(valid & (sym == l))[0]
            idx = idx[np.argsort(sc[idx])]
            left, right, w = _lerp(np.arange(self.f), sc[idx])
            freq[l] = (idx[left], idx[right], w)
        ps = np.asarray(sorted(self.pilot_syms))
        left, right, w = _lerp(np.arange(self.t), ps)
        return freq, (ps[left], ps[right], w)

    def _interp(self, x, s):
        """[..., P] pilot values of stream s -> [..., T * F]."""
        freq, (pl, pr, wt) = self._lin[s]
        per_sym = {}
        for l, (fl, fr, fw) in freq.items():
            w = torch.as_tensor(fw, device=x.device)
            per_sym[l] = (1 - w) * x[..., fl] + w * x[..., fr]
        rows = [(1 - float(wt[t])) * per_sym[pl[t]]
                + float(wt[t]) * per_sym[pr[t]] for t in range(self.t)]
        return torch.stack(rows, -2).reshape(x.shape[:-1] + (-1,))

    def estimate(self, y, q=identity):
        """LS at the pilots and linear interpolation: (h_hat [B, rxa, S,
        T * F], err_var [S, T * F])."""
        yp = y[..., self.pilot_pos]
        hs, evs = [], []
        for s in range(self.s):
            p = q(torch.as_tensor(self.pilots[s], device=y.device))
            nz = torch.abs(p) > 0
            h_ls = q(torch.where(nz, yp / torch.where(nz, p, 1), 0))
            ev = torch.where(nz, self.no / torch.abs(p) ** 2, 0)
            hs.append(q(self._interp(h_ls, s)))
            evs.append(q(self._interp(ev, s).clamp_min(0)))
        return torch.stack(hs, 2), torch.stack(evs)

    def detect(self, y, h, err_var, q=identity):
        """Whitened LMMSE of the S streams at each data RE with S = (N0 +
        the summed error variances) I, and APP demapping: [B, S, n] logit
        LLRs."""
        d = self.data_pos
        hd = h[..., d].permute(0, 3, 1, 2)                # [B, N, rxa, S]
        yd = y[..., d].permute(0, 2, 1)[..., None]        # [B, N, rxa, 1]
        s2 = (self.no + err_var[:, d].sum(0))[None, :, None, None]
        hw, yw = q(hd / torch.sqrt(s2)), q(yd / torch.sqrt(s2))
        hh = hw.conj().transpose(-1, -2)
        a = q(q(hh @ hw) + torch.eye(self.s, dtype=hw.dtype,
                                     device=hw.device))
        g = q(torch.linalg.solve(a, hh))                  # [B, N, S, rxa]
        dg = q(torch.diagonal(g @ hw, dim1=-2, dim2=-1))  # [B, N, S]
        x_hat = q(q((g @ yw)[..., 0]) / dg)
        no_eff = q((1 / dg - 1).real)
        return ofdm.app_demap(x_hat.transpose(1, 2), no_eff.transpose(1, 2),
                              self.m, q=q)

    def receive(self, y, q=identity):
        """[B, S, n] logit LLRs of a received grid [B, rxa, T * F]."""
        h_hat, err_var = self.estimate(y, q)
        return self.detect(y, h_hat, err_var, q)

    def decode(self, llr, dtype=torch.float32):
        """Info bits [B * S, k] decoded from logit LLRs [..., n]."""
        ch = self.code.rate_recover(llr.reshape(-1, self.n).to(dtype))
        return self.code.decode_flooding(ch, self.num_iter, dtype)

    # the comparison -----------------------------------------------------
    def _rows(self, s, sl):
        b = s["b"][sl]
        n = b.shape[0]
        c128 = torch.complex128
        x = s["x"][sl].reshape(n, self.s, -1).to(c128)
        h = s["h"][sl][:, 0, :, 0].reshape(n, -1, self.s, self.t * self.f)
        y = s["y"][sl].reshape(n, -1, self.t * self.f).to(c128)
        return b, x, h.to(c128), y

    @staticmethod
    def _through(h, x):
        """[B, rxa, T * F]: the grid x [B, txa, T * F] through h."""
        return torch.einsum("brpx,bpx->brx", h, x)

    def readings(self, s, block=32):
        """The four readings of one sampled iteration ``s`` (a dict of the
        program's tensors), in blocks of ``block`` grids."""
        gaps = {"tx_grid_gap": Gap(), "channel_gap": Gap(),
                "llr_gap": Gap()}
        diff = 0
        for lo in range(0, s["b"].shape[0], block):
            sl = slice(lo, lo + block)
            b, x, h, y = self._rows(s, sl)
            x_ref = self.transmit(b)
            gaps["tx_grid_gap"].add(x, x_ref)
            h_ref = self.channel(s["a"][sl], s["tau"][sl])
            gaps["channel_gap"].add(h, h_ref)
            y_ref = self._through(h_ref, x_ref) + (y - self._through(h, x))
            llr = s["llr"][sl].reshape(b.shape[0], self.s, -1)
            gaps["llr_gap"].add(llr, self.receive(y_ref))
            b_ref = self.decode(llr)
            b_hat = s["b_hat"][sl].reshape(b_ref.shape).to(torch.int64)
            diff += int((b_ref != b_hat).any(1).sum())
        out = {k: g.value for k, g in gaps.items()}
        out["decode_cw_diff"] = diff
        return out

    def control(self, s, q, dtype, block=32):
        """The reference in the program's place, rounded by ``q`` and
        decoding in ``dtype``: a sample of its outputs on the inputs of
        ``s`` (the same bits, draws and noise)."""
        out = {k: [] for k in ("x", "h", "y", "llr", "b_hat")}
        for lo in range(0, s["b"].shape[0], block):
            sl = slice(lo, lo + block)
            b, x, h, y = self._rows(s, sl)
            xc = self.transmit(b, q)
            hc = self.channel(s["a"][sl], s["tau"][sl], q)
            yc = q(q(self._through(hc, xc)) + (y - self._through(h, x)))
            llr = self.receive(yc, q)
            out["x"].append(xc.reshape(s["x"][sl].shape))
            out["h"].append(hc.reshape(s["h"][sl].shape))
            out["y"].append(yc.reshape(s["y"][sl].shape))
            out["llr"].append(llr.reshape(s["llr"][sl].shape))
            out["b_hat"].append(self.decode(llr, dtype).reshape(
                s["b_hat"][sl].shape))
        res = dict(s)
        res.update({k: torch.cat(v) for k, v in out.items()})
        return res
