"""Plain reference of the 5G NR PUSCH link (configs/pusch_273prb.json)
and the readings that compare a run of the program with it.

Transmitter: CRC24A on the transport block, code blocks with CRC24B,
5G LDPC (``ldpc5g.Code``), rate matching to each block's length and bit
interleaving, scrambling with the Gold sequence of n_RNTI 2^15 + n_ID,
16-QAM, two layers, DMRS of configuration type 1 on symbols 2 and 11
(no data there: two CDM groups without data, DMRS power sqrt(2)), TPMI
precoding onto two ports. Receiver, in complex128: LS at the DMRS,
averaged over each CDM pair, linear interpolation over frequency then
time (extrapolated at the edges), or the precoded true channel (perfect
CSI); LMMSE equalization of the two streams with the estimation error
as noise; max-log demapping; layer demapping. Decoder: descrambling,
de-interleaving, the flooding BP of the stated rule (boxplus-phi runs
the tanh rule on the lifted engine), CRCs removed.

The readings are those of ``flagship_tdla``; ``decode_cw_diff`` counts
the code blocks whose share of the decoded transport block differs.
"""

import numpy as np
import torch

from . import nr, ofdm
from .compare import Gap, identity
from .ldpc5g import Code

# TS 38.211 Table 6.4.1.1.3-3, 14-symbol PUSCH of mapping type A,
# single-symbol DMRS: the DMRS symbols by dmrs-AdditionalPosition
DMRS_SYMBOLS_14 = {0: [], 1: [11], 2: [7, 11], 3: [5, 8, 11]}


class PuschReference:
    """The link of ``cfg`` under the cell's ``traffic``."""

    def __init__(self, cfg, traffic):
        car, dm = cfg["carrier"], cfg["dmrs"]
        self.f = 12 * car["n_size_grid"]
        self.t = 14
        self.layers = cfg["num_layers"]
        self.ports = cfg["num_antenna_ports"]
        self.dmrs_syms = [dm["type_a_position"]] \
            + DMRS_SYMBOLS_14[dm["additional_position"]]
        self.qm, r1024 = nr.MCS_TABLE_1[cfg["tb"]["mcs_index"]]
        self.rate = r1024 / 1024
        data_syms = self.t - len(self.dmrs_syms)
        self.ncb = self.qm * self.layers * data_syms * self.f
        self.tbs, self.k_cb, self.c, self.e = nr.tb_config(
            self.ncb, self.rate, self.qm, self.layers)
        self.code = Code(self.k_cb, max(self.e), cfg["llr_max"])
        n_id = cfg["n_cell_id"]
        self.scramble = nr.gold(self.ncb, cfg["n_rnti"] * 2 ** 15 + n_id)
        mask = np.zeros((self.t, self.f), bool)
        mask[self.dmrs_syms] = True
        self.data_pos, self.pilot_pos = ofdm.grid_positions(mask)
        grid = nr.dmrs_type1(self.f, self.t, self.dmrs_syms,
                             list(range(self.layers)), n_id)
        self.pilots = grid.reshape(self.layers, -1)[:, self.pilot_pos]
        self.w = nr.TPMI_2X2[cfg["tpmi"]].astype(np.complex128)
        scs = car["subcarrier_spacing_khz"] * 1e3
        self.freqs = ofdm.subcarrier_frequencies(self.f, scs)
        # N0 from Eb/N0 with the grid's overheads, per stream
        cp_s = (144 * 64 * 2.0 ** -1 + 16 * 64) / (480e3 * 4096)
        cp = int(np.ceil(cp_s * self.f * scs))
        n_data = len(self.data_pos)
        es = self.t * (1 + cp / self.f) * self.f / n_data / self.layers
        ebno = 10 ** (traffic["ebno_db"] / 10)
        self.no = es / (ebno * self.rate * self.qm)
        self.perfect = traffic["receiver"] == "perfect_csi"
        self.num_iter = cfg["receiver"]["decoder"]["num_iter"]
        self._lin = self._lin_weights()

    # the chain ----------------------------------------------------------
    def transmit(self, b, q=identity):
        """[B, ports, T * F] complex128 grid of transport blocks ``b``."""
        bsz, dev = b.shape[0], b.device
        a = nr.crc_attach(b.to(torch.int64), "CRC24A")
        blocks = a.reshape(bsz * self.c, -1)
        if self.c > 1:
            blocks = nr.crc_attach(blocks, "CRC24B")
        cw = self.code.rate_match(self.code.encode(blocks))
        cw = cw.reshape(bsz, self.c, -1)
        bits = torch.cat([cw[:, r, :e][:, torch.as_tensor(
            nr.bit_interleave(e, self.qm), device=dev)]
            for r, e in enumerate(self.e)], 1)
        bits = (bits + torch.as_tensor(self.scramble, device=dev)) % 2
        sym = ofdm.map_bits(bits, self.qm, torch.complex128)
        lay = nr.layer_map(sym, self.layers)
        grid = torch.zeros((bsz, self.layers, self.t * self.f),
                           dtype=torch.complex128, device=dev)
        grid[:, :, self.data_pos] = q(lay)
        grid[:, :, self.pilot_pos] = q(torch.as_tensor(self.pilots,
                                                       device=dev))
        w = q(torch.as_tensor(self.w, device=dev))
        return q(torch.einsum("pl,blr->bpr", w, grid))

    def channel(self, a, tau, q=identity):
        """[B, rx_ant, tx_ant, T * F] complex128 response of the draws."""
        h = ofdm.ofdm_channel(a.to(torch.complex128), tau.to(torch.float64),
                              self.freqs, q=q)
        h = h[:, 0, :, 0]                        # [B, rxa, txa, T, F]
        return h.reshape(h.shape[:3] + (-1,))

    def _lin_weights(self):
        """Frequency then time linear interpolation of the pilots of each
        stream: (left, right, weight) index maps into the pilot axis."""
        out = []
        ps = np.asarray(sorted(self.dmrs_syms))
        for s in range(self.layers):
            valid = np.abs(self.pilots[s]) != 0
            sym = self.pilot_pos // self.f
            sc = self.pilot_pos % self.f
            fl, fr, fw = {}, {}, {}
            for l in ps:
                idx = np.nonzero(valid & (sym == l))[0]
                js = sc[idx]
                order = np.argsort(js)
                js, idx = js[order], idx[order]
                j = np.arange(self.f)
                r = np.clip(np.searchsorted(js, j), 1, len(js) - 1)
                lft = r - 1
                wgt = (j - js[lft]) / (js[r] - js[lft])
                fl[l], fr[l], fw[l] = idx[lft], idx[r], wgt
            t = np.arange(self.t)
            r = np.clip(np.searchsorted(ps, t), 1, len(ps) - 1)
            lft = r - 1
            wt = (t - ps[lft]) / (ps[r] - ps[lft])
            out.append((ps[lft], ps[r], wt, fl, fr, fw))
        return out

    def _interp(self, x, s):
        """[..., P] pilot values of stream s -> [..., T * F]."""
        pl, pr, wt, fl, fr, fw = self._lin[s]
        per_sym = {}
        for l in fl:
            w = torch.as_tensor(fw[l], device=x.device)
            per_sym[l] = (1 - w) * x[..., fl[l]] + w * x[..., fr[l]]
        rows = []
        for t in range(self.t):
            w = float(wt[t])
            rows.append((1 - w) * per_sym[pl[t]] + w * per_sym[pr[t]])
        return torch.stack(rows, -2).reshape(x.shape[:-1] + (-1,))

    def estimate(self, y, q=identity):
        """LS at the DMRS, CDM-pair averaging, linear interpolation:
        (h_hat [B, rxa, layers, T * F], err_var [layers, T * F])."""
        hs, evs = [], []
        for s in range(self.layers):
            p = torch.as_tensor(self.pilots[s], device=y.device)
            nz = torch.abs(p) > 0
            yp = y[..., self.pilot_pos]
            h_ls = torch.where(nz, yp / torch.where(nz, p, 1), 0)
            ev = torch.where(nz, self.no / torch.abs(p) ** 2, 0)
            g = h_ls.reshape(h_ls.shape[:-1] + (-1, 4))
            avg = (g.sum(-1, keepdim=True) / 2).expand(g.shape)
            h_ls = q(torch.where(g != 0, avg, 0).reshape(h_ls.shape))
            hs.append(q(self._interp(h_ls, s)))
            evs.append(q(self._interp((ev / 2).to(torch.complex128), s)
                         .real.clamp_min(0)))
        return torch.stack(hs, 2), torch.stack(evs)

    def detect(self, y, h, err_var, q=identity):
        """LMMSE (the estimation error as noise) and max-log demapping of
        the data REs, layer-demapped: [B, ncb] logit LLRs."""
        d = self.data_pos
        hd = h[..., d].permute(0, 3, 1, 2)                # [B, N, rxa, L]
        yd = y[..., d].permute(0, 2, 1)[..., None]        # [B, N, rxa, 1]
        s2 = (self.no + err_var[:, d].sum(0))[None, :, None, None]
        hw, yw = hd / torch.sqrt(s2), yd / torch.sqrt(s2)
        hh = hw.conj().transpose(-1, -2)
        a = hh @ hw + torch.eye(self.layers, dtype=hw.dtype,
                                device=hw.device)
        g = torch.linalg.solve(a, hh)                     # [B, N, L, rxa]
        dg = torch.diagonal(g @ hw, dim1=-2, dim2=-1)     # [B, N, L]
        x_hat = q((g @ yw)[..., 0] / dg)
        no_eff = q((1 / dg - 1).real)
        pts = torch.as_tensor(ofdm.qam_points(self.qm), device=y.device)
        lab = torch.as_tensor(ofdm.bit_labels(self.qm), device=y.device)
        dist = q(-torch.abs(x_hat[..., None] - q(pts)) ** 2
                 / no_eff[..., None])                     # [B, N, L, M]
        ninf = torch.tensor(-float("inf"), dtype=dist.dtype,
                            device=dist.device)
        one = lab.T == 1                                  # [m, M]
        l1 = torch.where(one, dist[..., None, :], ninf).amax(-1)
        l0 = torch.where(one, ninf, dist[..., None, :]).amax(-1)
        llr = q(l1 - l0)                                  # [B, N, L, m]
        return llr.reshape(llr.shape[0], -1)

    def receive(self, y, h=None, q=identity):
        """[B, ncb] logit LLRs of a received grid [B, rxa, T * F]; ``h``
        [B, rxa, txa, T * F] for perfect CSI."""
        if self.perfect:
            w = q(torch.as_tensor(self.w, device=y.device))
            h_eff = q(torch.einsum("brpx,pl->brlx", h, w))
            err = torch.zeros((self.layers, h.shape[-1]), dtype=torch.float64,
                              device=y.device)
        else:
            h_eff, err = self.estimate(y, q)
        return self.detect(y, h_eff, err, q)

    def decode(self, llr, dtype=torch.float32):
        """Transport blocks [B, tbs] (int64) from logit LLRs [B, ncb]."""
        bsz, dev = llr.shape[0], llr.device
        sgn = 1 - 2 * torch.as_tensor(self.scramble, device=dev,
                                      dtype=llr.dtype)
        llr = llr * sgn
        e_max = max(self.e)
        blocks, pos = [], 0
        for e in self.e:
            seg = llr[:, pos:pos + e]
            inv = torch.as_tensor(np.argsort(nr.bit_interleave(e, self.qm)),
                                  device=dev)
            seg = seg[:, inv]
            blocks.append(torch.nn.functional.pad(seg, (0, e_max - e)))
            pos += e
        cw = torch.stack(blocks, 1).reshape(bsz * self.c, e_max)
        ch = self.code.rate_recover(cw.to(dtype))
        u = self.code.decode_flooding(ch, self.num_iter, dtype)
        u = u.reshape(bsz, self.c, -1)
        if self.c > 1:
            u = u[..., :-24]
        return u.reshape(bsz, -1)[:, :self.tbs]

    # the comparison -----------------------------------------------------
    def _rows(self, s, sl):
        b = s["b"][sl].reshape(-1, self.tbs)
        n = b.shape[0]
        x = s["x"][sl].reshape(n, self.ports, -1).to(torch.complex128)
        h = s["h"][sl][:, 0, :, 0].reshape(n, -1, self.ports, self.t
                                           * self.f).to(torch.complex128)
        y = s["y"][sl].reshape(n, -1, self.t * self.f).to(torch.complex128)
        return b, x, h, y

    def readings(self, s, block=16):
        """The four readings of one sampled iteration ``s``."""
        gaps = {"tx_grid_gap": Gap(), "channel_gap": Gap(),
                "llr_gap": Gap()}
        diff = 0
        seg = (self.tbs + 24) // self.c
        for lo in range(0, s["b"].shape[0], block):
            sl = slice(lo, lo + block)
            b, x, h, y = self._rows(s, sl)
            x_ref = self.transmit(b)
            gaps["tx_grid_gap"].add(x, x_ref)
            h_ref = self.channel(s["a"][sl], s["tau"][sl])
            gaps["channel_gap"].add(h, h_ref)
            noise = y - torch.einsum("brpx,bpx->brx", h, x)
            y_ref = torch.einsum("brpx,bpx->brx", h_ref, x_ref) + noise
            llr = s["llr"][sl].reshape(b.shape[0], -1)
            gaps["llr_gap"].add(llr, self.receive(y_ref, h_ref))
            u = self.decode(llr)
            b_hat = s["b_hat"][sl].reshape(b.shape[0], -1).to(torch.int64)
            bad = (u != b_hat).reshape(-1, self.tbs)
            pos = torch.arange(self.tbs, device=bad.device) // seg
            diff += int(torch.zeros((bad.shape[0], self.c), dtype=torch.int64,
                                    device=bad.device)
                        .index_add_(1, pos, bad.to(torch.int64))
                        .gt(0).sum())
        out = {k: g.value for k, g in gaps.items()}
        out["decode_cw_diff"] = diff
        return out

    def control(self, s, q, dtype, block=16):
        """The reference in the program's place, rounded by ``q``, its
        decoder in ``dtype``, on the inputs of ``s``."""
        out = {k: [] for k in ("x", "h", "y", "llr", "b_hat")}
        for lo in range(0, s["b"].shape[0], block):
            sl = slice(lo, lo + block)
            b, x, h, y = self._rows(s, sl)
            xc = self.transmit(b, q)
            hc = self.channel(s["a"][sl], s["tau"][sl], q)
            noise = y - torch.einsum("brpx,bpx->brx", h, x)
            yc = q(q(torch.einsum("brpx,bpx->brx", hc, xc)) + noise)
            llr = self.receive(yc, hc, q)
            shape = s["h"][sl].shape
            out["x"].append(xc.reshape(s["x"][sl].shape))
            out["h"].append(hc.reshape(shape[0], shape[2], shape[4],
                                       *shape[5:])[:, None, :, None])
            out["y"].append(yc.reshape(s["y"][sl].shape))
            out["llr"].append(llr.reshape(s["llr"][sl].shape))
            out["b_hat"].append(self.decode(llr, dtype).reshape(
                s["b_hat"][sl].shape))
        res = dict(s)
        res.update({k: torch.cat(v) for k, v in out.items()})
        return res
