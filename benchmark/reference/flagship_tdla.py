"""Plain reference of the flagship TDL-A OFDM link (configs/
flagship_tdla.json), from the bits to the decoded bits, and the readings
that compare a run of the program with it.

The program's run hands over, for each sampled MC iteration, its inputs
(the source bits ``b``, the TDL draws ``a`` and ``tau``, and through
``y - h * x`` the noise it added) and its outputs (the resource grid
``x``, the frequency response ``h``, the decoder's input LLRs ``llr`` and
the decoded bits ``b_hat``). The reference recomputes from the inputs:

* ``tx_grid_gap``: the grid from the bits (5G LDPC encoding and rate
  matching, row-column interleaving, 16-QAM, Kronecker pilots);
* ``channel_gap``: the frequency response from the draws;
* ``llr_gap``: the received grid (its own grid and channel plus the
  program's noise), LS estimation with nearest-pilot interpolation,
  LMMSE equalization, APP demapping and deinterleaving, in complex128;
* ``decode_cw_diff``: the number of codewords whose decoded info bits
  differ from the program's, the reference decoder (float32, the stated
  algorithm) run on the program's own decoder input. Belief propagation
  at the waterfall is not continuous in its input, so the decoder is
  judged on the program's LLRs; ``llr_gap`` judges those LLRs.
"""

import numpy as np
import torch

from . import ofdm
from .compare import Gap, identity
from .ldpc5g import Code


class FlagshipReference:
    """The link of ``cfg`` (configs/flagship_tdla.json) under the cell's
    ``traffic`` (its Eb/No and decoder schedule)."""

    def __init__(self, cfg, traffic):
        rg = cfg["resource_grid"]
        self.t, self.f = rg["num_ofdm_symbols"], rg["fft_size"]
        mask, pilots = ofdm.kronecker_pilots(
            1, self.t, self.f, rg["pilot_ofdm_symbol_indices"],
            rg["pilot_seed"])
        self.data_pos, self.pilot_pos = ofdm.grid_positions(mask[0])
        self.nearest = ofdm.nearest_pilot(mask[0])
        self.pilots = pilots[0]
        self.m = cfg["num_bits_per_symbol"]
        code = cfg["code"]
        self.code = Code(code["k"], code["n"], code["llr_max"])
        self.k, self.n = self.code.k, self.code.n
        self.perm = ofdm.row_column_perm(self.n,
                                         cfg["interleaver"]["row_depth"])
        self.inv_perm = np.argsort(self.perm)
        self.freqs = ofdm.subcarrier_frequencies(
            self.f, rg["subcarrier_spacing_hz"])
        # N0 from Eb/N0 with the grid's overheads (cyclic prefix, pilots)
        cp = rg["cyclic_prefix_length"] / self.f
        es = self.t * (1 + cp) * self.f / len(self.data_pos)
        ebno = 10 ** (traffic["ebno_db"] / 10)
        self.no = es / (ebno * cfg["coderate"] * self.m)
        dec = traffic["decoder"]
        self.layered = dec["cn_schedule"] == "layered"
        self.num_iter = dec["num_iter"]

    # the chain ----------------------------------------------------------
    def transmit(self, b, q=identity):
        """[B, T * F] complex128 grid of info bits ``b`` [B, k]."""
        bits = self.code.rate_match(self.code.encode(b))
        bits = bits[:, torch.as_tensor(self.perm, device=b.device)]
        grid = torch.zeros((b.shape[0], self.t * self.f),
                           dtype=torch.complex128, device=b.device)
        grid[:, self.data_pos] = q(ofdm.map_bits(bits, self.m,
                                                 torch.complex128))
        grid[:, self.pilot_pos] = q(torch.as_tensor(self.pilots,
                                                    device=b.device))
        return grid

    def channel(self, a, tau, q=identity):
        """[B, T * F] complex128 response of the SISO draws."""
        h = ofdm.ofdm_channel(a.to(torch.complex128), tau.to(torch.float64),
                              self.freqs, q=q)
        return h.reshape(a.shape[0], -1)

    def receive(self, y, q=identity):
        """Deinterleaved logit-convention LLRs [B, n] of a received grid
        [B, T * F] (complex128)."""
        pil = torch.as_tensor(self.pilots, device=y.device)
        x_hat, no_eff = ofdm.ls_nn_lmmse_siso(
            y, q(pil), self.data_pos, self.pilot_pos, self.nearest,
            self.no, q=q)
        llr = ofdm.app_demap(x_hat, no_eff, self.m, q=q)
        return llr[:, torch.as_tensor(self.inv_perm, device=y.device)]

    def decode(self, llr, dtype=torch.float32):
        """Info bits [B, k] decoded from logit LLRs [B, n]."""
        ch = self.code.rate_recover(llr.to(dtype))
        if self.layered:
            return self.code.decode_layered(ch, self.num_iter, dtype)
        return self.code.decode_flooding(ch, self.num_iter, dtype)

    # the comparison -----------------------------------------------------
    def _rows(self, s, sl):
        b = s["b"][sl].reshape(-1, self.k)
        x = s["x"][sl].reshape(b.shape[0], -1).to(torch.complex128)
        h = s["h"][sl].reshape(b.shape[0], -1).to(torch.complex128)
        y = s["y"][sl].reshape(b.shape[0], -1).to(torch.complex128)
        return b, x, h, y

    def readings(self, s, block=256):
        """The four readings of one sampled iteration ``s`` (a dict of the
        program's tensors), in blocks of ``block`` codewords."""
        gaps = {"tx_grid_gap": Gap(), "channel_gap": Gap(),
                "llr_gap": Gap()}
        diff = 0
        batch = s["b"].shape[0]
        for lo in range(0, batch, block):
            sl = slice(lo, lo + block)
            b, x, h, y = self._rows(s, sl)
            x_ref = self.transmit(b)
            gaps["tx_grid_gap"].add(x, x_ref)
            h_ref = self.channel(s["a"][sl], s["tau"][sl])
            gaps["channel_gap"].add(h, h_ref)
            y_ref = h_ref * x_ref + (y - h * x)
            llr = s["llr"][sl].reshape(b.shape[0], -1)
            gaps["llr_gap"].add(llr, self.receive(y_ref))
            b_ref = self.decode(llr)
            b_hat = s["b_hat"][sl].reshape(b.shape[0], -1).to(torch.int64)
            diff += int((b_ref != b_hat).any(1).sum())
        out = {k: g.value for k, g in gaps.items()}
        out["decode_cw_diff"] = diff
        return out

    def control(self, s, q, dtype, block=256):
        """The reference in the program's place, rounded by ``q`` and
        decoding in ``dtype``: a sample of its outputs on the inputs of
        ``s`` (the same bits, draws and noise)."""
        out = {k: [] for k in ("x", "h", "y", "llr", "b_hat")}
        batch = s["b"].shape[0]
        for lo in range(0, batch, block):
            sl = slice(lo, lo + block)
            b, x, h, y = self._rows(s, sl)
            xc = self.transmit(b, q)
            hc = self.channel(s["a"][sl], s["tau"][sl], q)
            yc = q(q(hc * xc) + (y - h * x))
            llr = self.receive(yc, q)
            out["x"].append(xc)
            out["h"].append(hc)
            out["y"].append(yc)
            out["llr"].append(llr)
            out["b_hat"].append(self.decode(llr, dtype))
        res = dict(s)
        res.update({k: torch.cat(v) for k, v in out.items()})
        return res
