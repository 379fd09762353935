"""Plain 5G NR LDPC code of TS 38.212 for the benchmark's reference.

Written from the standard and the decoder's stated algorithm, in plain
NumPy and PyTorch: the base graphs of Table 5.3.2-2/3 (frozen copies in
``codes/``), the lifting of Section 5.3.2, the base-graph choice of
Section 7.2.2 (as upstream Sionna applies it), the encoder (systematic,
H c = 0, the core parity block inverted over GF(2)), rate matching as
upstream Sionna's ``LDPC5GEncoder`` without an output interleaver (the
filler bits removed, the first 2Z bits punctured, n bits kept), and the
two belief-propagation schedules that ``LDPC5GDecoder`` states:

* flooding, "boxplus" (the tanh rule): v2c messages and marginals clipped
  at +-llr_max, the extrinsic tanh product taken as prefix times suffix
  product along each check node's edges (in base-column order) and
  capped at 1 - 1e-7, c2v = sign * min(2 atanh(product), llr_max);
  a variable node adds its channel LLR and its messages in base-row
  order;
* layered: the base rows in order, each row's Z check nodes at once,
  v2c = posterior - old c2v (not clipped), the same check-node rule, the
  posterior updated by new - old c2v.

The degree-1 parity nodes that are never sent are pruned from the
graph, with their check nodes, as upstream's ``prune_pcm=True`` does.
LLRs here are in the classic convention (positive: bit 0) inside the
decoders; ``rate_recover`` takes the logit convention
(log P(1)/P(0)) that the demapper emits.
"""

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

CODES_DIR = Path(__file__).resolve().parent / "codes"

# TS 38.212 Table 5.3.2-1: the lifting sizes of each set index i_LS
LIFTING_SETS = [
    [2, 4, 8, 16, 32, 64, 128, 256],
    [3, 6, 12, 24, 48, 96, 192, 384],
    [5, 10, 20, 40, 80, 160, 320],
    [7, 14, 28, 56, 112, 224],
    [9, 18, 36, 72, 144, 288],
    [11, 22, 44, 88, 176, 352],
    [13, 26, 52, 104, 208],
    [15, 30, 60, 120, 240],
]
BG_SHAPE = {1: (46, 68), 2: (42, 52)}


def base_graph(bg, i_ls):
    """[m_b, n_b] int array: the shift of set ``i_ls`` at each non-zero
    block, -1 elsewhere (TS 38.212 Table 5.3.2-2 for BG1, 5.3.2-3 for
    BG2). The CSV lists, row by row, the row index (on the first entry
    of a row), the column index and the eight sets' shifts."""
    bm = np.full(BG_SHAPE[bg], -1, np.int64)
    row = 0
    lines = (CODES_DIR / f"5G_bg{bg}.csv").read_text().splitlines()
    for line in lines[2:]:
        f = line.split(";")
        if f[0].strip():
            row = int(f[0])
        bm[row, int(f[1])] = int(f[2 + i_ls])
    return bm


def select_code(k, n):
    """(bg, z, i_ls, k_b): the base graph by code rate and k, then the
    smallest lifting size with k_b * z >= k (TS 38.212 5.2.2)."""
    r = k / n
    bg = 2 if (k <= 292 or (k <= 3824 and r <= 0.67) or r <= 0.25) else 1
    if bg == 1:
        kb = 22
    else:
        kb = 10 if k > 640 else 9 if k > 560 else 8 if k > 192 else 6
    z, i_ls = min((zz, i) for i, s in enumerate(LIFTING_SETS) for zz in s
                  if kb * zz >= k)
    return bg, z, i_ls, (22 if bg == 1 else 10)


class Code:
    """The lifted, pruned 5G code of (k, n), with the layouts the plain
    encoder and decoders use."""

    def __init__(self, k, n, llr_max=20.0):
        self.k, self.n, self.llr_max = int(k), int(n), float(llr_max)
        self.bg, self.z, self.i_ls, self.k_b = select_code(self.k, self.n)
        z = self.z
        self.bm = base_graph(self.bg, self.i_ls)
        m_b, n_b = self.bm.shape
        self.k_ldpc = self.k_b * z
        self.n_ldpc = n_b * z
        self.k_filler = self.k_ldpc - self.k
        # pruning: the trailing degree-1 columns that are never sent
        deg = (self.bm >= 0).sum(axis=0)
        last = n_b
        while last > 0 and deg[last - 1] == 1:
            last -= 1
        n_unsent = (self.n_ldpc - self.k_filler) - self.n - 2 * z
        self.num_vns = int(max(last * z, self.n_ldpc - n_unsent))
        self.num_cns = m_b * z - (self.n_ldpc - self.num_vns)
        # lifted edges (row r, column c, shift s): check node r*z + i
        # meets variable node c*z + (i + s) mod z
        cn_rows = []
        for r in range(m_b):
            for c in range(n_b):
                s = self.bm[r, c]
                if s < 0:
                    continue
                i = np.arange(z)
                cn_rows.append(np.stack([r * z + i, c * z + (i + s) % z,
                                         np.full(z, r), np.full(z, c)], 1))
        e = np.concatenate(cn_rows)
        keep = (e[:, 0] < self.num_cns) & (e[:, 1] < self.num_vns)
        e = e[keep]
        self.num_edges = len(e)
        # check-node layout: [num_cns, dc_max], edges of a check node in
        # base-column order, padded with -1
        order = np.lexsort((e[:, 3], e[:, 0]))
        e = e[order]
        cn, vn = e[:, 0], e[:, 1]
        dc = np.bincount(cn, minlength=self.num_cns)
        start = np.concatenate([[0], np.cumsum(dc)[:-1]])
        slot = np.arange(len(e)) - start[cn]
        self.dc_max = int(dc.max())
        cn_vn = np.full((self.num_cns, self.dc_max), -1, np.int64)
        cn_vn[cn, slot] = vn
        self.cn_vn = cn_vn
        # variable-node layout: [num_vns, dv_max] positions into the
        # flattened [dc_max * num_cns] message array, edges of a variable
        # node in base-row order, padded with the extra zero slot
        flat = slot * self.num_cns + cn
        vorder = np.lexsort((e[:, 2], vn))
        vn_s, flat_s = vn[vorder], flat[vorder]
        dv = np.bincount(vn_s, minlength=self.num_vns)
        vstart = np.concatenate([[0], np.cumsum(dv)[:-1]])
        vslot = np.arange(len(vn_s)) - vstart[vn_s]
        self.dv_max = int(dv.max())
        pad = self.dc_max * self.num_cns
        vn_pos = np.full((self.num_vns, self.dv_max), pad, np.int64)
        vn_pos[vn_s, vslot] = flat_s
        self.vn_pos = vn_pos
        self._dev = {}

    def tables(self, device):
        """The layouts as tensors on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._dev:
            cn_vn = torch.as_tensor(self.cn_vn, device=device)
            self._dev[device] = {
                "cn_vn": cn_vn.clamp_min(0), "cn_pad": cn_vn < 0,
                "vn_pos": torch.as_tensor(self.vn_pos, device=device)}
        return self._dev[device]

    # ---------------------------------------------------------------- encoder
    @lru_cache(maxsize=None)
    def _core_inverse(self):
        """The inverse over GF(2) of the 4Z x 4Z core parity block (rows
        0-3, columns k_b .. k_b+3), by Gauss-Jordan elimination on bits
        packed into bytes."""
        z = self.z
        m = np.zeros((4 * z, 4 * z), np.uint8)
        i = np.arange(z)
        for r in range(4):
            for c in range(4):
                s = self.bm[r, self.k_b + c]
                if s >= 0:
                    m[r * z + i, c * z + (i + s) % z] = 1
        aug = np.packbits(np.concatenate([m, np.eye(4 * z, dtype=np.uint8)],
                                         1), axis=1)
        for col in range(4 * z):
            byte, bit = divmod(col, 8)
            column = (aug[:, byte] >> (7 - bit)) & 1
            cand = np.nonzero(column[col:])[0]
            if len(cand) == 0:
                raise ValueError("the core parity block is singular")
            p = col + cand[0]
            if p != col:
                aug[[col, p]] = aug[[p, col]]
                column[[col, p]] = column[[p, col]]
            rows = np.nonzero(column)[0]
            rows = rows[rows != col]
            aug[rows] ^= aug[col]
        return np.unpackbits(aug, axis=1)[:, 4 * z:8 * z]

    def _block_sums(self, rows, cols, bits):
        """[B, len(rows) * z] sums over the listed base rows of the
        blocks of ``bits`` ([B, num_cols * z], base column ``cols[0]``
        first) rotated by each block's shift."""
        z = self.z
        out = []
        i = torch.arange(z, device=bits.device)
        for r in rows:
            acc = torch.zeros((bits.shape[0], z), dtype=bits.dtype,
                              device=bits.device)
            for j, c in enumerate(cols):
                s = int(self.bm[r, c])
                if s >= 0:
                    acc = acc + bits[:, j * z + (i + s) % z]
            out.append(acc)
        return torch.cat(out, 1)

    def encode(self, u):
        """Mother codeword [B, n_ldpc] (int64 bits) of the info bits ``u``
        [B, k] (any numeric dtype, values 0/1): filler zeros appended,
        H c = 0."""
        z, kb = self.z, self.k_b
        u = u.to(torch.int64)
        s = torch.cat([u, torch.zeros((u.shape[0], self.k_filler),
                                      dtype=u.dtype, device=u.device)], 1)
        lam = self._block_sums(range(4), range(kb), s) % 2
        binv = torch.as_tensor(self._core_inverse(), dtype=torch.float64,
                               device=u.device)
        p_core = (lam.to(torch.float64) @ binv.T).round().to(u.dtype) % 2
        sp = torch.cat([s, p_core], 1)
        m_b = self.bm.shape[0]
        p_ext = self._block_sums(range(4, m_b), range(kb + 4), sp) % 2
        return torch.cat([sp, p_ext], 1)

    def rate_match(self, c):
        """Sent bits [B, n]: filler bits removed, the first 2Z punctured,
        the next n kept."""
        c_nf = torch.cat([c[:, :self.k], c[:, self.k_ldpc:]], 1)
        return c_nf[:, 2 * self.z:2 * self.z + self.n]

    def syndrome_weight(self, c):
        """Unsatisfied checks of the full (unpruned) graph per word."""
        m_b, n_b = self.bm.shape
        return (self._block_sums(range(m_b), range(n_b), c) % 2).sum(1)

    # ---------------------------------------------------------------- decoder
    def rate_recover(self, llr_logit):
        """Classic-convention LLRs [B, num_vns] of the pruned code from the
        sent bits' logit-convention LLRs [B, n]: punctured and unsent
        positions 0, filler bits known zeros (+llr_max), all clipped."""
        b = llr_logit.shape[0]
        dt, dev = llr_logit.dtype, llr_logit.device
        z = self.z
        # the filler-free word of the pruned code, then the filler bits
        # put back after the k info bits
        tail = self.num_vns - self.k_filler - 2 * z - self.n
        body = torch.cat([
            torch.zeros((b, 2 * z), dtype=dt, device=dev), llr_logit,
            torch.zeros((b, tail), dtype=dt, device=dev)], 1)
        full = torch.cat([body[:, :self.k],
                          torch.full((b, self.k_filler), -self.llr_max,
                                     dtype=dt, device=dev),
                          body[:, self.k:]], 1)
        return -torch.clamp(full, -self.llr_max, self.llr_max)

    def _cn_update(self, v2c, pad, dt):
        """Boxplus check-node rule over [dc_max, B, num_cns] v2c messages
        (pads hold +inf, read as absent): [dc_max, B, num_cns] c2v."""
        one = torch.ones((), dtype=dt, device=v2c.device)
        hi = torch.tensor(1 - 1e-7, dtype=dt, device=v2c.device)
        t = torch.where(pad, one, torch.tanh(torch.abs(v2c) / 2))
        sgn = torch.where(v2c < 0, -one, one)
        d = v2c.shape[0]
        pre = [one.expand_as(t[0])]
        for j in range(d - 1):
            pre.append(pre[-1] * t[j])
        suf = [one.expand_as(t[0])] * d
        acc = None
        for j in range(d - 1, 0, -1):
            acc = t[j] if acc is None else acc * t[j]
            suf[j - 1] = acc
        sign_tot = sgn[0]
        for j in range(1, d):
            sign_tot = sign_tot * sgn[j]
        out = []
        for j in range(d):
            if j == 0:
                ext = suf[0]
            elif j == d - 1:
                ext = pre[d - 1]
            else:
                ext = pre[j] * suf[j]
            ext = torch.minimum(ext, hi)
            mag = torch.log1p(ext) - torch.log1p(-ext)
            out.append(sign_tot * sgn[j]
                       * torch.clamp(mag, max=self.llr_max))
        return torch.stack(out)

    def decode_flooding(self, llr, num_iter, dtype=torch.float32):
        """Hard decisions [B, k] (int64) of ``num_iter`` flooding
        iterations on the classic-convention LLRs [B, num_vns]."""
        tb = self.tables(llr.device)
        cn_vn, pad, vn_pos = tb["cn_vn"], tb["cn_pad"], tb["vn_pos"]
        clip = self.llr_max
        llr = llr.to(dtype)
        bsz = llr.shape[0]
        inf = torch.tensor(float("inf"), dtype=dtype, device=llr.device)
        pad_b = pad.T[:, None, :]                      # [dc, 1, cns]
        v2c = torch.clamp(llr, -clip, clip)[:, cn_vn.T]  # [B, dc, cns]
        v2c = torch.where(pad_b, inf, v2c.permute(1, 0, 2))
        marg = llr
        for _ in range(num_iter):
            c2v = self._cn_update(v2c, pad_b, dtype)
            flat = torch.cat([c2v.permute(1, 0, 2).reshape(bsz, -1),
                              torch.zeros((bsz, 1), dtype=dtype,
                                          device=llr.device)], 1)
            tot = llr
            for j in range(self.dv_max):
                tot = tot + flat[:, vn_pos[:, j]]
            marg = torch.clamp(tot, -clip, clip)
            v2c = torch.clamp(tot[:, cn_vn.T].permute(1, 0, 2) - c2v,
                              -clip, clip)
            v2c = torch.where(pad_b, inf, v2c)
        return (marg[:, :self.k] < 0).to(torch.int64)

    def decode_layered(self, llr, num_iter, dtype=torch.float32):
        """Hard decisions [B, k] (int64) of ``num_iter`` layered
        iterations (base rows in order) on classic-convention LLRs. The
        check nodes of one base row share its degree and no variable
        node, so a row is one dense [degree, B, rows] update."""
        z = self.z
        marg = llr.to(dtype).clone()
        bsz = llr.shape[0]
        rows = []
        for lo in range(0, self.num_cns, z):
            hi = min(lo + z, self.num_cns)
            deg = int((self.cn_vn[lo] >= 0).sum())
            idx = self.cn_vn[lo:hi, :deg]
            if (idx < 0).any() or (self.cn_vn[lo:hi, deg:] >= 0).any():
                raise ValueError("a base row's check nodes differ in degree")
            rows.append(torch.as_tensor(idx.T.copy(), device=llr.device))
        no_pad = [torch.zeros(r.shape[0], 1, 1, dtype=torch.bool,
                              device=llr.device) for r in rows]
        c2v = [torch.zeros((r.shape[0], bsz, r.shape[1]), dtype=dtype,
                           device=llr.device) for r in rows]
        for _ in range(num_iter):
            for r, idx in enumerate(rows):
                v2c = marg[:, idx].permute(1, 0, 2) - c2v[r]
                new = self._cn_update(v2c, no_pad[r], dtype)
                delta = (new - c2v[r]).permute(1, 0, 2)   # [B, deg, rows]
                marg.index_add_(1, idx.reshape(-1),
                                delta.reshape(bsz, -1))
                c2v[r] = new
        return (marg[:, :self.k] < 0).to(torch.int64)
