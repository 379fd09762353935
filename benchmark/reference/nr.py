"""Plain 5G NR pieces of the PUSCH for the benchmark's reference, from
TS 38.211, 38.212 and 38.214 as upstream Sionna applies them: the Gold
sequence, the CRCs, the transport block size and its code blocks, the
DMRS of configuration type 1, the codebook precoders of two layers on
two ports, and layer mapping. NumPy and PyTorch only."""

from functools import lru_cache

import numpy as np
import torch

CRC_POLYS = {  # TS 38.212 5.1: the exponents of g(D)
    "CRC24A": [24, 23, 18, 17, 14, 11, 10, 7, 6, 5, 4, 3, 1, 0],
    "CRC24B": [24, 23, 6, 5, 1, 0],
    "CRC16": [16, 12, 5, 0],
}

# TS 38.214 Table 5.1.3.1-1 (MCS index table 1 for PUSCH without
# transform precoding): MCS index -> (modulation order, rate x 1024)
MCS_TABLE_1 = {i: (q, r) for i, (q, r) in enumerate(
    [(2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
     (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
     (4, 553), (4, 616), (4, 658), (6, 438), (6, 466), (6, 517), (6, 567),
     (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910),
     (6, 948)])}

# TS 38.211 Table 6.3.1.5-4: precoders of two layers on two ports
TPMI_2X2 = [np.array([[1, 0], [0, 1]]) / np.sqrt(2),
            np.array([[1, 1], [1, -1]]) / 2,
            np.array([[1, 1], [1j, -1j]]) / 2]


def gold(n, c_init):
    """c(0..n-1) of TS 38.211 5.2.1 (Nc = 1600), uint8."""
    nc = 1600
    total = n + nc + 31
    x1 = np.zeros(total, np.uint8)
    x2 = np.zeros(total, np.uint8)
    x1[0] = 1
    x2[:31] = (int(c_init) >> np.arange(31)) & 1
    for i in range(total - 31):
        x1[i + 31] = x1[i + 3] ^ x1[i]
        x2[i + 31] = x2[i + 3] ^ x2[i + 2] ^ x2[i + 1] ^ x2[i]
    return x1[nc:nc + n] ^ x2[nc:nc + n]


@lru_cache(maxsize=8)
def crc_matrix(length, poly):
    """[length, L] GF(2) matrix M: the CRC parity bits (MSB first) of a
    word a are a @ M mod 2, the remainder of a(D) D^L by g(D)."""
    exps = CRC_POLYS[poly]
    deg = exps[0]
    g = sum(1 << e for e in exps if e < deg)
    rows = np.zeros((length, deg), np.uint8)
    r = g  # D^deg mod g for the last bit
    for i in range(length - 1, -1, -1):
        rows[i] = (r >> np.arange(deg - 1, -1, -1)) & 1
        r = (r << 1) ^ (g if r >> (deg - 1) & 1 else 0)
        r &= (1 << deg) - 1
    return rows


def crc_attach(bits, poly):
    """[B, A] bits (int64) with their CRC appended: [B, A + L]."""
    m = torch.as_tensor(crc_matrix(bits.shape[1], poly),
                        dtype=torch.float64, device=bits.device)
    p = (bits.to(torch.float64) @ m).round().to(torch.int64) % 2
    return torch.cat([bits, p], 1)


def tb_config(num_coded_bits, rate, qm, layers):
    """(tb_size, code block size K' with its CRC, number of code blocks,
    rate-matched lengths of each block) by TS 38.214 5.1.3.2 for
    information sizes above 3824 bits and TS 38.212 5.2.2 / 5.4.2.1, as
    upstream Sionna computes them (a CRC24A on the TB, a CRC24B on each
    block when there are several)."""
    n_info = int(rate * num_coded_bits)  # truncated, as upstream Sionna
    if n_info <= 3824:
        raise ValueError("small transport blocks are not needed here")
    n = np.floor(np.log2(n_info - 24)) - 5
    n_info_q = max(3840.0, 2 ** n * np.round((n_info - 24) / 2 ** n))
    if rate <= 1 / 4:
        c = int(np.ceil((n_info_q + 24) / 3816))
    else:
        c = int(np.ceil((n_info_q + 24) / 8424)) if n_info_q > 8424 else 1
    tbs = int(8 * c * np.ceil((n_info_q + 24) / (8 * c)) - 24)
    cb_crc = 24 if c > 1 else 0
    k_cb = (tbs + 24) // c + cb_crc
    ql = layers * qm
    n_last = (num_coded_bits // ql) % c
    e = [ql * (num_coded_bits // (ql * c))] * (c - n_last) \
        + [ql * -(-num_coded_bits // (ql * c))] * n_last
    return tbs, k_cb, c, e


def bit_interleave(e, qm):
    """TS 38.212 5.4.2.2: output j*Q + i reads input i*(E/Q) + j."""
    rows = e // qm
    return (np.arange(qm)[None, :] * rows
            + np.arange(rows)[:, None]).reshape(-1)


def dmrs_type1(num_sc, num_sym, dmrs_symbols, ports, n_id, n_scid=0,
               slot=0, beta=np.sqrt(2)):
    """[ports, num_sym, num_sc] complex128 grids of DMRS configuration
    type 1, single symbol (TS 38.211 6.4.1.1): QPSK from the Gold
    sequence of c_init(l), on subcarriers 4n + 2k' + delta, with the
    frequency and time covers of each port, times ``beta``."""
    delta = {0: 0, 1: 0, 2: 1, 3: 1}
    wf = {0: (1, 1), 1: (1, -1), 2: (1, 1), 3: (1, -1)}
    grid = np.zeros((len(ports), num_sym, num_sc), np.complex128)
    n = np.arange(num_sc // 4)
    for l in dmrs_symbols:
        c_init = (2 ** 17 * (num_sym * slot + l + 1) * (2 * n_id + 1)
                  + 2 * n_id + n_scid) % 2 ** 31
        c = gold(2 * num_sc, c_init).astype(np.float64)
        r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
        for i, p in enumerate(ports):
            for kp in (0, 1):
                grid[i, l, 4 * n + 2 * kp + delta[p]] = \
                    beta * r[2 * n + kp] * wf[p][kp]
    return grid


def layer_map(symbols, layers):
    """[B, n] symbols -> [B, layers, n / layers]: symbol i*L + l on
    layer l (TS 38.211 6.3.1.3)."""
    return symbols.reshape(symbols.shape[0], -1, layers).transpose(1, 2)
