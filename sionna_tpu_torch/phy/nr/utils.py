"""5G NR utilities (counterpart of ``sionna_tpu/phy/nr/utils.py``).

The TS 38.214 procedures ``decode_mcs_index``, ``calculate_num_coded_bits``
and ``calculate_tb_size`` run on the host in NumPy, as in the JAX package.
``decode_mcs_index_jit`` and ``calculate_cb_size_jit`` are their tensor
forms (the JAX package's traced path, float32 quantization arithmetic,
no value check): they run on the device of their inputs, so that a slot
loop on the card reads nothing back. ``MCSDecoderNR`` and
``TransportBlockNR`` take the tensor forms for tensor inputs and the
host forms otherwise, as the JAX package takes its traced forms under
``jit``.
"""

import functools

import numpy as np
import torch

from ..fec.scrambling import generate_prng_seq as _generate_prng_seq
from ..utils.misc import MCSDecoder, SingleLinkChannel, TransportBlock

__all__ = ["generate_prng_seq", "decode_mcs_index", "decode_mcs_index_jit",
           "calculate_num_coded_bits", "calculate_tb_size",
           "calculate_cb_size_jit", "MCSDecoderNR", "TransportBlockNR",
           "CodedAWGNChannelNR"]


def generate_prng_seq(length, c_init):
    """Gold sequence per TS 38.211 Sec. 5.2.1."""
    return _generate_prng_seq(length, c_init)


# MCS tables (TS 38.214 Tables 5.1.3.1-1/2/3/4 and 6.1.4.1-1/2)
_MOD_ORDERS = np.array([
    [  # PUSCH with transform precoding
        [1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 4, 4, 4, 4, 4, 4, 4, 6,
         6, 6, 6, 6, 6, 6, 6, 6, 6, 6, -1],
        [1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 4, 4,
         4, 4, 4, 4, 4, 4, 6, 6, 6, 6, -1],
        [-1] * 29,
        [-1] * 29,
    ],
    [  # PDSCH or PUSCH without transform precoding
        [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 4, 4, 4, 4, 4, 4, 4, 6,
         6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6],
        [2, 2, 2, 2, 2, 4, 4, 4, 4, 4, 4, 6, 6, 6, 6, 6, 6,
         6, 6, 6, 8, 8, 8, 8, 8, 8, 8, 8, -1],
        [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 4, 4, 4,
         4, 4, 4, 6, 6, 6, 6, 6, 6, 6, 6],
        [2, 2, 2, 4, 4, 4, 6, 6, 6, 6, 6, 6, 6, 6, 6, 8, 8, 8,
         8, 8, 8, 8, 8, 10, 10, 10, 10, -1, -1],
    ],
])

_TARGET_RATES = np.array([
    [  # PUSCH with transform precoding (pi2bpsk variants both rows)
        [240, 314, 193, 251, 308, 379, 449, 526, 602,
         679, 340, 378, 434, 490, 553, 616, 658, 466, 517,
         567, 616, 666, 719, 772, 822, 873, 910, 948, -1],
        [60, 80, 100, 128, 156, 198, 120, 157,
         193, 251, 308, 379, 449, 526, 602, 679, 378, 434,
         490, 553, 616, 658, 699, 772, 567, 616, 666, 772, -1],
        [-1] * 29,
        [-1] * 29,
    ],
    [
        [120, 157, 193, 251, 308, 379, 449, 526, 602, 679,
         340, 378, 434, 490, 553, 616, 658, 438, 466, 517,
         567, 616, 666, 719, 772, 822, 873, 910, 948],
        [120, 193, 308, 449, 602, 378, 434, 490, 553, 616,
         658, 466, 517, 567, 616, 666, 719, 772, 822, 873,
         682.5, 711, 754, 797, 841, 885, 916.5, 948, -1],
        [30, 40, 50, 64, 78, 99, 120, 157, 193, 251, 308,
         379, 449, 526, 602, 340, 378, 434, 490, 553, 616,
         438, 466, 517, 567, 616, 666, 719, 772],
        [120, 193, 449, 378, 490, 616, 466, 517, 567, 616,
         666, 719, 772, 822, 873, 682.5, 711, 754, 797, 841,
         885, 916.5, 948, 805.5, 853, 900.5, 948, -1, -1],
    ],
])


_TAB51321 = np.array(
    [-1, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128,
     136, 144, 152, 160, 168, 176, 184, 192, 208, 224, 240, 256,
     272, 288, 304, 320, 336, 352, 368, 384, 408, 432, 456, 480,
     504, 528, 552, 576, 608, 640, 672, 704, 736, 768, 808, 848,
     888, 928, 984, 1032, 1064, 1128, 1160, 1192, 1224, 1256,
     1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736, 1800,
     1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536,
     2600, 2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496,
     3624, 3752, 3824], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _device_tables(device):
    """The MCS tables and TS 38.214 Table 5.1.3.2-1 on ``device``, made
    once per device."""
    return (torch.as_tensor(_MOD_ORDERS, device=device),
            torch.as_tensor(_TARGET_RATES, device=device),
            torch.as_tensor(_TAB51321, dtype=torch.float32, device=device))


def _like(value, ref):
    """``value`` (a tensor or a Python number) broadcast to ``ref``'s
    shape on its device; a number is filled in there, not copied."""
    if isinstance(value, torch.Tensor):
        return value.to(ref.device).expand(ref.shape)
    return torch.full(ref.shape, value, device=ref.device)


def decode_mcs_index(mcs_index, table_index=1, is_pusch=True,
                     transform_precoding=False, pi2bpsk=False,
                     check_index_validity=True, verbose=False):
    """MCS index -> (modulation_order, target_rate) per TS 38.214, as
    NumPy int32 and float32 arrays."""
    mcs_index = np.asarray(mcs_index, np.int32)
    shape = mcs_index.shape
    table_index = np.broadcast_to(np.asarray(table_index, np.int32),
                                  shape)
    is_pusch = np.broadcast_to(np.asarray(is_pusch, bool), shape)
    transform_precoding = np.broadcast_to(
        np.asarray(transform_precoding, bool), shape)
    if np.any(mcs_index < 0) or np.any(mcs_index > 28):
        raise ValueError("MCS index must be in [0, 28]")
    if not np.all(np.isin(table_index, [1, 2, 3, 4])):
        raise ValueError("table_index must contain values in [1,2,3,4]")

    # with transform precoding on PUSCH the first table set applies
    channel_idx = (~is_pusch | ~transform_precoding).astype(np.int32)
    row = table_index - 1
    mod = _MOD_ORDERS[channel_idx, row, mcs_index]
    rate = _TARGET_RATES[channel_idx, row, mcs_index] / 1024.0
    if check_index_validity and np.any(mod < 0):
        raise ValueError("Invalid MCS index for this configuration")
    return mod.astype(np.int32), rate.astype(np.float32)


def decode_mcs_index_jit(mcs_index, table_index=1, is_pusch=True,
                         transform_precoding=False, pi2bpsk=False):
    """Tensor form of :func:`decode_mcs_index`: table gathers on the
    device of ``mcs_index``, no value check (an invalid entry gives
    -1). Returns (int32 modulation order, float32 rate)."""
    mcs = torch.as_tensor(mcs_index).long()
    mods, rates, _ = _device_tables(mcs.device)
    ti = _like(table_index, mcs).long()
    ip = _like(is_pusch, mcs).to(torch.bool)
    tp = _like(transform_precoding, mcs).to(torch.bool)
    channel_idx = (~ip | ~tp).long()
    mod = mods[channel_idx, ti - 1, mcs]
    rate = rates[channel_idx, ti - 1, mcs] / 1024.0
    return mod.to(torch.int32), rate.to(torch.float32)


def calculate_cb_size_jit(modulation_order, target_coderate,
                          num_coded_bits):
    """Tensor form of the code-block segmentation of
    :func:`calculate_tb_size` (TS 38.214 Sec. 5.1.3.2) when
    ``num_coded_bits`` is given, in float32 as the JAX package's traced
    form: (int32 cb_size, int32 num_cb)."""
    f32 = torch.float32
    target_coderate = torch.as_tensor(target_coderate).to(f32)
    dev = target_coderate.device
    num_coded_bits = torch.as_tensor(num_coded_bits).to(device=dev,
                                                        dtype=f32)
    tab = _device_tables(dev)[2]
    tts = torch.clamp_min(target_coderate * num_coded_bits, 0.)

    n_small = torch.clamp_min(
        torch.floor(torch.log2(torch.clamp_min(tts, 1.))) - 6., 3.0)
    q_small = torch.clamp_min(
        2. ** n_small * torch.floor(tts / 2. ** n_small), 24.0)
    n_big = torch.floor(torch.log2(torch.clamp_min(tts - 24., 1.))) - 5.
    q_big = torch.clamp_min(
        2. ** n_big * torch.round((tts - 24.) / 2. ** n_big), 3840.0)
    n_info_q = torch.where(tts <= 3824., q_small, q_big)

    one = torch.ones_like(n_info_q)
    num_cb = torch.where(
        n_info_q <= 3824., one,
        torch.where(target_coderate <= 0.25,
                    torch.ceil((n_info_q + 24.) / 3816.),
                    torch.where(n_info_q > 8424.,
                                torch.ceil((n_info_q + 24.) / 8424.), one)))

    idx = torch.searchsorted(tab, n_info_q.contiguous(), side="left")
    idx = torch.clamp_max(idx, tab.shape[0] - 1)
    tbs_small = tab[idx]
    tbs_big = (8. * num_cb * torch.ceil((n_info_q + 24.) / (8. * num_cb))
               - 24.)
    tb_size = torch.where(n_info_q <= 3824., tbs_small, tbs_big)
    tb_crc = torch.where(tb_size > 3824., 24., 16.)
    cb_crc = torch.where(num_cb > 1., 24., 0.)
    cb_size = (torch.floor((tb_size + tb_crc) / num_cb)
               + cb_crc).to(torch.int32)
    return cb_size, num_cb.to(torch.int32)


def calculate_num_coded_bits(modulation_order, num_prbs,
                             num_ofdm_symbols, num_dmrs_per_prb,
                             num_layers=1, num_ov=0, tb_scaling=1.0,
                             precision=None):
    """Number of coded bits fitting in a slot (NumPy int32)."""
    n_re_per_prb = 12 * np.asarray(num_ofdm_symbols) \
        - np.asarray(num_dmrs_per_prb) - np.asarray(num_ov)
    n_re_per_prb = np.minimum(156, n_re_per_prb)
    num_coded_bits = np.asarray(tb_scaling) * (
        n_re_per_prb * np.asarray(num_prbs)
        * np.asarray(modulation_order) * np.asarray(num_layers))
    return num_coded_bits.astype(np.int32)


def calculate_tb_size(modulation_order, target_coderate,
                      target_tb_size=None, num_coded_bits=None,
                      num_prbs=None, num_ofdm_symbols=None,
                      num_dmrs_per_prb=None, num_layers=1, num_ov=0,
                      tb_scaling=1.0, return_cw_length=True,
                      verbose=False, precision=None):
    """Transport block size per TS 38.214 Sec. 5.1.3.2 / 6.1.4.2, on the
    host in NumPy.

    Returns (tb_size, cb_size, num_cb, tb_crc_length, cb_crc_length
    [, cw_length])."""
    modulation_order = np.asarray(modulation_order, np.int32)
    target_coderate = np.asarray(target_coderate, np.float64)
    shape = modulation_order.shape
    num_layers = np.broadcast_to(np.asarray(num_layers, np.int32),
                                 shape)
    tb_scaling = np.broadcast_to(np.asarray(tb_scaling, np.float64),
                                 shape)

    if num_coded_bits is not None:
        num_coded_bits = np.asarray(num_coded_bits, np.int32)
        if np.any(num_coded_bits % modulation_order != 0):
            raise ValueError(
                "num_coded_bits must be a multiple of modulation_order.")
    else:
        if num_prbs is None or num_ofdm_symbols is None \
                or num_dmrs_per_prb is None:
            raise ValueError(
                "If num_coded_bits is None then num_prbs, "
                "num_ofdm_symbols, num_dmrs_per_prb must be specified.")
        num_coded_bits = calculate_num_coded_bits(
            modulation_order, num_prbs, num_ofdm_symbols,
            num_dmrs_per_prb, num_layers, num_ov, tb_scaling,
            precision=precision)
    if np.any(num_coded_bits % num_layers != 0):
        raise ValueError("num_coded_bits must be a multiple of "
                         "num_layers")

    if target_tb_size is None:
        target_tb_size = target_coderate * num_coded_bits
    target_tb_size = np.asarray(target_tb_size, np.float64)

    # quantized intermediate number of information bits
    # (TS 38.214 Sec. 5.1.3.2 steps 3 and 4)
    with np.errstate(divide="ignore", invalid="ignore"):
        n_small = np.maximum(
            3.0, np.floor(np.log2(np.maximum(target_tb_size, 1))) - 6)
        q_small = np.maximum(
            24.0, 2 ** n_small * np.floor(target_tb_size / 2 ** n_small))
        n_big = np.floor(
            np.log2(np.maximum(target_tb_size - 24, 1))) - 5
        q_big = np.maximum(
            3840.0, 2 ** n_big * np.round(
                (target_tb_size - 24) / 2 ** n_big))
    n_info_q = np.where(target_tb_size <= 3824, q_small, q_big)

    num_cb = np.where(
        n_info_q <= 3824, 1.0,
        np.where(target_coderate <= 1 / 4,
                 np.ceil((n_info_q + 24) / 3816),
                 np.where(n_info_q > 8424,
                          np.ceil((n_info_q + 24) / 8424), 1.0)))

    # TBS for small blocks: smallest table entry >= n_info_q
    idx = np.searchsorted(_TAB51321, n_info_q, side="left")
    idx = np.minimum(idx, len(_TAB51321) - 1)
    tbs_small = _TAB51321[idx]
    tbs_big = 8 * num_cb * np.ceil((n_info_q + 24) / (8 * num_cb)) - 24
    tb_size = np.where(n_info_q <= 3824, tbs_small,
                       tbs_big).astype(np.int32)
    num_cb = num_cb.astype(np.int32)
    tb_crc_length = np.where(tb_size > 3824, 24, 16).astype(np.int32)
    cb_crc_length = np.where(num_cb > 1, 24, 0).astype(np.int32)
    cb_size = ((tb_size + tb_crc_length) // num_cb
               + cb_crc_length).astype(np.int32)

    if not return_cw_length:
        return tb_size, cb_size, num_cb, tb_crc_length, cb_crc_length

    # rate-matched codeword lengths per CB (TS 38.212 Sec. 5.4.2.1)
    ql = num_layers * modulation_order
    num_last = (num_coded_bits // ql) % num_cb
    cw_last = ql * np.ceil(num_coded_bits / (ql * num_cb)).astype(
        np.int64)
    num_first = num_cb - num_last
    cw_first = ql * np.floor(num_coded_bits / (ql * num_cb)).astype(
        np.int64)

    nf = np.reshape(num_first, (-1,))
    cf = np.reshape(cw_first, (-1,))
    nl = np.reshape(num_last, (-1,))
    cl = np.reshape(cw_last, (-1,))
    num_cols = int(np.max(nf + nl))
    r = np.arange(num_cols)[None, :]
    cw_length = np.where(
        r < nf[:, None], cf[:, None],
        np.where(r < (nf + nl)[:, None], cl[:, None], 0))
    cw_length = cw_length.reshape(shape + (num_cols,)).astype(np.int32)
    return (tb_size, cb_size, num_cb, tb_crc_length, cb_crc_length,
            cw_length)


class MCSDecoderNR(MCSDecoder):
    """5G NR MCS index -> (modulation order, coderate). mcs_category: 0
    for PUSCH, 1 for PDSCH. ``transform_precoding`` defaults to True, as
    the shipped BLER tables were generated.

    A tensor ``mcs_index`` takes :func:`decode_mcs_index_jit` on its
    device (no value check: nothing is read back); host input takes
    :func:`decode_mcs_index` and is checked."""

    def forward(self, mcs_index, mcs_table_index, mcs_category, *,
                check_index_validity=True, transform_precoding=True,
                pi2bpsk=False, verbose=False, **kwargs):
        if isinstance(mcs_index, torch.Tensor):
            is_pusch = mcs_category == 0
            mod, rate = decode_mcs_index_jit(
                mcs_index, table_index=mcs_table_index, is_pusch=is_pusch,
                transform_precoding=transform_precoding, pi2bpsk=pi2bpsk)
            return mod, rate.to(self.rdtype)
        mod, rate = decode_mcs_index(
            np.asarray(mcs_index), table_index=np.asarray(mcs_table_index),
            is_pusch=np.asarray(mcs_category) == 0,
            transform_precoding=transform_precoding, pi2bpsk=pi2bpsk,
            check_index_validity=check_index_validity, verbose=verbose)
        return np.asarray(mod, np.int32), np.asarray(rate, self.np_rdtype)


class TransportBlockNR(TransportBlock):
    """Number and size of the code blocks of a 5G NR transport block.
    Tensor input takes :func:`calculate_cb_size_jit` on its device, host
    input :func:`calculate_tb_size`."""

    def forward(self, modulation_order, target_coderate, num_coded_bits,
                **kwargs):
        if any(isinstance(a, torch.Tensor) for a in
               (modulation_order, target_coderate, num_coded_bits)):
            return calculate_cb_size_jit(modulation_order, target_coderate,
                                         num_coded_bits)
        _, cb_size, num_cb, *_ = calculate_tb_size(
            np.asarray(modulation_order), np.asarray(target_coderate),
            num_coded_bits=np.asarray(num_coded_bits), tb_scaling=1.,
            return_cw_length=False, verbose=False)
        return np.asarray(cb_size, np.int32), np.asarray(num_cb, np.int32)


class CodedAWGNChannelNR(SingleLinkChannel):
    """5G NR single-link LDPC-coded AWGN channel for BLER tables: QAM,
    AWGN, APP demapper and ``LDPC5GDecoder`` (on the card its lifted
    engine, kernel K1). Call: (batch_size, ebno_db[, generator]) ->
    (bits, bits_hat)."""

    def __init__(self, num_bits_per_symbol=None, num_info_bits=None,
                 target_coderate=None, num_iter_decoder=20,
                 cn_update_decoder="boxplus-phi", precision=None,
                 device=None, **kwargs):
        super().__init__(num_bits_per_symbol, num_info_bits,
                         target_coderate, precision=precision, device=device)
        self._num_iter_decoder = int(num_iter_decoder)
        self._cn_update_decoder = cn_update_decoder
        self._kwargs = kwargs
        self._built_for = None

    def _build(self):
        # (re)built when the code parameters change
        spec = (self.num_bits_per_symbol, self.num_info_bits,
                self.target_coderate, self.device)
        if self._built_for == spec:
            return
        from ..channel import AWGN
        from ..fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
        from ..mapping import BinarySource, Demapper, Mapper
        kw = dict(precision=self.precision, device=self.device)
        self._binary_source = BinarySource(**kw)
        self._mapper = Mapper("qam", self.num_bits_per_symbol, **kw)
        self._demapper = Demapper("app", "qam", self.num_bits_per_symbol,
                                  **kw)
        self._awgn = AWGN(**kw)
        self._encoder = LDPC5GEncoder(
            self.num_info_bits, self.num_coded_bits,
            num_bits_per_symbol=self.num_bits_per_symbol,
            device=self.device)
        self._decoder = LDPC5GDecoder(
            self._encoder, hard_out=True, num_iter=self._num_iter_decoder,
            cn_update=self._cn_update_decoder, **kw, **self._kwargs)
        self._built_for = spec

    @property
    def decoder(self):
        """The LDPC decoder of the current code parameters"""
        self._build()
        return self._decoder

    def forward(self, batch_size, ebno_db, generator=None):
        from ..utils.misc import ebnodb2no
        self._build()
        no = ebnodb2no(ebno_db, num_bits_per_symbol=self.num_bits_per_symbol,
                       coderate=self.target_coderate).to(self.device)
        bits = self._binary_source([batch_size, self.num_info_bits],
                                   generator=generator)
        x = self._mapper(self._encoder(bits))
        y = self._awgn(x, no, generator=generator)
        llr = self._demapper(y, no)
        return bits, self._decoder(llr)
