"""PUSCH receiver composite (counterpart of
``sionna_tpu/phy/nr/pusch_receiver.py``).

With perfect CSI and codebook precoding the receiver precodes the channel
(:func:`precode_channel`). On a card that is one launch of the
hand-written kernel ``csrc/precode_channel.cu``;
:func:`precoding_kernel_applies` states the rule. Every other call runs
:func:`precode_channel_plain`.
"""

import ctypes

import numpy as np
import torch

from ..._build import CudaKernel
from ..block import Block
from ..channel import time_to_ofdm_channel
from ..mimo import StreamManagement
from ..ofdm import LinearDetector, OFDMDemodulator
from ..utils.profiling import traced
from .layer_mapping import LayerDemapper
from .pusch_channel_estimation import PUSCHLSChannelEstimator
from .tb_decoder import TBDecoder

__all__ = ["PUSCHReceiver"]

# the row dimensions outside tx: b, rx and rxa
_PRECODE_ROW_DIMS = 3
_PRECODE_MAX_PORTS = 4
#: The CUDA kernel of the channel's precoding (built on first use): one
#: instance for each P ports and L layers, 1 <= L <= P <= 4.
PRECODE_CHANNEL_KERNEL = CudaKernel(
    name="precode_channel",
    source="precode_channel.cu",
    replaces=None,
    functions={
        "sionna_precode_channel": ([ctypes.c_void_p] * 3
                                   + [ctypes.POINTER(ctypes.c_longlong),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p],
                                   ctypes.c_int),
        "sionna_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    defines={"SIONNA_PRECODE_ROW_DIMS": _PRECODE_ROW_DIMS,
             "SIONNA_PRECODE_MAX_PORTS": _PRECODE_MAX_PORTS})


def precode_channel(h, w):
    """The channel h [b, rx, rxa, tx, P, sym, sc] seen through each
    transmitter's precoding matrix w [tx, P, L]: [b, rx, rxa, tx, L, sym,
    sc], sum_p h[..., p, :, :] w[tx, p, l]. Where
    :func:`precoding_kernel_applies` holds, one launch of
    :func:`precode_channel_cuda`; otherwise :func:`precode_channel_plain`."""
    if precoding_kernel_applies(h, w):
        return precode_channel_cuda(h, w)
    return precode_channel_plain(h, w)


def precode_channel_plain(h, w):
    """:func:`precode_channel` in plain PyTorch: h permuted to [b, rx, tx,
    sym, sc, rxa, P], a matrix product with w, and the result permuted
    back (a view)."""
    h = h.permute(0, 1, 3, 5, 6, 2, 4)
    h = torch.matmul(h, w[:, None, None])
    return h.permute(0, 1, 5, 2, 6, 3, 4)


def precoding_kernel_applies(h, w):
    """Whether :func:`precode_channel` runs the kernel on h [b, rx, rxa,
    tx, P, sym, sc] and w [tx, P, L]: w given; both complex64 on a card;
    1 <= L <= P <= 4; and no gradient to keep (grad mode off, or no input
    requiring one). Reads only the inputs' device, dtype, shape and
    ``requires_grad``."""
    if w is None:
        return False
    p, l = w.shape[-2:]
    return bool(
        all(t.device.type == "cuda" and t.dtype == torch.complex64
            for t in (h, w))
        and 1 <= l <= p <= _PRECODE_MAX_PORTS
        and not (torch.is_grad_enabled()
                 and any(t.requires_grad for t in (h, w))))


def precode_layout(h):
    """How :func:`precode_channel_cuda`'s kernel walks h [b, rx, rxa, tx,
    P, sym, sc]: sym and sc merged into the columns of a row, b, rx and
    rxa (those of size above 1) each merged into the next inner one where
    the strides allow. Returns the kernel's int64 layout (the columns and
    their stride, the three row sizes innermost first, their strides,
    num_tx and the strides of tx and of the port axis, in complex values),
    or None where sym and sc do not merge."""
    sym, sc = h.shape[-2:]
    if sym > 1 and sc > 1 and h.stride(-2) != sc * h.stride(-1):
        return None
    col = h.stride(-1) if sc > 1 else h.stride(-2) if sym > 1 else 1
    dims = []  # innermost first: [size, stride]
    for d in (2, 1, 0):
        size, stride = h.shape[d], h.stride(d)
        if size == 1:
            continue
        if dims and stride == dims[-1][0] * dims[-1][1]:
            dims[-1][0] *= size
        else:
            dims.append([size, stride])
    dims += [[1, 0]] * (_PRECODE_ROW_DIMS - len(dims))
    return ([sym * sc, col] + [size for size, _ in dims]
            + [stride for _, stride in dims]
            + [h.shape[3], h.stride(3), h.stride(4)])


@traced("pusch.precode_kernel")
def precode_channel_cuda(h, w):
    """:func:`precode_channel` by one launch of the CUDA kernel
    ``csrc/precode_channel.cu`` on the current stream: h [b, rx, rxa, tx,
    P, sym, sc] (any strides) and w [tx, P, L], complex64 on one card, 1 <=
    L <= P <= 4 -> a contiguous complex64 [b, rx, rxa, tx, L, sym, sc]. An
    h whose sym and sc axes do not merge is copied to contiguous first.
    Raises ``ValueError`` on anything the kernel does not take."""
    kern = PRECODE_CHANNEL_KERNEL
    ok = h.dim() == 7 and w.dim() == 3 \
        and w.shape[0] == h.shape[3] and w.shape[1] == h.shape[4] \
        and 1 <= w.shape[2] <= w.shape[1] <= _PRECODE_MAX_PORTS \
        and all(t.dtype == torch.complex64 and t.is_cuda
                and t.device == h.device for t in (h, w))
    if not ok:
        raise ValueError(
            f"{kern.name}: h {h.dtype} {tuple(h.shape)} on {h.device}, w "
            f"{w.dtype} {tuple(w.shape)} on {w.device}: not a layout the "
            f"kernel takes")
    p, l = w.shape[1:]
    out = torch.empty(h.shape[:4] + (l,) + h.shape[5:], dtype=torch.complex64,
                      device=h.device)
    if out.numel() == 0:
        return out
    layout = precode_layout(h)
    if layout is None:
        h = h.contiguous()
        layout = precode_layout(h)
    w = w.contiguous()
    lib = kern.library()
    with torch.cuda.device(h.device):
        err = lib.sionna_precode_channel(
            h.data_ptr(), w.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * len(layout))(*layout), p, l,
            torch.cuda.current_stream().cuda_stream)
    kern.check(err)
    kern.count(f"{p}x{l}")
    return out


class PUSCHReceiver(Block):
    """Full 5G NR PUSCH receive chain: (OFDM demod) -> channel
    estimation -> MIMO detection -> layer demapping -> TB decoding.

    Called with y [batch, num_rx, num_rx_ant, num_ofdm_symbols,
    fft_size] (or [..., num_time_samples] for ``input_domain="time"``),
    the noise variance ``no`` and, for ``channel_estimator="perfect"``,
    the channel ``h``; returns the decoded bits [batch, num_tx, tb_size]
    (and the TB CRC status).
    """

    def __init__(self, pusch_transmitter, channel_estimator=None,
                 mimo_detector=None, tb_decoder=None,
                 return_tb_crc_status=False, stream_management=None,
                 input_domain="freq", l_min=None, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if input_domain not in ("time", "freq"):
            raise ValueError("input_domain must be 'time' or 'freq'")
        dev, prec = self.device, self.precision
        tx = pusch_transmitter
        self._input_domain = input_domain
        self._return_tb_crc_status = bool(return_tb_crc_status)
        self._resource_grid = tx.resource_grid

        if input_domain == "time":
            if l_min is None:
                raise ValueError(
                    "l_min must be provided for input_domain==time")
            self._l_min = l_min
            self._ofdm_demodulator = OFDMDemodulator(
                fft_size=tx._num_subcarriers, l_min=l_min,
                cyclic_prefix_length=tx._cyclic_prefix_length,
                precision=prec, device=dev)

        self._perfect_csi = False
        w = None
        if channel_estimator is None:
            self._channel_estimator = PUSCHLSChannelEstimator(
                self._resource_grid, tx._dmrs_length,
                tx._dmrs_additional_position,
                tx._num_cdm_groups_without_data,
                interpolation_type="lin", precision=prec, device=dev)
        elif channel_estimator == "perfect":
            self._perfect_csi = True
            if tx._precoding == "codebook":
                # [tx, P, L]
                w = tx._precoder._w.to(device=dev, dtype=self.cdtype)
        else:
            self._channel_estimator = channel_estimator
        self.register_buffer("_w", w, persistent=False)

        if stream_management is None:
            rx_tx_association = np.ones([1, tx._num_tx], bool)
            self._stream_management = StreamManagement(
                rx_tx_association, tx._num_layers)
        else:
            self._stream_management = stream_management

        if mimo_detector is None:
            self._mimo_detector = LinearDetector(
                "lmmse", "bit", "maxlog", tx.resource_grid,
                self._stream_management, "qam", tx._num_bits_per_symbol,
                precision=prec, device=dev)
        else:
            self._mimo_detector = mimo_detector

        self._layer_demapper = LayerDemapper(
            tx._layer_mapper, num_bits_per_symbol=tx._num_bits_per_symbol,
            precision=prec, device=dev)
        if tb_decoder is None:
            self._tb_decoder = TBDecoder(tx._tb_encoder, precision=prec,
                                         device=dev)
        else:
            self._tb_decoder = tb_decoder

    @property
    def resource_grid(self):
        return self._resource_grid

    def forward(self, y, no, h=None):
        if self._input_domain == "time":
            y = self._ofdm_demodulator(y)
        if self._perfect_csi:
            if h is None:
                raise ValueError("h must be provided for perfect CSI")
            h = torch.as_tensor(h).to(self.cdtype)
            if self._input_domain == "time":
                h = time_to_ofdm_channel(h, self._resource_grid,
                                         self._l_min)
            if self._w is not None:
                # h: [b, rx, rxa, tx, txa, sym, sc]
                h = precode_channel(h, self._w.to(h.device))
            h_hat = h
            err_var = torch.zeros((1,) * h_hat.dim(), dtype=self.rdtype,
                                  device=h_hat.device)
        else:
            h_hat, err_var = self._channel_estimator(y, no)
        llr = self._mimo_detector(y, h_hat, err_var, no)
        llr = self._layer_demapper(llr)
        b_hat, tb_crc_status = self._tb_decoder(llr)
        if self._return_tb_crc_status:
            return b_hat, tb_crc_status
        return b_hat
