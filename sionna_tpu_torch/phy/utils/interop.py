"""Loads state exported from the JAX package into the port's blocks.

The JAX package keeps its parameters as arrays on its blocks (the raw
``Constellation`` points). ``load_numpy_state`` copies such arrays,
exported as NumPy, into the matching parameters of a torch block.
Structure that the port rebuilds itself from the same sources (an LDPC
code's base matrix, lifting size, edge list and edge masks; the Kronecker
pilots and pilot mask; a TDL model's delays and powers) is checked for
equality instead of overwritten.

Names are the port's dotted module paths: ``"raw_points"`` on a
``Constellation``, ``"constellation.raw_points"`` on a ``Mapper`` or
``Demapper``; ``"bm"``/``"z"`` on an ``LDPC5GEncoder``; on an
``LDPC5GDecoder`` ``"encoder.bm"``, ``"encoder.z"``, ``"lifted.edges"``
(rows ``(r, c, s mod Z)``) and ``"lifted.edge_mask"``; on a
``ResourceGridMapper`` ``"pilot_pattern.mask"`` and
``"pilot_pattern.pilots"``; on an ``OFDMChannel`` with a TDL model
``"gen.channel_model.delays"`` (normalised), ``".mean_powers"`` (diffuse
cluster powers) and, for LoS models, ``".los_power"``; on a
``Polar5GEncoder`` ``"frozen_pos"``, ``"ind_rate_matching"``,
``"ind_input_int"`` (downlink) and ``"enc_crc.parity_matrix"``; on a
``CRCEncoder`` ``"parity_matrix"`` (of the last length encoded); on a
``ConvEncoder`` or a Viterbi/BCJR decoder ``"trellis.<table>"`` (the
``Trellis`` tables ``to_nodes``, ``from_nodes``, ``op_mat``,
``ip_by_tonode``, ``op_by_tonode``, ``op_by_fromnode``,
``op_bits_by_fromnode``); on a ``TurboEncoder``
``"internal_interleaver.perm"`` (of the last frame size) and
``"convencoder.trellis.<table>"``; on a ``CDL`` ``"delays"``
(normalised), ``"powers"``, ``"aoa"``/``"aod"``/``"zoa"``/``"zod"`` (the
ray angles at this link's ends), ``"xpr"``, ``"k_factor"``, for LoS
models ``"los_aoa"``/``"los_aod"``/``"los_zoa"``/``"los_zod"``, and
``"tx_array.ant_pos"``/``"rx_array.ant_pos"`` (with
``".ant_ind_pol1"``/``".ant_ind_pol2"``), under ``"gen.channel_model."``
in an ``OFDMChannel``; on an ``AntennaArray`` (or ``PanelArray``)
``"ant_pos"``, ``"ant_ind_pol1"`` and ``"ant_ind_pol2"``. Objects that
are not modules (a ``PilotPattern``, a ``TDL``, a ``CDL``, an antenna
array, a ``Trellis``) take the same names without the prefix. The
CDL, the antenna arrays, the precoders and the MIMO detectors have no
trainable parameters.
"""

import numpy as np
import torch
from torch import nn

__all__ = ["load_numpy_state"]


def _structure(block):
    """Dotted name -> NumPy array of every checked structure entry."""
    out = {}
    mods = block.named_modules() if isinstance(block, nn.Module) \
        else [("", block)]
    for prefix, mod in mods:
        if hasattr(mod, "numpy_structure"):
            for k, v in mod.numpy_structure().items():
                out[f"{prefix}.{k}" if prefix else k] = v
    return out


def load_numpy_state(block, arrays):
    """Loads ``arrays`` (dict of name -> ``np.ndarray``) into ``block``.

    Parameters are overwritten in place (same shape, cast to the
    parameter's dtype, on its device); structure entries must be equal.
    Raises ``KeyError`` for an unknown name and ``ValueError`` for a
    shape or structure mismatch.
    """
    params = dict(block.named_parameters()) \
        if isinstance(block, nn.Module) else {}
    structure = _structure(block)
    for name, value in arrays.items():
        value = np.asarray(value)
        if name in params:
            p = params[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {value.shape} does not "
                                 f"match {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.as_tensor(value).to(device=p.device,
                                                  dtype=p.dtype))
        elif name in structure:
            mine = np.asarray(structure[name])
            if mine.shape != value.shape or not np.array_equal(mine, value):
                raise ValueError(f"{name}: the exported structure differs "
                                 "from the one this block built")
        else:
            raise KeyError(f"{name}: no such parameter or structure entry "
                           f"(known: {sorted(params) + sorted(structure)})")
