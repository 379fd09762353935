"""Physical-layer abstraction (counterpart of
``sionna_tpu/sys/phy_abstraction.py``).

The BLER tables are read from the JAX package's JSON files, by path, and
spline-interpolated on the host by SciPy at construction (the JAX
package's code), then held on the block's device. A call is tensor code
on that device: the MCS and transport-block lookups take their tensor
forms (``decode_mcs_index_jit``, ``calculate_cb_size_jit``), the table
lookups are gathers, and the HARQ outcomes come from a
``torch.Generator`` or from ``uniform`` draws passed in; nothing is read
back to the host.
"""

import json
import os
import warnings
from pathlib import Path

import numpy as np
import torch

from ..phy.block import Block
from ..phy.config import config
from ..phy.utils.misc import (DeepUpdateDict, dict_keys_to_int, to_list,
                              Interpolate, MCSDecoder, TransportBlock,
                              SingleLinkChannel,
                              SplineGriddataInterpolation,
                              scalar_to_shaped_tensor)
from ..phy.utils.tensors import gather_from_batched_indices
from ..phy.utils.sim import sim_ber
from ..phy.nr.utils import (MCSDecoderNR, TransportBlockNR,
                            CodedAWGNChannelNR)
from .effective_sinr import EffectiveSINR, EESM

__all__ = ["PHYAbstraction"]

_BLER_DIR = (Path(__file__).resolve().parents[2] / "sionna_tpu" / "sys"
             / "bler_tables")


class PHYAbstraction(Block):
    """Maps per-stream SINR to decoded bits, HARQ feedback and BLER
    through precomputed AWGN BLER tables.

    Call: (mcs_index, sinr=None, sinr_eff=None, num_allocated_re=None,
    mcs_table_index=1, mcs_category=0, check_mcs_index_validity=True,
    generator=None, uniform=None) -> (num_decoded_bits, harq_feedback,
    sinr_eff, tbler, bler). ``uniform`` (the shape of ``tbler``, in
    [0, 1)) replaces the HARQ draw.
    """

    def __init__(self, interp_fun=None, mcs_decoder_fun=None,
                 transport_block_fun=None, sinr_effective_fun=None,
                 load_bler_tables_from="default",
                 snr_db_interp_min_max_delta=(-5, 30.01, .1),
                 cbs_interp_min_max_delta=(24, 8448, 100),
                 bler_interp_delta=0.01, precision=None, device=None,
                 **kwargs):
        super().__init__(precision=precision, device=device)
        device = self.device

        if interp_fun is None:
            interp_fun = SplineGriddataInterpolation()
        if mcs_decoder_fun is None:
            mcs_decoder_fun = MCSDecoderNR(precision=precision,
                                           device=device)
        if transport_block_fun is None:
            transport_block_fun = TransportBlockNR(precision=precision,
                                                   device=device)
        if sinr_effective_fun is None:
            sinr_effective_fun = EESM(precision=precision, device=device)

        if not isinstance(interp_fun, Interpolate):
            raise ValueError("interp_fun must be an Interpolate")
        if not isinstance(mcs_decoder_fun, MCSDecoder):
            raise ValueError("mcs_decoder_fun must be an MCSDecoder")
        if not isinstance(transport_block_fun, TransportBlock):
            raise ValueError(
                "transport_block_fun must be a TransportBlock")
        if not isinstance(sinr_effective_fun, EffectiveSINR):
            raise ValueError(
                "sinr_effective_fun must be an EffectiveSINR")

        self._kwargs = kwargs
        self._bler_table = None
        self._interp_fun = interp_fun
        self._mcs_decoder_fun = mcs_decoder_fun
        self._transport_block_fun = transport_block_fun
        self._sinr_effective_fun = sinr_effective_fun
        self.register_buffer("_bler_table_interp", None, persistent=False)
        self.register_buffer("_snr_table_interp", None, persistent=False)

        self._cbs_interp = None
        self._snr_dbs_interp = None
        self._blers_interp = None

        if load_bler_tables_from == "default":
            names = ["PUSCH_table1.json", "PUSCH_table2.json",
                     "PDSCH_table1.json", "PDSCH_table2.json",
                     "PDSCH_table3.json", "PDSCH_table4.json"]
            self.bler_table_filenames = [str(_BLER_DIR / f) for f in names]
        else:
            self.bler_table_filenames = load_bler_tables_from

        self.snr_db_interp_min_max_delta = snr_db_interp_min_max_delta
        self.cbs_interp_min_max_delta = cbs_interp_min_max_delta
        self.bler_interp_delta = bler_interp_delta

    # ------------------------------------------------------------------
    # Table loading / properties
    # ------------------------------------------------------------------
    @staticmethod
    def load_table(filename):
        """Loads a BLER table stored as JSON."""
        with open(filename, encoding="utf-8") as f:
            return json.load(f, object_hook=dict_keys_to_int)

    @property
    def bler_table_filenames(self):
        return self._bler_table_filenames

    @bler_table_filenames.setter
    def bler_table_filenames(self, value):
        self._bler_table_filenames = to_list(value)
        self._bler_table = DeepUpdateDict({"category": {}})
        for f in self._bler_table_filenames:
            try:
                with open(f, encoding="utf-8") as fh:
                    sub = json.load(fh, object_hook=dict_keys_to_int)
                self._bler_table.deep_update(
                    sub, stop_at_keys=("CBS", "SNR_db"))
            except FileNotFoundError:
                warnings.warn(f"BLER table file '{f}' does not exist. "
                              "Skipping...")
        self.validate_bler_table()

    @property
    def bler_table(self):
        """Nested dict: ['category'][cat]['index'][tab]['MCS'][mcs]
        with 'CBS'/'SNR_db' leaves."""
        return self._bler_table

    @property
    def bler_table_interp(self):
        """[n_cat, n_tables, n_mcs, n_cbs, n_snr] interpolated BLER, on
        the block's device"""
        return self._bler_table_interp

    @property
    def snr_table_interp(self):
        """[n_cat, n_tables, n_mcs, n_cbs, n_bler] interpolated SNR, on
        the block's device"""
        return self._snr_table_interp

    @property
    def snr_db_interp_min_max_delta(self):
        return self._snr_db_interp_min_max_delta

    @snr_db_interp_min_max_delta.setter
    def snr_db_interp_min_max_delta(self, value):
        if not (hasattr(value, "__len__") and len(value) == 3):
            raise ValueError(
                "snr_db_interp_min_max_delta must have length 3")
        self._snr_db_interp_min_max_delta = tuple(value)
        self._snr_dbs_interp = np.arange(*self._snr_db_interp_min_max_delta)
        if self._bler_table is not None and self._cbs_interp is not None:
            self._interpolate_bler()

    @property
    def cbs_interp_min_max_delta(self):
        return self._cbs_interp_min_max_delta

    @cbs_interp_min_max_delta.setter
    def cbs_interp_min_max_delta(self, value):
        if not (hasattr(value, "__len__") and len(value) == 3):
            raise ValueError(
                "cbs_interp_min_max_delta must have length 3")
        self._cbs_interp_min_max_delta = tuple(value)
        self._cbs_interp = np.arange(*self._cbs_interp_min_max_delta)
        if self._bler_table is not None:
            if self._blers_interp is not None:
                self._interpolate_snr()
            if self._snr_dbs_interp is not None:
                self._interpolate_bler()

    @property
    def bler_interp_delta(self):
        return self._bler_interp_delta

    @bler_interp_delta.setter
    def bler_interp_delta(self, value):
        self._bler_interp_delta = float(value)
        self._blers_interp = np.arange(0, 1, self._bler_interp_delta)
        if self._bler_table is not None and self._cbs_interp is not None:
            self._interpolate_snr()

    # ------------------------------------------------------------------
    # Retrieval
    # ------------------------------------------------------------------
    def get_idx_from_grid(self, val, which):
        """Index of SNR [dB] or CBS values in the interpolation grid."""
        if which == "snr":
            len_grid = len(self._snr_dbs_interp)
            mmd = self._snr_db_interp_min_max_delta
        elif which == "cbs":
            len_grid = len(self._cbs_interp)
            mmd = self._cbs_interp_min_max_delta
        else:
            raise ValueError("which must be 'snr' or 'cbs'")
        val = torch.as_tensor(val).to(self.rdtype)
        idx = torch.round((val - mmd[0]) / mmd[2]).to(torch.int32)
        return torch.clamp(idx, 0, len_grid - 1)

    def get_bler(self, mcs_index, mcs_table_index, mcs_category,
                 cb_size, snr_eff):
        """BLER lookup from the interpolated tables."""
        snr_eff = torch.as_tensor(snr_eff).to(self.rdtype)
        shape, dev = snr_eff.shape, snr_eff.device
        i32 = torch.int32
        mcs_category = scalar_to_shaped_tensor(mcs_category, i32, shape, dev)
        mcs_index = scalar_to_shaped_tensor(mcs_index, i32, shape, dev)
        mcs_table_index = scalar_to_shaped_tensor(mcs_table_index, i32,
                                                  shape, dev)
        cb_size = scalar_to_shaped_tensor(cb_size, i32, shape, dev)

        snr_eff_db = 10 * torch.log10(torch.clamp_min(snr_eff, 1e-30))
        snr_db_idx = self.get_idx_from_grid(snr_eff_db, "snr")
        cbs_idx = self.get_idx_from_grid(cb_size, "cbs")

        idx = torch.stack([mcs_category, mcs_table_index - 1, mcs_index,
                           cbs_idx, snr_db_idx], dim=-1)
        return gather_from_batched_indices(self._bler_table_interp, idx)

    def forward(self, mcs_index, sinr=None, sinr_eff=None,
                num_allocated_re=None, mcs_table_index=1, mcs_category=0,
                check_mcs_index_validity=True, generator=None,
                uniform=None, **kwargs):
        if not ((sinr is not None)
                ^ ((sinr_eff is not None)
                   and (num_allocated_re is not None))):
            raise ValueError(
                "Either 'sinr' or ('sinr_eff','num_allocated_re') is "
                "required as input")
        dev = self.device
        if sinr is not None:
            sinr = sinr.to(self.rdtype)
            num_allocated_re = torch.sum((sinr > 0).to(torch.int32),
                                         dim=(-4, -3, -1))
            sinr_eff = self._sinr_effective_fun(
                sinr, mcs_index=mcs_index,
                mcs_table_index=mcs_table_index,
                mcs_category=mcs_category, per_stream=False, **kwargs)
        else:
            sinr_eff = torch.as_tensor(sinr_eff).to(self.rdtype)
            num_allocated_re = torch.as_tensor(num_allocated_re).to(
                torch.int32)

        ut_is_scheduled = num_allocated_re > 0

        # a tensor MCS index takes the decoders' tensor forms on the
        # device; host input their host forms (checked), then copied
        modulation_order, target_coderate = self._mcs_decoder_fun(
            mcs_index, mcs_table_index, mcs_category,
            check_index_validity=check_mcs_index_validity, **kwargs)
        modulation_order = torch.as_tensor(modulation_order, device=dev).to(
            torch.int32)
        target_coderate = torch.as_tensor(target_coderate, device=dev).to(
            self.rdtype)

        num_coded_bits = modulation_order * num_allocated_re
        cb_size, num_cb = self._transport_block_fun(
            modulation_order, target_coderate, num_coded_bits, **kwargs)
        cb_size = torch.as_tensor(cb_size, device=dev).to(torch.int32)
        num_cb = torch.as_tensor(num_cb, device=dev).to(torch.int32)

        bler = self.get_bler(mcs_index, mcs_table_index, mcs_category,
                             cb_size, sinr_eff)
        tbler = 1. - torch.pow(1. - bler, num_cb.to(self.rdtype))

        minus_one = torch.full((), -1., dtype=self.rdtype, device=dev)
        bler = torch.where(ut_is_scheduled, bler, minus_one)
        tbler = torch.where(ut_is_scheduled, tbler, minus_one)

        if uniform is None:
            if generator is None:
                generator = config.generator(dev)
            uniform = torch.rand(tbler.shape, generator=generator,
                                 dtype=self.rdtype, device=dev)
        harq_feedback = (~(uniform < tbler)).to(torch.int32)

        num_decoded_bits = harq_feedback * num_cb * cb_size
        num_decoded_bits = torch.where(ut_is_scheduled, num_decoded_bits,
                                       torch.zeros_like(num_decoded_bits))
        harq_feedback = torch.where(ut_is_scheduled, harq_feedback,
                                    torch.full_like(harq_feedback, -1))
        return num_decoded_bits, harq_feedback, sinr_eff, tbler, bler

    # ------------------------------------------------------------------
    # Interpolation
    # ------------------------------------------------------------------
    def _get_batch_size_interp_mat(self):
        cats = list(self._bler_table["category"].keys())
        max_tab, max_mcs = [], []
        for c in cats:
            tabs = list(self._bler_table["category"][c]["index"].keys())
            max_tab.append(max(tabs))
            for t in tabs:
                mcss = list(self._bler_table["category"][c]["index"][t]
                            ["MCS"].keys())
                max_mcs.append(max(mcss))
        if cats and max_tab and max_mcs:
            return [max(cats) + 1, max(max_tab), max(max_mcs) + 1]
        return [0, 0, 0]

    def _interpolate_bler(self):
        """Interpolates BLER over a fine (CBS, SNR) grid."""
        shape = self._get_batch_size_interp_mat()
        table = np.full(shape + [len(self._cbs_interp),
                                 len(self._snr_dbs_interp)], np.inf)
        for cat, cat_tab in self._bler_table["category"].items():
            for tab, tab_tab in cat_tab["index"].items():
                for mcs, mcs_tab in tab_tab["MCS"].items():
                    cbs_vec = list(mcs_tab["CBS"].keys())
                    snr_vec = mcs_tab["SNR_db"]
                    bler_val = np.array(
                        [mcs_tab["CBS"][c]["BLER"] for c in cbs_vec])
                    try:
                        interp = self._interp_fun.struct(
                            bler_val, cbs_vec, snr_vec,
                            self._cbs_interp, self._snr_dbs_interp,
                            **self._kwargs)
                    except ValueError as e:
                        warnings.warn(
                            f"SINR-to-BLER interpolation failed for "
                            f"category {cat}, index {tab}, MCS {mcs}: "
                            f"{e}")
                        continue
                    table[cat, tab - 1, mcs] = np.clip(
                        np.asarray(interp), 0., 1.)
        self._bler_table_interp = torch.as_tensor(
            table.astype(self.np_rdtype), device=self.device)

    def _interpolate_snr(self):
        """Interpolates SNR over a fine (CBS, BLER) grid."""
        shape = self._get_batch_size_interp_mat()
        table = np.full(shape + [len(self._cbs_interp),
                                 len(self._blers_interp)], np.inf)
        for cat, cat_tab in self._bler_table["category"].items():
            for tab, tab_tab in cat_tab["index"].items():
                for mcs, mcs_tab in tab_tab["MCS"].items():
                    snr_vec = mcs_tab["SNR_db"]
                    cbs_vec = list(mcs_tab["CBS"].keys())
                    snr_tile = np.tile(snr_vec, len(cbs_vec))
                    cbs_rep = np.repeat(cbs_vec, len(snr_vec))
                    bler_vec = [b for c in cbs_vec
                                for b in mcs_tab["CBS"][c]["BLER"]]
                    try:
                        interp = self._interp_fun.unstruct(
                            snr_tile, cbs_rep, bler_vec,
                            self._cbs_interp, self._blers_interp,
                            **self._kwargs)
                    except ValueError as e:
                        warnings.warn(
                            f"BLER-to-SINR interpolation failed for "
                            f"category {cat}, index {tab}, MCS {mcs}: "
                            f"{e}")
                        continue
                    table[cat, tab - 1, mcs] = np.asarray(interp)
        self._snr_table_interp = torch.as_tensor(
            table.astype(self.np_rdtype), device=self.device)

    def validate_bler_table(self):
        """Validates the nested structure of ``bler_table``."""
        if not isinstance(self._bler_table, dict):
            raise ValueError("Must be a dictionary")
        for cat, cat_tab in self._bler_table["category"].items():
            if cat < 0:
                raise ValueError("Categories must be nonnegative")
            if set(cat_tab.keys()) != {"index"}:
                raise ValueError("Key must be 'index'")
            for tab, tab_tab in cat_tab["index"].items():
                if tab < 1:
                    raise ValueError("Table indices must be positive")
                if set(tab_tab.keys()) != {"MCS"}:
                    raise ValueError("Key must be 'MCS'")
                for mcs, mcs_tab in tab_tab["MCS"].items():
                    if mcs < 0:
                        raise ValueError("MCS must be nonnegative")
                    if set(mcs_tab.keys()) != {"CBS", "SNR_db"}:
                        raise ValueError(
                            "Keys must be ['CBS', 'SNR_db']")
        return True

    def plot(self, plot_subset="all", show=True, save_path=None):
        """Plots the SINR-to-BLER tables, one figure per MCS (matplotlib,
        imported here), saving each under ``save_path`` if given; returns
        the saved files' names."""
        import matplotlib.pyplot as plt
        fignames = []
        if plot_subset == "all":
            plot_subset = self._bler_table
        for cat, cat_tab in plot_subset["category"].items():
            for tab, tab_tab in cat_tab["index"].items():
                for mcs in to_list(tab_tab["MCS"]):
                    try:
                        mcs_tab = self._bler_table["category"][cat][
                            "index"][tab]["MCS"][mcs]
                    except KeyError:
                        continue
                    fig, ax = plt.subplots()
                    for cbs, leaf in mcs_tab["CBS"].items():
                        ax.semilogy(mcs_tab["SNR_db"], leaf["BLER"],
                                    label=f"code block size={cbs}")
                    ax.set_title(f"MCS {mcs} (category {cat}, "
                                 f"table {tab})")
                    ax.legend()
                    ax.grid(True)
                    ax.set_xlabel("SNR [dB]")
                    ax.set_ylabel("BLER")
                    if save_path is not None:
                        os.makedirs(save_path, exist_ok=True)
                        name = os.path.join(
                            save_path,
                            f"category{cat}_table{tab}_mcs{mcs}.png")
                        fig.savefig(name)
                        fignames.append(name)
                    if show:
                        plt.show()
                    plt.close(fig)
        return fignames

    def new_bler_table(self, snr_dbs, cb_sizes, sim_set, channel=None,
                       filename=None, write_mode="w", batch_size=1000,
                       max_mc_iter=100, target_bler=None,
                       early_stop=True, verbose=True, **kwargs):
        """Monte-Carlo generation of new SNR->BLER tables through
        :func:`~sionna_tpu_torch.phy.utils.sim_ber` over ``channel``
        (default :class:`CodedAWGNChannelNR` on the block's device: its
        decoder runs kernel K1 on the card). The result is merged into
        ``bler_table``."""
        if channel is None:
            channel = CodedAWGNChannelNR(precision=self.precision,
                                         device=self.device)
        if not isinstance(channel, SingleLinkChannel):
            raise ValueError("'channel' must be a SingleLinkChannel")
        if write_mode not in ("a", "w"):
            raise ValueError("'write_mode' must be 'a' or 'w'")

        snr_dbs = to_list(snr_dbs)
        cb_sizes = to_list(cb_sizes)

        if (filename is not None and os.path.isfile(filename)
                and write_mode == "a"):
            new_table = self.load_table(filename)
        else:
            new_table = {"category": {}}

        for cat, sim_cat in sim_set["category"].items():
            new_table["category"].setdefault(cat, {"index": {}})
            for tab, sim_tab in sim_cat["index"].items():
                new_table["category"][cat]["index"].setdefault(
                    tab, {"MCS": {}})
                for mcs in sim_tab["MCS"]:
                    try:
                        mod, rate = self._mcs_decoder_fun(
                            mcs, tab, cat, **self._kwargs)
                        mod = int(np.asarray(mod))
                        rate = float(np.asarray(rate))
                    except ValueError as e:
                        if verbose:
                            print(f"Invalid (category={cat}, "
                                  f"index={tab}, MCS={mcs}): {e}; "
                                  "skipping")
                        continue
                    ebno_dbs = [s - 10 * np.log10(mod * rate)
                                for s in snr_dbs]
                    mcs_entry = None
                    for cbs in cb_sizes:
                        if verbose:
                            print(f"Simulating category={cat}, "
                                  f"index={tab}, CBS={cbs}, MCS={mcs}")
                        try:
                            channel.num_bits_per_symbol = mod
                            channel.num_info_bits = int(cbs)
                            channel.target_coderate = rate
                            _, bler = sim_ber(
                                channel, ebno_dbs, batch_size,
                                max_mc_iter=max_mc_iter,
                                early_stop=early_stop,
                                target_bler=target_bler,
                                verbose=verbose,
                                precision=self.precision, **kwargs)
                            if mcs_entry is None:
                                mcs_entry = {"CBS": {},
                                             "SNR_db": snr_dbs}
                                new_table["category"][cat]["index"][
                                    tab]["MCS"][mcs] = mcs_entry
                            mcs_entry["CBS"][int(cbs)] = {
                                "BLER": np.asarray(bler).tolist()}
                            if filename is not None:
                                with open(filename, "w",
                                          encoding="utf-8") as f:
                                    json.dump(new_table, f, indent=6)
                        except ValueError as e:
                            if verbose:
                                print(f"Simulation failed for "
                                      f"(category={cat}, index={tab}, "
                                      f"CBS={cbs}, MCS={mcs}): {e}")

        self._bler_table.deep_update(new_table,
                                     stop_at_keys=("CBS", "SNR_db"))
        self.validate_bler_table()
        self._interpolate_bler()
        self._interpolate_snr()
        if filename is not None:
            self._bler_table_filenames.append(filename)
        return new_table
