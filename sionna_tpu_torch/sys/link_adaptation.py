"""Link adaptation (counterpart of ``sionna_tpu/sys/link_adaptation.py``).

ILLA scans every MCS at once through the PHY abstraction. OLLA keeps its
SINR offset and last effective SINR as tensors on its device; its eager
call checks the HARQ feedback (one read of the device), and its
functional ``init_state``/``step`` is the slot loop's form, which reads
nothing back.
"""

import numpy as np
import torch

from ..phy.block import Block
from ..phy.utils.misc import scalar_to_shaped_tensor
from ..phy.utils.tensors import find_true_position, tensor_values_are_in_set
from .utils import is_scheduled_in_slot

__all__ = ["InnerLoopLinkAdaptation", "OuterLoopLinkAdaptation"]


class InnerLoopLinkAdaptation(Block):
    """Inner-loop link adaptation (ILLA): the highest MCS with TBLER <=
    ``bler_target``."""

    def __init__(self, phy_abstraction, bler_target=0.1,
                 fill_mcs_value=0):
        super().__init__(precision=phy_abstraction.precision,
                         device=phy_abstraction.device)
        self._phy_abstraction = phy_abstraction
        self._fill_mcs_value = int(fill_mcs_value)
        self.bler_target = bler_target

    @property
    def bler_target(self):
        return self._bler_target

    @bler_target.setter
    def bler_target(self, value):
        self._bler_target = float(value)

    def forward(self, sinr=None, sinr_eff=None, num_allocated_re=None,
                mcs_table_index=1, mcs_category=0,
                return_lowest_available_mcs=False, **kwargs):
        if not ((sinr is not None)
                ^ ((sinr_eff is not None)
                   and (num_allocated_re is not None))):
            raise ValueError(
                "Either 'sinr' or ('sinr_eff','num_allocated_re') is "
                "required as input")

        num_mcs = self._phy_abstraction.bler_table_interp.shape[2]
        ut_is_scheduled = is_scheduled_in_slot(
            sinr=sinr, num_allocated_re=num_allocated_re)
        dev = self.device
        if sinr is not None:
            sinr = sinr.to(self.rdtype)
            batch_dims = tuple(sinr.shape[:-4])
            num_ut = sinr.shape[-2]
        else:
            sinr_eff = torch.as_tensor(sinr_eff).to(self.rdtype)
            batch_dims = tuple(sinr_eff.shape[:-1])
            num_ut = sinr_eff.shape[-1]
        nb = len(batch_dims)
        tiled = batch_dims + (num_mcs, num_ut)

        # every input tiled along a new MCS axis at -2 (before num_ut)
        mcs_index_all = torch.arange(num_mcs, dtype=torch.int32,
                                     device=dev)[:, None].expand(tiled)
        i32 = torch.int32
        mcs_table_index = scalar_to_shaped_tensor(
            mcs_table_index, i32, batch_dims + (num_ut,), dev)
        mcs_table_index = mcs_table_index[..., None, :].expand(tiled)
        mcs_category = scalar_to_shaped_tensor(
            mcs_category, i32, batch_dims + (num_ut,), dev)
        mcs_category = mcs_category[..., None, :].expand(tiled)
        if num_allocated_re is not None:
            num_allocated_re = torch.as_tensor(num_allocated_re).to(i32)
            num_allocated_re = num_allocated_re[..., None, :].expand(tiled)
        if sinr is not None:
            sinr = sinr[..., None, :, :, :, :].expand(
                batch_dims + (num_mcs,) + tuple(sinr.shape[nb:]))
        else:
            sinr_eff = sinr_eff[..., None, :].expand(tiled)

        *_, tbler_per_mcs, _ = self._phy_abstraction(
            mcs_index_all, sinr=sinr, sinr_eff=sinr_eff,
            num_allocated_re=num_allocated_re,
            mcs_table_index=mcs_table_index, mcs_category=mcs_category,
            check_mcs_index_validity=False)

        # the highest MCS with TBLER <= target (-1 if none)
        mcs_index = find_true_position(tbler_per_mcs <= self.bler_target,
                                       side="last", axis=-2)
        lowest_available = find_true_position(
            (tbler_per_mcs >= 0) & (tbler_per_mcs <= 1), side="first",
            axis=-2)
        mcs_index = torch.where(mcs_index != -1, mcs_index,
                                lowest_available)
        mcs_index = torch.where(ut_is_scheduled, mcs_index,
                                torch.full_like(mcs_index,
                                                self._fill_mcs_value))
        if return_lowest_available_mcs:
            return mcs_index, lowest_available
        return mcs_index


class OuterLoopLinkAdaptation(Block):
    """Outer-loop link adaptation (OLLA): ILLA on the effective SINR
    lowered by an offset that the HARQ feedback walks up on a NACK and
    down on an ACK [Pedersen05]/[Sampath97]. The state lives on the
    PHY abstraction's device."""

    def __init__(self, phy_abstraction, num_ut, bler_target=0.1,
                 delta_up=1., batch_size=None, sinr_eff_init=1.,
                 sinr_eff_init_fill=1., offset_min=-20.,
                 offset_max=20.):
        super().__init__(precision=phy_abstraction.precision,
                         device=phy_abstraction.device)
        if sinr_eff_init_fill <= 0:
            raise ValueError("'sinr_eff_init_fill' must be positive")
        if batch_size is None:
            batch_size = []
        elif isinstance(batch_size, int):
            batch_size = [batch_size]
        else:
            batch_size = list(batch_size)

        self._batch_size = batch_size
        self._num_ut = int(num_ut)
        self._phy_abstraction = phy_abstraction
        self._illa = InnerLoopLinkAdaptation(phy_abstraction,
                                             bler_target=bler_target)
        self._bler_target = float(bler_target)
        self._delta_up = float(delta_up)
        self._offset_min = float(offset_min)
        self._offset_max = float(offset_max)
        self.reset(sinr_eff_init, sinr_eff_init_fill)

    def reset(self, sinr_eff_init=1., sinr_eff_init_fill=.1):
        """Resets ``sinr_eff_db_last`` and ``offset`` (computed on the
        host in NumPy as in the JAX package, then copied)."""
        shape = tuple(self._batch_size) + (self._num_ut,)
        if isinstance(sinr_eff_init, torch.Tensor):
            sinr_eff_init = sinr_eff_init.cpu().numpy()
        sinr_eff_init = np.broadcast_to(
            np.asarray(sinr_eff_init, self.np_rdtype), shape)
        db_last = np.where(
            sinr_eff_init > 0,
            10. * np.log10(np.maximum(sinr_eff_init, 1e-30)),
            10. * np.log10(sinr_eff_init_fill)).astype(self.np_rdtype)
        self._sinr_eff_db_last = torch.as_tensor(db_last, device=self.device)
        self._offset = torch.zeros(shape, dtype=self.rdtype,
                                   device=self.device)

    @property
    def offset(self):
        """[..., num_ut] current SINR offset [dB]"""
        return self._offset

    @property
    def offset_min(self):
        return self._offset_min

    @offset_min.setter
    def offset_min(self, value):
        self._offset_min = float(value)

    @property
    def offset_max(self):
        return self._offset_max

    @offset_max.setter
    def offset_max(self, value):
        self._offset_max = float(value)

    @property
    def bler_target(self):
        return self._bler_target

    @bler_target.setter
    def bler_target(self, value):
        self._bler_target = float(value)
        self._illa.bler_target = float(value)

    @property
    def sinr_eff_db_last(self):
        """[..., num_ut] last observed effective SINR [dB]"""
        return self._sinr_eff_db_last

    @sinr_eff_db_last.setter
    def sinr_eff_db_last(self, value):
        self._sinr_eff_db_last = torch.as_tensor(value).to(
            device=self.device, dtype=self.rdtype)

    @property
    def delta_up(self):
        return self._delta_up

    @delta_up.setter
    def delta_up(self, value):
        if value <= 0:
            raise ValueError("'delta_up' must be positive")
        self._delta_up = float(value)

    @property
    def delta_down(self):
        """delta_up * bler_target / (1 - bler_target)"""
        return (self._delta_up * self._bler_target
                / (1. - self._bler_target))

    def forward(self, num_allocated_re, harq_feedback=None, sinr_eff=None,
                mcs_table_index=1, mcs_category=0):
        num_allocated_re = torch.as_tensor(num_allocated_re,
                                           device=self.device)
        if harq_feedback is not None:
            harq_feedback = torch.as_tensor(harq_feedback,
                                            device=self.device)
            if not bool(tensor_values_are_in_set(harq_feedback,
                                                 [-1, 0, 1])):
                raise ValueError("'harq_feedback' must contain values in "
                                 "[-1 (N/A), 0 (NACK), 1 (ACK)]")
        state, mcs = self.step(
            (self._offset, self._sinr_eff_db_last), num_allocated_re,
            harq_feedback=harq_feedback, sinr_eff=sinr_eff,
            mcs_table_index=mcs_table_index, mcs_category=mcs_category)
        self._offset, self._sinr_eff_db_last = state
        return mcs

    # ------------------------------------------------------------------
    # Functional API
    # ------------------------------------------------------------------
    def init_state(self):
        """The OLLA state for :meth:`step`: ``(offset [..., num_ut],
        sinr_eff_db_last [..., num_ut])``, copies of the current state
        (so ``reset`` and ``sinr_eff_db_last=...`` still set it)."""
        return self._offset.clone(), self._sinr_eff_db_last.clone()

    def step(self, state, num_allocated_re, harq_feedback=None,
             sinr_eff=None, mcs_table_index=1, mcs_category=0):
        """One OLLA slot update as a function of ``state``: the same
        offset update, SINR tracking and ILLA search as the eager call,
        with no value check and nothing read back.

        state : ``(offset, sinr_eff_db_last)`` from :meth:`init_state`
            or a previous ``step``.
        harq_feedback : [..., num_ut] in {-1 (N/A), 0 (NACK), 1 (ACK)}.

        Returns ``((offset, sinr_eff_db_last), mcs_index)``.
        """
        offset, sinr_db_last = state
        n_re = torch.as_tensor(num_allocated_re).to(torch.int32)
        if harq_feedback is not None:
            harq_feedback = torch.as_tensor(harq_feedback)
            offset = torch.where(
                harq_feedback == 1, offset - self.delta_down,
                torch.where(harq_feedback == 0, offset + self._delta_up,
                            offset))
        offset = torch.clamp(offset, self._offset_min, self._offset_max)

        if sinr_eff is not None:
            sinr_eff = torch.as_tensor(sinr_eff).to(self.rdtype)
            sinr_db_last = torch.where(
                sinr_eff > 0,
                10. * torch.log10(torch.clamp_min(sinr_eff, 1e-30)),
                sinr_db_last)

        sinr_eff_offset = torch.pow(10., (sinr_db_last - offset) / 10.)
        mcs = self._illa(sinr_eff=sinr_eff_offset, num_allocated_re=n_re,
                         mcs_table_index=mcs_table_index,
                         mcs_category=mcs_category)
        return (offset, sinr_db_last), mcs
