"""Scheduling (counterpart of ``sionna_tpu/sys/scheduling.py``)."""

import torch

from ..phy.block import Block

__all__ = ["PFSchedulerSUMIMO"]


class PFSchedulerSUMIMO(Block):
    """Proportional-fairness scheduler for SU-MIMO: each time-frequency
    resource goes to the user maximizing achievable_rate /
    discounted_past_rate (the first such user on ties). Its state lives
    on the block's device.

    Call: (rate_last_slot [batch, num_ut],
    rate_achievable_curr_slot [batch, num_ofdm_sym, num_freq_res,
    num_ut]) -> is_scheduled [batch, num_ofdm_sym, num_freq_res,
    num_ut, num_streams_per_ut] bool.
    """

    def __init__(self, num_ut, num_freq_res, num_ofdm_sym,
                 batch_size=None, num_streams_per_ut=1, beta=.98,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if batch_size is None:
            batch_size = []
        elif isinstance(batch_size, int):
            batch_size = [batch_size]
        else:
            batch_size = list(batch_size)
        self._batch_size = batch_size
        self._num_ut = int(num_ut)
        self._num_freq_res = int(num_freq_res)
        self._num_ofdm_sym = int(num_ofdm_sym)
        self._num_streams_per_ut = int(num_streams_per_ut)
        self.beta = beta
        self._rate_achieved_past = torch.ones(
            batch_size + [num_ut], dtype=self.rdtype, device=self.device)
        self._pf_metric = torch.zeros(
            batch_size + [num_ofdm_sym, num_freq_res, num_ut],
            dtype=self.rdtype, device=self.device)

    @property
    def rate_achieved_past(self):
        """[batch, num_ut] beta-discounted average achieved rate"""
        return self._rate_achieved_past

    @property
    def pf_metric(self):
        """[batch, sym, freq_res, num_ut] last-slot PF metric"""
        return self._pf_metric

    @property
    def beta(self):
        return self._beta

    @beta.setter
    def beta(self, value):
        if not 0. < value < 1.:
            raise ValueError(
                "Discount factor 'beta' must be within (0;1)")
        self._beta = float(value)

    def forward(self, rate_last_slot, rate_achievable_curr_slot):
        rate_last_slot = torch.as_tensor(rate_last_slot).to(self.rdtype)
        rate_achievable = torch.as_tensor(rate_achievable_curr_slot).to(
            self.rdtype)
        expected_last = tuple(self._batch_size) + (self._num_ut,)
        if tuple(rate_last_slot.shape) != expected_last:
            raise ValueError("Inconsistent 'rate_last_slot' shape")
        expected_ach = tuple(self._batch_size) + (
            self._num_ofdm_sym, self._num_freq_res, self._num_ut)
        if tuple(rate_achievable.shape) != expected_ach:
            raise ValueError(
                "Inconsistent 'rate_achievable_curr_slot' shape")

        # beta-discounted throughput update
        self._rate_achieved_past = (
            self._beta * self._rate_achieved_past
            + (1 - self._beta) * rate_last_slot)
        past = self._rate_achieved_past[..., None, None, :]
        self._pf_metric = rate_achievable / past

        scheduled_ut = torch.argmax(self._pf_metric, dim=-1)
        is_scheduled = scheduled_ut[..., None] == torch.arange(
            self._num_ut, device=scheduled_ut.device)
        return is_scheduled[..., None].expand(
            tuple(is_scheduled.shape) + (self._num_streams_per_ut,))
