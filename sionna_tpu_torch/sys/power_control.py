"""Transmit power control (counterpart of
``sionna_tpu/sys/power_control.py``). The downlink fair allocation
solves its KKT conditions with the batched ``bisection_method``."""

import torch

from ..phy.utils.misc import (_rdtype, scalar_to_shaped_tensor, lin_to_db,
                              dbm_to_watt)
from ..phy.utils.numerics import bisection_method

__all__ = ["open_loop_uplink_power_control",
           "downlink_fair_power_control"]


def open_loop_uplink_power_control(pathloss,
                                   num_allocated_subcarriers,
                                   alpha=1., p0_dbm=-90.,
                                   ut_max_power_dbm=26.,
                                   precision=None):
    """Open-loop uplink power control per TS 38.213 Sec. 7.1.1:
    P = min{P0 + alpha*PL + 10 log10(#PRB), Pmax} [dBm]. Returns the
    power [W] per user, on ``pathloss``'s device."""
    rdtype = _rdtype(precision)
    pathloss = torch.as_tensor(pathloss).to(rdtype)
    dev = pathloss.device

    def t(x):
        return torch.as_tensor(x).to(device=dev, dtype=rdtype)

    pathloss_db = lin_to_db(pathloss, precision=precision)
    num_prb = torch.ceil(t(num_allocated_subcarriers) / 12.)
    tx_power = torch.where(
        num_prb > 0,
        dbm_to_watt(t(p0_dbm) + t(alpha) * pathloss_db
                    + lin_to_db(torch.clamp_min(num_prb, 1.),
                                precision=precision),
                    precision=precision),
        torch.zeros((), dtype=rdtype, device=dev))
    return torch.minimum(tx_power, dbm_to_watt(t(ut_max_power_dbm),
                                               precision=precision))


def downlink_fair_power_control(pathloss, interference_plus_noise,
                                num_allocated_re,
                                bs_max_power_dbm=56.,
                                guaranteed_power_ratio=0.5,
                                fairness=0., return_lagrangian=False,
                                precision=None, **kwargs):
    """Fair downlink power allocation maximizing sum g^(f)(r log(1 +
    p q)) under a total-power budget and a per-user guaranteed power.

    Returns (tx_power [..., num_ut] in Watt, utility [..., num_ut]
    [, mu_inv_star]), on ``pathloss``'s device."""
    rdtype = _rdtype(precision)
    pathloss = torch.as_tensor(pathloss).to(rdtype)
    dev = pathloss.device
    batch_size, num_ut = tuple(pathloss.shape[:-1]), pathloss.shape[-1]
    fairness = float(fairness)
    if fairness < 0:
        raise ValueError("fairness parameter must be non-negative")
    if not 0. <= guaranteed_power_ratio <= 1.:
        raise ValueError("guaranteed_power_ratio must be in [0;1]")

    num_allocated_re = scalar_to_shaped_tensor(
        num_allocated_re, rdtype, batch_size + (num_ut,), dev).to(dev)
    interference_plus_noise = torch.as_tensor(
        interference_plus_noise).to(device=dev, dtype=rdtype)
    zero = torch.zeros((), dtype=rdtype, device=dev)
    max_power_bs = dbm_to_watt(torch.full((), float(bs_max_power_dbm),
                                          dtype=rdtype, device=dev)
                               if not isinstance(bs_max_power_dbm,
                                                 torch.Tensor)
                               else bs_max_power_dbm, precision=precision)
    max_power_bs = scalar_to_shaped_tensor(max_power_bs, rdtype,
                                           batch_size, dev)
    max_power_bs = torch.where(torch.sum(num_allocated_re, dim=-1) > 0,
                               max_power_bs, zero)

    # per-resource power bounds
    num_scheduled = torch.sum((num_allocated_re > 0).to(rdtype), dim=-1)
    p_left = (guaranteed_power_ratio * max_power_bs
              / torch.clamp_min(num_scheduled, 1.))[..., None]
    safe_re = torch.clamp_min(num_allocated_re, 1.)
    p_left = torch.where(num_allocated_re > 0, p_left / safe_re, zero)
    p_right = torch.where(num_allocated_re > 0,
                          max_power_bs[..., None] / safe_re, zero)

    # channel quality q = 1 / (PL * (I+N))
    cq = 1. / (pathloss * interference_plus_noise)

    def kkt_fun(p, mu_inv, cq, num_resources):
        if fairness == 0:
            return cq * mu_inv[..., None] - (1. + p * cq)
        log_pow = torch.pow(num_resources * torch.log(1. + p * cq),
                            fairness)
        return cq * mu_inv[..., None] - log_pow * (1. + p * cq)

    def get_p_star_mu(mu_inv):
        if fairness == 0:
            return torch.maximum(mu_inv[..., None] - 1. / cq, p_left)
        p_star, _ = bisection_method(
            kkt_fun, p_left, p_right, expand_to_right=False,
            expand_to_left=False, regula_falsi=False, mu_inv=mu_inv,
            cq=cq, num_resources=num_allocated_re,
            precision=precision, **kwargs)
        return p_star

    def constraint_slackness(mu_inv):
        p_star = get_p_star_mu(mu_inv)
        return max_power_bs - torch.sum(num_allocated_re * p_star, dim=-1)

    mu_inv_left = torch.zeros(batch_size, dtype=rdtype, device=dev)
    mu_inv_right = torch.full(batch_size, 1000., dtype=rdtype, device=dev)
    mu_inv_star, _ = bisection_method(
        constraint_slackness, mu_inv_left, mu_inv_right,
        expand_to_right=True, expand_to_left=False,
        regula_falsi=False, precision=precision, **kwargs)

    p_star = get_p_star_mu(mu_inv_star)
    # total power per user across its resources; the utility is
    # r log(1 + P q) of that total, as the reference computes it
    tx_power = p_star * num_allocated_re
    utility = num_allocated_re * torch.log(1. + tx_power * cq)

    if return_lagrangian:
        return tx_power, utility, mu_inv_star
    return tx_power, utility
