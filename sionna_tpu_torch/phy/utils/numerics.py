"""Root finding (counterpart of ``sionna_tpu/phy/utils/numerics.py``),
used by the SYS downlink fair power control."""

import torch

from .misc import _rdtype


def expand_bound(f, bound, expansion_factor=2.0, side="upper",
                 max_n_iter=100, precision=None, **kwargs):
    """Expands ``bound`` geometrically until ``f`` changes sign.

    For side="upper", finds b such that f(b) <= 0; for side="lower",
    finds b such that f(b) >= 0 (element-wise over a batch).

    The JAX package loops in a ``while_loop`` on the device. Here the
    loop's condition is read on the host once per expansion step (one
    device sync each): power control calls this once per slot, and a
    bound that already holds costs one evaluation of ``f`` and one read.
    """
    bound = torch.as_tensor(bound).to(_rdtype(precision))
    sign = 1.0 if side == "upper" else -1.0
    for _ in range(max_n_iter):
        outside = sign * f(bound, **kwargs) > 0
        if not bool(outside.any()):
            break
        bound = torch.where(outside, bound * expansion_factor, bound)
    return bound


def bisection_method(f, left, right, regula_falsi=False, expand_to_left=True,
                     expand_to_right=True, step_expand=2.0, eps_x=1e-5,
                     eps_y=1e-4, max_n_iter=100, return_brackets=False,
                     precision=None, **kwargs):
    """Bisection root finding of a batch of monotonically decreasing
    functions ``f`` on intervals [left, right]: ``max_n_iter`` steps,
    each element frozen once its bracket is narrower than ``eps_x`` or
    ``|f|`` at its midpoint below ``eps_y``.

    Returns (x_opt, f(x_opt)) (and the brackets if requested).
    """
    rdtype = _rdtype(precision)
    left = torch.as_tensor(left).to(rdtype)
    right = torch.as_tensor(right).to(device=left.device, dtype=rdtype)
    left, right = torch.broadcast_tensors(left, right)

    if expand_to_right:
        right = expand_bound(f, right, step_expand, side="upper",
                             max_n_iter=max_n_iter, precision=precision,
                             **kwargs)
    if expand_to_left:
        left = expand_bound(f, left, step_expand, side="lower",
                            max_n_iter=max_n_iter, precision=precision,
                            **kwargs)

    for _ in range(max_n_iter):
        if regula_falsi:
            fl = f(left, **kwargs)
            fr = f(right, **kwargs)
            denom = torch.where(torch.abs(fl - fr) < 1e-30,
                                torch.full_like(fl, 1e-30), fl - fr)
            m = left + fl * (right - left) / denom
        else:
            m = 0.5 * (left + right)
        fm = f(m, **kwargs)
        # f decreasing: the root lies right of m iff fm > 0
        done = (torch.abs(right - left) < eps_x) | (torch.abs(fm) < eps_y)
        go_right = (fm > 0) & ~done
        go_left = (fm <= 0) & ~done
        left = torch.where(go_right, m, left)
        right = torch.where(go_left, m, right)
    x_opt = 0.5 * (left + right)
    f_opt = f(x_opt, **kwargs)
    if return_brackets:
        return x_opt, f_opt, left, right
    return x_opt, f_opt
