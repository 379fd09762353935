"""MIMO utilities (counterpart of ``sionna_tpu/phy/mimo/utils.py``; the
port needs ``whiten_channel``)."""

import torch

from ..utils.linalg import _matmul, inv_cholesky

__all__ = ["whiten_channel"]


def whiten_channel(y, h, s, return_s=True):
    """Whitens y = Hx + n by L^{-1} with S = L L^H."""
    y = torch.as_tensor(y)
    h = torch.as_tensor(h)
    s = torch.as_tensor(s)
    l_inv = inv_cholesky(s)
    yw = _matmul(l_inv, y[..., None])[..., 0]
    hw = _matmul(l_inv, h)
    if return_s:
        sw = torch.eye(s.shape[-1], dtype=s.dtype,
                       device=s.device).expand(s.shape)
        return yw, hw, sw
    return yw, hw
