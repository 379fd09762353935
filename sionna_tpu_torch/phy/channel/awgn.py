"""AWGN channel (counterpart of ``sionna_tpu/phy/channel/awgn.py``)."""

import torch

from ..block import Block
from ..config import config
from ..utils.tensors import expand_to_rank


class AWGN(Block):
    """Adds complex AWGN with variance ``no`` to the input.

    Input: ``(x, no)`` where ``no`` broadcasts to ``x``. The noise comes
    from ``generator`` when given, else from ``config.generator`` of
    ``x``'s device.
    """

    def forward(self, x, no, generator=None):
        x = torch.as_tensor(x).to(self.cdtype)
        if generator is None:
            generator = config.generator(x.device)
        no = torch.as_tensor(no).to(device=x.device, dtype=self.rdtype)
        no = expand_to_rank(no, x.dim(), axis=-1)
        stddev = torch.sqrt(no / 2)
        nr = torch.randn(x.shape, generator=generator, dtype=self.rdtype,
                         device=x.device)
        ni = torch.randn(x.shape, generator=generator, dtype=self.rdtype,
                         device=x.device)
        return x + torch.complex(stddev * nr, stddev * ni)
