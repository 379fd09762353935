"""ChannelModel interface (counterpart of
``sionna_tpu/phy/channel/channel_model.py``).

Contract: ``model(batch_size, num_time_steps, sampling_frequency)``
returns ``(a, tau)`` with
a : [batch, num_rx, num_rx_ant, num_tx, num_tx_ant, num_paths,
     num_time_steps] complex
tau : [batch, num_rx, num_tx, num_paths] float.

Models take an optional ``generator=`` (a ``torch.Generator``) where the
JAX package takes ``key=``, and ``device=`` for where to draw.
"""

from abc import abstractmethod

from ..block import Object


class ChannelModel(Object):
    """Abstract channel model emitting channel impulse responses."""

    @abstractmethod
    def __call__(self, batch_size, num_time_steps, sampling_frequency,
                 **kwargs):
        ...
