"""MIMO layer mapping per TS 38.211 Sec. 6.3.1.3 / 7.3.1.3 (counterpart
of ``sionna_tpu/phy/nr/layer_mapping.py``): reshapes and transposes on
the input's device."""

import torch

from ..block import Block
from ..utils.tensors import flatten_last_dims, split_dim

__all__ = ["LayerMapper", "LayerDemapper"]


class LayerMapper(Block):
    """Maps modulated symbols to MIMO layers.

    Input [..., n] (or a list of two codewords for >= 5 layers) ->
    [..., num_layers, n / num_layers].
    """

    def __init__(self, num_layers=1, verbose=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if num_layers not in range(1, 9):
            raise ValueError("num_layers must be between 1 and 8.")
        self._num_layers = num_layers
        if num_layers < 5:
            self._num_codewords = 1
        else:
            self._num_codewords = 2
            splits = {5: (2, 3), 6: (3, 3), 7: (3, 4), 8: (4, 4)}
            self._num_layers0, self._num_layers1 = splits[num_layers]
        if verbose:
            print("Number of layers: ", num_layers)

    @property
    def num_codewords(self):
        return self._num_codewords

    @property
    def num_layers(self):
        return self._num_layers

    @property
    def num_layers0(self):
        return self._num_layers if self._num_codewords == 1 \
            else self._num_layers0

    @property
    def num_layers1(self):
        return 0 if self._num_codewords == 1 else self._num_layers1

    @staticmethod
    def _split(x, num_layers):
        """[..., s] -> [..., s / num_layers, num_layers]"""
        return split_dim(x, (x.shape[-1] // num_layers, num_layers),
                         x.dim() - 1)

    def forward(self, inputs):
        if self._num_codewords == 1:
            if inputs.shape[-1] % self._num_layers != 0:
                raise ValueError("Last dimension must be a multiple of "
                                 "num_layers.")
            y = self._split(inputs, self._num_layers)
        else:
            y = torch.cat([self._split(inputs[0], self._num_layers0),
                           self._split(inputs[1], self._num_layers1)],
                          dim=-1)
        return y.transpose(-1, -2)


class LayerDemapper(Block):
    """Reverts layer mapping, grouping LLRs per symbol.

    Input [..., num_layers, n] -> [..., n * num_layers] (or a list of two
    codewords).
    """

    def __init__(self, layer_mapper, num_bits_per_symbol=1,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(layer_mapper, LayerMapper):
            raise TypeError("layer_mapper must be LayerMapper.")
        self._mapper = layer_mapper
        self._num_bits_per_symbol = int(num_bits_per_symbol)

    def forward(self, inputs):
        x = inputs
        if x.shape[-2] != self._mapper.num_layers:
            raise ValueError(
                "Input shape must be [..., num_layers, n].")
        if x.shape[-1] % self._num_bits_per_symbol != 0:
            raise ValueError("Last dimension must be a multiple of "
                             "num_bits_per_symbol.")
        s = x.shape[-1]
        x = split_dim(x, (s // self._num_bits_per_symbol,
                          self._num_bits_per_symbol), x.dim() - 1)
        x = x.transpose(-2, -3)
        if self._mapper.num_codewords == 1:
            return flatten_last_dims(x, 3)
        y0 = flatten_last_dims(x[..., :self._mapper.num_layers0, :], 3)
        y1 = flatten_last_dims(x[..., self._mapper.num_layers0:, :], 3)
        return [y0, y1]
