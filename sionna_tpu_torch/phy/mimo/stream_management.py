"""Stream management bookkeeping (counterpart of
``sionna_tpu/phy/mimo/stream_management.py``).

Pure host-side NumPy: static index maps used by the detection path.
"""

import numpy as np

from ..block import Object

__all__ = ["StreamManagement"]


class StreamManagement(Object):
    """Static association between receivers, transmitters, and streams.

    ``rx_tx_association[i, j] = 1`` means receiver i receives at least
    one stream from transmitter j. All row sums and column sums must be
    equal (symmetric load).
    """

    def __init__(self, rx_tx_association, num_streams_per_tx):
        super().__init__()
        self._num_streams_per_tx = int(num_streams_per_tx)
        self.rx_tx_association = rx_tx_association

    @property
    def rx_tx_association(self):
        return self._rx_tx_association

    @property
    def num_rx(self):
        return self._num_rx

    @property
    def num_tx(self):
        return self._num_tx

    @property
    def num_streams_per_tx(self):
        return self._num_streams_per_tx

    @property
    def num_streams_per_rx(self):
        return int(self.num_tx * self.num_streams_per_tx / self.num_rx)

    @property
    def num_interfering_streams_per_rx(self):
        return int(self.num_tx * self.num_streams_per_tx
                   - self.num_streams_per_rx)

    @property
    def num_tx_per_rx(self):
        return self._num_tx_per_rx

    @property
    def num_rx_per_tx(self):
        return self._num_rx_per_tx

    @property
    def precoding_ind(self):
        """[num_tx, num_rx_per_tx]: receivers served by each tx."""
        return self._precoding_ind

    @property
    def stream_association(self):
        """[num_rx, num_tx, num_streams_per_tx] binary association."""
        return self._stream_association

    @property
    def detection_desired_ind(self):
        """Gather indices of desired channels from a tensor flattened
        over [num_rx, num_tx, num_streams_per_tx]."""
        return self._detection_desired_ind

    @property
    def detection_undesired_ind(self):
        return self._detection_undesired_ind

    @property
    def tx_stream_ids(self):
        return self._tx_stream_ids

    @property
    def rx_stream_ids(self):
        return self._rx_stream_ids

    @property
    def stream_ind(self):
        """Gather indices reordering flattened rx streams to
        [num_tx, num_streams_per_tx] order."""
        return self._stream_ind

    @rx_tx_association.setter
    def rx_tx_association(self, rx_tx_association):
        a = np.array(rx_tx_association, np.int32)
        if not np.all(np.isin(a, [0, 1])):
            raise ValueError("All elements of rx_tx_association must be "
                             "0 or 1.")
        self._num_rx, self._num_tx = a.shape

        num_tx_per_rx = a.sum(1)
        if num_tx_per_rx.min() != num_tx_per_rx.max():
            raise ValueError("Each receiver must be associated with the "
                             "same number of transmitters.")
        self._num_tx_per_rx = int(num_tx_per_rx[0])

        num_rx_per_tx = a.sum(0)
        if num_rx_per_tx.min() != num_rx_per_tx.max():
            raise ValueError("Each transmitter must be associated with "
                             "the same number of receivers.")
        self._num_rx_per_tx = int(num_rx_per_tx[0])

        self._rx_tx_association = a

        self._precoding_ind = np.zeros(
            [self.num_tx, self.num_rx_per_tx], np.int32)
        for i in range(self.num_tx):
            self._precoding_ind[i, :] = np.where(a[:, i])[0]

        # stream_association[i, j, k] = 1 iff stream k of tx j goes to
        # rx i
        stream_association = np.zeros(
            [self.num_rx, self.num_tx, self.num_streams_per_tx], np.int32)
        n_streams = min(self.num_streams_per_rx, self.num_streams_per_tx)
        for j in range(self.num_tx):
            c = 0
            for i in range(self.num_rx):
                if a[i, j]:
                    stream_association[
                        i, j, c:c + self.num_streams_per_rx] = \
                        np.ones(n_streams)
                    c += self.num_streams_per_rx
        self._stream_association = stream_association

        flat = stream_association.reshape(-1)
        self._detection_desired_ind = np.where(flat == 1)[0]
        self._detection_undesired_ind = np.where(flat == 0)[0]

        self._tx_stream_ids = np.arange(
            self.num_tx * self.num_streams_per_tx).reshape(
            [self.num_tx, self.num_streams_per_tx])

        self._rx_stream_ids = np.zeros(
            [self.num_rx, self.num_streams_per_rx], np.int32)
        for i in range(self.num_rx):
            c = []
            for j in range(self.num_tx):
                if a[i, j]:
                    tmp = np.where(stream_association[i, j])[0] \
                        + j * self.num_streams_per_tx
                    c += list(tmp)
            self._rx_stream_ids[i, :] = c

        self._stream_ind = np.argsort(self._rx_stream_ids.reshape(-1))
