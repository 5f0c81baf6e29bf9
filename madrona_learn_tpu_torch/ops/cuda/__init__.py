"""Hand-written CUDA kernels of the port, each beside its plain version."""

from .gae import GAE
from .lstm import LSTM_BWD, LSTM_FWD
from .mha import MHA

KERNELS = (GAE, LSTM_FWD, LSTM_BWD, MHA)

__all__ = ["GAE", "KERNELS", "LSTM_BWD", "LSTM_FWD", "MHA"]
