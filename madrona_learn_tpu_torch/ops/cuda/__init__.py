"""Hand-written CUDA kernels of the port, each beside its plain twin."""

from .gae import GAE
from .lstm import LSTM_BWD, LSTM_FWD

KERNELS = (GAE, LSTM_FWD, LSTM_BWD)

__all__ = ["GAE", "KERNELS", "LSTM_BWD", "LSTM_FWD"]
