"""Hand-written CUDA kernels of the port, each beside its plain version."""

from .gae import GAE
from .lstm import LSTM_BWD, LSTM_FWD, LSTM_PROJ_BWD, LSTM_PROJ_FWD
from .mha import MHA
from .policy_step import POLICY_STEP

KERNELS = (GAE, LSTM_FWD, LSTM_BWD, MHA, POLICY_STEP, LSTM_PROJ_FWD,
           LSTM_PROJ_BWD)

__all__ = ["GAE", "KERNELS", "LSTM_BWD", "LSTM_FWD", "LSTM_PROJ_BWD",
           "LSTM_PROJ_FWD", "MHA", "POLICY_STEP"]
