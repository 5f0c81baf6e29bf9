"""Hand-written CUDA kernels of the port, each beside its plain version."""

from .gae import GAE
from .grouped_matmul import GROUPED_MATMUL
from .gru import GRU_BWD, GRU_FWD
from .layer_norm import LAYER_NORM_BWD, LAYER_NORM_FWD
from .lstm import (LSTM_BWD, LSTM_BWD_CHUNKED, LSTM_FWD, LSTM_FWD_CHUNKED,
                   LSTM_PROJ_BWD, LSTM_PROJ_FWD)
from .mha import MHA
from .mha_flash import MHA_FLASH_BWD_DKDV, MHA_FLASH_BWD_DQ, MHA_FLASH_FWD
from .policy_step import POLICY_STEP

KERNELS = (GAE, LSTM_FWD, LSTM_BWD, MHA, POLICY_STEP, LSTM_PROJ_FWD,
           LSTM_PROJ_BWD, GRU_FWD, GRU_BWD, LAYER_NORM_FWD, LAYER_NORM_BWD,
           MHA_FLASH_FWD, MHA_FLASH_BWD_DKDV, MHA_FLASH_BWD_DQ,
           GROUPED_MATMUL, LSTM_FWD_CHUNKED, LSTM_BWD_CHUNKED)

__all__ = ["GAE", "GROUPED_MATMUL", "GRU_BWD", "GRU_FWD", "KERNELS",
           "LAYER_NORM_BWD", "LAYER_NORM_FWD", "LSTM_BWD", "LSTM_BWD_CHUNKED",
           "LSTM_FWD", "LSTM_FWD_CHUNKED",
           "LSTM_PROJ_BWD", "LSTM_PROJ_FWD", "MHA", "MHA_FLASH_BWD_DKDV",
           "MHA_FLASH_BWD_DQ", "MHA_FLASH_FWD", "POLICY_STEP"]
