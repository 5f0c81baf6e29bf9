"""Parameters of the upstream madrona-learn into the JAX package's layout,
with numpy only (JAX: madrona_learn_tpu/compat/reference_import.py).

Upstream trains its LSTM through flax's ``nn.OptimizedLSTMCell``: eight
per-gate denses, the input side ``ii/if/ig/io`` without bias, the
recurrent side ``hi/hf/hg/ho`` with biases. The JAX package and the port
pack the gates ``(i, f, g, o)`` along one axis with one bias:

    input_proj/kernel = concat(ii, if, ig, io)   # [F, 4H]
    recurrent_kernel  = concat(hi, hf, hg, ho)   # [H, 4H]
    bias              = concat(b_hi, b_hf, b_hg, b_ho)

``convert_reference_params`` rewrites every ``.../cell/
OptimizedLSTMCell_<i>`` subtree (and the JAX package's pre-restructure
``.../cell/layer_<i>``, which holds the same eight denses) into
``.../layer_<i>`` and passes every other entry through: the MLPs,
LayerNorms, heads, critics and the EMA observation normalizer's state
already match. The result is a flax-layout tree;
``compat/from_jax.py`` carries it into the port's state dict.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

_GATE_ORDER = ("i", "f", "g", "o")
_CELL_PREFIXES = ("OptimizedLSTMCell_", "layer_")


def _is_ref_lstm_cell(subtree: Any) -> bool:
    return (isinstance(subtree, Mapping)
            and all(f"i{g}" in subtree and f"h{g}" in subtree
                    for g in _GATE_ORDER))


def _pack_ref_lstm_cell(cell: Mapping[str, Any]) -> dict:
    for g in _GATE_ORDER:
        if "bias" in cell[f"i{g}"]:
            raise ValueError(
                f"unexpected input-dense bias on gate '{g}': upstream's "
                "OptimizedLSTMCell has none, and packing would drop it")
    return {
        "input_proj": {"kernel": np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]) for g in _GATE_ORDER],
            axis=-1)},
        "recurrent_kernel": np.concatenate(
            [np.asarray(cell[f"h{g}"]["kernel"]) for g in _GATE_ORDER],
            axis=-1),
        "bias": np.concatenate(
            [np.asarray(cell[f"h{g}"]["bias"]) for g in _GATE_ORDER]),
    }


def _cell_layer_idx(key: str):
    """The layer index if ``key`` names a per-layer cell, else None."""
    for prefix in _CELL_PREFIXES:
        if key.startswith(prefix) and key[len(prefix):].isdigit():
            return int(key[len(prefix):])
    return None


def _is_ref_lstm_cell_container(value: Any) -> bool:
    return (isinstance(value, Mapping) and bool(value)
            and all(isinstance(k, str) and _cell_layer_idx(k) is not None
                    and _is_ref_lstm_cell(v) for k, v in value.items()))


def convert_reference_params(params: Any) -> Any:
    """An upstream tree (the ``{'params': ...}`` variables, bare params or
    any tree holding them) in the JAX package's layout; every non-LSTM
    entry passes through. A ``cell`` level is collapsed only where it holds
    per-gate LSTM cells."""
    if not isinstance(params, Mapping):
        return params
    converted = {}
    for key, value in params.items():
        if key == "cell" and _is_ref_lstm_cell_container(value):
            for cell_key, cell in value.items():
                converted[f"layer_{_cell_layer_idx(cell_key)}"] = \
                    _pack_ref_lstm_cell(cell)
        else:
            converted[key] = convert_reference_params(value)
    return converted
