"""Convert the JAX package's state into the port's, with numpy only.

- ``actor_critic_state_dict``: a flax ``params`` tree (nested dicts of
  arrays, already on the host) -> ``{torch parameter name: np.ndarray}`` for
  ``ActorCritic.load_state_dict``. Layouts are shared (Dense kernels
  ``[in, out]``, LSTM gates (i, f, g, o) in ``[F, 4H]`` / ``[H, 4H]``; GRU
  gates ``[r | z | n]`` in ``layer_k.input_proj.kernel`` ``[F, 3H]`` with
  its own ``input_proj.bias`` ``[3H]``, ``layer_k.recurrent_kernel``
  ``[H, 3H]`` and ``layer_k.bias_h`` ``[H]``, the candidate gate's
  recurrent bias; the attention projections ``[F, heads, head_dim]`` /
  ``[heads, head_dim, out]`` with their biases, the DreamerV3 and HL-Gauss
  critics' ``Dense_0``, the two-part HL-Gauss critic's ``small`` and
  ``large`` heads), so only the names change: path components join with
  ``.``, and flax's ``heads_<name>`` for a dict of submodules becomes
  ``heads.<name>``.
- ``obs_preprocess_state``: the EMA normalizer state of
  ``ObservationsEMANormalizer`` (per obs key: mu, inv_sigma, sigma,
  mu_biased, sigma_sq_biased, N) -> the same dict of numpy arrays.
- ``ema_state``: one EMA state (the value normalizer's, or the
  max-advantage estimate's mu, mu_biased and N) -> a dict of numpy arrays.
- ``dynamic_scale_state``: flax's ``DynamicScale`` (the float16 loss
  scaler) -> ``{"scale": float32, "fin_steps": int32}`` arrays, the port's
  ``ops/dynamic_scale.py`` state.
- ``policy_slice``: strip the JAX package's leading policy axis.
- A PBT population's own state, policy by policy after ``policy_slice``
  or whole: ``fitness`` (the ``MMR`` Elo or the ``MovingEpisodeScore``
  mean / var / N, ``[P]`` arrays), ``reward_hyper_params`` (``[P, R]`` or
  ``None``) and ``hyper_params`` (one train policy's hyperparameters, each
  a numpy scalar; ``lr`` and ``entropy_coef`` are what PBT searches).

The caller turns the arrays into tensors (``torch.from_numpy``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, value


def _torch_name(path):
    parts = []
    for part in path:
        if part.startswith("heads_"):
            parts += ["heads", part[len("heads_"):]]
        else:
            parts.append(part)
    return ".".join(parts)


def policy_slice(tree, index: int = 0):
    """Index the leading (policy) axis of every array in a nested dict."""
    if hasattr(tree, "items"):
        return {k: policy_slice(v, index) for k, v in tree.items()}
    return np.asarray(tree)[index]


def actor_critic_state_dict(params) -> Dict[str, np.ndarray]:
    """flax params of one policy -> torch ``state_dict`` arrays."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    return {_torch_name(path): np.array(value, dtype=np.float32)
            for path, value in _flatten(params)}


def ema_state(est) -> Dict[str, np.ndarray]:
    """One EMA state -> numpy arrays."""
    return {name: np.array(value) for name, value in est.items()}


def dynamic_scale_state(scaler) -> Dict[str, np.ndarray]:
    """flax ``DynamicScale`` -> the port's loss-scaler state arrays."""
    return {"scale": np.array(scaler.scale, dtype=np.float32),
            "fin_steps": np.array(scaler.fin_steps, dtype=np.int32)}


def obs_preprocess_state(state) -> Dict[str, Any]:
    """EMA normalizer state of one policy -> numpy arrays per obs key."""
    return {key: ema_state(est) for key, est in state.items()}


def fitness(policy_states) -> Dict[str, np.ndarray]:
    """The population's fitness: ``{"elo"}`` or ``{"mean", "var", "N"}``."""
    if policy_states.mmr is not None:
        return {"elo": np.array(policy_states.mmr.elo, dtype=np.float32)}
    score = policy_states.episode_score
    return {"mean": np.array(score.mean, dtype=np.float32),
            "var": np.array(score.var, dtype=np.float32),
            "N": np.array(score.N, dtype=np.int32)}


def reward_hyper_params(policy_states):
    """The ``[P, R]`` reward hyperparameters, or ``None``."""
    params = policy_states.reward_hyper_params
    return None if params is None else np.array(params, dtype=np.float32)


def hyper_params(hp, index: int = 0) -> Dict[str, np.ndarray]:
    """Train policy ``index``'s hyperparameters from the stacked ones."""
    return {name: np.asarray(value)[index]
            for name, value in vars(hp).items()}
