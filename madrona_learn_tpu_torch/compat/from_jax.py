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
  ``heads.<name>``. The same rule carries ``BackboneSeparate``'s towers
  (``backbone.actor_encoder.*``, ``backbone.critic_encoder.*``) and
  ``WindowAttentionMemory``'s ``step.{q,k,v,out}.kernel`` and
  ``step.norm.{scale,bias}`` (flax's own LayerNorm, held by the port's
  ``FlaxLayerNorm``).
- ``obs_preprocess_state``: the EMA normalizer state of
  ``ObservationsEMANormalizer`` (per obs key: mu, inv_sigma, sigma,
  mu_biased, sigma_sq_biased, N) -> the same dict of numpy arrays.
- ``ema_state``: one EMA state (the value normalizer's, or the
  max-advantage estimate's mu, mu_biased and N) -> a dict of numpy arrays.
- ``dynamic_scale_state``: flax's ``DynamicScale`` (the float16 loss
  scaler) -> ``{"scale": float32, "fin_steps": int32}`` arrays, the port's
  ``ops/dynamic_scale.py`` state.
- ``policy_slice``: strip the JAX package's leading policy axis (dicts,
  lists and tuples followed, ``None`` kept).
- A PBT population's own state, policy by policy after ``policy_slice``
  or whole: ``fitness`` (the ``MMR`` Elo or the ``MovingEpisodeScore``
  mean / var / N, ``[P]`` arrays), ``reward_hyper_params`` (``[P, R]`` or
  ``None``) and ``hyper_params`` (one train policy's hyperparameters, each
  a numpy scalar; ``lr`` and ``entropy_coef`` are what PBT searches).
- ``adam_state``: the ``ScaleByAdamState`` of one policy's optax state
  (the ``clip_by_global_norm`` + ``scale_by_adam`` chain, live or as orbax
  restores it, where the chain is a list and each state a dict) ->
  ``{"count", "mu", "nu"}``, the moments keyed by the port's parameter
  names; ``initial_weight_norms``: the weight-projection norms of one
  policy, renamed the same way (the ``None`` leaves of the heads dropped).
- ``checkpoint_tree``: a whole checkpoint as the JAX package's
  ``TrainStateManager.restore_host`` returns it (``next_update``,
  ``policy_states``, ``train_states``, ``pbt_rng``, ``user_state``) -> the
  tree the port's ``TrainStateManager.load`` reads (``train_state.py``),
  with numpy arrays and Python scalars in the place of tensors.

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
    """Index the leading (policy) axis of every array in nested dicts,
    lists and tuples; ``None`` stays."""
    if hasattr(tree, "items"):
        return {k: policy_slice(v, index) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [policy_slice(v, index) for v in tree]
    if tree is None:
        return None
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


def _field(x, name):
    """Field ``name`` of a live flax / optax state or of its orbax dict."""
    return x[name] if hasattr(x, "items") else getattr(x, name)


def dynamic_scale_state(scaler) -> Dict[str, np.ndarray]:
    """flax ``DynamicScale`` -> the port's loss-scaler state arrays."""
    return {"scale": np.array(_field(scaler, "scale"), dtype=np.float32),
            "fin_steps": np.array(_field(scaler, "fin_steps"),
                                  dtype=np.int32)}


def obs_preprocess_state(state) -> Dict[str, Any]:
    """EMA normalizer state of one policy -> numpy arrays per obs key
    (``None`` for a preprocessor without state, such as the caster)."""
    return {key: None if est is None else ema_state(est)
            for key, est in state.items()}


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


_ADAM_FIELDS = {"count", "mu", "nu"}


def _find_adam(state):
    """The one ``ScaleByAdamState`` in an optax chain state, found by its
    fields (a namedtuple live, a dict as orbax restores it), or None."""
    if hasattr(state, "_fields") and _ADAM_FIELDS <= set(state._fields):
        return {name: getattr(state, name) for name in _ADAM_FIELDS}
    if hasattr(state, "items"):
        if _ADAM_FIELDS <= set(state):
            return state
        children = list(state.values())
    elif isinstance(state, (list, tuple)):
        children = list(state)
    else:
        return None
    found = [adam for adam in map(_find_adam, children) if adam is not None]
    if len(found) > 1:
        raise ValueError("the optimizer state holds more than one "
                         "ScaleByAdamState")
    return found[0] if found else None


def adam_state(opt_state) -> Dict[str, Any]:
    """One policy's optax state -> the port's Adam state arrays."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")
    return {"count": np.array(adam["count"], dtype=np.int32),
            "mu": actor_critic_state_dict(adam["mu"]),
            "nu": actor_critic_state_dict(adam["nu"])}


def initial_weight_norms(norms) -> Dict[str, np.ndarray]:
    """One policy's initial weight norms -> ``{torch name: norm}``."""
    return {_torch_name(path): np.array(value, dtype=np.float32)
            for path, value in _flatten(norms) if value is not None}


def _seed(key_data) -> int:
    """A torch generator seed from a JAX PRNG key's uint32 data, through
    numpy's ``SeedSequence`` as the port seeds its own generators. Draws
    from the seeded generator are not JAX's."""
    words = [int(x) for x in np.asarray(key_data).reshape(-1)]
    return int(np.random.SeedSequence(words).generate_state(1)[0])


def _train_state(train_states, p: int) -> Dict[str, Any]:
    ts = policy_slice(train_states, p)
    return {
        "hyper_params": {name: np.asarray(value).item()
                         for name, value in ts["hyper_params"].items()},
        "opt_state": adam_state(ts["opt_state"]),
        "initial_weight_norms": initial_weight_norms(
            ts["initial_weight_norms"]),
        "max_advantage_est_state": ema_state(ts["max_advantage_est_state"]),
        "value_normalizer_state": (
            None if ts["value_normalizer_state"] is None
            else ema_state(ts["value_normalizer_state"])),
        "scaler_state": (None if ts["scaler"] is None
                         else dynamic_scale_state(ts["scaler"])),
        "generator": _seed(ts["update_prng_key"]),
    }


def checkpoint_tree(tree) -> Dict[str, Any]:
    """A JAX checkpoint tree (host numpy) -> the port's checkpoint tree.

    The population entries (reward hyperparameters, Elo, episode score)
    and the PBT generator are kept whenever the JAX run has them, a single
    policy's episode score too: the manager that loads the checkpoint
    knows whether it is a population, and a single-policy manager takes no
    fitness. Each PRNG key seeds its torch generator (``_seed``).
    """
    policies, train_states = tree["policy_states"], tree["train_states"]
    num_train = np.asarray(train_states["update_prng_key"]).shape[0]
    total = np.asarray(next(v for _, v in _flatten(policies["params"]))
                       ).shape[0]
    mmr = policies.get("mmr")
    episode_score = policies.get("episode_score")
    reward_params = policies.get("reward_hyper_params")
    return {
        "next_update": int(np.asarray(tree["next_update"])),
        "policy_states": [
            {"actor_critic": actor_critic_state_dict(
                policy_slice(policies["params"], p)),
             "obs_preprocess_state": obs_preprocess_state(
                 policy_slice(policies["obs_preprocess_state"], p))}
            for p in range(total)],
        "train_states": [_train_state(train_states, p)
                         for p in range(num_train)],
        "population": {
            "reward_hyper_params": (
                None if reward_params is None
                else np.array(reward_params, dtype=np.float32)),
            "mmr": (None if mmr is None else
                    {"elo": np.array(mmr["elo"], dtype=np.float32)}),
            "episode_score": (None if episode_score is None else {
                "mean": np.array(episode_score["mean"], dtype=np.float32),
                "var": np.array(episode_score["var"], dtype=np.float32),
                "N": np.array(episode_score["N"], dtype=np.int32)}),
        },
        "pbt_generator": _seed(tree["pbt_rng"]),
        "user_state": tree.get("user_state"),
    }
