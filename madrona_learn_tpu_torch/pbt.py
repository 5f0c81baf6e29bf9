"""Population-based training: matchmaking, fitness and evolution (JAX:
madrona_learn_tpu/pbt.py).

- ``PBTMatchmakeConfig``: the self / cross / past / static play slices of
  the sim batch and their match counts, from the portions.
- Matchmaking: train policies block-assigned to team 0 of every match;
  cross-play opponents are other train policies, past-play opponents past
  policies; each step rerolls the opponents of finished matches.
- Fitness: Elo from the results of two-team matches (K = 1), or an EMA of
  episode scores with a decayed, weighted Chan variance merge.
- Evolution: hyperparameter explore (resample in linear, log10 or ln space,
  or perturb), cull (the bottom train policies overwritten by mutated
  copies of the top ones) and past snapshots, each gated by an expected
  winrate or a one-sided Welch test.

The population (``train_state.Population``) is a list of policies with
their Elo and episode-score statistics as ``[P]`` tensors. A copy writes
the source's parameters, optimizer moments, hyperparameters and normalizer
state into the destination's tensors (``copy_``); the destination keeps its
own update generator. Every random draw goes through the module-level
``uniform`` and ``randint``, on the ``torch.Generator`` the caller passes.
The data-sharded layouts of the JAX package are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .config import ParamExplore, TrainConfig

_I32 = torch.int32
_F32 = torch.float32


def uniform(generator: torch.Generator, low: float, high: float):
    """One float32 draw from U[low, high), on the generator's device."""
    u = torch.rand((), dtype=_F32, generator=generator,
                   device=generator.device)
    return low + (high - low) * u


def randint(generator: torch.Generator, shape, low: int, high: int):
    """int32 draws from [low, high), on the generator's device."""
    return torch.randint(low, high, tuple(shape), generator=generator,
                         dtype=_I32, device=generator.device)


@dataclass(frozen=True)
class PBTMatchmakeConfig:
    num_current_policies: int
    num_past_policies: int
    total_num_policies: int
    num_teams: int
    team_size: int

    self_play_portion: float
    cross_play_portion: float
    past_play_portion: float
    static_play_portion: float

    self_play_batch_size: int
    cross_play_batch_size: int
    past_play_batch_size: int
    static_play_batch_size: int

    num_cross_play_matches: int
    num_past_play_matches: int
    num_static_play_matches: int
    num_total_matches: int

    complex_matchmaking: bool
    custom_policy_ids: Tuple[int, ...]

    @staticmethod
    def setup(num_current_policies: int, num_past_policies: int,
              num_teams: int, team_size: int, sim_batch_size: int,
              self_play_portion: float, cross_play_portion: float,
              past_play_portion: float, static_play_portion: float,
              custom_policy_ids=()) -> "PBTMatchmakeConfig":
        total = (self_play_portion + cross_play_portion + past_play_portion
                 + static_play_portion)
        if abs(total - 1.0) >= 1e-9:
            raise ValueError(f"matchmaking portions sum to {total}, not 1")
        self_bs = int(sim_batch_size * self_play_portion)
        cross_bs = int(sim_batch_size * cross_play_portion)
        past_bs = int(sim_batch_size * past_play_portion)
        static_bs = int(sim_batch_size * static_play_portion)
        agents_per_world = num_teams * team_size
        sizes = dict(self=self_bs, cross=cross_bs, past=past_bs,
                     static=static_bs)
        if self_bs + cross_bs + past_bs + static_bs != sim_batch_size:
            raise ValueError(f"play slices {sizes} do not add up to the "
                             f"sim batch of {sim_batch_size}")
        for name in ("cross", "past", "static"):
            if sizes[name] % agents_per_world:
                raise ValueError(
                    f"the {name}-play slice of {sizes[name]} agents is not "
                    f"whole matches of {agents_per_world}")
        total_policies = num_current_policies + num_past_policies
        below = [i for i in custom_policy_ids if i < total_policies]
        if below:
            raise ValueError(f"custom policy ids {below} are not past the "
                             f"population's {total_policies} policies")
        num_cross = cross_bs // agents_per_world
        num_past = past_bs // agents_per_world
        num_static = static_bs // agents_per_world
        for name, n in (("cross-play matches", num_cross),
                        ("past-play matches", num_past),
                        ("self-play agents", self_bs)):
            if n % num_current_policies:
                raise ValueError(f"{n} {name} do not divide among "
                                 f"{num_current_policies} train policies")
        return PBTMatchmakeConfig(
            num_current_policies=num_current_policies,
            num_past_policies=num_past_policies,
            total_num_policies=total_policies,
            num_teams=num_teams,
            team_size=team_size,
            self_play_portion=self_play_portion,
            cross_play_portion=cross_play_portion,
            past_play_portion=past_play_portion,
            static_play_portion=static_play_portion,
            self_play_batch_size=self_bs,
            cross_play_batch_size=cross_bs,
            past_play_batch_size=past_bs,
            static_play_batch_size=static_bs,
            num_cross_play_matches=num_cross,
            num_past_play_matches=num_past,
            num_static_play_matches=num_static,
            num_total_matches=sim_batch_size // agents_per_world,
            complex_matchmaking=self_play_portion != 1.0,
            custom_policy_ids=tuple(custom_policy_ids),
        )


# -- Matchmaking ---------------------------------------------------------

def pbt_init_matchmaking(generator: torch.Generator,
                         mm_cfg: PBTMatchmakeConfig,
                         static_play_assignments: Optional[torch.Tensor]):
    """The initial ``[sim_batch_size]`` int32 assignments, on the
    generator's device: self | cross | past | static slices. Team 0 of
    every cross and past match is a block-assigned train policy; the other
    teams are drawn (cross: another train policy; past: a past policy)."""
    device = generator.device
    P = mm_cfg.num_current_policies

    def block_assign(batch_size):
        return torch.repeat_interleave(
            torch.arange(P, dtype=_I32, device=device), batch_size // P)

    def with_opponents(batch_size, num_matches, draw):
        base = block_assign(batch_size).reshape(
            num_matches, mm_cfg.num_teams, mm_cfg.team_size)
        base[:, 1:, :] = draw(base[:, 0, 0])[..., None]
        return base.reshape(-1)

    shape = (mm_cfg.num_cross_play_matches, mm_cfg.num_teams - 1)
    parts = []
    if mm_cfg.self_play_batch_size > 0:
        parts.append(block_assign(mm_cfg.self_play_batch_size))
    if mm_cfg.cross_play_batch_size > 0:
        parts.append(with_opponents(
            mm_cfg.cross_play_batch_size, mm_cfg.num_cross_play_matches,
            lambda team0: _sample_cross_opponents(generator, team0, mm_cfg,
                                                  shape)))
    if mm_cfg.past_play_batch_size > 0:
        parts.append(with_opponents(
            mm_cfg.past_play_batch_size, mm_cfg.num_past_play_matches,
            lambda team0: _sample_past_opponents(generator, mm_cfg)))
    if mm_cfg.static_play_batch_size > 0:
        if static_play_assignments is None:
            raise ValueError("static play needs static_play_assignments")
        parts.append(static_play_assignments.reshape(-1).to(_I32))
    return torch.cat(parts)


def _sample_cross_opponents(generator, team0_policy, mm_cfg, shape):
    """Uniform over the train policies but each match's own team-0 one."""
    draws = randint(generator, shape, 0, mm_cfg.num_current_policies - 1)
    team0 = team0_policy.reshape(-1, *([1] * (len(shape) - 1)))
    return torch.where(draws >= team0, draws + 1, draws)


def _sample_past_opponents(generator, mm_cfg):
    return randint(generator,
                   (mm_cfg.num_past_play_matches, mm_cfg.num_teams - 1),
                   mm_cfg.num_current_policies, mm_cfg.total_num_policies)


def pbt_update_matchmaking(assignments, dones, generator,
                           mm_cfg: PBTMatchmakeConfig):
    """The next step's assignments: the opponents of finished cross- and
    past-play matches are drawn anew, every other slot is kept."""
    cross_start = mm_cfg.self_play_batch_size
    cross_end = cross_start + mm_cfg.cross_play_batch_size
    past_end = cross_end + mm_cfg.past_play_batch_size
    match_shape = (-1, mm_cfg.num_teams, mm_cfg.team_size)
    assignments = assignments.clone()

    def reroll(start, end, fresh_fn):
        cur = assignments[start:end].reshape(match_shape)
        cur_dones = dones[start:end].reshape(cur.shape)
        fresh = fresh_fn(cur[:, 0, 0])
        cur[:, 1:, :] = torch.where(cur_dones[:, 1:, :], fresh[:, :, None],
                                    cur[:, 1:, :])

    if mm_cfg.cross_play_batch_size > 0:
        reroll(cross_start, cross_end,
               lambda team0: _sample_cross_opponents(
                   generator, team0, mm_cfg,
                   (mm_cfg.num_cross_play_matches, mm_cfg.num_teams - 1)))
    if mm_cfg.past_play_batch_size > 0:
        reroll(cross_end, past_end,
               lambda team0: _sample_past_opponents(generator, mm_cfg))
    return assignments


# -- Fitness: Elo and the EMA episode score ---------------------------------

def elo_expected_result(my_elo, opponent_elo):
    return 1.0 / (1.0 + 10.0 ** ((opponent_elo - my_elo) / 400.0))


def _convert_custom_policy_ids(assignments, mm_cfg):
    """Custom policy ids -> the slots after the Elo table's policies."""
    if not mm_cfg.custom_policy_ids:
        return assignments
    custom = torch.tensor(mm_cfg.custom_policy_ids, dtype=assignments.dtype,
                          device=assignments.device)
    eq = assignments[..., None] == custom
    remap = (torch.argmax(eq.to(_I32), dim=-1)
             + mm_cfg.total_num_policies).to(assignments.dtype)
    return torch.where(eq.any(dim=-1), remap, assignments)


def episode_scores(get_episode_scores_fn, episode_results):
    """``get_episode_scores_fn`` over every world at once: the worlds'
    results [M, ...] are handed over with the world axis last, so the
    function's ``er[k]`` reads field k of every world ([M])."""
    return get_episode_scores_fn(episode_results.movedim(0, -1))


def pbt_update_elo(get_episode_scores_fn, assignments, dones,
                   episode_results, policy_elos, mm_cfg: PBTMatchmakeConfig):
    """Elo after the finished two-team matches of one step (K = 1).
    Matches between one policy and itself are skipped; custom policies
    read the clamped last entry of the table and move nothing."""
    if mm_cfg.num_teams != 2:
        raise ValueError("Elo needs two teams")
    num_policies = policy_elos.shape[0]
    assignments = _convert_custom_policy_ids(assignments, mm_cfg).reshape(
        mm_cfg.num_total_matches, mm_cfg.num_teams, mm_cfg.team_size)
    dones = dones.reshape(mm_cfg.num_total_matches, mm_cfg.num_teams,
                          mm_cfg.team_size, -1)
    a = assignments[:, 0, 0].long()
    b = assignments[:, 1, 0].long()
    valid = dones[:, 0, 0, 0] & (a != b)

    a_scores, b_scores = episode_scores(get_episode_scores_fn,
                                        episode_results)
    elo_a = policy_elos[a.clamp(max=num_policies - 1)]
    elo_b = policy_elos[b.clamp(max=num_policies - 1)]
    diff_a = torch.where(valid, a_scores - elo_expected_result(elo_a, elo_b),
                         0.0)
    diff_b = torch.where(valid, b_scores - elo_expected_result(elo_b, elo_a),
                         0.0)
    pids = torch.arange(num_policies, device=policy_elos.device)
    contrib = (torch.where(a[:, None] == pids, diff_a[:, None], 0.0)
               + torch.where(b[:, None] == pids, diff_b[:, None], 0.0))
    return policy_elos + contrib.sum(dim=0)


def pbt_update_fitness(assignments, episode_score, dones, episode_results,
                       get_episode_scores_fn, mm_cfg: PBTMatchmakeConfig):
    """The EMA episode score ([P] mean, var, N) after the finished
    single-team episodes of one step (decay 0.9999, a weighted Chan merge
    of the step's mean and variance)."""
    if mm_cfg.num_teams != 1:
        raise ValueError("episode-score fitness needs one team")
    cur = episode_score
    num_policies = cur.mean.shape[0]
    assignments = assignments.reshape(mm_cfg.num_total_matches,
                                      mm_cfg.team_size)[:, 0]
    dones = dones.reshape(mm_cfg.num_total_matches, mm_cfg.team_size)[:, 0]
    scores = episode_scores(get_episode_scores_fn,
                            episode_results).to(_F32)

    onehot = ((assignments[:, None] == torch.arange(
        num_policies, device=assignments.device)[None, :])
        & dones[:, None])                                       # [M, P]
    x_n = onehot.sum(dim=0, dtype=cur.N.dtype)
    x_nf = x_n.to(_F32)
    x_mean = (torch.where(onehot, scores[:, None], 0.0).sum(dim=0)
              / torch.clamp(x_nf, min=1.0))
    sq_dev = (scores[:, None] - x_mean[None, :]) ** 2
    x_ssd = torch.where(onehot, sq_dev, 0.0).sum(dim=0)
    x_var = torch.where(x_n > 1, x_ssd / torch.clamp(x_nf - 1.0, min=1.0),
                        0.0)

    # The decay's log in float32, as ops/ema.py takes it.
    log_decay = torch.log(torch.tensor(0.9999, dtype=_F32,
                                       device=x_nf.device))
    mean_delta = x_mean - cur.mean
    cur_weight = torch.expm1(x_nf * log_decay) + 1.0
    x_weight = 1.0 - cur_weight
    n_max = torch.iinfo(cur.N.dtype).max
    new_n = torch.where(x_n > n_max - cur.N, n_max, cur.N + x_n)
    cross = torch.where(
        cur.N > 0,
        cur.N.to(_F32) / torch.clamp((new_n - 1).to(_F32), min=1.0)
        * (cur_weight * x_weight) * mean_delta ** 2,
        0.0)
    new_mean = cur_weight * cur.mean + x_weight * x_mean
    new_var = cur_weight * cur.var + x_weight * x_var + cross
    has_data = x_n > 0
    return dataclasses.replace(
        cur,
        mean=torch.where(has_data, new_mean, cur.mean),
        var=torch.where(has_data, new_var, cur.var),
        N=torch.where(has_data, new_n, cur.N))


# -- Hyperparameter exploration ---------------------------------------------

def explore_param(generator: torch.Generator, param,
                  param_explore: ParamExplore, resample_chance: float):
    """Resample (uniform in the configured space) with probability
    ``resample_chance``, else perturb; a float32 tensor. Two draws: the
    coin, then the value."""
    lo = param_explore.base * param_explore.min_scale
    hi = param_explore.base * param_explore.max_scale
    if bool(uniform(generator, 0.0, 1.0) < resample_chance):
        if param_explore.log10_scale:
            return 10.0 ** uniform(generator, math.log10(lo), math.log10(hi))
        if param_explore.ln_scale:
            return torch.exp(uniform(generator, math.log(lo), math.log(hi)))
        return uniform(generator, lo, hi)
    perturbed = param * uniform(generator, param_explore.perturb_rnd_min,
                                param_explore.perturb_rnd_max)
    if param_explore.clip_perturb:
        perturbed = torch.clamp(perturbed, lo, hi)
    return perturbed


def pbt_explore_hyperparams(cfg: TrainConfig, generator, population,
                            policy_idx: int, train_state,
                            resample_chance: float):
    """Mutate one train policy's reward hyperparameters (in the
    population's ``[P, R]`` table), then its learning rate, then the
    algorithm's own hyperparameters (PPO: ``entropy_coef``), in place."""
    params = population.reward_hyper_params
    if params is not None:
        for i, spec in enumerate(cfg.pbt.reward_hyper_params_explore
                                 .values()):
            params[policy_idx, i] = explore_param(
                generator, params[policy_idx, i], spec, resample_chance)
    hp = train_state.hyper_params
    if isinstance(cfg.lr, ParamExplore):
        hp.lr = explore_param(generator, hp.lr, cfg.lr, resample_chance)
    explore_algo = getattr(cfg.algo, "explore_hyperparams", None)
    if explore_algo is not None:
        train_state.hyper_params = explore_algo(generator, hp,
                                                resample_chance)


# -- Population evolution ------------------------------------------------

def _check_overwrite(cfg: TrainConfig, population, src_idx: int,
                     dst_idx: int) -> bool:
    """Should ``src`` overwrite ``dst``? Elo populations: src's expected
    winrate over dst reaches the threshold. Fitness populations: a
    one-sided Welch test, p < 0.2."""
    if population.mmr is not None:
        elo = population.mmr.elo
        return bool(elo_expected_result(elo[src_idx], elo[dst_idx])
                    >= cfg.pbt.policy_overwrite_threshold)
    scores = population.episode_score
    src_s2 = scores.var[src_idx] / scores.N[src_idx].to(_F32)
    dst_s2 = scores.var[dst_idx] / scores.N[dst_idx].to(_F32)
    t = (scores.mean[src_idx] - scores.mean[dst_idx]) / torch.sqrt(
        src_s2 + dst_s2)
    return bool(1 - torch.special.ndtr(t) < 0.20)


def _get_fitness_scores(population):
    if population.mmr is not None:
        return population.mmr.elo
    return population.episode_score.mean


def pbt_cull_update(cfg: TrainConfig, train_state_mgr,
                    num_cull_policies: int) -> List[Tuple[int, int]]:
    """Overwrite the ``num_cull_policies`` lowest-fitness train policies
    with copies of the highest, each copy gated by ``_check_overwrite`` and
    its hyperparameters then mutated (resample chance 0.2). Returns the
    (source, destination) pairs copied."""
    if 2 * num_cull_policies > cfg.pbt.num_train_policies:
        raise ValueError("cannot cull more than half the train policies")
    population = train_state_mgr.policy_states
    fitness = _get_fitness_scores(population)
    order = torch.argsort(fitness[:cfg.pbt.num_train_policies],
                          stable=True).tolist()
    pairs = list(zip(order[-num_cull_policies:],
                     order[:num_cull_policies]))
    should = [_check_overwrite(cfg, population, src, dst)
              for src, dst in pairs]
    copied = []
    for (src, dst), ok in zip(pairs, should):
        if not ok:
            continue
        population.copy_policy(src, dst)
        copy_train_state(train_state_mgr.train_states[src],
                         train_state_mgr.train_states[dst])
        pbt_explore_hyperparams(cfg, train_state_mgr.pbt_generator,
                                population, dst,
                                train_state_mgr.train_states[dst], 0.2)
        copied.append((src, dst))
    return copied


def pbt_past_update(cfg: TrainConfig, train_state_mgr
                    ) -> List[Tuple[int, int]]:
    """Snapshot a random train policy into the past slot of lowest
    fitness, gated by ``_check_overwrite``. Returns the copy made, if
    any, as a (source, destination) pair."""
    if cfg.pbt.num_past_policies == 0:
        return []
    population = train_state_mgr.policy_states
    P = cfg.pbt.num_train_policies
    src = int(randint(train_state_mgr.pbt_generator, (), 0, P))
    dst = int(torch.argmin(_get_fitness_scores(population)[P:])) + P
    if not _check_overwrite(cfg, population, src, dst):
        return []
    population.copy_policy(src, dst)
    return [(src, dst)]


def _copy_tree(src, dst):
    """``dst``'s tensors take ``src``'s values in place (dicts, tuples,
    dataclasses and tensors)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_tree(src[k], dst[k])
    elif isinstance(dst, (tuple, list)):
        for s, d in zip(src, dst):
            _copy_tree(s, d)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_tree(getattr(src, f.name), getattr(dst, f.name))


def copy_train_state(src, dst):
    """Train state ``src`` into ``dst``: optimizer state, initial weight
    norms, normalizer and loss-scaler state in place, and a copy of the
    hyperparameters. ``dst`` keeps its own update generator."""
    with torch.no_grad():
        for name in ("opt_state", "initial_weight_norms",
                     "max_advantage_est_state", "value_normalizer_state",
                     "scaler_state"):
            _copy_tree(getattr(src, name), getattr(dst, name))
    dst.hyper_params = dataclasses.replace(src.hyper_params, **{
        f.name: getattr(src.hyper_params, f.name).clone()
        for f in dataclasses.fields(src.hyper_params)
        if isinstance(getattr(src.hyper_params, f.name), torch.Tensor)})
