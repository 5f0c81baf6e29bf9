"""Policy and training state (JAX: madrona_learn_tpu/train_state.py).

- ``PolicyState``: the actor-critic module (its parameters) and the
  observation preprocessor with its state.
- ``PolicyTrainState``: hyperparameters, the optimizer and its state, the
  initial L2 norm of every Dense kernel outside the actor and critic heads
  (for the weight-norm projection), the value normalizer and its state
  (``None`` unless ``TrainConfig.normalize_values``), the EMA of the
  largest |advantage| (advantage filtering reads it), the float16 loss
  scaler and its state (``None`` unless ``TrainConfig.compute_dtype`` is
  float16), and the update RNG.
- ``Population`` (PBT): the policy states of the train policies and then
  the past policies, the ``[P, R]`` reward hyperparameters, the
  episode-score function and the fitness, an Elo ``MMR`` (competitive
  populations) or a ``MovingEpisodeScore`` (the others), as ``[P]``
  tensors. ``Population.stacked()`` gives the ``PopulationStack`` that
  the policy-batched rollout reads.
- ``StackedTrainState`` (PBT, the batched learn): the train policies'
  parameters, Adam states and per-policy train state as ``[P, ...]``
  stacks for the length of one learn phase, then written back.
- ``TrainStateManager``: the policy and train state of the one train
  policy, or with ``TrainConfig.pbt`` the ``Population``, one train state a
  train policy and the PBT generator; plus the user's hook state. It
  saves and loads checkpoints, re-slices a population's checkpoint and
  loads policies for evaluation.

A checkpoint is one ``torch.save`` file of plain nested dicts and lists of
CPU tensors and Python scalars, which ``torch.load(weights_only=True)``
reads: ``next_update``; ``policy_states``, one entry a policy (train
policies first), with the module's ``state_dict`` and the obs
preprocessor's state; ``train_states``, one a train policy, with the
hyperparameters, the Adam state, the initial weight norms, the advantage
EMA, the value normalizer's and the loss scaler's states (or ``None``) and
the update generator's state; ``population`` (``None`` for one policy):
the ``[P, R]`` reward hyperparameters, the Elo ``mmr`` or the
``episode_score``, as ``[P]`` tensors; ``pbt_generator`` (or ``None``) and
``user_state``. As in the JAX package, the rollout state (simulator,
recurrent state, rollout generator) is not saved. A checkpoint carried
over from the JAX package (``compat/from_jax.py``) keeps the population
entries and the PBT generator of a single policy too, which a
single-policy manager does not load; there a generator entry may be an
int, the seed of the generator.

The optimizer is learning-rate free and the live ``hyper_params.lr`` scales
each step, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .algo import AlgoBase, HyperParams
from .config import TrainConfig
from .models.actor_critic import ActorCritic
from .models.common import StackedParams
from .observations import ObservationsPreprocess, ObservationsPreprocessNoop
from .ops.dynamic_scale import DynamicScale
from .ops.ema import EMAEstimate, EMANormalizer
from .pbt import _copy_tree
from .policy import Policy
from .ppo import AdamState
from .utils import tree_map, tree_stack


@dataclass
class PolicyState:
    actor_critic: ActorCritic
    obs_preprocess: ObservationsPreprocess
    obs_preprocess_state: Dict[str, Any]


@dataclass
class MovingEpisodeScore:
    mean: torch.Tensor
    var: torch.Tensor
    N: torch.Tensor


@dataclass
class MMR:
    elo: torch.Tensor


@dataclass
class Population:
    """The PBT population: train policies first, then past policies."""

    policies: List[PolicyState]
    reward_hyper_params: Optional[torch.Tensor]
    get_episode_scores_fn: Callable
    episode_score: Optional[MovingEpisodeScore]
    mmr: Optional[MMR]

    def __len__(self):
        return len(self.policies)

    def __getitem__(self, index: int) -> PolicyState:
        return self.policies[index]

    def stacked(self) -> "PopulationStack":
        """The stacked view of the population, train then past policies:
        one ``torch.stack`` a parameter and a leaf of obs-preprocess state.
        A copy, built once per collect or evaluation: learning,
        ``copy_policy``, checkpoint loads and population surgery write the
        modules' parameters in place, which no stack built before sees."""
        first = self.policies[0]
        return PopulationStack(
            population=self, actor_critic=first.actor_critic,
            obs_preprocess=first.obs_preprocess,
            params=StackedParams.of([p.actor_critic for p in self.policies]),
            obs_states=first.obs_preprocess.stack_states(
                [p.obs_preprocess_state for p in self.policies]))

    def copy_policy(self, src: int, dst: int):
        """Policy ``src`` into ``dst`` in place: parameters, obs-normalizer
        state, reward hyperparameters and fitness."""
        with torch.no_grad():
            source, dest = self.policies[src], self.policies[dst]
            _copy_tree(source.actor_critic.state_dict(),
                       dest.actor_critic.state_dict())
            _copy_tree(source.obs_preprocess_state,
                       dest.obs_preprocess_state)
            tables = [self.reward_hyper_params]
            if self.mmr is not None:
                tables.append(self.mmr.elo)
            if self.episode_score is not None:
                tables += [self.episode_score.mean, self.episode_score.var,
                           self.episode_score.N]
            for table in tables:
                if table is not None:
                    table[dst] = table[src]


@dataclass
class PopulationStack:
    """A population as its policy-batched forms read it
    (``Population.stacked``): ``params`` and ``obs_states`` hold every
    policy's as ``[P, ...]`` stacks; ``actor_critic`` and
    ``obs_preprocess`` (policy 0's) give the structure, their own
    parameters unread. Each method runs over chunk-order inputs, chunk b
    with policy ``layout.chunk_policy[b]``'s weights."""

    population: Population
    actor_critic: ActorCritic
    obs_preprocess: ObservationsPreprocess
    params: StackedParams
    obs_states: Dict[str, Any]

    def preprocess(self, layout, obs):
        return self.obs_preprocess.preprocess_chunked(self.obs_states, obs,
                                                      layout)

    def rollout(self, layout, generator, rnn_states, obs,
                sample_actions=True):
        return self.actor_critic.rollout_chunked(
            self.params, layout, generator, rnn_states, obs,
            sample_actions=sample_actions)

    def critic_only(self, layout, rnn_states, obs):
        return self.actor_critic.critic_only_chunked(self.params, layout,
                                                     rnn_states, obs)


@dataclass
class PolicyTrainState:
    hyper_params: HyperParams
    tx: Any
    opt_state: Any
    initial_weight_norms: Dict[str, torch.Tensor]
    generator: torch.Generator
    max_advantage_est: EMAEstimate
    max_advantage_est_state: Dict[str, torch.Tensor]
    value_normalizer: Optional[EMANormalizer] = None
    value_normalizer_state: Optional[Dict[str, torch.Tensor]] = None
    scaler: Optional[DynamicScale] = None
    scaler_state: Optional[Dict[str, torch.Tensor]] = None


@dataclass
class StackedTrainState:
    """The train policies' learn state as ``[P, ...]`` stacks, which
    ``ppo._ppo_population`` updates in place (JAX keeps a population's train
    state stacked throughout; the port stacks it at the start of "Learn"
    and ``write_back`` returns it to the modules and ``PolicyTrainState``s
    under "Set New Policy States", so checkpoints, ``copy_policy``, surgery
    and the collect's ``Population.stacked()`` see the same objects as
    ever). While the learn runs, each train policy's module parameters are
    views of its rows of ``leaves``, so ``policy_views`` hands the
    ``optimize_metrics`` hook every policy's current state, as JAX and the
    per-policy loop do, without a copy. ``leaves``, every parameter path's
    stack, requiring grad; the Adam state (count ``[P]``); the searched
    ``lr`` and ``entropy_coef`` as ``[P]`` tensors; the initial weight
    norms ``[P]``, the value normalizer's state and, under float16 loss
    scaling, each policy's own scaler state (``scale`` / ``fin_steps``
    ``[P]``). ``actor_critic`` (policy 0's) gives the structure;
    ``hyper_params``, ``tx``, ``value_normalizer`` and ``scaler`` (policy
    0's) the rest, which is the configuration's and the same for every
    policy."""

    policies: List[PolicyState]
    train_states: List[PolicyTrainState]
    actor_critic: ActorCritic
    hyper_params: HyperParams
    tx: Any
    leaves: Dict[str, torch.Tensor]
    opt_state: AdamState
    lr: torch.Tensor
    entropy_coef: torch.Tensor
    initial_weight_norms: Dict[str, torch.Tensor]
    value_normalizer: Optional[EMANormalizer]
    value_normalizer_state: Optional[Dict[str, torch.Tensor]]
    scaler: Optional[DynamicScale] = None
    scaler_state: Optional[Dict[str, torch.Tensor]] = None

    @staticmethod
    def stack(policies: List[PolicyState],
              train_states: List[PolicyTrainState]) -> "StackedTrainState":
        first, hp = train_states[0], train_states[0].hyper_params
        for i, ts in enumerate(train_states):
            for name in ("clip_coef", "value_loss_coef", "max_grad_norm"):
                if getattr(ts.hyper_params, name) != getattr(hp, name):
                    raise ValueError(
                        f"the batched learn takes one {name} for every "
                        f"train policy; policy {i} has "
                        f"{getattr(ts.hyper_params, name)}, policy 0 "
                        f"{getattr(hp, name)}")
        device = first.opt_state.count.device

        def stack(trees):
            return tree_stack(trees) if trees[0] is not None else None

        def per_policy(name):
            return torch.stack([torch.as_tensor(
                getattr(ts.hyper_params, name), dtype=torch.float32,
                device=device) for ts in train_states])

        with torch.no_grad():
            named = [dict(p.actor_critic.named_parameters())
                     for p in policies]
            leaves = {k: torch.stack([n[k] for n in named]).requires_grad_()
                      for k in named[0]}
            # Each module's parameters become views of its rows.
            for p, n in enumerate(named):
                for k, param in n.items():
                    param.data = leaves[k].detach()[p]
            opts = [vars(ts.opt_state) for ts in train_states]
            return StackedTrainState(
                policies=policies, train_states=train_states,
                actor_critic=policies[0].actor_critic, hyper_params=hp,
                tx=first.tx, leaves=leaves, opt_state=AdamState(**stack(opts)),
                lr=per_policy("lr"), entropy_coef=per_policy("entropy_coef"),
                initial_weight_norms=stack(
                    [ts.initial_weight_norms for ts in train_states]),
                value_normalizer=first.value_normalizer,
                value_normalizer_state=stack(
                    [ts.value_normalizer_state for ts in train_states]),
                scaler=first.scaler,
                scaler_state=stack([ts.scaler_state for ts in train_states]))

    def _state_rows(self, p):
        """Views of row p of the Adam, value-normalizer and scaler
        stacks."""
        rows = lambda tree: (None if tree is None else
                             {k: v[p] for k, v in tree.items()})
        return dict(
            opt_state=AdamState(**tree_map(lambda x: x[p],
                                           vars(self.opt_state))),
            value_normalizer_state=rows(self.value_normalizer_state),
            scaler_state=rows(self.scaler_state))

    def policy_views(self, p):
        """Train policy p's current learn state, as the per-policy loop hands
        it to the ``optimize_metrics`` hook: its ``PolicyState`` (whose
        module's parameters are its rows of ``leaves`` while the learn
        runs) and a ``PolicyTrainState`` whose Adam, value-normalizer and
        scaler states are views of its rows of the stacks; its
        hyperparameters are the ones its rows were stacked from, which the
        learn does not change."""
        return self.policies[p], dataclasses.replace(self.train_states[p],
                                                     **self._state_rows(p))

    def write_back(self):
        """Each policy's module parameters own their storage again (a copy
        of their rows of the stacks) and its train state takes views of its
        rows."""
        with torch.no_grad():
            for p, (policy, ts) in enumerate(zip(self.policies,
                                                 self.train_states)):
                for param in policy.actor_critic.parameters():
                    param.data = param.data.clone()
                for name, rows in self._state_rows(p).items():
                    setattr(ts, name, rows)


def initial_weight_norms(actor_critic) -> Dict[str, torch.Tensor]:
    """L2 norm of every ``kernel`` parameter outside the actor and critic
    heads (the MLP Dense kernels and the LSTM input projections; the
    ``recurrent_kernel`` is not a ``kernel`` leaf and stays free)."""
    with torch.no_grad():
        return {name: torch.linalg.vector_norm(p).clone()
                for name, p in actor_critic.named_parameters()
                if name.rsplit(".", 1)[-1] == "kernel"
                and name.split(".", 1)[0] not in ("actor", "critic")}


def _setup_value_normalizer(hyper_params: HyperParams, device):
    """The normalizer of a scalar critic's float32 [..., 1] values."""
    normalizer = EMANormalizer(decay=hyper_params.value_normalizer_decay,
                               norm_dtype=torch.float32)
    return normalizer, normalizer.init_estimates(
        torch.zeros((1, 1), dtype=torch.float32, device=device))


def _seed(*key) -> int:
    return int(np.random.SeedSequence(list(key)).generate_state(1)[0])


@dataclass
class TrainStateManager:
    policy_states: Any  # PolicyState, or a Population with PBT
    train_states: Any  # PolicyTrainState, or a list of them with PBT
    user_state: Any
    pbt_generator: Optional[torch.Generator] = None

    # -- checkpoints ------------------------------------------------------

    def _policies(self) -> List[PolicyState]:
        states = self.policy_states
        return states.policies if isinstance(states, Population) else [states]

    def _train_state_list(self) -> List[PolicyTrainState]:
        states = self.train_states
        return states if isinstance(states, list) else [states]

    def checkpoint(self, next_update: int) -> Dict[str, Any]:
        """The checkpoint tree (module docstring), snapshotted to the
        host."""
        population = None
        if isinstance(self.policy_states, Population):
            pop = self.policy_states
            population = {
                "reward_hyper_params": pop.reward_hyper_params,
                "mmr": None if pop.mmr is None else {"elo": pop.mmr.elo},
                "episode_score": (None if pop.episode_score is None
                                  else dict(vars(pop.episode_score)))}
        return _host({
            "next_update": int(next_update),
            "policy_states": [
                {"actor_critic": p.actor_critic.state_dict(),
                 "obs_preprocess_state": p.obs_preprocess_state}
                for p in self._policies()],
            "train_states": [_train_state_tree(ts)
                             for ts in self._train_state_list()],
            "population": population,
            "pbt_generator": (None if self.pbt_generator is None
                              else self.pbt_generator.get_state()),
            "user_state": self.user_state,
        })

    def save(self, next_update: int, path: str, block: bool = True):
        """Write the checkpoint file ``path``, under a temporary name that
        is renamed when the file is complete. The tensors are copied to the
        host before this returns; with ``block=False`` the file is written
        on a background thread (``wait_for_checkpoints``)."""
        tree = self.checkpoint(next_update)
        if block:
            _write(tree, path)
            return
        thread = threading.Thread(target=_write_logged, args=(tree, path),
                                  name="checkpoint-writer")
        _WRITERS.append(thread)
        thread.start()

    def load(self, path: str):
        """Copy checkpoint ``path`` into this manager's modules and
        tensors, in place and on their devices, and set every generator's
        state. The checkpoint must come from the same configuration; a
        single-policy manager skips its population entries and PBT
        generator. Returns ``(self, next_update)``."""
        ckpt = TrainStateManager.restore_host(path)
        policies, train_states = self._policies(), self._train_state_list()
        if (len(ckpt["policy_states"]), len(ckpt["train_states"])) != \
                (len(policies), len(train_states)):
            raise ValueError(
                f"{path}: {len(ckpt['policy_states'])} policies and "
                f"{len(ckpt['train_states'])} train states, this manager "
                f"{len(policies)} and {len(train_states)}")
        for i, (policy, saved) in enumerate(zip(policies,
                                                ckpt["policy_states"])):
            policy.actor_critic.load_state_dict(saved["actor_critic"])
            policy.obs_preprocess_state = _load_into(
                policy.obs_preprocess_state, saved["obs_preprocess_state"],
                f"policy {i} obs_preprocess_state")
        for i, (ts, saved) in enumerate(zip(train_states,
                                            ckpt["train_states"])):
            _load_train_state(ts, saved, f"train state {i}")
        if isinstance(self.policy_states, Population):
            population = ckpt["population"]
            if population is None:
                raise ValueError(f"{path}: a single-policy checkpoint and a "
                                 f"population manager")
            pop = self.policy_states
            pop.reward_hyper_params = _load_into(
                pop.reward_hyper_params, population["reward_hyper_params"],
                "reward_hyper_params")
            pop.mmr = _load_into(pop.mmr, population["mmr"] and MMR(
                **population["mmr"]), "mmr")
            pop.episode_score = _load_into(
                pop.episode_score, population["episode_score"] and
                MovingEpisodeScore(**population["episode_score"]),
                "episode_score")
            _set_generator(self.pbt_generator, ckpt["pbt_generator"],
                           "pbt_generator")
        self.user_state = _load_into(self.user_state, ckpt["user_state"],
                                     "user_state")
        return self, int(ckpt["next_update"])

    @staticmethod
    def restore_host(path: str) -> Dict[str, Any]:
        """Checkpoint ``path`` as its tree of CPU tensors."""
        return torch.load(path, map_location="cpu", weights_only=True)

    @staticmethod
    def slice_checkpoint(src: str, dst: str, train_select, past_select):
        """Write to ``dst`` the checkpoint ``src`` with the train policies
        ``train_select`` (and their train states) followed by the policies
        ``past_select`` as past policies."""
        ckpt = TrainStateManager.restore_host(src)
        train_select = [int(i) for i in train_select]
        order = train_select + [int(i) for i in past_select]
        ckpt["policy_states"] = [ckpt["policy_states"][i] for i in order]
        ckpt["train_states"] = [ckpt["train_states"][i]
                                for i in train_select]
        if ckpt["population"] is not None:
            index = torch.tensor(order, dtype=torch.long)
            ckpt["population"] = _map_tensors(lambda x: x[index],
                                              ckpt["population"])
        _write(ckpt, dst)

    @staticmethod
    def load_policies(policy: Policy, path: str):
        """The policies of checkpoint ``path``, for evaluation: a
        ``PolicyState`` for a checkpoint without population entries (the
        port's single-policy ones), else a ``Population`` (a checkpoint
        carried over from the JAX package, whose fitness it keeps),
        each module a copy of ``policy.actor_critic`` (or of
        ``policy.actor_critic(0)`` when it builds a population's modules)
        with the saved parameters. Returns ``(policy_states,
        num_train_policies, total_num_policies)``."""
        ckpt = TrainStateManager.restore_host(path)
        saved = ckpt["policy_states"]
        template = (policy.actor_critic
                    if isinstance(policy.actor_critic, torch.nn.Module)
                    else policy.actor_critic(0))
        obs_preprocess = (policy.obs_preprocess
                          or ObservationsPreprocessNoop.create())
        policies = []
        for entry in saved:
            module = copy.deepcopy(template)
            module.load_state_dict(entry["actor_critic"])
            policies.append(PolicyState(
                actor_critic=module, obs_preprocess=obs_preprocess,
                obs_preprocess_state=entry["obs_preprocess_state"]))
        num_train, total = len(ckpt["train_states"]), len(saved)
        population = ckpt["population"]
        if population is None:
            return policies[0], num_train, total
        return Population(
            policies=policies,
            reward_hyper_params=population["reward_hyper_params"],
            get_episode_scores_fn=(policy.get_episode_scores
                                   or (lambda er: (0.0, 0.0))),
            episode_score=(population["episode_score"] and
                           MovingEpisodeScore(
                               **population["episode_score"])),
            mmr=population["mmr"] and MMR(**population["mmr"]),
        ), num_train, total

    @staticmethod
    def create(policy: Policy, cfg: TrainConfig, algo: AlgoBase,
               init_user_state_cb: Callable, example_obs, device,
               generator: torch.Generator) -> "TrainStateManager":
        actor_critic = policy.actor_critic.to(device)
        policy_state = _make_policy_state(policy, actor_critic, example_obs)
        return TrainStateManager(
            policy_states=policy_state,
            train_states=_make_train_state(cfg, algo, actor_critic, device,
                                           generator),
            user_state=init_user_state_cb(),
        )

    @staticmethod
    def create_population(policy: Policy, cfg: TrainConfig, algo: AlgoBase,
                          init_user_state_cb: Callable, example_obs,
                          device, use_competitive_mmr: bool
                          ) -> "TrainStateManager":
        """The PBT population: train policy p is ``policy.actor_critic(p)``
        (each from its own seed); past policy j copies train policy j mod
        ``num_train_policies``. Fitness starts at Elo 1500 or an empty
        episode score; the reward hyperparameters at 0."""
        P, num_past = cfg.pbt.num_train_policies, cfg.pbt.num_past_policies
        if isinstance(policy.actor_critic, torch.nn.Module):
            raise TypeError("a PBT population needs Policy.actor_critic as "
                            "a callable: train policy index -> ActorCritic")
        train_modules = [policy.actor_critic(p).to(device) for p in range(P)]
        modules = train_modules + [copy.deepcopy(train_modules[j % P])
                                   for j in range(num_past)]
        policies = [_make_policy_state(policy, m, example_obs)
                    for m in modules]
        total = P + num_past
        num_reward = len(cfg.pbt.reward_hyper_params_explore)
        if use_competitive_mmr:
            mmr = MMR(elo=torch.full((total,), 1500.0, dtype=torch.float32,
                                     device=device))
            episode_score = None
        else:
            mmr = None
            zeros = lambda dt: torch.zeros((total,), dtype=dt, device=device)
            episode_score = MovingEpisodeScore(
                mean=zeros(torch.float32), var=zeros(torch.float32),
                N=zeros(torch.int32))
        population = Population(
            policies=policies,
            reward_hyper_params=(
                torch.zeros((total, num_reward), dtype=torch.float32,
                            device=device) if num_reward else None),
            get_episode_scores_fn=(policy.get_episode_scores
                                   or (lambda er: (0.0, 0.0))),
            episode_score=episode_score,
            mmr=mmr)
        train_states = [
            _make_train_state(cfg, algo, modules[p], device,
                              torch.Generator(device=device).manual_seed(
                                  _seed(cfg.seed, 1, p)))
            for p in range(P)]
        return TrainStateManager(
            policy_states=population, train_states=train_states,
            user_state=init_user_state_cb(),
            pbt_generator=torch.Generator(device=device).manual_seed(
                _seed(cfg.seed, 2)))


def _make_policy_state(policy: Policy, actor_critic, example_obs):
    obs_preprocess = (policy.obs_preprocess
                      or ObservationsPreprocessNoop.create())
    # Batch-1 example obs: only shapes matter.
    return PolicyState(
        actor_critic=actor_critic,
        obs_preprocess=obs_preprocess,
        obs_preprocess_state=obs_preprocess.init_state(
            {k: v[0:1] for k, v in example_obs.items()}))


def _make_train_state(cfg: TrainConfig, algo: AlgoBase, actor_critic,
                      device, generator) -> PolicyTrainState:
    hyper_params = algo.init_hyperparams(cfg)
    tx = algo.make_optimizer(hyper_params)
    value_norm, value_norm_state = None, None
    if cfg.normalize_values:
        value_norm, value_norm_state = _setup_value_normalizer(
            hyper_params, device)
    scaler, scaler_state = None, None
    if cfg.compute_dtype == torch.float16:
        scaler = DynamicScale()
        scaler_state = scaler.init_state(device)
    max_adv_est = EMAEstimate(decay=hyper_params.max_advantage_est_decay)
    params = {k: p.detach() for k, p in actor_critic.named_parameters()}
    return PolicyTrainState(
        hyper_params=hyper_params,
        tx=tx,
        opt_state=tx.init(params),
        initial_weight_norms=initial_weight_norms(actor_critic),
        generator=generator,
        max_advantage_est=max_adv_est,
        max_advantage_est_state=max_adv_est.init_estimates(
            torch.zeros((1,), dtype=torch.float32, device=device)),
        value_normalizer=value_norm,
        value_normalizer_state=value_norm_state,
        scaler=scaler,
        scaler_state=scaler_state)


# -- Checkpoint helpers ------------------------------------------------------

# Background checkpoint writes (save(..., block=False)) and their errors.
_WRITERS: List[threading.Thread] = []
_WRITE_ERRORS: List[BaseException] = []


def wait_for_checkpoints():
    """Block until every checkpoint saved with ``block=False`` is written;
    raise the first error a write met."""
    while _WRITERS:
        _WRITERS.pop(0).join()
    if _WRITE_ERRORS:
        error = _WRITE_ERRORS[0]
        _WRITE_ERRORS.clear()
        raise error


def _write(tree, path: str):
    """``torch.save`` to a temporary name beside ``path``, synced to disk,
    then renamed and the rename synced: ``path`` is never a partly written
    file, after a crash of the process or of the machine."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_logged(tree, path: str):
    try:
        _write(tree, path)
    except Exception as error:  # raised by wait_for_checkpoints
        _WRITE_ERRORS.append(error)


def _map_tensors(fn, tree):
    """``fn`` over every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _host(tree):
    """A copy of ``tree`` with every tensor detached and on the CPU."""
    return _map_tensors(lambda x: x.detach().to("cpu", copy=True), tree)


def _train_state_tree(ts: PolicyTrainState) -> Dict[str, Any]:
    return {
        "hyper_params": dict(vars(ts.hyper_params)),
        "opt_state": dict(vars(ts.opt_state)),
        "initial_weight_norms": ts.initial_weight_norms,
        "max_advantage_est_state": ts.max_advantage_est_state,
        "value_normalizer_state": ts.value_normalizer_state,
        "scaler_state": ts.scaler_state,
        "generator": ts.generator.get_state(),
    }


def _load_into(dst, src, what: str):
    """``src`` into ``dst``: tensors copied in place (shapes must agree),
    dicts, lists, tuples and dataclasses leaf by leaf (their structure must
    agree); any other leaf is ``src``. Returns the loaded tree."""
    if (dst is None) != (src is None):
        raise ValueError(f"{what}: the checkpoint holds {type(src)}, the "
                         f"manager {type(dst)}")
    if isinstance(dst, torch.Tensor):
        src = torch.as_tensor(src)
        if src.shape != dst.shape:
            raise ValueError(f"{what}: shape {tuple(src.shape)} in the "
                             f"checkpoint, {tuple(dst.shape)} here")
        with torch.no_grad():
            dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if set(src) != set(dst):
            raise ValueError(f"{what}: keys {sorted(src)} in the "
                             f"checkpoint, {sorted(dst)} here")
        for k in dst:
            dst[k] = _load_into(dst[k], src[k], f"{what}.{k}")
        return dst
    if isinstance(dst, (list, tuple)):
        if len(src) != len(dst):
            raise ValueError(f"{what}: {len(src)} entries in the "
                             f"checkpoint, {len(dst)} here")
        return type(dst)(_load_into(d, s, f"{what}[{i}]")
                         for i, (d, s) in enumerate(zip(dst, src)))
    if dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            setattr(dst, f.name, _load_into(
                getattr(dst, f.name), getattr(src, f.name),
                f"{what}.{f.name}"))
        return dst
    return src


def _set_generator(generator: Optional[torch.Generator], state, what: str):
    """Set ``generator`` to a saved state, or seed it from an int (a
    checkpoint carried over from the JAX package)."""
    if (generator is None) != (state is None):
        raise ValueError(f"{what}: the checkpoint and the manager disagree "
                         f"on whether it exists")
    if generator is None:
        return
    if isinstance(state, int):
        generator.manual_seed(state)
    else:
        generator.set_state(state)


def _load_train_state(ts: PolicyTrainState, saved, what: str):
    hp = ts.hyper_params
    names = {f.name for f in dataclasses.fields(hp)}
    if set(saved["hyper_params"]) != names:
        raise ValueError(f"{what}: hyperparameters "
                         f"{sorted(saved['hyper_params'])}, expected "
                         f"{sorted(names)}")
    for name, value in saved["hyper_params"].items():
        setattr(hp, name, _load_into(getattr(hp, name), value,
                                     f"{what} hyper_params.{name}"))
    ts.opt_state = _load_into(ts.opt_state, AdamState(**saved["opt_state"]),
                              f"{what} opt_state")
    for name in ("initial_weight_norms", "max_advantage_est_state",
                 "value_normalizer_state", "scaler_state"):
        setattr(ts, name, _load_into(getattr(ts, name), saved[name],
                                     f"{what} {name}"))
    _set_generator(ts.generator, saved["generator"], f"{what} generator")
