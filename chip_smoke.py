#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

(``python3 chip_smoke.py --digests`` runs phases 1 and 2, then prints the
SHA-256 of the LSTM and GRU kernels' tensor-core instances (bf16, and
float16 at 128 / 256; the chunk-indexed ones included, and the fused
step's), ``mha``'s, ``gae``'s and the two ``layer_norm`` kernels'
outputs from seeded inputs, to hold two
checkouts' kernels bitwise equal: copy the script into the other
checkout's root and run it there too. ``--timings`` runs phases 1 and 2,
then times ``gae``, ``layer_norm_fwd`` and ``layer_norm_bwd`` at their
main-path shapes three ways: between CUDA events, on the device alone and
on the host, with ``native_layer_norm`` and ``native_layer_norm_backward``
beside them; run from another checkout in the same way, it times that
checkout's kernels.)

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles ``madrona_learn_tpu_torch/csrc/*.cu`` with nvcc;
3. kernels: each hand-written kernel against its plain PyTorch version at
   the main paths' shapes and at ragged ones, with the stated tolerances;
   the median time of the kernel, of the plain version and, where one
   PyTorch call computes the same function, of that call; and each
   kernel's bound, the least time the card could take for the same work.
   ``mha`` and ``mha_flash`` are also run with the keys past ``valid_len``
   poisoned, ``mha_flash`` at the update pass's B = 4096 must equal the
   rollout step's B = 512 bitwise on the rows they share, and ``mha`` at
   the update pass's B = 131072 must equal the rollout step's B = 16384
   and give the batch rolled by 5 items rolled, bitwise; the kernels with
   a tensor-core route (the four LSTM kernels, the two GRU kernels,
   ``mha``, the fused step) are held to their path rules, the backwards at
   N = 8192 must equal N = 256 bitwise on the shared rows and give bitwise
   equal weight gradients over two calls, the fused step at N = 16384 must
   equal N = 512 bitwise on the shared rows, the LSTM and GRU forwards at
   N = 8192 must equal N = 256 on the shared rows and the batch rolled by
   5 rows bitwise, a T = 1 call from the cleared state must equal the
   matching step of the T = 16 call bitwise, and at ragged N they must
   write no row past N; the LSTM and GRU kernels' float16 instances (on
   tensor cores, held bitwise as the bf16 ones: batch invariance, and for
   the forwards the rollout step) are checked,
   forward and backward, and timed at
   headline_fp16's and headline_gru_fp16's update minibatch and rollout
   step, with their bounds at 2 bytes an element; ``gae`` must equal its plain
   version bitwise at four shapes and on the columns two calls share, and
   is timed at each steps-a-chunk and columns-a-block pair it is built
   for; ``layer_norm_fwd``'s y and ``layer_norm_bwd``'s dx at N = 131072
   must equal N = 16384's on the shared rows, and the forward's y, mu and
   rsigma and the backward's dw / db must be bitwise equal over two calls;
   the three are also timed on the device alone (torch.profiler) and on
   the host (the enqueue), ``layer_norm_bwd`` by launch, and
   ``native_layer_norm`` the same way; ``grouped_matmul`` is also run and
   timed at headline_pbt's batched-pass shapes (75 chunks of 512 rows, 12
   policies: 2 -> 256, 256 -> 256, 256 -> 1024); and
   ``lstm_sequence_fwd_chunked`` (the chunk-indexed instance of the LSTM
   forward, on tensor cores in bf16) at headline_pbt's collect step (the
   chunk size and count init_training derives) and at chunks of 100 rows
   in bf16 and float32: against its plain twin, every row bitwise
   ``lstm_sequence_fwd``'s with its policy's weights, the first 8 chunks
   alone and the chunks rolled bitwise, chunks of index P and -1 skipped
   (NaN rows, the others unchanged), and timed against one
   ``lstm_sequence_fwd`` a policy over the same rows; and
   ``lstm_sequence_bwd_chunked`` (the chunk-indexed backward) at
   headline_pbt's learn step (8 train policies, one chunk of a minibatch's
   1280 sequences each, T = 16, bf16) and at chunks of 37 rows in a
   shuffled order (one policy of two chunks, one of none) in bf16 and
   float32: against its twin's autograd, every chunk's dx_proj / dh0 /
   dc0 bitwise ``lstm_sequence_bwd``'s on its rows, each policy's dwr / db
   within the backward's tolerance of that kernel's, bitwise over two
   calls and, for a policy of one chunk, bitwise its chunk alone, chunks
   of index P and -1 NaN and in no policy's gradients, and timed against
   one ``lstm_sequence_bwd`` a policy over the same rows; and the GRU's
   chunk-indexed instances the same way: ``gru_sequence_fwd_chunked`` at
   headline_pbt_gru's collect step (T = 1, 75 chunks of 512 rows, 12
   policies) and learn step (T = 16, 8 chunks of 1280, 8 policies), and
   ``gru_sequence_bwd_chunked`` at the learn step, both also at chunks of
   37 rows in a shuffled order in bf16 and float32 (every row bitwise the
   single-policy kernel's, bitwise over two calls and for a chunk alone,
   chunks of index P and -1 NaN, each policy's dwh / dbh within the
   tolerance of the single-policy backward's sum and, where 64 divides
   the chunk, bitwise it), each timed against one single-policy launch a
   policy; and the fused trunk's chunk-indexed instances the same way:
   ``fused_policy_step_chunked`` at headline_pbt_fused's collect step (75
   chunks of 512 rows, 12 policies, F = 2, bf16 on tensor cores) and at
   chunks of 37 rows in a shuffled order (bf16 at H = 256 and 128, f32),
   ``lstm_sequence_proj_fwd_chunked`` / ``_bwd_chunked`` at its learn
   step ([16, 8 x 1280, 256 -> 1024], one chunk a train policy) and at
   chunks of 37 rows (bf16 at H = 256 and 128, f32): every row bitwise
   the single-policy kernel's, each policy's dwi / dwr / db within the
   tolerance of the single-policy backward's sum and, at C = 1280,
   bitwise it; and the float16 instances of ``grouped_matmul`` at
   headline_pbt's three pass shapes (tensor cores at 256 -> 256 and 256 ->
   1024, CUDA cores at IN = 2), of ``lstm_sequence_fwd_chunked`` /
   ``gru_sequence_fwd_chunked`` at the collect step (the LSTM's also at
   the learn step) and of their backwards at the learn step (tensor cores
   at 256): against the
   plain twins (the recurrences within 2^-8, ``grouped_matmul`` within
   one float16 ulp of the largest value), every row bitwise one
   single-policy float16 launch a policy over the same rows, chunks of
   index P and -1 NaN, and timed against those launches (the
   ``kernels`` line's ``float16`` entries); and the same four checks of
   the chunk-indexed recurrences again at H = 384 and 512 (CUDA cores in
   every dtype but the bf16 LSTM kernels' and GRU forward's two-block
   clusters on tensor cores), with
   infer_512's step and the learn step for the LSTM forward:
   every check
   above at those widths (batch invariance, bitwise rows, a one-chunk
   policy's dW / db bitwise the single-policy kernel's on CUDA cores, the
   forwards' T = 1 steps bitwise their sequence's steps at every width),
   and the single-policy kernels at those widths against their twins,
   timed (the ``kernels`` line's ``wide`` entries); the fused trunk's
   checks above again at H = 384 and 512 (bf16 on the two-block
   clusters, f32 on CUDA cores; the projection also at F = 128 and 4H),
   with the single-policy step and projection kernels against their
   twins, their bitwise checks and the projection's product witness
   (``_lstm_proj_witness``: the backward's recomputed round(x . Wi) and
   round(x . Wi) + h . Wr bitwise the forward's); and
   ``layer_norm_fwd_chunked`` / ``_bwd_chunked`` at
   headline_pbt_lnkernel's collect and learn rows and at ragged chunks:
   against the twin, every row (y, mu, rsigma, dx) bitwise one
   single-policy launch's, dscale / dbias bitwise over two calls and
   within the f32 sums' tolerance of each policy's ``layer_norm_bwd``,
   chunks of index P and -1 NaN, timed against a launch a policy and
   ``native_layer_norm`` (and its backward) with one policy's weight;
4. models: the update pass and its gradients through the kernels on the
   card against the same model on the CPU, for the MLP model, a small GRU
   model, a small fused-trunk model, a small flagship (entity attention)
   model and the same over 281 entities (``mha_flash``) (the GRU's and the
   fused trunk's rollout step are also compared), the MLP model with a
   two-part HL-Gauss critic, and with a dense critic under value
   normalization and the clipped Huber value loss (the normalizer's
   update compared too); then
   ``LayerNorm(use_kernel=True)``, the entry point of the layer_norm
   kernels, forward and backward at [131072, 256] bf16 and [300, 128]
   float32, and ``grouped_matmul``, the one entry point of its kernel, at
   the three ``benchmarks/grouped_matmul_bench.py`` shapes in bf16, each
   with the launches of its path counted;
5. headline trainer: the ``bench.py`` headline configuration (16384
   worlds, 2x256 MLP, 256-wide LSTM, bf16, T=32 in 2 BPTT chunks, 1 epoch
   of 4 minibatches) built in the port, 1 warm-up update and 3 trials of 10;
   headline_valuenorm trainer: the headline with value normalization
   (decay 0.99999), the clipped value loss and the Huber value loss; its
   value normalizer's state must be finite, folded in once a minibatch and
   moved from mu = 0, sigma = 1;
   headline_hlgauss trainer: the headline with ``HLGaussCritic`` (127 bins
   over [-100, 100]) in the dense critic's place; both 1 warm-up update and
   3 trials of 10, with the headline's launches and a first-minibatch
   max |ratio - 1| of exactly 0;
   the advantage side, each 1 warm-up update and 2 trials of 5:
   headline_importance (the headline drawing 2 of its 4 minibatches by
   trajectory importance sampling: ``lstm_sequence_fwd`` 35 and
   ``lstm_sequence_bwd`` 2 an update, ratio exactly 0, then the path's
   weights and draw on one more rollout: distinct, finite and positive),
   headline_stratified (``minibatch_stratify=4``: the headline's
   launches, ratio exactly 0, then one epoch's index stream on the card:
   2048 rows of each block a minibatch, block-major, every sequence
   once), mlp_filter (the headline's MLP, actor and critic without the
   LSTM, bf16, advantage filtering over minibatches of 131072 rows:
   ``gae`` only; the max-|advantage| estimate moved once an update),
   mlp_fp16 (that model in float16 with the observations cast and the
   loss scaled: ``gae`` only; the scale backed off once a non-finite step,
   parameters finite) and headline_continuous (the headline's trunk with
   a 2-dim continuous head over the gridworld behind an adapter: the
   headline's launches, its rewards logged but not held to rise);
6. flagship trainer: the repo's flagship model (EntitySelfAttentionNet
   128 -> 256 with 4 heads, LSTM 256, [5, 3] actions, DreamerV3 critic,
   bf16) at the same rollout and PPO settings over entity observations
   made from the toy gridworld, 1 warm-up update and 3 trials of 5;
7. headline_fused trainer: the headline with the fused trunk (the rollout
   step as one ``fused_policy_step`` launch, the LSTM's input projection
   inside ``lstm_sequence_proj``), 1 warm-up update and 3 trials of 10;
8. native trainer: the headline_fused model over the C++ batch simulator
   (``make_native_sim``, built with g++), 1 warm-up update and 2 trials
   of 4;
9. headline_gru trainer: the headline with GRU(256, 256, 1, bf16) in the
   LSTM's place (``gru_sequence_fwd`` / ``gru_sequence_bwd``), 1 warm-up
   update and 3 trials of 10;
10. flagship_large trainer: the flagship over 511 entities (self, 255
    allies, 255 enemies, padded to 512), so its attention takes
    ``mha_flash`` (forward, and the dK/dV and dQ kernels), at 512 worlds,
    1 warm-up update and 3 trials of 30 (its reward rises late);
11. headline_pbt: BASELINE config #4, population-based training (8 train
    and 4 past policies over the bidding duel, 16384 worlds x 2 agents,
    25% self, 50% cross and 25% past play, the headline's MLP + LSTM in
    bf16, lr searched in log10 space, 4 minibatches of 1280 sequences a
    policy), 1 warm-up update and 2 trials of 5, then ``eval_elo`` over 64
    steps and ``update_population``, the population in the rollout's
    policy-chunk layout (12 policies, 75 chunks of 512 rows) and the
    batched learn (one PPO step a minibatch over the 8 train policies).
    Besides the trainers' checks (launch counts: ``lstm_sequence_fwd_
    chunked`` once a step, once for the batched bootstrap value and once
    a minibatch, ``lstm_sequence_bwd_chunked`` once a minibatch,
    ``grouped_matmul`` 5 times a step and 4 for the bootstrap, ``gae``
    once, no single-policy LSTM kernel), every train
    policy's first-minibatch |ratio - 1| is below 1e-3, no step copies
    policy counts to the host, at one rollout step every row's value
    equals its own policy's module run over all rows (and the next
    policy's would differ by more than twice the tolerance), one collect
    from one rollout state through the chunked path, through the
    per-policy loop and with ``chunkwise_rnn`` (bitwise the chunked
    one's) is timed, the chunked one also profiled (launches a collect
    step, kernel time, idle share), one update's learn from one state
    batched and through the per-policy loop is timed with its launches,
    the batched one also profiled (the largest parameter difference at
    most twice the loop's largest move), the
    eight learning rates are distinct and in
    [1e-4, 1e-2], the assignments keep their invariants after every training step (the
    self-play block and team 0 fixed, cross opponents other train
    policies, past opponents past policies, 2560 train agents a policy;
    checked on the device, read after each stage, the timed trials
    included), the Elo ratings are finite with policy 0 at 1500 and the
    training portions restored, and every copy of the population update
    is bitwise, with a finite lr and the destination's own generator;
12. checkpoint_eval: checkpoints and offline evaluation at full width,
    each run with the launch counts set to 0 just before it and read just
    after: (a) the headline after its warm-up and 2 updates is saved
    (``save_ckpt``; bytes and time printed), its rollout state copied and
    one more update run; a fresh headline built with
    ``restore_ckpt=latest_checkpoint(...)`` must hold every tensor and
    generator state of the save bitwise, and given the copied rollout
    state its next update must launch exactly the headline's kernels
    (``lstm_sequence_fwd`` 37, ``lstm_sequence_bwd`` 4, ``gae`` 1) and
    leave every parameter bitwise the uninterrupted update's (max |delta|
    printed); (b) ``eval_policies`` of that
    checkpoint, the deterministic policy over 16384 worlds for 64 steps,
    twice: the policy-chunk layout's ``lstm_sequence_fwd_chunked`` once a
    step and ``grouped_matmul`` 5 times, no other kernel, the two
    runs' actions bitwise equal, eval env-steps/s printed; (c) the trained
    headline_pbt population (8 + 4 policies) saved and restored into a
    fresh manager, every tensor, Elo, hyperparameter and generator state
    bitwise; (d) ``eval_load_ckpt(train_only=True)`` and a competitive
    ``eval_policies`` over the duel at 16384 worlds x 2 agents for 32
    steps: ``lstm_sequence_fwd_chunked`` once a step and
    ``grouped_matmul`` 5 times, Elo returned at
    1500; (e) headline_pbt with ``custom_policy_ids=[100]`` over a duel
    that plays policy 100's rows with a fixed bid, and ``eval_elo`` over
    32 steps: ``lstm_sequence_fwd_chunked`` once a step and
    ``grouped_matmul`` 5 times (the custom policy's chunks read no
    weights), Elo finite with policy 0 at 1500.
12b. headline_pbt's population (16384 duel worlds x 2 agents, 8 train +
    4 past policies, the same portions and PPO settings) with other
    models, each in the policy-chunk layout and the batched learn, one
    warm-up update whose first minibatch's max |ratio - 1| is below 1e-3
    for every train policy, then timed updates (agent-steps/s), the
    launches exact, then ``_pbt_learn_ab``'s learn A/B:
    headline_pbt_gru (GRU(256, 256, 1, bf16) in the LSTM's place, 3 timed
    updates: ``gru_sequence_fwd_chunked`` 37 an update, 33 in collect and
    4 in learn, ``gru_sequence_bwd_chunked`` 4, ``grouped_matmul`` 164,
    ``gae`` 1, no single-policy GRU kernel; and ``_pbt_collect_ab``'s
    collect A/B), headline_pbt_dreamer (the DreamerV3 critic, 1 timed
    update: the LSTM's chunk-indexed 37 and 4, ``grouped_matmul`` 164) and
    headline_pbt_hlgauss (the two-part HL-Gauss critic, 1 timed update:
    ``grouped_matmul`` 197, its two heads a step and for the bootstrap)
    and headline_pbt_fused (headline_fused's tower, ``use_fused_step`` and
    ``fuse_input_proj``, 1 timed update: ``fused_policy_step_chunked`` 33
    an update, 32 steps and the bootstrap, ``lstm_sequence_proj_fwd_
    chunked`` and ``_bwd_chunked`` 4 each, ``grouped_matmul`` 65, the
    heads', ``gae`` 1, no single-policy kernel; and both A/Bs) and
    headline_pbt_flagship (the flagship's model, EntitySelfAttentionNet
    (128, 256, 4 heads) -> LSTM 256 -> [5, 3] actor and the DreamerV3
    critic, over the duel's [time, acc] as entity sets, 1 timed update:
    ``mha`` 37 an update over every chunk's (in learn every policy's)
    entities folded into its batch, ``lstm_sequence_fwd_chunked`` 37,
    ``_bwd_chunked`` 4, ``grouped_matmul`` 395, 12 a step and 11 for the
    bootstrap, ``gae`` 1; both A/Bs) and headline_pbt_separate
    (headline_separate's two MLP 2 x 256 -> LSTM 256 towers, 1 timed
    update: ``lstm_sequence_fwd_chunked`` 73, ``_bwd_chunked`` 8,
    ``grouped_matmul`` 260, ``gae`` 1; the learn A/B) and
    headline_pbt_fp16 (the headline's model in float16, the obs cast to
    float16, ``compute_dtype=float16``: one loss scaler a train policy;
    headline_pbt's launches, 37 / 4 / 164 / 1, every LSTM launch on
    tensor cores, ``grouped_matmul`` 66 of its 164 on them (the products
    with IN and OUT multiples of 8); both A/Bs), headline_pbt_gru_fp16
    (the GRU in float16: 37 / 4 / 164 / 1, every GRU launch on tensor
    cores, 66 likewise; the learn A/B) and headline_pbt_window
    (headline_window's
    WindowAttentionMemory(256, window 16, 4 heads), bf16: ``grouped_matmul``
    263, 8 a step and 7 for the bootstrap, ``gae`` 1, no recurrent
    kernel; both A/Bs); the float16 phases print each policy's loss scale
    and non-finite steps and run the learn A/B again with train policy 1's
    scale forced to 2^40 (its Adam state bitwise kept, its parameters
    kept but for the per-step projections' rounding, its scale halved a
    minibatch, every scaler the loop's); then
    entity_large_set: the flagship net of 3 policies over 511 entities
    (padded past 256), its ``chunked`` form over 6 shuffled chunks of 64
    rows, one of no policy (NaN), and its ``batched`` form forward and
    backward, each chunk's and policy's output within 3.2e-2 of its
    policy's own forward, launches exact: ``mha_flash_fwd`` 2, the two
    flash backward kernels 1 each, ``grouped_matmul`` 9, ``mha`` 0.
12c. every width the JAX package takes: infer_512
    (``benchmarks/infer_bench.py``'s shape: 32 policies x 16384 agents,
    MLP 2 x 512 over 64 features -> LSTM 512, bf16, a fresh random
    assignment every step through ``compute_policy_chunks``, chunks of 256
    from ``heuristic_policy_chunk_size``, 95 chunks, 200 steps of
    ``rollout_chunked``: ``lstm_sequence_fwd_chunked`` once and
    ``grouped_matmul`` 5 times a step, the LSTM's on tensor cores (its
    two-block cluster), no step on the plain twin, four chunks' critic and new state within the step rule of
    their policy alone; agent-steps/s); then headline_pbt's population
    with the model at 512 channels (headline_pbt_512: headline_pbt's
    launches, 37 / 4 / 164 / 1, the LSTM forward on its 512-wide
    tensor-core instance and the backward on its CUDA-core one, 2 timed
    updates, the learn A/B), with the fused trunk at 512
    (headline_pbt_fused_512: headline_pbt_fused's launches, 33 / 4 / 4 /
    65 / 1, every fused step and projection launch on its two-block
    cluster, 1 timed update, its collect and learn printed against
    headline_pbt_512's), at 32 (headline_pbt_h32: no recurrent
    kernel, the LSTM on its plain twins as JAX takes its jnp twin, on the
    card one gathered batched product a step over the chunks,
    ``grouped_matmul`` 164, ``gae`` 1; one collect step and one learn pass
    of the trained population on the card against the CPU,
    ``_population_card_vs_cpu``; the collect and learn A/Bs) and with
    each MLP
    LayerNorm replaced by ``LayerNorm(use_kernel=True)``
    (headline_pbt_lnkernel: headline_pbt's launches and
    ``layer_norm_fwd_chunked`` 74, ``layer_norm_bwd_chunked`` 8 an update;
    the learn A/B), each 1 warm-up update whose train policies' ratios
    are below 1e-3, finite losses.

13. the rest of the model zoo, five trainers at 16384 worlds with the
    headline's width and PPO settings, each 1 warm-up update and 2 trials
    of 5 (headline_gru_fp16: of 3; flagship_concat_self_remat: 3 of 5,
    as the flagship): headline_separate (an MLP 2 x 256 ->
    LSTM 256 tower for the actor and another for the critic,
    ``BackboneSeparate``, bf16: ``lstm_sequence_fwd`` 73 an update, the
    critic's tower alone for the bootstrap value, ``lstm_sequence_bwd``
    8, ratio exactly 0), headline_fp16 and headline_gru_fp16 (the
    headline and headline_gru in float16 with the observations cast and
    the loss scaled: the headline's and headline_gru's launches, every
    LSTM and GRU launch on the float16 tensor-core instances, the scaler
    checked as at mlp_fp16; ratio exactly 0 at both), headline_window
    (``WindowAttentionMemory(256, window 16, 4 heads)`` in the LSTM's
    place, bf16: ``gae`` alone, its ratio printed) and
    flagship_concat_self_remat (the flagship with ``embed_concat_self``
    and ``remat_trunk_sequence``: ``mha`` 41 an update, 4 of them the
    backward's recomputes; then, from one saved state and rollout copy,
    an update with the trunk rematerialized and one without must give
    bitwise equal parameters, their peak memory printed).
14. tools: the trainer's tools at the headline's width: one update under
    torch.profiler (after one traced and discarded, the profiler's
    warm-up step), its launches counted (``lstm_sequence_fwd`` 37,
    ``lstm_sequence_bwd`` 4, ``gae`` 1), every named range of the update
    present, each launch of those three kernels inside "Collect Rollouts"
    or "Learn" (the backward and ``gae`` in the one each belongs to), and
    device ms / wall ms per range printed; env-steps/s with the ranges
    enabled and disabled, no profiler active, over 5 alternating pairs of
    3 updates, and the host's µs a range (100000 entries) times the
    ranges of an update; the gridworld's snapshot restored bitwise on the card after
    an update; a real update's metrics through ``log_metrics_tensorboard``
    read back bitwise by the port's reader, CRCs checked;
    ``examples/torch_train_toy.py`` (3 updates at 1024 worlds, TensorBoard
    and a checkpoint) and ``examples/torch_evaluate.py`` of that
    checkpoint over 64 steps; and the first and second ``eval_elo`` of a
    fresh headline_pbt population after one update, timed. Its files go
    to ``_tools_smoke/`` in the checkout, removed after.

Each trainer phase sets every launch count to 0 just before it and checks
just after it that every kernel of its path launched as often as the
configuration implies and that every launch of the kernels with a
tensor-core route took it; it checks finite losses and metrics and a rising
mean reward and a first-minibatch max |ratio - 1| below the clip
coefficient, and prints env-steps/s (beside the headline's of the same
run at the end), peak memory, that ratio, its minibatches an epoch by
update, a synchronized collect / learn split and a torch.profiler
breakdown of one update.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel with its launches on the main paths, error, times and bound,
and the script fails if a kernel was launched on no path.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

# Tolerances, max |kernel - plain| <= atol + rtol * max |plain|:
# - float32: the kernels and the plain versions do the same f32 math and
#   differ only in the summation order of the products and in expf/tanhf
#   against PyTorch's implementations (a few ulp per step); the mha kernel
#   also takes its softmax with a running maximum over chunks of keys, which
#   rounds differently from the plain two-pass softmax;
# - bfloat16: outputs are rounded to bf16 (8 mantissa bits), so a few-ulp
#   f32 difference can flip a rounding by one bf16 ulp (2^-7 at |x| = 1)
#   and the recurrence carries it on; the plain backward (autograd through
#   the plain forward) also rounds the gate cotangents at other points than
#   the kernel, which rounds them to bf16 as the TPU kernel does. The mha
#   kernel in bf16 is held per element to 2^-7 |plain| (compare_ulp): one
#   bf16 ulp, or two just above a power of two.
TOL = {
    "gae": dict(atol=1e-5, rtol=1e-5),
    ("fwd", "float32"): dict(atol=1e-5, rtol=1e-5),
    ("bwd", "float32"): dict(atol=1e-4, rtol=1e-4),
    ("fwd", "bfloat16"): dict(atol=3.2e-2, rtol=0.0),
    ("bwd", "bfloat16"): dict(atol=0.0, rtol=3.2e-2),
    # float16 (the CUDA-core instances, the same f32 math from float16
    # operands): the bf16 rules' reasons at float16's 3 more bits, 2^-8
    # (four float16 ulps at 1) where bf16 has 2^-5.
    ("fwd", "float16"): dict(atol=2 ** -8, rtol=0.0),
    ("bwd", "float16"): dict(atol=0.0, rtol=2 ** -8),
    ("mha", "float32"): dict(atol=1e-5, rtol=1e-5),
    # fused_policy_step: the same f32 math as its plain version, with row
    # sums and products in another order; in bf16 a last-bit difference can
    # flip the rounding of a LayerNorm mean or variance, which moves a whole
    # row by about one bf16 ulp.
    ("step", "float32"): dict(atol=1e-5, rtol=1e-5),
    ("step", "bfloat16"): dict(atol=3.2e-2, rtol=0.0),
    # gru_sequence_*: the LSTM kernels' reasons, and the plain backward also
    # rounds the carried dh to bf16 at every step (h is stored in bf16, so
    # its cotangent is), where the kernel carries it in f32 as the TPU
    # kernel does.
    ("gru_fwd", "float32"): dict(atol=1e-5, rtol=1e-5),
    ("gru_bwd", "float32"): dict(atol=1e-4, rtol=1e-4),
    ("gru_fwd", "bfloat16"): dict(atol=3.2e-2, rtol=0.0),
    ("gru_bwd", "bfloat16"): dict(atol=0.0, rtol=3.2e-2),
    ("gru_fwd", "float16"): dict(atol=2 ** -8, rtol=0.0),
    ("gru_bwd", "float16"): dict(atol=0.0, rtol=2 ** -8),
    # layer_norm_*: the same f32 math with row sums in another order (and
    # the plain backward through autograd's graph of the mean and variance);
    # in bf16 y and dx are rounded once, so a last-bit f32 difference may
    # move one by a bf16 ulp: 2^-7 of the largest value. dw / db are f32
    # sums over up to 131072 rows in another order.
    ("ln_fwd", "float32"): dict(atol=1e-5, rtol=1e-5),
    ("ln_bwd", "float32"): dict(atol=1e-5, rtol=1e-5),
    ("ln_fwd", "bfloat16"): dict(atol=0.0, rtol=2 ** -7),
    ("ln_bwd", "bfloat16"): dict(atol=0.0, rtol=2 ** -7),
    "ln_dwdb": dict(atol=0.0, rtol=1e-4),
    # mha_flash_*: the same f32 math as the plain versions, with the softmax
    # taken online over tiles of keys (the forward) and the gradient sums
    # over up to 1024 rows in another order (the backward); lse in f32. In
    # bf16 the output is held per element to 2^-7 |plain| (compare_ulp) and
    # dq / dk / dv, each rounded once from f32 sums, to one bf16 ulp of the
    # largest value, 2^-7 of it. Not per element: the tensor-core backward
    # takes p and dS as bf16 hi + lo (~16 bits), so a gradient that cancels
    # to near 0 can miss 2^-7 of itself by a few ulps
    # (tests/test_torch_tensor_core_numerics.py).
    ("flash_fwd", "float32"): dict(atol=1e-5, rtol=1e-5),
    ("flash_bwd", "float32"): dict(atol=1e-5, rtol=1e-4),
    ("flash_bwd", "bfloat16"): dict(atol=0.0, rtol=2 ** -7),
    "flash_lse": dict(atol=1e-5, rtol=1e-5),
    # grouped_matmul: f32 sums over IN in another order, then (bf16) one
    # rounding, which may move a value by one bf16 ulp, at most 2^-7 of the
    # largest value.
    ("gmm", "float32"): dict(atol=1e-5, rtol=1e-5),
    ("gmm", "bfloat16"): dict(atol=0.0, rtol=2 ** -7),
    # float16 (tensor cores at aligned shapes, else CUDA cores): f32 sums
    # in another order and one rounding, at most one float16 ulp of the
    # largest value.
    ("gmm", "float16"): dict(atol=0.0, rtol=2 ** -10),
}

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates, at the
# full 700 W power limit): device memory bandwidth and the rates of the
# operation types the kernels do. "sfu": exponentials on the
# special-function units, 16 a clock an SM, ~3.9e12 a second (the figure
# the FlashAttention-3 paper gives for the H100 SXM). Tensor cores, f32
# pipes and special-function units run side by side, so a kernel's least
# time on operations is that of its busiest unit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f16_tensor": 989e12, "f32": 67e12,
                  "sfu": 3.9e12}


def log(msg):
    print(msg, flush=True)


def bound(nbytes, ops):
    """The least time the card could take for a kernel's work: the larger
    of the bytes it must move over the memory rate and its operations over
    the peak rate of their type, the largest of those over the types."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # Plain float32 products in full f32, as the reference semantics assume.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase():
    from madrona_learn_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log(build.build_log())


def time_ms(fn, reps=10, warmup=2):
    """Median wall time of one call on the card, with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, calls=20):
    """Device time of one call by kernel, in ms: torch.profiler's kernel
    durations summed over `calls` calls (after a warm-up call), divided by
    `calls`. Neither the host's work nor the gaps between launches are in
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A capture of a few short kernels now and then comes back without its
    # device events (seen once in a run of this script on an H100); take
    # it again, and fail if three captures in a row hold none.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                ms = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) / 1e3
                split[e.key] = split.get(e.key, 0.0) + ms / calls
        if split:
            return split
        log(f"  (profiler capture {attempt + 1} of 3 held no device events)")
    raise AssertionError("the profiler recorded no device time")


def host_us(fn, calls=100):
    """What one call costs the host, in us: `calls` calls enqueued from an
    idle card, timed to the last return (the card may still be running)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def call_timings(fn):
    """A call's time three ways: between two CUDA events (`time_ms`, the
    kernel table's `ms`, host work included), on the device alone (the
    profiler, by kernel) and on the host (the enqueue)."""
    split = device_split(fn)
    return dict(ms=time_ms(fn), device_ms=sum(split.values()),
                device_split=split, host_us=host_us(fn))


def _split_text(split):
    """The profiler's kernels as "ms name", the name without its return
    type, unnamed namespace and arguments."""
    def short(name):
        name = name.replace("(anonymous namespace)::", "")
        return name.split("(")[0].removeprefix("void ")[:48]

    return ", ".join(f"{ms:.4f} ms {short(name)}"
                     for name, ms in split.items())


def bitwise(name, got, want):
    import torch

    ok = torch.equal(got, want)
    log(f"  {name}: bitwise {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: not bitwise equal")


def compare(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = math.isfinite(err) and err <= atol + rtol * scale
    log(f"  {name}: max_abs_err {err:.3e} (max |plain| {scale:.3e}, "
        f"tol atol {atol:g} rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def compare_ulp(name, got, want):
    """bf16 outputs within 2^-7 |plain| of the plain version, element by
    element (1e-6 absolute where the plain value is 0)."""
    diff = (got.float() - want.float()).abs()
    worst = (diff / (want.float().abs() * 2 ** -7 + 1e-6)).max().item()
    err = diff.max().item()
    ok = math.isfinite(worst) and worst <= 1.0
    log(f"  {name}: max_abs_err {err:.3e}, worst |diff| / (2^-7 |plain|) "
        f"{worst:.3f} (tol 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def _gae_inputs(gen, T, N):
    import torch

    r = torch.randn(T, N, device="cuda", generator=gen)
    v = torch.randn(T, N, device="cuda", generator=gen)
    d = torch.rand(T, N, device="cuda", generator=gen) < 0.05
    b = torch.randn(N, device="cuda", generator=gen)
    return r, v, d, b


def check_gae(results):
    """gae bitwise against its plain version at the update's [32, 16384],
    its first 1000 columns (also bitwise those of the whole call), a long
    [1000, 4096] and a width off 16-byte rows, [7, 70]; its three times at
    [32, 16384] and the sweep of its chunk and block widths."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gae import gae, gae_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    main = _gae_inputs(gen, 32, 16384)
    cases = {(32, 16384): main,
             (32, 1000): [t[..., :1000].contiguous() for t in main],
             (1000, 4096): _gae_inputs(gen, 1000, 4096),
             (7, 70): _gae_inputs(gen, 7, 70)}
    outs = {}
    for (T, N), args in cases.items():
        got = outs[(T, N)] = gae(0.99, 0.95, *args)
        want = gae_reference(0.99, 0.95, *args)
        worst = max(worst, compare(f"gae [{T},{N}]", got, want,
                                   **TOL["gae"]))
        bitwise(f"gae [{T},{N}] against its plain version", got, want)
    bitwise("gae [32,16384] columns :1000 against the [32,1000] call",
            outs[(32, 16384)][:, :1000], outs[(32, 1000)])

    t = call_timings(lambda: gae(0.99, 0.95, *main))
    plain_ms = time_ms(lambda: gae_reference(0.99, 0.95, *main))
    log(f"  gae [32,16384] kernel {t['ms']:.4f} ms (one call between "
        f"events), device {t['device_ms']:.4f} ms a call "
        f"({_split_text(t['device_split'])}), host {t['host_us']:.1f} us "
        f"a call (enqueue, 100 calls); plain {plain_ms:.4f} ms")
    # rewards, values, dones read and advantages written once, the
    # bootstrap read once; five f32 operations per element. GAE is a
    # reverse scan: no single PyTorch call computes it.
    results["gae"] = dict(
        ms=t["ms"], device_ms=t["device_ms"], host_us=t["host_us"],
        plain_ms=plain_ms, library_ms=None, max_abs_err=worst,
        **bound(32 * 16384 * (4 + 4 + 1 + 4) + 4 * 16384,
                {"f32": 5 * 32 * 16384}))
    _gae_sweep(main, cases[(1000, 4096)])


def _gae_sweep(update_args, long_args):
    """gae at every steps-a-chunk and columns-a-block pair csrc/gae.cu
    builds, device time at the update's [32, 16384] and a long [1000,
    4096]; each pair's advantages against the wrapper's pair, bitwise."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gae import (
        CHUNK, CHUNKS, COLUMNS, COLUMNS_CHOICES, gae_cuda)

    want = [gae_cuda(0.99, 0.95, *a) for a in (update_args, long_args)]
    for chunk in CHUNKS:
        for columns in COLUMNS_CHOICES:
            def run(args):
                return gae_cuda(0.99, 0.95, *args, chunk=chunk,
                                columns=columns)

            ms = [sum(device_split(lambda: run(a)).values())
                  for a in (update_args, long_args)]
            same = all(torch.equal(run(a), w)
                       for a, w in zip((update_args, long_args), want))
            log(f"  gae sweep: {chunk} steps a chunk, {columns} columns a "
                f"block: device {ms[0]:.4f} ms at [32, 16384], "
                f"{ms[1]:.4f} ms at [1000, 4096]; advantages bitwise equal "
                f"to {CHUNK} steps, {COLUMNS} columns: {same}")
            if not same:
                raise AssertionError("gae sweep: a variant's advantages "
                                     "differ from the wrapper's")


def _lstm_inputs(gen, T, N, H, dtype):
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    return (rnd(T, N, 4 * H),
            (torch.rand(T, N, device="cuda", generator=gen) > 0.2).to(dtype),
            rnd(H, 4 * H, scale=H ** -0.5), rnd(4 * H), rnd(N, H), rnd(N, H))


def _lstm_bounds(T, N, H, itemsize, tensor="bf16_tensor"):
    """Bytes and operations of the forward and backward kernels: each
    input read once, each output written once; the h . Wr products (and in
    the backward dgates . Wr^T and h^T . dgates) on tensor cores (bf16, or
    ``tensor``), and about 30 f32 operations of gate math per unit and step
    (40 backward)."""
    seq, state = T * N * H, N * H
    fwd_bytes = itemsize * (4 * seq + T * N + 4 * H * H + 4 * H + 2 * state
                            + 2 * seq)
    bwd_bytes = itemsize * (4 * seq + T * N + 4 * H * H + 4 * H + 2 * state
                            + 3 * seq
                            + 4 * seq + 4 * H * H + 4 * H + 2 * state)
    product = 2 * T * N * H * 4 * H
    return (bound(fwd_bytes, {tensor: product, "f32": 30 * seq}),
            bound(bwd_bytes, {tensor: 3 * product, "f32": 40 * seq}))


def cudnn_lstm_check(args, ys):
    """cuDNN's LSTM (torch.nn.LSTM, identity input weight so that its input
    is x_proj) on the same inputs as the forward kernel. It cannot clear the
    carry after a step whose keep is 0, so it computes another function and
    the kernel has no library yardstick; this prints how far it lands and
    its time."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import lstm_sequence_fwd

    x_proj, keep, wr, bias, c0, h0 = args
    G = x_proj.shape[-1]
    try:
        lstm = torch.nn.LSTM(G, G // 4).to(device="cuda", dtype=x_proj.dtype)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(torch.eye(G))
            lstm.weight_hh_l0.copy_(wr.t())
            lstm.bias_ih_l0.copy_(bias)
            lstm.bias_hh_l0.zero_()

            def run():
                return lstm(x_proj, (h0[None], c0[None]))[0]

            got = run()
            ones, _ = lstm_sequence_fwd(x_proj, torch.ones_like(keep), wr,
                                        bias, c0, h0)
            err_keep = (got.float() - ys.float()).abs().max().item()
            err_ones = (got.float() - ones.float()).abs().max().item()
            ms = time_ms(run)
        log(f"  cuDNN LSTM on the same inputs: max |diff| from the kernel "
            f"{err_keep:.3e} with the keep mask, {err_ones:.3e} with keep = "
            f"1; {ms:.3f} ms (another function: library_ms null)")
    except RuntimeError as e:
        log(f"  cuDNN LSTM on the same inputs did not run: {e}")


def _routed(kernel, rule, fn, *args):
    """fn(*args) and the route it took (``tensor_core`` where it counted a
    tensor-core launch in ``kernel.tc_launches``, else ``cuda_core``), which
    must be the one the path rule names (``rule``, a bool)."""
    before = kernel.tc_launches
    out = fn(*args)
    path = "tensor_core" if kernel.tc_launches > before else "cuda_core"
    want = "tensor_core" if rule else "cuda_core"
    if path != want:
        raise AssertionError(f"{kernel.name}: took the {path} route, the "
                             f"path rule names {want}")
    return out, path


def _tc_bwd_checks(name, bwd, args, states, probe, got, row_args, row_outs,
                   weight_outs, rows=256):
    """The bf16 tensor-core backward at the main-path shape, beyond its
    agreement with the plain version: two calls give bitwise equal weight
    gradients (deterministic), and its first ``rows`` batch rows give
    bitwise the outputs of a backward over those rows alone (batch
    invariant). ``states`` are the forward's [T, N, H] outputs the backward
    reads ((ys, cs), or (ys,)); ``row_args`` / ``row_outs`` map an argument
    / output index to its batch dimension; ``weight_outs`` lists the weight
    gradients."""
    import torch

    def first_rows(t, dim):
        return t.narrow(dim, 0, rows).contiguous()

    again = bwd(*args, *states, probe)
    same = all(torch.equal(got[i], again[i]) for i in weight_outs)
    log(f"  {name}: weight gradients bitwise equal over two calls: "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: weight gradients differ run to run")
    sub = [first_rows(a, row_args[i]) if i in row_args else a
           for i, a in enumerate(args)]
    alone = bwd(*sub, *(first_rows(t, 1) for t in states),
                first_rows(probe, 1))
    same = all(torch.equal(first_rows(got[i], d), alone[i])
               for i, d in row_outs.items())
    log(f"  {name}: rows 0-{rows - 1} bitwise equal to the backward at N = "
        f"{rows}: {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: not batch invariant")


def _tc_bwd_timing(name, results, x, keep, wi, wr, bias, c0, h0, ys, cs,
                   probe):
    """The tensor-core backward's time split into the recurrence and the
    weight-gradient pass (the same buffers, one pass a call)."""
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        _bwd_tc, _bwd_tc_buffers, tc_rows)

    buffers = _bwd_tc_buffers(x, wi, wr)

    def run(phases):
        return _bwd_tc(x, keep, wi, wr, bias, c0, h0, ys, cs, probe,
                       phases=phases, buffers=buffers)

    run(3)
    split = dict(recurrence_ms=time_ms(lambda: run(1)),
                 weight_grad_ms=time_ms(lambda: run(2)))
    rows = tc_rows(wi is not None, wr.shape[0])
    log(f"  {name} tensor-core split (R = {rows} rows a block): recurrence "
        f"{split['recurrence_ms']:.3f} ms, weight gradients "
        f"{split['weight_grad_ms']:.3f} ms")
    results.update(split)


def _tc_fwd_checks(name, fwd, args, outs, states, rows=256, roll=5):
    """The bf16 tensor-core forward at the update shape, beyond its
    agreement with the plain version, all bitwise: (a) a row's result
    depends on nothing but its inputs: the first ``rows`` batch rows equal
    a forward over those rows alone, and a forward over the batch rolled by
    ``roll`` rows (no multiple of a block's rows) equals it rolled; (b) a
    T = 1 call from the cleared state after step t - 1 equals step t of the
    T-step call, the kernel-level form of PPO's ratio starting at 1. x and
    keep lead ``args``; ``fwd`` returns a tuple like ``outs`` ((ys, cs), or
    (ys,)); ``states`` maps the index of each initial state in ``args`` to
    that of the output that carries it (c0 to cs, h0 to ys)."""
    import torch

    batched = {0: 1, 1: 1, **{i: 0 for i in states}}

    def each(fn):
        return [fn(a, batched[i]) if i in batched else a
                for i, a in enumerate(args)]

    sub = fwd(*each(lambda a, d: a.narrow(d, 0, rows).contiguous()))
    same = all(torch.equal(o[:, :rows], o_s) for o, o_s in zip(outs, sub))
    log(f"  {name}: rows 0-{rows - 1} of every output bitwise equal to the "
        f"forward at N = {rows}: {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: not batch invariant")
    rolled = fwd(*each(lambda a, d: a.roll(roll, d).contiguous()))
    same = all(torch.equal(o_r, o.roll(roll, 1))
               for o, o_r in zip(outs, rolled))
    log(f"  {name}: the batch rolled by {roll} rows gives every output "
        f"rolled, bitwise: {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: a row's result depends on where it "
                             f"sits")

    keep = args[1]
    T = keep.shape[0]
    zero = torch.zeros((), dtype=outs[0].dtype, device=outs[0].device)
    for t in sorted({0, 1, T // 2, T - 1}):
        if t == 0:
            carry, start = {i: args[i] for i in states}, "the initial state"
        else:
            kept = keep[t - 1][:, None] > 0.5
            carry = {i: torch.where(kept, outs[j][t - 1], zero)
                     for i, j in states.items()}
            start = (f"the state after step {t - 1}, "
                     f"{int((~kept).sum())} rows cleared by keep = 0")
        step = fwd(args[0][t:t + 1], keep[t:t + 1],
                   *[carry.get(i, a) for i, a in enumerate(args)][2:])
        same = all(torch.equal(o_1[0], o[t]) for o, o_1 in zip(outs, step))
        log(f"  {name}: T = 1 from {start}: bitwise equal to step {t}: "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{name}: step {t} differs at T = 1")


def _tc_fwd_guard_check(name, run, outs):
    """The bf16 tensor-core forward at a batch that is no multiple of a
    block's rows writes no row past N: ``run(out)`` launches it into
    outputs with 64 rows of NaN after their end, which must keep them and
    equal ``outs`` (the wrapper's) bitwise."""
    import torch

    T, N, H = outs[0].shape
    size = T * N * H
    bufs = [torch.full((size + 64 * H,), float("nan"), dtype=outs[0].dtype,
                       device="cuda") for _ in outs]
    out = tuple(b[:size].view(T, N, H) for b in bufs)
    run(out)
    guard = all(bool(torch.isnan(b[size:].float()).all()) for b in bufs)
    same = all(torch.equal(o, w) for o, w in zip(out, outs))
    log(f"  {name}: no row past N = {N} written, and the outputs bitwise "
        f"the wrapper's: {'ok' if guard and same else 'FAIL'}")
    if not (guard and same):
        raise AssertionError(f"{name}: rows past N written, or outputs "
                             f"differ")


def _float16_record(name, fwd, bwd, T, N, H, errs, calls, bounds,
                    paths=("cuda_core", "cuda_core")):
    """The float16 instances of a recurrence's kernels at a main-path
    shape, on the routes ``paths`` (the forward's, the backward's), checked
    against the plain version by the caller (``errs``: the forward's and,
    at T > 1, the backward's max_abs_err): their times, the plain versions'
    and the bounds at 2 bytes an element go to ``fwd["float16"]``
    (``step_*`` at T = 1) and, at T > 1, ``bwd["float16"]``. ``calls``: the
    forward, its plain version, the backward and its plain version."""
    fwd_fn, fwd_plain, bwd_fn, bwd_plain = calls
    fwd_bound, bwd_bound = bounds(T, N, H, 2, tensor="f16_tensor")
    rec = fwd.setdefault("float16", {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], errs[0])
    key = "" if T > 1 else "step_"
    ms, plain = time_ms(fwd_fn), time_ms(fwd_plain)
    rec.update({key + "ms": ms, key + "plain_ms": plain,
                key + "bound_ms": fwd_bound["bound_ms"],
                key + "bound_by": fwd_bound["bound_by"], "path": paths[0]})
    msg = (f"  {name} [{T},{N}] float16: fwd kernel ({paths[0]}) {ms:.3f} "
           f"ms, plain {plain:.3f} ms, bound {fwd_bound['bound_ms']:.4f} ms "
           f"({fwd_bound['bound_by']})")
    if T > 1:
        b = bwd.setdefault("float16", {})
        b.update(max_abs_err=errs[1], ms=time_ms(bwd_fn),
                 plain_ms=time_ms(bwd_plain), path=paths[1], **bwd_bound)
        msg += (f"; bwd kernel ({paths[1]}) {b['ms']:.3f} ms, plain "
                f"{b['plain_ms']:.3f} ms, bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']})")
    log(msg)


def check_lstm(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        LSTM_BWD, LSTM_FWD, _fwd_tc, bwd_uses_tensor_cores, fwd_tc_rows,
        fwd_uses_tensor_cores, lstm_sequence_bwd, lstm_sequence_fwd,
        lstm_sequence_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    fwd = results["lstm_sequence_fwd"] = {"max_abs_err": 0.0}
    bwd = results["lstm_sequence_bwd"] = {"max_abs_err": 0.0}
    # (T, N, H, dtype, role on the main paths): the headline's update
    # minibatch ("timed") and rollout step ("step"); headline_pbt's shapes
    # ("path"): a train policy's and a past policy's ragged rows of a
    # rollout step (each policy's count changes every step, about 900 to
    # 4100 rows), a train policy's 2560 agents at the bootstrap value, and
    # its update minibatch of 1280 sequences; then flagship_large's
    # minibatch, a ragged batch at both widths (the bf16 kernels on tensor
    # cores), the float16 instances (on tensor cores, f16 wgmma) at
    # headline_fp16's update minibatch and rollout step ("fp16") and ragged
    # at 128, and float32 at both instantiated widths (CUDA cores).
    cases = [
        (16, 8192, 256, torch.bfloat16, "timed"),
        (1, 16384, 256, torch.bfloat16, "step"),
        (1, 3583, 256, torch.bfloat16, "path"),
        (1, 1021, 256, torch.bfloat16, "path"),
        (1, PBT_TRAIN_AGENTS, 256, torch.bfloat16, "path"),
        (16, PBT_MINIBATCH, 256, torch.bfloat16, "path"),
        (16, 256, 256, torch.bfloat16, None),
        (16, 1000, 256, torch.bfloat16, None),
        (5, 70, 128, torch.bfloat16, None),
        (16, 8192, 256, torch.float16, "fp16"),
        (1, 16384, 256, torch.float16, "fp16"),
        (5, 70, 128, torch.float16, None),
        (5, 1000, 256, torch.float32, None),
        (4, 70, 128, torch.float32, None),
    ]
    for T, N, H, dtype, role in cases:
        main_path = role in ("timed", "step", "path")
        dname = str(dtype).split(".")[-1]
        args = _lstm_inputs(gen, T, N, H, dtype)
        tag = f"[{T},{N},{4 * H}] {dname}"
        probe = torch.randn(T, N, H, device="cuda", generator=gen).to(dtype)

        (ys, cs), fpath = _routed(LSTM_FWD, fwd_uses_tensor_cores(dtype, H),
                                  lstm_sequence_fwd, *args)
        err = fwd_err = compare(f"lstm fwd {tag} ({fpath})", ys,
                                lstm_sequence_reference(*args),
                                **TOL[("fwd", dname)])
        if main_path or role == "fp16":
            if fpath != "tensor_core":
                raise AssertionError(f"lstm fwd {tag}: the main path took "
                                     f"the {fpath} route")
        if main_path:
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
            fwd["path"] = fpath
        if fpath == "tensor_core" and N % fwd_tc_rows():
            x_proj, keep, wr, *rest = args
            _tc_fwd_guard_check(
                "lstm fwd " + tag,
                lambda out: _fwd_tc(x_proj, keep, None, wr, *rest, out=out),
                (ys, cs))

        leaves = [a.detach().clone().requires_grad_(i != 1)
                  for i, a in enumerate(args)]
        diff = [leaves[i] for i in (0, 2, 3, 4, 5)]

        def plain_bwd():
            out = lstm_sequence_reference(*leaves)
            return torch.autograd.grad(
                (out.float() * probe.float()).sum(), diff)

        got, path = _routed(LSTM_BWD, bwd_uses_tensor_cores(dtype, H),
                            lstm_sequence_bwd, *args, ys, cs, probe)
        bwd_err = 0.0
        for name, g, w in zip(("dxp", "dwr", "db", "dc0", "dh0"), got,
                              plain_bwd()):
            err = compare(f"lstm bwd {name} {tag} ({path})", g, w,
                          **TOL[("bwd", dname)])
            bwd_err = max(bwd_err, err)
            if main_path and T > 1:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
        if role == "fp16" and T > 1:
            # The float16 forward and backward's main route: tensor cores,
            # deterministic, batch invariant and the rollout step the
            # sequence's step, as the bf16 ones.
            if path != "tensor_core":
                raise AssertionError(f"lstm bwd {tag}: the main path took "
                                     f"the {path} route")
            _tc_bwd_checks("lstm bwd " + tag, lstm_sequence_bwd, args,
                           (ys, cs), probe, got,
                           row_args={0: 1, 1: 1, 4: 0, 5: 0},
                           row_outs={0: 1, 3: 0, 4: 0}, weight_outs=(1, 2))
            _tc_fwd_checks("lstm fwd " + tag, lstm_sequence_fwd, args,
                           (ys, cs), {4: 1, 5: 0})
            x_proj, keep, wr, bias, c0, h0 = args
            split = {}
            _tc_bwd_timing("lstm bwd " + tag, split, x_proj, keep, None, wr,
                           bias, c0, h0, ys, cs, probe)
            bwd.setdefault("float16", {}).update(split)
        if role == "fp16":
            _float16_record(
                "lstm", fwd, bwd, T, N, H, (fwd_err, bwd_err),
                (lambda: lstm_sequence_fwd(*args),
                 lambda: lstm_sequence_reference(*args),
                 lambda: lstm_sequence_bwd(*args, ys, cs, probe), plain_bwd),
                _lstm_bounds, paths=(fpath, path))

        if main_path and T > 1 and path != "tensor_core":
            raise AssertionError(f"lstm bwd {tag}: the main path took the "
                                 f"{path} route")
        if role == "timed":
            bwd["path"] = path
            _tc_bwd_checks("lstm bwd " + tag, lstm_sequence_bwd, args,
                           (ys, cs), probe, got,
                           row_args={0: 1, 1: 1, 4: 0, 5: 0},
                           row_outs={0: 1, 3: 0, 4: 0}, weight_outs=(1, 2))
            _tc_fwd_checks("lstm fwd " + tag, lstm_sequence_fwd, args,
                           (ys, cs), {4: 1, 5: 0})
            fwd["ms"] = time_ms(lambda: lstm_sequence_fwd(*args))
            fwd["plain_ms"] = time_ms(lambda: lstm_sequence_reference(*args))
            bwd["ms"] = time_ms(
                lambda: lstm_sequence_bwd(*args, ys, cs, probe))
            bwd["plain_ms"] = time_ms(plain_bwd)
            x_proj, keep, wr, bias, c0, h0 = args
            _tc_bwd_timing("lstm bwd " + tag, bwd, x_proj, keep, None, wr,
                           bias, c0, h0, ys, cs, probe)
            fwd_bound, bwd_bound = _lstm_bounds(T, N, H, 2)
            fwd.update(library_ms=None, **fwd_bound)
            bwd.update(library_ms=None, **bwd_bound)
            log(f"  lstm {tag}: fwd kernel {fwd['ms']:.3f} ms (R = "
                f"{fwd_tc_rows()}), plain "
                f"{fwd['plain_ms']:.3f} ms, bound {fwd['bound_ms']:.4f} ms "
                f"({fwd['bound_by']}); bwd kernel {bwd['ms']:.3f} ms, plain "
                f"{bwd['plain_ms']:.3f} ms, bound {bwd['bound_ms']:.4f} ms "
                f"({bwd['bound_by']})")
            cudnn_lstm_check(args, ys)
        elif role == "step":
            step_ms = time_ms(lambda: lstm_sequence_fwd(*args))
            step_plain = time_ms(lambda: lstm_sequence_reference(*args))
            step_bound = _lstm_bounds(T, N, H, 2)[0]
            # The rollout step: what a call costs the host (checks, the
            # transposed Wr, TMA maps, launch), as for fused_policy_step.
            host = host_us(lambda: lstm_sequence_fwd(*args))
            log(f"  lstm {tag}: fwd kernel {step_ms:.3f} ms (R = "
                f"{fwd_tc_rows()}), plain {step_plain:.3f} ms, bound "
                f"{step_bound['bound_ms']:.4f} ms "
                f"({step_bound['bound_by']}); host {host:.1f} us a call "
                f"(enqueue, 100 calls)")


def _mha_bound(B, S, H, D, valid_len, itemsize):
    """q read and the output written whole, the valid_len key and value
    rows read once; the q . k and P . V products on bf16 tensor cores and
    about 5 f32 operations of softmax per score."""
    nbytes = itemsize * B * H * D * (2 * S + 2 * valid_len)
    scores = B * H * S * valid_len
    return bound(nbytes, {"bf16_tensor": 4 * scores * D, "f32": 5 * scores})


def _mha_batch_checks(tag, q, k, v, valid_len, got, rows=16384, roll=5):
    """The bf16 kernel at the update pass, bitwise: its first ``rows``
    batch items equal a call over those items alone (the rollout step's
    B), and the batch rolled by ``roll`` items gives the output rolled."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.mha import mha_fwd

    same = torch.equal(
        mha_fwd(*(x[:rows].contiguous() for x in (q, k, v)), valid_len),
        got[:rows])
    log(f"  mha {tag}: items 0-{rows - 1} bitwise equal to the call at B = "
        f"{rows}: {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"mha {tag}: not batch invariant")
    same = torch.equal(
        mha_fwd(*(x.roll(roll, 0).contiguous() for x in (q, k, v)),
                valid_len), got.roll(roll, 0))
    log(f"  mha {tag}: the batch rolled by {roll} items gives the output "
        f"rolled, bitwise: {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"mha {tag}: an item's result depends on where "
                             f"it sits")


def check_mha(results):
    import torch
    import torch.nn.functional as F
    from madrona_learn_tpu_torch.ops.cuda.mha import (
        MHA, mha_fwd, mha_reference, uses_tensor_cores)

    gen = torch.Generator(device="cuda").manual_seed(5)
    res = results["mha"] = {"max_abs_err": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, S, H, D, dtype, valid_len, on the main path): the flagship's
    # rollout step and update pass, a ragged float32 batch, valid_len == S,
    # the other head widths (16: the small flagship of model_phase), S = 256
    # with valid_len = 200 (13 key tiles, the last partly masked) and S = 8
    # (a half-filled 16-row query tile), in both dtypes.
    cases = [
        (16384, 16, 4, 32, bf16, 12, True),
        (131072, 16, 4, 32, bf16, 12, True),
        (1000, 24, 4, 32, f32, 20, False),
        (2048, 16, 4, 32, bf16, 16, False),
        (1000, 16, 2, 16, f32, 16, False),
        (1000, 24, 2, 16, bf16, 20, False),
        (64, 256, 2, 64, f32, 200, False),
        (64, 256, 2, 64, bf16, 200, False),
        (1000, 8, 4, 32, bf16, 6, False),
    ]
    for B, S, H, D, dtype, valid_len, main_path in cases:
        dname = str(dtype).split(".")[-1]
        tag = f"[{B},{S},{H},{D}] {dname} valid_len={valid_len}"
        q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=gen)
                   .to(dtype) for _ in range(3))
        got, path = _routed(MHA, uses_tensor_cores(dtype), mha_fwd, q, k, v,
                            valid_len)
        want = mha_reference(q, k, v, valid_len)
        if dtype == bf16:
            err = compare_ulp(f"mha {tag} ({path})", got, want)
        else:
            err = compare(f"mha {tag} ({path})", got, want,
                          **TOL[("mha", dname)])
        if main_path:
            if path != "tensor_core":
                raise AssertionError(f"mha {tag}: the main path took the "
                                     f"{path} route")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["path"] = path
            if B > 16384:
                _mha_batch_checks(tag, q, k, v, valid_len, got)
        if valid_len < S:
            # Keys past valid_len must have no effect: poison them.
            k[:, valid_len:] = 1e4
            v[:, valid_len:] = -1e4
            if not torch.equal(mha_fwd(q, k, v, valid_len), got):
                raise AssertionError(f"mha {tag}: masked keys changed the "
                                     f"output")
            log(f"  mha {tag}: keys past valid_len poisoned, output "
                f"unchanged ok")
        if main_path:
            ms = time_ms(lambda: mha_fwd(q, k, v, valid_len))
            plain_ms = time_ms(lambda: mha_reference(q, k, v, valid_len))
            mask = (torch.arange(S, device="cuda") < valid_len).expand(S, S)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            b = _mha_bound(B, S, H, D, valid_len, q.element_size())
            log(f"  mha {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            # The last main-path case, the update pass, goes in the record.
            res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)


def _step_inputs(gen, N, F, H, layers, dtype):
    """fused_policy_step operands: orthogonal-scale weights, LayerNorm
    affines near 1 / 0, a carry of scale 0.5."""
    import torch

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dt)

    mlp, fin = [], F
    for _ in range(layers):
        mlp.append((rnd(fin, H, scale=(2 / fin) ** 0.5),
                    1 + rnd(H, scale=0.1, dt=torch.float32),
                    rnd(H, scale=0.1, dt=torch.float32)))
        fin = H
    return (rnd(N, F), mlp, rnd(H, 4 * H, scale=H ** -0.5),
            rnd(H, 4 * H, scale=H ** -0.5), rnd(4 * H, scale=0.1),
            rnd(N, H, scale=0.5), rnd(N, H, scale=0.5))


def _step_bound(N, F, H, layers, itemsize):
    """x, the weights and the carry read once, feats, c' and h' written
    once; the Dense and LSTM products on bf16 tensor cores, about 10 f32
    operations per LayerNorm element and 30 per LSTM unit."""
    weights = F * H + (layers - 1) * H * H + 8 * H * H + 4 * H
    nbytes = itemsize * (N * F + weights + 5 * N * H) + 8 * H * layers
    product = 2 * N * (F * H + (layers - 1) * H * H + 8 * H * H)
    return bound(nbytes, {"bf16_tensor": product,
                          "f32": 10 * N * H * layers + 30 * N * H})


def check_policy_step(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.policy_step import (
        POLICY_STEP, fused_policy_step, fused_policy_step_reference,
        uses_tensor_cores)

    gen = torch.Generator(device="cuda").manual_seed(8)
    res = results["fused_policy_step"] = {"max_abs_err": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    # (N, F, H, layers, dtype, on the main path): the headline_fused rollout
    # step, float32 at the same shape (CUDA cores), ragged batches at both
    # widths on tensor cores, F = 128 with three layers, and float32 at
    # H = 128.
    cases = [
        (16384, 3, 256, 2, bf16, True),
        (16384, 3, 256, 2, f32, False),
        (1000, 3, 256, 2, bf16, False),
        (1000, 3, 128, 1, bf16, False),
        (300, 128, 128, 3, bf16, False),
        (77, 100, 256, 4, bf16, False),
        (1000, 3, 128, 1, f32, False),
    ]
    for N, F, H, layers, dtype, main_path in cases:
        dname = str(dtype).split(".")[-1]
        tag = f"[{N},{F}->{H}x{layers},LSTM {H}] {dname}"
        args = _step_inputs(gen, N, F, H, layers, dtype)
        (got_f, (got_c, got_h)), path = _routed(
            POLICY_STEP, uses_tensor_cores(dtype, H, F), fused_policy_step,
            *args)
        want_f, (want_c, want_h) = fused_policy_step_reference(*args)
        for name, g, w in (("feats", got_f, want_f), ("c'", got_c, want_c),
                           ("h'", got_h, want_h)):
            err = compare(f"fused_policy_step {name} {tag} ({path})", g, w,
                          **TOL[("step", dname)])
            if main_path:
                res["max_abs_err"] = max(res["max_abs_err"], err)
        if main_path:
            if path != "tensor_core":
                raise AssertionError(f"fused_policy_step {tag}: the main "
                                     f"path took the {path} route")
            res["path"] = path
            # Batch invariance: the first 512 rows alone give bitwise the
            # same outputs.
            x, mlp, wi, wr, bias, c, h = args
            rows = 512
            alone = fused_policy_step(x[:rows].contiguous(), mlp, wi, wr,
                                      bias, c[:rows].contiguous(),
                                      h[:rows].contiguous())
            same = all(torch.equal(g[:rows], a) for g, a in zip(
                (got_f, got_c, got_h), (alone[0], *alone[1])))
            log(f"  fused_policy_step {tag}: rows 0-{rows - 1} bitwise equal "
                f"to the step at N = {rows}: {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError("fused_policy_step: not batch invariant")
            ms = time_ms(lambda: fused_policy_step(*args))
            plain_ms = time_ms(lambda: fused_policy_step_reference(*args))
            # The host's share: the rollout loop is host-bound, so what a
            # call costs the host (checks, TMA maps, launch) matters there.
            host = host_us(lambda: fused_policy_step(*args))
            b = _step_bound(N, F, H, layers, args[0].element_size())
            log(f"  fused_policy_step {tag}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}); no single PyTorch call computes it; "
                f"host {host:.1f} us a call (enqueue, 100 calls)")
            res.update(ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def _proj_bounds(T, N, F, H, itemsize):
    """Bytes and operations of the projection kernels: each input read
    once, each output written once; the forward's x . Wi and h . Wr on bf16
    tensor cores, the backward's six products (both recomputed, dgates .
    Wi^T, dgates . Wr^T, x^T . dgates, h^T . dgates), and the gate math as
    in _lstm_bounds."""
    seq, state, rows = T * N * H, N * H, T * N
    weights = F * 4 * H + 4 * H * H + 4 * H
    fwd_bytes = itemsize * (rows * F + rows + weights + 2 * state + 2 * seq)
    bwd_bytes = itemsize * (rows * F + rows + weights + 2 * state + 3 * seq
                            + rows * F + weights + 2 * state)
    products = 2 * rows * 4 * H * (F + H)
    return (bound(fwd_bytes, {"bf16_tensor": products, "f32": 30 * seq}),
            bound(bwd_bytes, {"bf16_tensor": 3 * products, "f32": 40 * seq}))


def check_lstm_proj(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        LSTM_PROJ_BWD, LSTM_PROJ_FWD, _fwd_tc, fwd_tc_rows,
        lstm_sequence_proj_bwd, lstm_sequence_proj_fwd,
        lstm_sequence_proj_reference, uses_tensor_cores)

    gen = torch.Generator(device="cuda").manual_seed(9)
    fwd = results["lstm_sequence_proj_fwd"] = {"max_abs_err": 0.0}
    bwd = results["lstm_sequence_proj_bwd"] = {"max_abs_err": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    # (T, N, F, H, dtype, on the main path): the headline_fused update
    # minibatch, float32 at the same shape, the minibatch at N = 256, ragged
    # batches with F < H, F = 2H and F = 4H (the bf16 kernels on tensor
    # cores; F = 4H takes one x buffer), F = 2H and 4H at H = 128 in
    # float32.
    cases = [
        (16, 8192, 256, 256, bf16, True),
        (16, 8192, 256, 256, f32, False),
        (16, 256, 256, 256, bf16, False),
        (5, 1000, 128, 256, bf16, False),
        (4, 70, 256, 128, bf16, False),
        (3, 300, 512, 128, bf16, False),
        (4, 70, 256, 128, f32, False),
        (3, 300, 512, 128, f32, False),
    ]
    for T, N, F, H, dtype, main_path in cases:
        dname = str(dtype).split(".")[-1]
        tag = f"[{T},{N},{F}->{4 * H}] {dname}"

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, device="cuda", generator=gen)
                    * scale).to(dtype)

        args = (rnd(T, N, F),
                (torch.rand(T, N, device="cuda", generator=gen) > 0.2)
                .to(dtype),
                rnd(F, 4 * H, scale=F ** -0.5), rnd(H, 4 * H, scale=H ** -0.5),
                rnd(4 * H), rnd(N, H), rnd(N, H))
        probe = rnd(T, N, H)

        (ys, cs), fpath = _routed(LSTM_PROJ_FWD, uses_tensor_cores(dtype, H),
                                  lstm_sequence_proj_fwd, *args)
        err = compare(f"lstm_proj fwd {tag} ({fpath})", ys,
                      lstm_sequence_proj_reference(*args),
                      **TOL[("fwd", dname)])
        if main_path:
            if fpath != "tensor_core":
                raise AssertionError(f"lstm_proj fwd {tag}: the main path "
                                     f"took the {fpath} route")
            fwd["max_abs_err"] = err
            fwd["path"] = fpath
        elif fpath == "tensor_core" and N % fwd_tc_rows():
            _tc_fwd_guard_check("lstm_proj fwd " + tag,
                                lambda out: _fwd_tc(*args, out=out),
                                (ys, cs))

        leaves = [a.detach().clone().requires_grad_(i != 1)
                  for i, a in enumerate(args)]
        diff = [leaves[i] for i in (0, 2, 3, 4, 5, 6)]

        def plain_bwd():
            out = lstm_sequence_proj_reference(*leaves)
            return torch.autograd.grad(
                (out.float() * probe.float()).sum(), diff)

        got, path = _routed(LSTM_PROJ_BWD, uses_tensor_cores(dtype, H),
                            lstm_sequence_proj_bwd, *args, ys, cs, probe)
        for name, g, w in zip(("dx", "dwi", "dwr", "db", "dc0", "dh0"), got,
                              plain_bwd()):
            err = compare(f"lstm_proj bwd {name} {tag} ({path})", g, w,
                          **TOL[("bwd", dname)])
            if main_path:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)

        if main_path:
            if path != "tensor_core":
                raise AssertionError(f"lstm_proj bwd {tag}: the main path "
                                     f"took the {path} route")
            bwd["path"] = path
            _tc_bwd_checks("lstm_proj bwd " + tag, lstm_sequence_proj_bwd,
                           args, (ys, cs), probe, got,
                           row_args={0: 1, 1: 1, 5: 0, 6: 0},
                           row_outs={0: 1, 4: 0, 5: 0}, weight_outs=(1, 2, 3))
            _tc_fwd_checks("lstm_proj fwd " + tag, lstm_sequence_proj_fwd,
                           args, (ys, cs), {5: 1, 6: 0})
            fwd["ms"] = time_ms(lambda: lstm_sequence_proj_fwd(*args))
            fwd["plain_ms"] = time_ms(
                lambda: lstm_sequence_proj_reference(*args))
            bwd["ms"] = time_ms(
                lambda: lstm_sequence_proj_bwd(*args, ys, cs, probe))
            bwd["plain_ms"] = time_ms(plain_bwd)
            _tc_bwd_timing("lstm_proj bwd " + tag, bwd, *args, ys, cs, probe)
            fwd_bound, bwd_bound = _proj_bounds(T, N, F, H, 2)
            fwd.update(library_ms=None, **fwd_bound)
            bwd.update(library_ms=None, **bwd_bound)
            log(f"  lstm_proj {tag}: fwd kernel {fwd['ms']:.3f} ms (R = "
                f"{fwd_tc_rows()}), plain "
                f"{fwd['plain_ms']:.3f} ms, bound {fwd['bound_ms']:.4f} ms "
                f"({fwd['bound_by']}); bwd kernel {bwd['ms']:.3f} ms, plain "
                f"{bwd['plain_ms']:.3f} ms, bound {bwd['bound_ms']:.4f} ms "
                f"({bwd['bound_by']}); no library call (cuDNN cannot clear "
                f"the carry mid-sequence)")


def _gru_inputs(gen, T, N, H, dtype):
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    return (rnd(T, N, 3 * H),
            (torch.rand(T, N, device="cuda", generator=gen) > 0.2).to(dtype),
            rnd(H, 3 * H, scale=H ** -0.5), rnd(H), rnd(N, H))


def _gru_bounds(T, N, H, itemsize, tensor="bf16_tensor"):
    """Bytes and operations of the GRU kernels, as _lstm_bounds reckons
    them: each input read once, each output written once (the backward's
    dhp and h_in scratch are neither); the h . Wh products (and in the
    backward the recomputed h_in . Wh, dhp . Wh^T and h_in^T . dhp) on bf16
    tensor cores, and about 25 f32 operations of gate math per unit and
    step (35 backward)."""
    seq, state = T * N * H, N * H
    weights = 3 * H * H + H
    fwd_bytes = itemsize * (3 * seq + T * N + weights + state + seq)
    bwd_bytes = itemsize * (3 * seq + T * N + weights + state + 2 * seq
                            + 3 * seq + weights + state)
    product = 2 * T * N * H * 3 * H
    return (bound(fwd_bytes, {tensor: product, "f32": 25 * seq}),
            bound(bwd_bytes, {tensor: 3 * product, "f32": 35 * seq}))


def cudnn_gru_check(args, ys):
    """cuDNN's GRU (torch.nn.GRU: gates (r, z, n), linear-before-reset, b_hn
    in bias_hh; identity input weight so that its input is x_proj) on the
    same inputs as the forward kernel. It cannot clear the carry after a
    step whose keep is 0, so it computes another function and the kernel has
    no library yardstick; this prints how far it lands and its time."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import gru_sequence_fwd

    x_proj, keep, wh, bias_h, h0 = args
    G, H = x_proj.shape[-1], wh.shape[0]
    try:
        gru = torch.nn.GRU(G, H).to(device="cuda", dtype=x_proj.dtype)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(torch.eye(G))
            gru.weight_hh_l0.copy_(wh.t())
            gru.bias_ih_l0.zero_()
            gru.bias_hh_l0.zero_()
            gru.bias_hh_l0[2 * H:].copy_(bias_h)

            def run():
                return gru(x_proj, h0[None])[0]

            got = run()
            ones = gru_sequence_fwd(x_proj, torch.ones_like(keep), wh,
                                    bias_h, h0)
            err_keep = (got.float() - ys.float()).abs().max().item()
            err_ones = (got.float() - ones.float()).abs().max().item()
            ms = time_ms(run)
        log(f"  cuDNN GRU on the same inputs: max |diff| from the kernel "
            f"{err_keep:.3e} with the keep mask, {err_ones:.3e} with keep = "
            f"1; {ms:.3f} ms (another function: library_ms null)")
    except RuntimeError as e:
        log(f"  cuDNN GRU on the same inputs did not run: {e}")


def _gru_tc_timing(results, args, ys, probe):
    """The tensor-core GRU backward's time split into the recurrence and
    the weight-gradient pass (the same buffers, one pass a call)."""
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        _bwd_tc, _bwd_tc_buffers, tc_rows)

    buffers = _bwd_tc_buffers(args[0])
    T, N, H = ys.shape

    def run(phases):
        return _bwd_tc(*args, ys, probe, phases=phases, buffers=buffers)

    run(3)
    split = dict(recurrence_ms=time_ms(lambda: run(1)),
                 weight_grad_ms=time_ms(lambda: run(2)))
    log(f"  gru bwd tensor-core split H={H} [{T},{N}] (R = {tc_rows(H)} "
        f"rows a row tile): recurrence {split['recurrence_ms']:.3f} ms, "
        f"weight gradients {split['weight_grad_ms']:.3f} ms")
    results.update(split)


def _gru_product_witness(tag, args, probe):
    """The witness that the tensor-core backward differentiates the forward
    that ran: on ``args`` (x_proj, keep, Wh, bias_h, h0), the forward's
    h . Wh of every step (``_fwd_tc``'s ``hp``) and the backward's
    recomputed h_in . Wh (``_bwd_tc``'s, from the forward's ys), both f32
    [T, N, 3H], bitwise equal."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import _bwd_tc, _fwd_tc

    T, N, G3 = args[0].shape
    fwd_hp, bwd_hp = (torch.full((T, N, G3), float("nan"), device="cuda")
                      for _ in range(2))
    ys = _fwd_tc(*args, hp=fwd_hp)
    _bwd_tc(*args, ys, probe, phases=1, hp=bwd_hp)
    if not (bool(torch.isfinite(fwd_hp).all())
            and torch.equal(fwd_hp, bwd_hp)):
        bad = (fwd_hp != bwd_hp).sum().item()
        raise AssertionError(f"{tag}: the backward's recomputed h_in . Wh "
                             f"differs from the forward's h . Wh at {bad} "
                             f"of {fwd_hp.numel()} elements")
    log(f"  {tag}: the backward's recomputed h_in . Wh bitwise the "
        f"forward's h . Wh at every step ({fwd_hp.numel()} f32) ok")


def check_gru(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        FWD_TC_ROWS, GRU_BWD, GRU_FWD, _fwd_tc, bwd_uses_tensor_cores,
        fwd_uses_tensor_cores, gru_sequence_bwd, gru_sequence_fwd,
        gru_sequence_reference)

    gen = torch.Generator(device="cuda").manual_seed(10)
    fwd = results["gru_sequence_fwd"] = {"max_abs_err": 0.0}
    bwd = results["gru_sequence_bwd"] = {"max_abs_err": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    # (T, N, H, dtype, on the main path): the headline_gru update minibatch,
    # its rollout step, ragged batches at both widths (bf16 on tensor
    # cores), the float16 instances (on f16 tensor cores) at
    # headline_gru_fp16's update minibatch and rollout step ("fp16") and
    # ragged at 128, ragged batches at 384 and 512 in float16 and bf16 (the
    # two-block clusters), and float32 at both widths (CUDA cores).
    f16 = torch.float16
    cases = [
        (16, 8192, 256, bf16, True),
        (1, 16384, 256, bf16, True),
        (16, 8192, 256, f16, "fp16"),
        (1, 16384, 256, f16, "fp16"),
        (5, 70, 128, f16, False),
        (16, 1000, 256, bf16, False),
        (5, 70, 128, bf16, False),
        (16, 1000, 128, bf16, False),
        (5, 70, 384, f16, False),
        (4, 70, 512, f16, False),
        (5, 70, 512, bf16, False),
        (5, 1000, 256, f32, False),
        (4, 70, 128, f32, False),
    ]
    for T, N, H, dtype, role in cases:
        main_path = role is True
        dname = str(dtype).split(".")[-1]
        tag = f"[{T},{N},{3 * H}] {dname}"
        args = _gru_inputs(gen, T, N, H, dtype)
        probe = torch.randn(T, N, H, device="cuda", generator=gen).to(dtype)

        ys, fpath = _routed(GRU_FWD, fwd_uses_tensor_cores(dtype, H),
                            gru_sequence_fwd, *args)
        err = fwd_err = compare(f"gru fwd {tag} ({fpath})", ys,
                                gru_sequence_reference(*args),
                                **TOL[("gru_fwd", dname)])
        if main_path:
            if fpath != "tensor_core":
                raise AssertionError(f"gru fwd {tag}: the main path took "
                                     f"the {fpath} route")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
            fwd["path"] = fpath
        elif fpath == "tensor_core" and N % FWD_TC_ROWS:
            _tc_fwd_guard_check(
                "gru fwd " + tag,
                lambda out: _fwd_tc(*args, out=out[0]), (ys,))

        leaves = [a.detach().clone().requires_grad_(i != 1)
                  for i, a in enumerate(args)]
        diff = [leaves[i] for i in (0, 2, 3, 4)]

        def plain_bwd():
            out = gru_sequence_reference(*leaves)
            return torch.autograd.grad(
                (out.float() * probe.float()).sum(), diff)

        got, path = _routed(GRU_BWD, bwd_uses_tensor_cores(dtype, H),
                            gru_sequence_bwd, *args, ys, probe)
        bwd_err = 0.0
        for name, g, w in zip(("dxp", "dwh", "dbh", "dh0"), got,
                              plain_bwd()):
            err = compare(f"gru bwd {name} {tag} ({path})", g, w,
                          **TOL[("gru_bwd", dname)])
            bwd_err = max(bwd_err, err)
            if main_path and T > 1:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
        if role == "fp16" and fpath != "tensor_core":
            raise AssertionError(f"gru fwd {tag}: the main path took the "
                                 f"{fpath} route")
        if role == "fp16" and T > 1:
            # The float16 main route: tensor cores, deterministic and batch
            # invariant as the bf16 one, the T = 1 step the sequence's.
            if path != "tensor_core":
                raise AssertionError(f"gru bwd {tag}: the main path took "
                                     f"the {path} route")
            _tc_bwd_checks("gru bwd " + tag, gru_sequence_bwd, args, (ys,),
                           probe, got, row_args={0: 1, 1: 1, 4: 0},
                           row_outs={0: 1, 3: 0}, weight_outs=(1, 2))
            _tc_fwd_checks("gru fwd " + tag,
                           lambda *a: (gru_sequence_fwd(*a),), args, (ys,),
                           {4: 0})
            _gru_tc_timing(bwd.setdefault("float16", {}), args, ys, probe)
        if role == "fp16":
            _float16_record(
                "gru", fwd, bwd, T, N, H, (fwd_err, bwd_err),
                (lambda: gru_sequence_fwd(*args),
                 lambda: gru_sequence_reference(*args),
                 lambda: gru_sequence_bwd(*args, ys, probe), plain_bwd),
                _gru_bounds, paths=(fpath, path))

        if main_path and T > 1:
            if path != "tensor_core":
                raise AssertionError(f"gru bwd {tag}: the main path took "
                                     f"the {path} route")
            bwd["path"] = path
            _tc_bwd_checks("gru bwd " + tag, gru_sequence_bwd, args, (ys,),
                           probe, got, row_args={0: 1, 1: 1, 4: 0},
                           row_outs={0: 1, 3: 0}, weight_outs=(1, 2))
            _tc_fwd_checks("gru fwd " + tag,
                           lambda *a: (gru_sequence_fwd(*a),), args, (ys,),
                           {4: 0})
            fwd["ms"] = time_ms(lambda: gru_sequence_fwd(*args))
            fwd["plain_ms"] = time_ms(lambda: gru_sequence_reference(*args))
            bwd["ms"] = time_ms(lambda: gru_sequence_bwd(*args, ys, probe))
            bwd["plain_ms"] = time_ms(plain_bwd)
            _gru_tc_timing(bwd, args, ys, probe)
            fwd_bound, bwd_bound = _gru_bounds(T, N, H, 2)
            fwd.update(library_ms=None, **fwd_bound)
            bwd.update(library_ms=None, **bwd_bound)
            log(f"  gru {tag}: fwd kernel {fwd['ms']:.3f} ms (R = "
                f"{FWD_TC_ROWS}), plain {fwd['plain_ms']:.3f} ms, bound "
                f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); bwd kernel "
                f"{bwd['ms']:.3f} ms, plain {bwd['plain_ms']:.3f} ms, bound "
                f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']})")
            cudnn_gru_check(args, ys)
        elif main_path:
            step_ms = time_ms(lambda: gru_sequence_fwd(*args))
            step_plain = time_ms(lambda: gru_sequence_reference(*args))
            step_bound = _gru_bounds(T, N, H, 2)[0]
            # The rollout step: what a call costs the host (checks, the
            # keep mask, the TMA map, launch).
            host = host_us(lambda: gru_sequence_fwd(*args))
            log(f"  gru {tag}: fwd kernel {step_ms:.3f} ms (R = "
                f"{FWD_TC_ROWS}), plain {step_plain:.3f} ms, bound "
                f"{step_bound['bound_ms']:.4f} ms "
                f"({step_bound['bound_by']}); host {host:.1f} us a call "
                f"(enqueue, 100 calls)")
            cudnn_gru_check(args, ys)


def _layer_norm_bounds(N, D, itemsize):
    """x read and y written once, w / b read and mu / rsigma written once;
    about 8 f32 operations per element. Backward: x and dy read, dx
    written, w, mu, rsigma read and dw / db written once; about 12."""
    elems = N * D
    fwd = bound(2 * itemsize * elems + 8 * D + 8 * N, {"f32": 8 * elems})
    bwd = bound(3 * itemsize * elems + 12 * D + 8 * N, {"f32": 12 * elems})
    return fwd, bwd


def check_layer_norm(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
        layer_norm_bwd, layer_norm_fwd, layer_norm_reference)

    gen = torch.Generator(device="cuda").manual_seed(11)
    fwd = results["layer_norm_fwd"] = {"max_abs_err": 0.0}
    bwd = results["layer_norm_bwd"] = {"max_abs_err": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    # (N, D, dtype, main): the headline trunk's rows in one update minibatch
    # (16 x 8192) and in one rollout step, a ragged batch, float32 at two
    # widths, one not a multiple of 32, a bf16 width that is no multiple of
    # 8 (the backward's element-by-element path) and the widest rows.
    cases = [
        (131072, 256, bf16, True),
        (16384, 256, bf16, False),
        (1000, 256, bf16, False),
        (300, 128, f32, False),
        (64, 48, f32, False),
        (300, 100, bf16, False),
        (257, 1024, f32, False),
        (129, 1024, bf16, False),
    ]
    for N, D, dtype, main_path in cases:
        dname = str(dtype).split(".")[-1]
        tag = f"[{N},{D}] {dname}"
        x = (2 * torch.randn(N, D, device="cuda", generator=gen)
             + 0.5).to(dtype)
        w = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
        b = 0.1 * torch.randn(D, device="cuda", generator=gen)
        dy = torch.randn(N, D, device="cuda", generator=gen).to(dtype)

        y, mu, rsigma = layer_norm_fwd(x, w, b)
        err = compare(f"layer_norm fwd {tag}", y,
                      layer_norm_reference(x, w, b), **TOL[("ln_fwd", dname)])
        if main_path:
            fwd["max_abs_err"] = err

        leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]

        def plain_bwd():
            out = layer_norm_reference(*leaves)
            return torch.autograd.grad((out.float() * dy.float()).sum(),
                                       leaves)

        got = layer_norm_bwd(x, w, mu, rsigma, dy)
        for name, g, want in zip(("dx", "dw", "db"), got, plain_bwd()):
            tol = TOL[("ln_bwd", dname)] if name == "dx" else TOL["ln_dwdb"]
            err = compare(f"layer_norm bwd {name} {tag}", g, want, **tol)
            if main_path:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)

        if main_path:
            _layer_norm_fwd_checks(tag, (x, w, b), (y, mu, rsigma), fwd)
            fwd["plain_ms"] = time_ms(lambda: layer_norm_reference(x, w, b))
            _layer_norm_bwd_checks(tag, (x, w, mu, rsigma, dy), got, bwd)
            bwd["plain_ms"] = time_ms(plain_bwd)
            fwd_bound, bwd_bound = _layer_norm_bounds(N, D, x.element_size())
            fwd.update(**fwd_bound)
            bwd.update(**bwd_bound)
            fwd["library_ms"], bwd["library_ms"] = _layer_norm_library(
                x, w, b, dy, fwd["ms"] + bwd["ms"], fwd)
            log(f"  layer_norm {tag}: fwd kernel {fwd['ms']:.4f} ms, plain "
                f"{fwd['plain_ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms "
                f"({fwd['bound_by']}); bwd kernel {bwd['ms']:.4f} ms, plain "
                f"(fwd + bwd) {bwd['plain_ms']:.4f} ms, bound "
                f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']})")


def _layer_norm_fwd_checks(tag, args, got, fwd, rows=16384):
    """The forward at the update's rows: y bitwise the [rows, D] call's on
    the shared rows, y / mu / rsigma bitwise over two calls; its three
    times."""
    from madrona_learn_tpu_torch.ops.cuda.layer_norm import layer_norm_fwd

    x, w, b = args
    sub = layer_norm_fwd(x[:rows], w, b)
    bitwise(f"layer_norm fwd y {tag} rows :{rows} against the "
            f"[{rows},{x.shape[1]}] call", got[0][:rows], sub[0])
    again = layer_norm_fwd(*args)
    for name, first, second in zip(("y", "mu", "rsigma"), got, again):
        bitwise(f"layer_norm fwd {name} {tag} over two calls", first, second)
    t = call_timings(lambda: layer_norm_fwd(*args))
    fwd.update(ms=t["ms"], device_ms=t["device_ms"], host_us=t["host_us"])
    log(f"  layer_norm fwd {tag}: kernel {t['ms']:.4f} ms (one call between "
        f"events), device {t['device_ms']:.4f} ms a call "
        f"({_split_text(t['device_split'])}), host {t['host_us']:.1f} us a "
        f"call (enqueue, 100 calls)")


def _layer_norm_bwd_checks(tag, args, got, bwd, rows=16384):
    """The backward at the update's rows: dx bitwise the [rows, D] call's
    on the shared rows, dw / db bitwise over two calls; its three times and
    its two launches' device times apart."""
    from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
        _bwd, _bwd_buffers, layer_norm_bwd)

    x, w, mu, rsigma, dy = args
    sub = layer_norm_bwd(x[:rows], w, mu[:rows], rsigma[:rows], dy[:rows])
    bitwise(f"layer_norm bwd dx {tag} rows :{rows} against the "
            f"[{rows},{x.shape[1]}] call", got[0][:rows], sub[0])
    again = layer_norm_bwd(*args)
    for name, first, second in zip(("dw", "db"), got[1:], again[1:]):
        bitwise(f"layer_norm bwd {name} {tag} over two calls", first, second)
    t = call_timings(lambda: layer_norm_bwd(*args))
    buffers = _bwd_buffers(x)
    split = {name: sum(device_split(
                 lambda: _bwd(*args, phases=phases, buffers=buffers))
                 .values())
             for name, phases in (("main_pass_ms", 1), ("reduction_ms", 2))}
    bwd.update(ms=t["ms"], device_ms=t["device_ms"], host_us=t["host_us"],
               **split)
    log(f"  layer_norm bwd {tag}: kernel {t['ms']:.4f} ms (one call between "
        f"events), device {t['device_ms']:.4f} ms a call "
        f"({_split_text(t['device_split'])}), host {t['host_us']:.1f} us a "
        f"call (enqueue, 100 calls); launched apart, main pass "
        f"{split['main_pass_ms']:.4f} ms, reduction "
        f"{split['reduction_ms']:.4f} ms (device)")


def _layer_norm_library(x, w, b, dy, kernels_ms, fwd):
    """PyTorch's own layer norm: the forward with its saved statistics and
    the backward from them, the same two functions as the kernels, and
    F.layer_norm forward plus backward through autograd. PyTorch takes a
    weight and bias only in x's dtype (float32 ones with a bf16 x are
    refused), so they are cast to it: the same bytes of x, y, dy and dx,
    with the affine rounded to x's dtype. The forward is timed three ways,
    its device and host times going into ``fwd`` as ``library_device_ms``
    and ``library_host_us``. Returns the first two event times."""
    import torch
    import torch.nn.functional as F

    D = x.shape[-1]
    w, b = w.to(x.dtype), b.to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [D], w, b, 1e-6)
    t = call_timings(
        lambda: torch.ops.aten.native_layer_norm(x, [D], w, b, 1e-6))
    fwd_ms = t["ms"]
    fwd.update(library_device_ms=t["device_ms"], library_host_us=t["host_us"])
    log(f"  native_layer_norm: {fwd_ms:.4f} ms between events, device "
        f"{t['device_ms']:.4f} ms a call ({_split_text(t['device_split'])}), "
        f"host {t['host_us']:.1f} us a call")
    bwd_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [D], mean, rstd, w, b, [True, True, True]))
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]

    def fwd_bwd():
        out = F.layer_norm(leaves[0], [D], leaves[1], leaves[2], 1e-6)
        return torch.autograd.grad(out, leaves, dy)

    both_ms = time_ms(fwd_bwd)
    log(f"  native_layer_norm {fwd_ms:.4f} ms, native_layer_norm_backward "
        f"{bwd_ms:.4f} ms (weight and bias in {x.dtype}); F.layer_norm fwd "
        f"+ bwd {both_ms:.4f} ms against the kernels' {kernels_ms:.4f} ms")
    return fwd_ms, bwd_ms


def _flash_bounds(B, S, H, D, valid_len, itemsize):
    """Bytes and operations of the three mha_flash kernels: q, dO and the
    outputs whole, the valid_len key and value rows, lse and delta (f32)
    read or written once; the products on bf16 tensor cores (two in the
    forward, four in dK/dV, three in dQ), one exponential per score on the
    special-function units and about 4, 7 and 5 other f32 operations per
    score."""
    rows, keys = B * S * H * D, B * valid_len * H * D
    scores, stats = B * H * S * valid_len, 4 * B * H * S
    fwd = bound(itemsize * (2 * rows + 2 * keys) + stats,
                {"bf16_tensor": 4 * scores * D, "f32": 4 * scores,
                 "sfu": scores})
    dkdv = bound(itemsize * (4 * rows + 2 * keys) + 2 * stats,
                 {"bf16_tensor": 8 * scores * D, "f32": 7 * scores,
                  "sfu": scores})
    dq = bound(itemsize * (3 * rows + 2 * keys) + 2 * stats,
               {"bf16_tensor": 6 * scores * D, "f32": 5 * scores,
                "sfu": scores})
    return fwd, dkdv, dq


def _plain_chunks(fn, tensors, valid_len):
    """A plain mha_flash version over slices of the batch, concatenated:
    each slice's [B, H, S, S] f32 tensors stay within 2 GiB, so the update
    shape fits."""
    import torch

    _, S, H, _ = tensors[0].shape
    chunk = max(1, 2 ** 31 // (4 * H * S * S))
    parts = [fn(*(t[i:i + chunk] for t in tensors), valid_len)
             for i in range(0, tensors[0].shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _sdpa_library(q, k, v, dout, valid_len):
    """F.scaled_dot_product_attention with the same key mask on the same
    inputs: its forward (with the log-sum-exp it saves for the backward),
    and its backward, dq, dk and dv in one autograd call. Returns the two
    times, None where PyTorch does not run it."""
    import torch
    import torch.nn.functional as F

    S = q.shape[1]
    mask = (torch.arange(S, device="cuda") < valid_len).expand(S, S)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    qt, kt, vt = (t.transpose(1, 2) for t in leaves)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    try:
        fwd_ms = time_ms(fwd)
        out = fwd()
        g = dout.transpose(1, 2)
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                     retain_graph=True))
    except RuntimeError as e:
        log(f"  scaled_dot_product_attention did not run: {e}")
        return None, None
    return fwd_ms, bwd_ms


def check_mha_flash(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.mha_flash import (
        mha_flash_bwd, mha_flash_bwd_reference, mha_flash_fwd,
        mha_flash_reference)

    gen = torch.Generator(device="cuda").manual_seed(14)
    fwd_r, dkdv_r, dq_r = (
        results.setdefault(name, {"max_abs_err": 0.0})
        for name in ("mha_flash_fwd", "mha_flash_bwd_dkdv",
                     "mha_flash_bwd_dq"))
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, S, H, D, dtype, valid_len, on the main path): flagship_large's
    # update pass, whose first 512 rows are its rollout step's shape (checked
    # for batch invariance below); a ragged problem across tile edges in
    # float32 (the CUDA-core kernels) and in bf16 (the tensor-core ones) at
    # D = 32, 16 and 64; D = 64 past 256 entities (five key tiles) in both;
    # S = 1024.
    cases = [
        (4096, 512, 4, 32, bf16, 511, True),
        (3, 130, 2, 32, f32, 97, False),
        (3, 130, 2, 32, bf16, 97, False),
        (3, 130, 2, 16, bf16, 97, False),
        (3, 130, 2, 64, bf16, 97, False),
        (64, 304, 4, 64, f32, 300, False),
        (64, 304, 4, 64, bf16, 300, False),
        (256, 1024, 4, 32, bf16, 1000, False),
    ]

    def kernels(q, k, v, dout, valid_len):
        out, lse = mha_flash_fwd(q, k, v, valid_len)
        return (out, lse,
                *mha_flash_bwd(q, k, v, out, lse, dout, valid_len))

    for B, S, H, D, dtype, valid_len, main_path in cases:
        dname = str(dtype).split(".")[-1]
        tag = f"[{B},{S},{H},{D}] {dname} valid_len={valid_len}"
        q, k, v, dout = (torch.randn(B, S, H, D, device="cuda", generator=gen)
                         .to(dtype) for _ in range(4))
        got = kernels(q, k, v, dout, valid_len)
        out, lse = got[:2]
        want_out, want_lse = _plain_chunks(mha_flash_reference, (q, k, v),
                                           valid_len)
        if dtype == bf16:
            fwd_err = compare_ulp(f"mha_flash fwd out {tag}", out, want_out)
        else:
            fwd_err = compare(f"mha_flash fwd out {tag}", out, want_out,
                              **TOL[("flash_fwd", dname)])
        fwd_err = max(fwd_err, compare(f"mha_flash fwd lse {tag}", lse,
                                       want_lse, **TOL["flash_lse"]))
        del want_out, want_lse
        # The plain backward from the kernel's out and lse: only the
        # backward's arithmetic is compared.
        want = _plain_chunks(mha_flash_bwd_reference,
                             (q, k, v, out, lse, dout), valid_len)
        tol = TOL[("flash_bwd", dname)]
        dq_err = compare(f"mha_flash bwd dq {tag}", got[2], want[0], **tol)
        dkdv_err = max(
            compare(f"mha_flash bwd dk {tag}", got[3], want[1], **tol),
            compare(f"mha_flash bwd dv {tag}", got[4], want[2], **tol))
        del want
        if main_path:
            for r, err in ((fwd_r, fwd_err), (dkdv_r, dkdv_err),
                           (dq_r, dq_err)):
                r["max_abs_err"] = max(r["max_abs_err"], err)
        if valid_len < S:
            # Keys past valid_len must have no effect: poison them.
            k[:, valid_len:] = 1e4
            v[:, valid_len:] = -1e4
            if not all(torch.equal(a, b) for a, b in
                       zip(kernels(q, k, v, dout, valid_len), got)):
                raise AssertionError(f"mha_flash {tag}: masked keys changed "
                                     f"the output or a gradient")
            log(f"  mha_flash {tag}: keys past valid_len poisoned, out, lse, "
                f"dq, dk, dv unchanged ok")
        if main_path:
            _flash_main_path(kernels, (q, k, v, dout), got, valid_len,
                             (fwd_r, dkdv_r, dq_r))


def _flash_main_path(kernels, inputs, got, valid_len, records):
    """flagship_large's shapes: the rollout step (the first 512 rows) must
    equal the update pass's rows bitwise; then the kernels' times at both
    shapes against their bounds and the library's, and the plain versions'
    at the rollout shape, where their [B, H, S, S] tensors fit. The record
    holds the rollout shape's numbers, the one shape all four are taken
    at."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.mha_flash import (
        mha_flash_bwd_dkdv, mha_flash_bwd_dq, mha_flash_bwd_reference,
        mha_flash_delta, mha_flash_fwd, mha_flash_reference)

    rollout = [t[:512] for t in inputs]
    if not all(torch.equal(a, b[:512]) for a, b in
               zip(kernels(*rollout, valid_len), got)):
        raise AssertionError("mha_flash: the first 512 rows of the update "
                             "pass differ from the rollout step's")
    log("  mha_flash: rows 0-511 at B=4096 equal B=512 bitwise (out, lse, "
        "dq, dk, dv) ok")
    for shape in ("update", "rollout"):
        q, k, v, dout = inputs if shape == "update" else rollout
        B, S, H, D = q.shape
        out, lse = mha_flash_fwd(q, k, v, valid_len)
        delta = mha_flash_delta(out, dout)
        ms = (time_ms(lambda: mha_flash_fwd(q, k, v, valid_len)),
              time_ms(lambda: mha_flash_bwd_dkdv(q, k, v, dout, lse, delta,
                                                 valid_len)),
              time_ms(lambda: mha_flash_bwd_dq(q, k, v, dout, lse, delta,
                                               valid_len)))
        bounds = _flash_bounds(B, S, H, D, valid_len, q.element_size())
        lib_fwd, lib_bwd = _sdpa_library(q, k, v, dout, valid_len)
        tag = f"[{B},{S},{H},{D}] bf16 valid_len={valid_len} ({shape})"
        # The C entry points run all three bf16 kernels on tensor cores.
        paths = ("tensor_core", "tensor_core", "tensor_core")
        for name, t, b, path in zip(("fwd", "bwd_dkdv", "bwd_dq"), ms,
                                    bounds, paths):
            log(f"  mha_flash_{name} {tag}: kernel {t:.3f} ms on the "
                f"{path} path, bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']})")
        log(f"  scaled_dot_product_attention {tag}: fwd {lib_fwd} ms, bwd "
            f"(dq, dk, dv in one call) {lib_bwd} ms; kernels fwd + dkdv + dq "
            f"{sum(ms):.3f} ms")
        if shape == "rollout":
            plain_fwd = time_ms(lambda: mha_flash_reference(q, k, v,
                                                            valid_len))
            plain_bwd = time_ms(lambda: mha_flash_bwd_reference(
                q, k, v, out, lse, dout, valid_len))
            log(f"  mha_flash plain {tag}: fwd {plain_fwd:.3f} ms, bwd (dq, "
                f"dk, dv together) {plain_bwd:.3f} ms")
            for r, t, plain, lib, b, path in zip(
                    records, ms, (plain_fwd, plain_bwd, plain_bwd),
                    (lib_fwd, lib_bwd, None), bounds, paths):
                r.update(ms=t, plain_ms=plain, library_ms=lib, path=path,
                         **b)


GMM_SHAPES = [(63, 512, 512, 39, 2048), (95, 256, 1024, 64, 2048),
              (127, 256, 1024, 128, 1024)]


def _gmm_inputs(gen, B, C, IN, P, OUT, dtype):
    import torch

    x = torch.randn(B, C, IN, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(P, IN, OUT, device="cuda", generator=gen)
         * IN ** -0.5).to(dtype)
    idx = torch.randint(0, P, (B,), device="cuda", generator=gen,
                        dtype=torch.int32)
    return x, w, idx


def _gmm_bound(B, C, IN, policies_used, OUT, itemsize):
    """x read, the weights of the policies in use read and y written once,
    the indices read; the product on bf16 tensor cores."""
    nbytes = (itemsize * (B * C * IN + policies_used * IN * OUT + B * C * OUT)
              + 4 * B)
    return bound(nbytes, {"bf16_tensor": 2 * B * C * IN * OUT})


def check_grouped_matmul(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import (
        GROUPED_MATMUL, grouped_matmul, grouped_matmul_reference,
        uses_tensor_cores)

    gen = torch.Generator(device="cuda").manual_seed(15)
    res = results["grouped_matmul"] = {"max_abs_err": 0.0}
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    # (B, C, IN, P, OUT, dtype, on the main path): the three shapes of
    # benchmarks/grouped_matmul_bench.py (tensor cores); ragged bf16 and
    # float16 on the tensor-core path (C and OUT not multiples of its 128 x
    # 128 tile, IN not of its 64-deep slice); bf16 with IN = 70, not a
    # multiple of 8, and bf16 and float16 with x one element off a 16-byte
    # boundary, on the CUDA-core path; float32 with no dimension a multiple
    # of the CUDA-core kernel's tiles. The last field shifts x's start by
    # that many elements.
    cases = [(*GMM_SHAPES[0], bf16, True, 0), (*GMM_SHAPES[1], bf16, False, 0),
             (*GMM_SHAPES[2], bf16, False, 0),
             (7, 100, 72, 3, 136, bf16, False, 0),
             (7, 100, 72, 3, 136, f16, False, 0),
             (5, 64, 70, 3, 96, bf16, False, 0),
             (5, 64, 72, 3, 96, bf16, False, 1),
             (5, 64, 72, 3, 96, f16, False, 1),
             (7, 100, 72, 3, 130, f32, False, 0)]
    for B, C, IN, P, OUT, dtype, main_path, shift in cases:
        dname = str(dtype).split(".")[-1]
        x, w, idx = _gmm_inputs(gen, B, C, IN, P, OUT, dtype)
        if shift:
            x = torch.cat([x.new_zeros(shift), x.flatten()])[shift:].view(
                B, C, IN)
        y, path = _routed(GROUPED_MATMUL, uses_tensor_cores(x, w),
                          grouped_matmul, x, w, idx)
        tag = (f"[{B}x{C}, {IN}->{OUT}, P={P}] {dname}"
               f"{f' x {2 * shift} bytes off' if shift else ''} ({path})")
        err = compare(f"grouped_matmul {tag}", y,
                      grouped_matmul_reference(x, w, idx),
                      **TOL[("gmm", dname)])
        if not main_path and B > 3:
            _gmm_out_of_range(tag, x, w, idx)
        if main_path:
            res["max_abs_err"] = err
            idx64 = idx.long()
            ms = time_ms(lambda: grouped_matmul(x, w, idx))
            plain_ms = time_ms(lambda: grouped_matmul_reference(x, w, idx))
            library_ms = time_ms(lambda: torch.bmm(x, w[idx64]))
            b = _gmm_bound(B, C, IN, int(idx.unique().numel()), OUT,
                           x.element_size())
            log(f"  grouped_matmul {tag}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, torch.bmm(x, W[idx]) {library_ms:.3f} "
                f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       path=path, **b)


def _gmm_out_of_range(tag, x, w, idx):
    """Chunks whose index lies outside [0, P) get NaN rows; the others are
    unchanged."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import grouped_matmul

    bad = idx.clone()
    bad[1], bad[3] = w.shape[0], -1
    got = grouped_matmul(x, w, bad)
    keep = torch.ones(idx.shape[0], dtype=torch.bool, device="cuda")
    keep[1] = keep[3] = False
    if not (bool(torch.isnan(got[~keep]).all())
            and torch.equal(got[keep], grouped_matmul(x, w, idx)[keep])):
        raise AssertionError(f"grouped_matmul {tag}: an index outside [0, P) "
                             f"did not give NaN rows alone")
    log(f"  grouped_matmul {tag}: indices P and -1 give NaN rows, the other "
        f"chunks unchanged ok")


def _pbt_chunk_geometry():
    """headline_pbt's policy-chunk layout, as ``init_training`` derives it
    for its 32768 rows: (policies, chunk size C, chunks B)."""
    from madrona_learn_tpu_torch.rollouts import RolloutConfig

    sp, cp, pp = PBT_PORTIONS
    cfg = RolloutConfig.setup_population(
        num_current_policies=PBT_TRAIN, num_past_policies=PBT_PAST,
        num_teams=2, team_size=1, sim_batch_size=2 * NUM_WORLDS,
        actions_cfg={}, self_play_portion=sp, cross_play_portion=cp,
        past_play_portion=pp, static_play_portion=0.0)
    return (cfg.pbt.total_num_policies, cfg.policy_chunk_size,
            cfg.num_policy_chunks)


def _chunked_lstm_inputs(gen, T, B, C, H, P, dtype):
    """x_proj, keep, the [P, H, 4H] / [P, 4H] stacks, chunk_policy [B] (in
    [0, P), every policy present), c0, h0."""
    import torch

    x, keep, _, _, c0, h0 = _lstm_inputs(gen, T, B * C, H, dtype)
    wr = (torch.randn(P, H, 4 * H, device="cuda", generator=gen)
          * H ** -0.5).to(dtype)
    bias = torch.randn(P, 4 * H, device="cuda", generator=gen).to(dtype)
    idx = torch.randint(0, P, (B,), device="cuda", generator=gen,
                        dtype=torch.int32)
    idx[:P] = torch.arange(P, device="cuda", dtype=torch.int32)
    return x, keep, wr, bias, idx, c0, h0


def _chunked_lstm_bound(T, B, C, H, policies_used, itemsize):
    """The forward's bytes and operations over its B * C rows: x_proj and
    keep read, the weights of the policies in use read, c0 and h0 read,
    ys and cs written, the chunk indices read; the h . Wr products on
    tensor cores and ~30 f32 operations of gate math per unit and step."""
    N = B * C
    seq = T * N * H
    nbytes = (itemsize * (4 * seq + T * N + policies_used * (4 * H * H + 4 * H)
                          + 2 * N * H + 2 * seq) + 4 * B)
    return bound(nbytes, {"bf16_tensor": 2 * T * N * H * 4 * H,
                          "f32": 30 * seq})


def _policy_rows(idx, C, P):
    """Each policy's rows of a chunk layout: [(p, int64 rows)]."""
    import torch

    out = []
    for p in range(P):
        chunks = torch.nonzero(idx == p).flatten()
        if chunks.numel():
            rows = (chunks[:, None] * C + torch.arange(
                C, device=idx.device)).flatten()
            out.append((p, rows))
    return out


def _step_checks(tag, fwd, x, keep, w, b, idx, states, outs, carried):
    """The rollout step is the sequence forward: a T = 1 call of ``fwd``
    from the state after step t - 1 (``carried``: each state's [T, N, H]
    sequence, in the states' order, cleared where keep is 0) bitwise step
    t of the T-step call's ``outs``, at the first, middle and last step."""
    import torch

    zero = torch.zeros((), dtype=x.dtype, device="cuda")
    T = x.shape[0]
    for t in sorted({0, T // 2, T - 1}):
        st = (states if t == 0 else
              [torch.where(keep[t - 1][:, None] > 0.5, s[t - 1], zero)
               for s in carried])
        step = fwd(x[t:t + 1].contiguous(), keep[t:t + 1].contiguous(), w, b,
                   idx, *st)
        step = step if isinstance(step, tuple) else (step,)
        if not all(torch.equal(o[0], seq[t]) for o, seq in zip(step, outs)):
            raise AssertionError(f"{tag}: the T = 1 step from the state "
                                 f"after step {t - 1} differs from step {t}")
    log(f"  {tag}: T = 1 steps bitwise steps of the sequence ok")


def _wide_single(results, name, H, dname, label, run, plain, tol, b,
                 path="cuda_core"):
    """The single-policy kernel ``name`` at H = 384 or 512 on one policy's
    rows, on route ``path``: ``run()``'s outputs against ``plain()``'s,
    both timed, into results[name]["wide"] with the bound ``b``."""
    err = max(compare(f"{name} H={H} {dname} {label} out {i}", o, r, **tol)
              for i, (o, r) in enumerate(zip(run(), plain())))
    ms = time_ms(run)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    log(f"  {name} H={H} {dname} at the {label} shape: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}), no library call (cuDNN takes one weight a "
        f"call and cannot clear the carry mid-sequence)")
    _wide_record(results, name, H, dname, label, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, library_ms=None, path=path, **b)


def _wide_record(results, name, H, dname, label, **rec):
    """An instance's numbers at one path's shape (``label``: collect,
    learn, infer or ragged) into results[name]["wide"][H][dtype][label]."""
    wide = results.setdefault(name, {}).setdefault("wide", {})
    wide.setdefault(str(H), {}).setdefault(dname, {})[label] = rec


def check_lstm_chunked(results, H):
    """lstm_sequence_fwd_chunked at width H (the model's 256, and the
    two-block-cluster instances at 384 and 512, whose numbers go under the
    record's ``wide``) at headline_pbt's collect step (the chunk size and
    count init_training derives), at its learn step (T = 16, 8 chunks of
    1280, one a train policy) and at chunks of 100 rows (not a multiple of
    the 32-row tile), bf16 (on tensor cores, as ``fwd_uses_tensor_cores``
    says at every width) and f32 on CUDA cores, its float16 instance (on
    tensor cores at 256, CUDA cores at 384 and 512) at the collect step
    (and at 256 at the learn step), and, at 512, infer_512's step (95
    chunks of
    256 rows, 32 policies): against its plain twin; row for row bitwise
    ``lstm_sequence_fwd`` with the row's policy's weights (each policy's
    chunks in one call); batch invariance (the first chunks alone, and the
    chunks rolled); chunks of index P and -1 NaN, the others unchanged;
    its time against one ``lstm_sequence_fwd`` a policy over the same rows
    (the per-policy loop's launches) and its bound (the float16 instance's
    into ``float16``, its learn step's into ``float16["learn_shape"]``, the
    bf16 learn step's into ``learn_shape``). At 384 and 512
    also ``lstm_sequence_fwd`` on one policy's rows against its twin,
    timed."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        LSTM_FWD, LSTM_FWD_CHUNKED, _sequence, fwd_uses_tensor_cores,
        lstm_sequence_fwd, lstm_sequence_fwd_chunked,
        lstm_sequence_fwd_chunked_reference)

    P, C, B = _pbt_chunk_geometry()
    wide = H != CHANNELS
    log(f"lstm_sequence_fwd_chunked at headline_pbt's collect step: "
        f"{P} policies, chunks of C = {C} rows, B = {B} chunks "
        f"(RolloutConfig.setup_population for {2 * NUM_WORLDS} rows: "
        f"ceil({2 * NUM_WORLDS} / {C}) + {P} - 1), H = {H}, T = 1")
    gen = torch.Generator(device="cuda").manual_seed(21 + wide * H)
    res = results.setdefault("lstm_sequence_fwd_chunked",
                             {"max_abs_err": 0.0})
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    # role: "collect" for the bf16 collect step, "learn" for the bf16
    # learn step (timed into res["learn_shape"]), "float16" for the
    # collect step's float16 instance (timed into res["float16"]),
    # "float16_learn" for its learn step (res["float16"]["learn_shape"]),
    # "infer" for infer_512's step, None for the ragged checks.
    learn_T = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    cases = [(bf16, 1, C, B, P, "collect"),
             (bf16, learn_T, PBT_MINIBATCH, PBT_TRAIN, PBT_TRAIN, "learn"),
             (f16, 1, C, B, P, "float16"),
             (bf16, 1, 100, 41, P, None), (f32, 1, 100, 41, P, None)]
    if not wide:
        cases.insert(3, (f16, learn_T, PBT_MINIBATCH, PBT_TRAIN, PBT_TRAIN,
                         "float16_learn"))
    if H == INFER_CHANNELS:
        infer_c, infer_b = _infer_geometry()
        cases.append((bf16, 1, infer_c, infer_b, INFER_POLICIES, "infer"))
    main_route = ("tensor_core" if fwd_uses_tensor_cores(bf16, H)
                  else "cuda_core")
    for dtype, T, chunk, chunks, P_c, role in cases:
        dname = str(dtype).split(".")[-1]
        args = _chunked_lstm_inputs(gen, T, chunks, chunk, H, P_c, dtype)
        if role in ("learn", "float16_learn"):
            args = (*args[:4], torch.arange(P_c, dtype=torch.int32,
                                            device="cuda"), *args[5:])
        x, keep, wr, bias, idx, c0, h0 = args
        (ys, cs), path = _routed(LSTM_FWD_CHUNKED,
                                 fwd_uses_tensor_cores(dtype, H),
                                 lstm_sequence_fwd_chunked, *args)
        if dtype == bf16 and path != main_route:
            raise AssertionError(f"lstm_sequence_fwd_chunked H={H} bf16: "
                                 f"took the {path} route")
        tag = (f"[{T}, {chunks} x {chunk}, {4 * H}] P={P_c} {dname} "
               f"({path})")
        want = lstm_sequence_fwd_chunked_reference(*args)
        tol = TOL[("fwd", dname)]
        err = max(compare(f"lstm_sequence_fwd_chunked {tag} ys", ys,
                          want[0], **tol),
                  compare(f"lstm_sequence_fwd_chunked {tag} cs", cs,
                          want[1], **tol))
        by_policy = _policy_rows(idx, chunk, P_c)
        for p, rows in by_policy:
            y1, c1 = lstm_sequence_fwd(
                x[:, rows].contiguous(), keep[:, rows].contiguous(), wr[p],
                bias[p], c0[rows], h0[rows])
            if not (torch.equal(y1, ys[:, rows])
                    and torch.equal(c1, cs[:, rows])):
                raise AssertionError(f"lstm_sequence_fwd_chunked {tag}: "
                                     f"policy {p}'s rows differ from "
                                     f"lstm_sequence_fwd's")
        log(f"  lstm_sequence_fwd_chunked {tag}: every row bitwise "
            f"lstm_sequence_fwd's with its policy's weights "
            f"({len(by_policy)} calls) ok")
        # Batch invariance: the first 8 chunks alone, and the chunks
        # rolled by 5.
        n8 = 8 * chunk
        sub = lstm_sequence_fwd_chunked(
            x[:, :n8].contiguous(), keep[:, :n8].contiguous(), wr, bias,
            idx[:8].contiguous(), c0[:n8], h0[:n8])
        roll = lambda t, dim: torch.roll(t, 5 * chunk, dims=dim)
        rolled = lstm_sequence_fwd_chunked(
            roll(x, 1), roll(keep, 1), wr, bias, torch.roll(idx, 5),
            roll(c0, 0), roll(h0, 0))
        for name, got, ref in (("8 chunks", sub[0], ys[:, :n8]),
                               ("8 chunks cs", sub[1], cs[:, :n8]),
                               ("rolled", rolled[0], roll(ys, 1)),
                               ("rolled cs", rolled[1], roll(cs, 1))):
            bitwise(f"lstm_sequence_fwd_chunked {tag} {name}", got, ref)
        if role not in ("collect", "infer", "learn", "float16_learn"):
            bad = idx.clone()
            bad[1], bad[3] = P_c, -1
            yb, cb = lstm_sequence_fwd_chunked(x, keep, wr, bias, bad, c0,
                                               h0)
            rows = _skipped_rows(chunks, chunk)
            if not (bool(yb[:, rows].isnan().all())
                    and bool(cb[:, rows].isnan().all())
                    and torch.equal(yb[:, ~rows], ys[:, ~rows])
                    and torch.equal(cb[:, ~rows], cs[:, ~rows])):
                raise AssertionError(f"lstm_sequence_fwd_chunked {tag}: a "
                                     f"chunk of index P or -1 was not "
                                     f"skipped alone")
            log(f"  lstm_sequence_fwd_chunked {tag}: chunks of index P and "
                f"-1 NaN, the others unchanged ok")
            if role is None:
                if wide:
                    _wide_record(results, "lstm_sequence_fwd_chunked", H,
                                 dname, "ragged", max_abs_err=err, shape=tag)
                continue
        per_policy = [(x[:, rows].contiguous(), keep[:, rows].contiguous(),
                       wr[p], bias[p], c0[rows], h0[rows])
                      for p, rows in by_policy]
        ms = time_ms(lambda: lstm_sequence_fwd_chunked(*args))
        loop_ms = time_ms(lambda: [lstm_sequence_fwd(*a)
                                   for a in per_policy])
        plain_ms = time_ms(lambda: lstm_sequence_fwd_chunked_reference(
            *args), reps=3, warmup=1)
        b = _chunked_lstm_bound(T, chunks, chunk, H, len(by_policy),
                                x.element_size())
        log(f"  lstm_sequence_fwd_chunked {tag}: kernel {ms:.4f} ms, "
            f"{len(per_policy)} lstm_sequence_fwd over the same rows "
            f"{loop_ms:.4f} ms, plain {plain_ms:.3f} ms, no library call "
            f"(cuDNN's LSTM takes one weight a call), bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=None, path=path, per_policy_ms=loop_ms,
                   chunk=chunk, chunks=chunks, policies=P_c, **b)
        if not wide:
            if role == "float16_learn":
                res.setdefault("float16", {})["learn_shape"] = rec
                continue
            key = {"collect": None, "float16": "float16",
                   "learn": "learn_shape"}[role]
            (res if key is None else res.setdefault(key, {})).update(rec)
            continue
        label = "collect" if role == "float16" else role
        _wide_record(results, "lstm_sequence_fwd_chunked", H, dname, label,
                     shape=tag, **rec)
        a1 = per_policy[0]
        _, single_path = _routed(LSTM_FWD, fwd_uses_tensor_cores(dtype, H),
                                 lstm_sequence_fwd, *a1)
        _wide_single(results, "lstm_sequence_fwd", H, dname, label,
                     lambda: lstm_sequence_fwd(*a1), lambda: _sequence(*a1),
                     tol, _lstm_bounds(T, a1[0].shape[1], H,
                                       x.element_size())[0],
                     path=single_path)


def _chunked_lstm_bwd_bound(T, B, C, H, policies_used, itemsize):
    """The backward's bytes and operations over its B * C rows (as
    ``_lstm_bounds``' backward, with the weights of the policies in use):
    x_proj, keep, ys, cs, dys, c0 and h0 read, each used policy's Wr and
    bias read and its dWr and db written, dx_proj, dh0 and dc0 written, the
    chunk indices read; three times the forward's products on tensor cores
    and ~40 f32 operations of gate math per unit and step."""
    N = B * C
    seq, state = T * N * H, N * H
    weights = policies_used * (4 * H * H + 4 * H)
    nbytes = (itemsize * (4 * seq + T * N + 3 * seq + 2 * state + weights
                          + 4 * seq + 2 * state + weights) + 4 * B)
    return bound(nbytes, {"bf16_tensor": 3 * 2 * T * N * H * 4 * H,
                          "f32": 40 * seq})


def check_lstm_bwd_chunked(results, H):
    """lstm_sequence_bwd_chunked at width H (256, and the two-block-cluster
    instances at 384 and 512, under the record's ``wide``) at
    headline_pbt's learn step (8 train policies, one chunk of a
    minibatch's 1280 sequences each, T = 16, bf16 on tensor cores at every
    width, as ``bwd_uses_tensor_cores`` says) and at chunks of 37 rows (no
    multiple of a tile) in a shuffled order with a policy owning two chunks
    and one owning none, in bf16 and f32 (CUDA cores): the forward's T = 1
    steps
    bitwise steps of its sequence; against its plain twin's autograd;
    every chunk's dx_proj / dh0 / dc0 bitwise ``lstm_sequence_bwd``'s on
    that chunk's rows with its policy's weights, and each policy's dwr /
    db within the backward's tolerance of that kernel's (summed over its
    chunks), bitwise it for a policy of one chunk on CUDA cores; dwr / db
    bitwise over two calls and, for a policy of one chunk, bitwise the call
    over that chunk alone; a chunk of index P or -1 NaN and adding to no
    policy; the time against the per-policy loop's lstm_sequence_bwd
    launches over the same rows, and its bound. Its float16 instance (on
    tensor cores at 256, CUDA cores at 384 and 512) at the learn step the
    same way, with the NaN chunks, its times and bound into ``float16``. At
    384 and 512 also ``lstm_sequence_bwd`` on one chunk's rows against its
    twin's autograd, timed."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        LSTM_BWD, LSTM_BWD_CHUNKED, bwd_uses_tensor_cores, lstm_sequence_bwd,
        lstm_sequence_bwd_chunked, lstm_sequence_chunked_reference,
        lstm_sequence_fwd_chunked, lstm_sequence_reference)

    T, P = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS, PBT_TRAIN
    wide = H != CHANNELS
    log(f"lstm_sequence_bwd_chunked at headline_pbt's learn step: {P} train "
        f"policies, one chunk of a minibatch's C = {PBT_MINIBATCH} "
        f"sequences each, T = {T}, H = {H}")
    gen = torch.Generator(device="cuda").manual_seed(23 + wide * H)
    res = results.setdefault("lstm_sequence_bwd_chunked",
                             {"max_abs_err": 0.0})
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    shuffled = [2, 0, 3, 2, 1, 0]      # policy 4 of 5 owns no chunk
    # main_path: True for the bf16 learn step, "float16" for its float16
    # instance (timed into res["float16"]), False for the ragged checks.
    for dtype, T_c, C, order, main_path in (
            (bf16, T, PBT_MINIBATCH, list(range(P)), True),
            (f16, T, PBT_MINIBATCH, list(range(P)), "float16"),
            (bf16, 5, 37, shuffled, False), (f32, 5, 37, shuffled, False)):
        P_c = P if main_path else 5
        B = len(order)
        dname = str(dtype).split(".")[-1]
        args = list(_chunked_lstm_inputs(gen, T_c, B, C, H, P_c, dtype))
        args[4] = torch.tensor(order, dtype=torch.int32, device="cuda")
        x, keep, wr, bias, idx, c0, h0 = args
        tag = (f"[{T_c}, {B} x {C}, {4 * H}] P={P_c} {dname} chunks "
               f"{order}")
        ys, cs = lstm_sequence_fwd_chunked(*args)
        _step_checks(f"lstm_sequence_fwd_chunked {tag}",
                     lstm_sequence_fwd_chunked, x, keep, wr, bias, idx,
                     (c0, h0), (ys, cs), (cs, ys))
        probe = torch.randn(T_c, B * C, H, device="cuda",
                            generator=gen).to(dtype)
        got, path = _routed(LSTM_BWD_CHUNKED, bwd_uses_tensor_cores(dtype, H),
                            lstm_sequence_bwd_chunked, *args, ys, cs, probe)
        tag += f" ({path})"
        # The main paths' routes: bf16 on tensor cores at every width,
        # float16 there at 128 and 256.
        main_route = ("tensor_core" if dtype == bf16 or H in (128, 256)
                      else "cuda_core")
        if main_path and path != main_route:
            raise AssertionError(f"lstm_sequence_bwd_chunked {tag}: the "
                                 f"main path took the {path} route")
        leaves = [a.detach().clone().requires_grad_(i in (0, 2, 3, 5, 6))
                  for i, a in enumerate(args)]
        diff = [leaves[i] for i in (0, 2, 3, 5, 6)]

        def plain_bwd():
            out = lstm_sequence_chunked_reference(*leaves)
            return torch.autograd.grad(
                (out.float() * probe.float()).sum(), diff)

        tol = TOL[("bwd", dname)]
        err = 0.0
        for name, g, w in zip(("dxp", "dwr", "db", "dc0", "dh0"), got,
                              plain_bwd()):
            err = max(err, compare(f"lstm_sequence_bwd_chunked {name} {tag}",
                                   g, w, **tol))
        dxp, dwr, db, dc0, dh0 = got
        # Row for row, the single-policy backward on each chunk's rows; on
        # CUDA cores a policy of one chunk's dwr / db bitwise too.
        sums = {}
        for b, p in enumerate(order):
            rows = slice(b * C, (b + 1) * C)
            one = lstm_sequence_bwd(
                *(t[:, rows].contiguous() for t in (x, keep)), wr[p],
                bias[p], c0[rows], h0[rows],
                *(t[:, rows].contiguous() for t in (ys, cs, probe)))
            if not (torch.equal(one[0], dxp[:, rows])
                    and torch.equal(one[3], dc0[rows])
                    and torch.equal(one[4], dh0[rows])):
                raise AssertionError(f"lstm_sequence_bwd_chunked {tag}: chunk "
                                     f"{b}'s rows differ from "
                                     f"lstm_sequence_bwd's")
            if (path == "cuda_core" and order.count(p) == 1
                    and not (torch.equal(one[1], dwr[p])
                             and torch.equal(one[2], db[p]))):
                raise AssertionError(f"lstm_sequence_bwd_chunked {tag}: "
                                     f"policy {p}'s dwr / db differ from "
                                     f"lstm_sequence_bwd's")
            dw1, db1 = sums.get(p, (0.0, 0.0))
            sums[p] = (dw1 + one[1].float(), db1 + one[2].float())
        log(f"  lstm_sequence_bwd_chunked {tag}: every chunk's dxp / dc0 / "
            f"dh0 bitwise lstm_sequence_bwd's on its rows ({B} calls) ok")
        for p in range(P_c):
            want_w, want_b = sums.get(p, (torch.zeros_like(dwr[p]),
                                          torch.zeros_like(db[p])))
            compare(f"lstm_sequence_bwd_chunked dwr[{p}] {tag} vs "
                    f"lstm_sequence_bwd", dwr[p], want_w, **tol)
            compare(f"lstm_sequence_bwd_chunked db[{p}] {tag} vs "
                    f"lstm_sequence_bwd", db[p], want_b, **tol)
            if p not in sums and (dwr[p].any() or db[p].any()):
                raise AssertionError(f"lstm_sequence_bwd_chunked {tag}: "
                                     f"policy {p} owns no chunk and got a "
                                     f"gradient")
        again = lstm_sequence_bwd_chunked(*args, ys, cs, probe)
        for i, name in enumerate(("dxp", "dwr", "db", "dc0", "dh0")):
            bitwise(f"lstm_sequence_bwd_chunked {tag} {name} over two calls",
                    again[i], got[i])
        # A policy of one chunk: its chunk alone gives the same dwr / db.
        alone = [p for p in set(order) if order.count(p) == 1]
        for p in sorted(alone):
            b = order.index(p)
            rows = slice(b * C, (b + 1) * C)
            one = lstm_sequence_bwd_chunked(
                *(t[:, rows].contiguous() for t in (x, keep)), wr, bias,
                idx[b:b + 1].contiguous(), c0[rows], h0[rows],
                *(t[:, rows].contiguous() for t in (ys, cs, probe)))
            if not (torch.equal(one[1][p], dwr[p])
                    and torch.equal(one[2][p], db[p])):
                raise AssertionError(f"lstm_sequence_bwd_chunked {tag}: "
                                     f"policy {p}'s dwr / db differ from "
                                     f"its chunk's alone")
        log(f"  lstm_sequence_bwd_chunked {tag}: dwr / db of policies "
            f"{sorted(alone)} bitwise their chunk's alone ok")
        if main_path is not True:
            bad = idx.clone()
            bad[1], bad[3] = P_c, -1
            yb, cb = lstm_sequence_fwd_chunked(x, keep, wr, bias, bad, c0,
                                               h0)
            gb = lstm_sequence_bwd_chunked(x, keep, wr, bias, bad, c0, h0,
                                           yb, cb, probe)
            rows = _skipped_rows(B, C)
            if not (bool(gb[0][:, rows].isnan().all())
                    and bool(gb[3][rows].isnan().all())
                    and bool(gb[4][rows].isnan().all())
                    and torch.equal(gb[0][:, ~rows], dxp[:, ~rows])
                    and torch.equal(gb[3][~rows], dc0[~rows])
                    and torch.equal(gb[4][~rows], dh0[~rows])
                    and bool(torch.isfinite(gb[1]).all())
                    and bool(torch.isfinite(gb[2]).all())):
                raise AssertionError(f"lstm_sequence_bwd_chunked {tag}: a "
                                     f"chunk of index P or -1 was not "
                                     f"skipped alone")
            log(f"  lstm_sequence_bwd_chunked {tag}: chunks of index P and "
                f"-1 NaN and in no policy's dwr / db, the others unchanged "
                f"ok")
            if not main_path:
                if wide:
                    _wide_record(results, "lstm_sequence_bwd_chunked", H,
                                 dname, "ragged", max_abs_err=err, shape=tag)
                continue
        per_policy = [((x[:, b * C:(b + 1) * C].contiguous(),
                        keep[:, b * C:(b + 1) * C].contiguous(), wr[p],
                        bias[p], c0[b * C:(b + 1) * C],
                        h0[b * C:(b + 1) * C])
                       + tuple(t[:, b * C:(b + 1) * C].contiguous()
                               for t in (ys, cs, probe)))
                      for b, p in enumerate(order)]
        same = all(torch.equal(lstm_sequence_bwd(*a)[1], dwr[p])
                   for a, p in zip(per_policy, order))
        log(f"  lstm_sequence_bwd_chunked {tag}: dwr bitwise "
            f"lstm_sequence_bwd's a policy (64 divides C: the same boxes "
            f"and splits): {'yes' if same else 'no'}")
        ms = time_ms(lambda: lstm_sequence_bwd_chunked(*args, ys, cs, probe))
        loop_ms = time_ms(lambda: [lstm_sequence_bwd(*a)
                                   for a in per_policy])
        plain_ms = time_ms(plain_bwd, reps=3, warmup=1)
        b = _chunked_lstm_bwd_bound(T_c, B, C, H, P_c, x.element_size())
        log(f"  lstm_sequence_bwd_chunked {tag}: kernel {ms:.4f} ms, {B} "
            f"lstm_sequence_bwd over the same rows {loop_ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, no library call (cuDNN's LSTM takes one "
            f"weight a call and no keep mask), bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
        rec = dict(max_abs_err=err, path=path, ms=ms, plain_ms=plain_ms,
                   library_ms=None, per_policy_ms=loop_ms, chunk=C, chunks=B,
                   policies=P_c, dwr_bitwise_single=same, **b)
        if not wide:
            (res if main_path is True else
             res.setdefault("float16", {})).update(rec)
            continue
        _wide_record(results, "lstm_sequence_bwd_chunked", H, dname, "learn",
                     shape=tag, **rec)
        a1 = per_policy[0]
        one_leaves = [t.detach().clone().requires_grad_()
                      for t in (a1[0], *a1[2:6])]

        def plain_one():
            out = lstm_sequence_reference(one_leaves[0], a1[1],
                                          *one_leaves[1:])
            return torch.autograd.grad(
                (out.float() * a1[8].float()).sum(), one_leaves)

        single = ("tensor_core" if bwd_uses_tensor_cores(dtype, H)
                  else "cuda_core")
        before = LSTM_BWD.tc_launches
        _wide_single(results, "lstm_sequence_bwd", H, dname, "learn",
                     lambda: lstm_sequence_bwd(*a1), plain_one, tol,
                     _lstm_bounds(T_c, C, H, x.element_size())[1],
                     path=single)
        if (LSTM_BWD.tc_launches > before) != (single == "tensor_core"):
            raise AssertionError(f"lstm_sequence_bwd H={H} {dname}: did not "
                                 f"take the {single} route")


def _chunked_gru_inputs(gen, T, B, C, H, P, dtype):
    """x_proj, keep, the [P, H, 3H] / [P, H] stacks, chunk_policy [B] (in
    [0, P), every policy present), h0."""
    import torch

    x, keep, _, _, h0 = _gru_inputs(gen, T, B * C, H, dtype)
    wh = (torch.randn(P, H, 3 * H, device="cuda", generator=gen)
          * H ** -0.5).to(dtype)
    bias_h = torch.randn(P, H, device="cuda", generator=gen).to(dtype)
    idx = torch.randint(0, P, (B,), device="cuda", generator=gen,
                        dtype=torch.int32)
    idx[:P] = torch.arange(P, device="cuda", dtype=torch.int32)
    return x, keep, wh, bias_h, idx, h0


def _chunked_gru_bounds(T, B, C, H, policies_used, itemsize,
                        tensor="bf16_tensor"):
    """``_gru_bounds`` over the B * C rows with the weights of the policies
    in use (read, and backward their dWh / dbh written) and the chunk
    indices read: (forward, backward)."""
    N = B * C
    seq, state = T * N * H, N * H
    weights = policies_used * (3 * H * H + H)
    fwd_bytes = itemsize * (3 * seq + T * N + weights + state + seq) + 4 * B
    bwd_bytes = (itemsize * (3 * seq + T * N + weights + state + 2 * seq
                             + 3 * seq + weights + state) + 4 * B)
    product = 2 * T * N * H * 3 * H
    return (bound(fwd_bytes, {tensor: product, "f32": 25 * seq}),
            bound(bwd_bytes, {tensor: 3 * product, "f32": 35 * seq}))


def _skipped_rows(B, C, bad=(1, 3)):
    """The rows of chunks ``bad``, as a [B * C] mask."""
    import torch

    skipped = torch.zeros(B, dtype=torch.bool, device="cuda")
    skipped[list(bad)] = True
    return skipped.repeat_interleave(C)


def check_gru_chunked(results, H):
    """gru_sequence_fwd_chunked at width H (256, and the two-block-cluster
    instances at 384 and 512, under the record's ``wide``) at
    headline_pbt_gru's collect step (T = 1, the chunk size and count
    init_training derives, 12 policies) and its learn step (T = 16, 8
    train policies, one chunk of a minibatch's 1280 sequences each), bf16
    on tensor cores (as ``fwd_uses_tensor_cores`` says at every width), and
    at chunks of 37 rows (no multiple of a tile) in a shuffled order, in
    bf16 and f32 (CUDA cores): against its plain twin; row for row bitwise
    ``gru_sequence_fwd`` with the row's policy's weights (each policy's
    rows in one call); bitwise over two calls and for the first chunk
    alone; chunks of index P and -1 NaN, the others unchanged; its time
    against one ``gru_sequence_fwd`` a policy over the same rows (the
    per-policy loop's launches) and its bound. Its float16 instance (on
    tensor cores at every width, in the two-block cluster at 384 and 512)
    at the collect step the same way, with the NaN chunks, its times and
    bound into ``float16``. At 384 and 512 also ``gru_sequence_fwd`` on one
    policy's rows against its twin, timed."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        GRU_FWD, GRU_FWD_CHUNKED, fwd_uses_tensor_cores, gru_sequence_fwd,
        gru_sequence_fwd_chunked, gru_sequence_fwd_chunked_reference,
        gru_sequence_reference)

    P, C, B = _pbt_chunk_geometry()
    T = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    wide = H != CHANNELS
    gen = torch.Generator(device="cuda").manual_seed(24 + wide * H)
    res = results.setdefault("gru_sequence_fwd_chunked", {"max_abs_err": 0.0})
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    main_route = ("tensor_core" if fwd_uses_tensor_cores(bf16, H)
                  else "cuda_core")
    shuffled = [2, 0, 3, 2, 1, 0]      # policy 4 of 5 owns no chunk
    # (T, chunks, C, P, dtype, role): the collect step, the learn step,
    # the float16 collect step, then the ragged, shuffled chunks.
    for T_c, chunks, chunk, P_c, dtype, role in (
            (1, B, C, P, bf16, "collect"),
            (T, PBT_TRAIN, PBT_MINIBATCH, PBT_TRAIN, bf16, "learn"),
            (1, B, C, P, f16, "float16"),
            (5, len(shuffled), 37, 5, bf16, None),
            (5, len(shuffled), 37, 5, f32, None)):
        dname = str(dtype).split(".")[-1]
        args = list(_chunked_gru_inputs(gen, T_c, chunks, chunk, H, P_c,
                                        dtype))
        if role == "learn":
            args[4] = torch.arange(P_c, dtype=torch.int32, device="cuda")
        elif role is None:
            args[4] = torch.tensor(shuffled, dtype=torch.int32,
                                   device="cuda")
        x, keep, wh, bias_h, idx, h0 = args
        ys, path = _routed(GRU_FWD_CHUNKED, fwd_uses_tensor_cores(dtype, H),
                           gru_sequence_fwd_chunked, *args)
        tag = (f"[{T_c}, {chunks} x {chunk}, {3 * H}] P={P_c} {dname} "
               f"({path})")
        if role in ("collect", "learn", "float16") and path != main_route:
            raise AssertionError(f"gru_sequence_fwd_chunked {tag}: the main "
                                 f"path took the {path} route")
        tol = TOL[("gru_fwd", dname)]
        err = compare(f"gru_sequence_fwd_chunked {tag}", ys,
                      gru_sequence_fwd_chunked_reference(*args), **tol)
        by_policy = _policy_rows(idx, chunk, P_c)
        for p, rows in by_policy:
            y1 = gru_sequence_fwd(x[:, rows].contiguous(),
                                  keep[:, rows].contiguous(), wh[p],
                                  bias_h[p], h0[rows])
            if not torch.equal(y1, ys[:, rows]):
                raise AssertionError(f"gru_sequence_fwd_chunked {tag}: "
                                     f"policy {p}'s rows differ from "
                                     f"gru_sequence_fwd's")
        log(f"  gru_sequence_fwd_chunked {tag}: every row bitwise "
            f"gru_sequence_fwd's with its policy's weights "
            f"({len(by_policy)} calls) ok")
        bitwise(f"gru_sequence_fwd_chunked {tag} over two calls",
                gru_sequence_fwd_chunked(*args), ys)
        bitwise(f"gru_sequence_fwd_chunked {tag} the first chunk alone",
                gru_sequence_fwd_chunked(
                    x[:, :chunk].contiguous(), keep[:, :chunk].contiguous(),
                    wh, bias_h, idx[:1].contiguous(), h0[:chunk]),
                ys[:, :chunk])
        if role in (None, "float16"):
            bad = idx.clone()
            bad[1], bad[3] = P_c, -1
            yb = gru_sequence_fwd_chunked(x, keep, wh, bias_h, bad, h0)
            rows = _skipped_rows(chunks, chunk)
            if not (bool(yb[:, rows].isnan().all())
                    and torch.equal(yb[:, ~rows], ys[:, ~rows])):
                raise AssertionError(f"gru_sequence_fwd_chunked {tag}: a "
                                     f"chunk of index P or -1 was not "
                                     f"skipped alone")
            log(f"  gru_sequence_fwd_chunked {tag}: chunks of index P and "
                f"-1 NaN, the others unchanged ok")
            if role is None:
                if wide:
                    _wide_record(results, "gru_sequence_fwd_chunked", H,
                                 dname, "ragged", max_abs_err=err, shape=tag)
                continue
        per_policy = [(x[:, rows].contiguous(), keep[:, rows].contiguous(),
                       wh[p], bias_h[p], h0[rows]) for p, rows in by_policy]
        ms = time_ms(lambda: gru_sequence_fwd_chunked(*args))
        loop_ms = time_ms(lambda: [gru_sequence_fwd(*a) for a in per_policy])
        plain_ms = time_ms(lambda: gru_sequence_fwd_chunked_reference(
            *args), reps=3, warmup=1)
        b = _chunked_gru_bounds(T_c, chunks, chunk, H, len(by_policy),
                                x.element_size())[0]
        log(f"  gru_sequence_fwd_chunked {tag}: kernel {ms:.4f} ms, "
            f"{len(per_policy)} gru_sequence_fwd over the same rows "
            f"{loop_ms:.4f} ms, plain {plain_ms:.3f} ms, no library call "
            f"(cuDNN's GRU takes one weight a call), bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      library_ms=None, path=path, per_policy_ms=loop_ms,
                      shape=[T_c, chunks, chunk, 3 * H], policies=P_c, **b)
        if wide:
            label = "learn" if role == "learn" else "collect"
            _wide_record(results, "gru_sequence_fwd_chunked", H, dname,
                         label, **record)
            a1 = per_policy[0]
            _, single_path = _routed(GRU_FWD, fwd_uses_tensor_cores(dtype, H),
                                     gru_sequence_fwd, *a1)
            _wide_single(results, "gru_sequence_fwd", H, dname, label,
                         lambda: (gru_sequence_fwd(*a1),),
                         lambda: (gru_sequence_reference(*a1),), tol,
                         _gru_bounds(T_c, a1[0].shape[1], H,
                                     x.element_size())[0],
                         path=single_path)
        elif role == "collect":
            res.update(record)     # 33 of the 37 launches an update
        elif role == "float16":
            res["float16"] = record
        else:
            res["learn_shape"] = record


def check_gru_bwd_chunked(results, H):
    """gru_sequence_bwd_chunked at width H (256, and the two-block-cluster
    instances at 384 and 512, under the record's ``wide``) at
    headline_pbt_gru's learn step (8 train policies, one chunk of a
    minibatch's 1280 sequences each, T = 16, bf16 on tensor cores as
    ``bwd_uses_tensor_cores`` says at every width) and at chunks of 37 rows in a shuffled
    order with a policy owning two chunks and one owning none, in bf16 and
    f32 (CUDA cores): the forward's T = 1 steps bitwise steps of its
    sequence; against its plain twin's autograd; every chunk's dx_proj /
    dh0 bitwise ``gru_sequence_bwd``'s on that chunk's rows with its
    policy's weights, and each policy's dwh / dbh within the backward's
    tolerance of that kernel's (summed over its chunks), bitwise it for a
    policy of one chunk on CUDA cores; bitwise over two calls and, for a
    policy of one chunk, bitwise the call over that chunk alone; a chunk
    of index P or -1 NaN and adding to no policy; the time against the
    per-policy loop's gru_sequence_bwd launches over the same rows, and
    its bound. Its float16 instance (on tensor cores at every width) at
    the learn step the same way, with the NaN chunks, its times and bound
    into ``float16``. At 384 and 512 also, in both dtypes,
    ``gru_sequence_bwd`` and ``gru_sequence_fwd`` on one chunk's rows:
    against the twins, timed, the backward's recurrence and weight-gradient
    passes timed apart, its weight gradients bitwise over two calls and
    its rows and the forward's bitwise N-independent, the forward's T = 1
    steps bitwise steps of its sequence (``_tc_bwd_checks``,
    ``_tc_fwd_checks``). At every width, in bf16 and float16 on the
    learn step's rows, the backward's recomputed h_in . Wh bitwise the
    forward's h . Wh (``_gru_product_witness``)."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        GRU_BWD, GRU_BWD_CHUNKED, bwd_uses_tensor_cores, gru_sequence_bwd,
        gru_sequence_bwd_chunked, gru_sequence_chunked_reference,
        gru_sequence_fwd, gru_sequence_fwd_chunked, gru_sequence_reference)

    T, P = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS, PBT_TRAIN
    wide = H != CHANNELS
    gen = torch.Generator(device="cuda").manual_seed(25 + wide * H)
    res = results.setdefault("gru_sequence_bwd_chunked", {"max_abs_err": 0.0})
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    main_route = ("tensor_core" if bwd_uses_tensor_cores(bf16, H)
                  else "cuda_core")
    shuffled = [2, 0, 3, 2, 1, 0]      # policy 4 of 5 owns no chunk
    # main_path: True for the bf16 learn step, "float16" for its float16
    # instance (timed into res["float16"]), False for the ragged checks.
    for dtype, T_c, C, order, main_path in (
            (bf16, T, PBT_MINIBATCH, list(range(P)), True),
            (f16, T, PBT_MINIBATCH, list(range(P)), "float16"),
            (bf16, 5, 37, shuffled, False), (f32, 5, 37, shuffled, False)):
        P_c = P if main_path else 5
        B = len(order)
        dname = str(dtype).split(".")[-1]
        args = list(_chunked_gru_inputs(gen, T_c, B, C, H, P_c, dtype))
        args[4] = torch.tensor(order, dtype=torch.int32, device="cuda")
        x, keep, wh, bias_h, idx, h0 = args
        ys = gru_sequence_fwd_chunked(*args)
        _step_checks(f"gru_sequence_fwd_chunked [{T_c}, {B} x {C}, {3 * H}] "
                     f"P={P_c} {dname} chunks {order}",
                     gru_sequence_fwd_chunked, x, keep, wh, bias_h, idx,
                     (h0,), (ys,), (ys,))
        probe = torch.randn(T_c, B * C, H, device="cuda",
                            generator=gen).to(dtype)
        got, path = _routed(GRU_BWD_CHUNKED, bwd_uses_tensor_cores(dtype, H),
                            gru_sequence_bwd_chunked, *args, ys, probe)
        tag = (f"[{T_c}, {B} x {C}, {3 * H}] P={P_c} {dname} chunks "
               f"{order} ({path})")
        if main_path and path != main_route:
            raise AssertionError(f"gru_sequence_bwd_chunked {tag}: the main "
                                 f"path took the {path} route")
        leaves = [a.detach().clone().requires_grad_(i in (0, 2, 3, 5))
                  for i, a in enumerate(args)]
        diff = [leaves[i] for i in (0, 2, 3, 5)]

        def plain_bwd():
            out = gru_sequence_chunked_reference(*leaves)
            return torch.autograd.grad(
                (out.float() * probe.float()).sum(), diff)

        tol = TOL[("gru_bwd", dname)]
        err = 0.0
        for name, g, w in zip(("dxp", "dwh", "dbh", "dh0"), got,
                              plain_bwd()):
            err = max(err, compare(f"gru_sequence_bwd_chunked {name} {tag}",
                                   g, w, **tol))
        dxp, dwh, dbh, dh0 = got
        # Row for row, the single-policy backward on each chunk's rows; on
        # CUDA cores a policy of one chunk's dwh / dbh bitwise too.
        sums = {}
        for b, p in enumerate(order):
            rows = slice(b * C, (b + 1) * C)
            one = gru_sequence_bwd(
                *(t[:, rows].contiguous() for t in (x, keep)), wh[p],
                bias_h[p], h0[rows],
                *(t[:, rows].contiguous() for t in (ys, probe)))
            if not (torch.equal(one[0], dxp[:, rows])
                    and torch.equal(one[3], dh0[rows])):
                raise AssertionError(f"gru_sequence_bwd_chunked {tag}: chunk "
                                     f"{b}'s rows differ from "
                                     f"gru_sequence_bwd's")
            if (path == "cuda_core" and order.count(p) == 1
                    and not (torch.equal(one[1], dwh[p])
                             and torch.equal(one[2], dbh[p]))):
                raise AssertionError(f"gru_sequence_bwd_chunked {tag}: "
                                     f"policy {p}'s dwh / dbh differ from "
                                     f"gru_sequence_bwd's")
            dw1, db1 = sums.get(p, (0.0, 0.0))
            sums[p] = (dw1 + one[1].float(), db1 + one[2].float())
        log(f"  gru_sequence_bwd_chunked {tag}: every chunk's dxp / dh0 "
            f"bitwise gru_sequence_bwd's on its rows ({B} calls) ok")
        for p in range(P_c):
            want_w, want_b = sums.get(p, (torch.zeros_like(dwh[p]),
                                          torch.zeros_like(dbh[p])))
            compare(f"gru_sequence_bwd_chunked dwh[{p}] {tag} vs "
                    f"gru_sequence_bwd", dwh[p], want_w, **tol)
            compare(f"gru_sequence_bwd_chunked dbh[{p}] {tag} vs "
                    f"gru_sequence_bwd", dbh[p], want_b, **tol)
            if p not in sums and (dwh[p].any() or dbh[p].any()):
                raise AssertionError(f"gru_sequence_bwd_chunked {tag}: "
                                     f"policy {p} owns no chunk and got a "
                                     f"gradient")
        again = gru_sequence_bwd_chunked(*args, ys, probe)
        for i, name in enumerate(("dxp", "dwh", "dbh", "dh0")):
            bitwise(f"gru_sequence_bwd_chunked {tag} {name} over two calls",
                    again[i], got[i])
        # A policy of one chunk: its chunk alone gives the same dwh / dbh.
        alone = [p for p in set(order) if order.count(p) == 1]
        for p in sorted(alone):
            b = order.index(p)
            rows = slice(b * C, (b + 1) * C)
            one = gru_sequence_bwd_chunked(
                *(t[:, rows].contiguous() for t in (x, keep)), wh, bias_h,
                idx[b:b + 1].contiguous(), h0[rows],
                *(t[:, rows].contiguous() for t in (ys, probe)))
            if not (torch.equal(one[1][p], dwh[p])
                    and torch.equal(one[2][p], dbh[p])):
                raise AssertionError(f"gru_sequence_bwd_chunked {tag}: "
                                     f"policy {p}'s dwh / dbh differ from "
                                     f"its chunk's alone")
        log(f"  gru_sequence_bwd_chunked {tag}: dwh / dbh of policies "
            f"{sorted(alone)} bitwise their chunk's alone ok")
        if main_path is not True:
            bad = idx.clone()
            bad[1], bad[3] = P_c, -1
            yb = gru_sequence_fwd_chunked(x, keep, wh, bias_h, bad, h0)
            gb = gru_sequence_bwd_chunked(x, keep, wh, bias_h, bad, h0, yb,
                                          probe)
            rows = _skipped_rows(B, C)
            if not (bool(gb[0][:, rows].isnan().all())
                    and bool(gb[3][rows].isnan().all())
                    and torch.equal(gb[0][:, ~rows], dxp[:, ~rows])
                    and torch.equal(gb[3][~rows], dh0[~rows])
                    and bool(torch.isfinite(gb[1]).all())
                    and bool(torch.isfinite(gb[2]).all())):
                raise AssertionError(f"gru_sequence_bwd_chunked {tag}: a "
                                     f"chunk of index P or -1 was not "
                                     f"skipped alone")
            log(f"  gru_sequence_bwd_chunked {tag}: chunks of index P and "
                f"-1 NaN and in no policy's dwh / dbh, the others unchanged "
                f"ok")
            if not main_path:
                if wide:
                    _wide_record(results, "gru_sequence_bwd_chunked", H,
                                 dname, "ragged", max_abs_err=err, shape=tag)
                continue
        per_policy = [((x[:, b * C:(b + 1) * C].contiguous(),
                        keep[:, b * C:(b + 1) * C].contiguous(), wh[p],
                        bias_h[p], h0[b * C:(b + 1) * C])
                       + tuple(t[:, b * C:(b + 1) * C].contiguous()
                               for t in (ys, probe)))
                      for b, p in enumerate(order)]
        _gru_product_witness(f"gru_sequence_bwd H={H} [{T_c}, {B * C}] "
                             f"{dname}, policy 0's weights",
                             (x, keep, wh[0], bias_h[0], h0), probe)
        same = all(torch.equal(gru_sequence_bwd(*a)[1], dwh[p])
                   and torch.equal(gru_sequence_bwd(*a)[2], dbh[p])
                   for a, p in zip(per_policy, order))
        log(f"  gru_sequence_bwd_chunked {tag}: dwh / dbh bitwise "
            f"gru_sequence_bwd's a policy (64 divides C: the same boxes "
            f"and splits): {'yes' if same else 'no'}")
        if not same:
            raise AssertionError(f"gru_sequence_bwd_chunked {tag}: 64 "
                                 f"divides C, and a policy's dwh / dbh "
                                 f"are not the single-policy pass's")
        ms = time_ms(lambda: gru_sequence_bwd_chunked(*args, ys, probe))
        loop_ms = time_ms(lambda: [gru_sequence_bwd(*a)
                                   for a in per_policy])
        plain_ms = time_ms(plain_bwd, reps=3, warmup=1)
        b = _chunked_gru_bounds(T_c, B, C, H, P_c, x.element_size())[1]
        log(f"  gru_sequence_bwd_chunked {tag}: kernel {ms:.4f} ms, {B} "
            f"gru_sequence_bwd over the same rows {loop_ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, no library call (cuDNN's GRU takes one "
            f"weight a call and no keep mask), bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
        record = dict(max_abs_err=err, path=path, ms=ms, plain_ms=plain_ms,
                      library_ms=None, per_policy_ms=loop_ms, chunk=C,
                      chunks=B, policies=P_c, dwh_bitwise_single=same, **b)
        if not wide:
            if main_path is True:
                res.update(record)
            else:
                res["float16"] = record
            continue
        _wide_record(results, "gru_sequence_bwd_chunked", H, dname, "learn",
                     shape=tag, **record)
        a1 = per_policy[0]
        one_leaves = [t.detach().clone().requires_grad_()
                      for t in (a1[0], *a1[2:5])]

        def plain_one():
            out = gru_sequence_reference(one_leaves[0], a1[1],
                                         *one_leaves[1:])
            return torch.autograd.grad(
                (out.float() * a1[6].float()).sum(), one_leaves)

        got1, single = _routed(GRU_BWD, bwd_uses_tensor_cores(dtype, H),
                               gru_sequence_bwd, *a1)
        _wide_single(results, "gru_sequence_bwd", H, dname, "learn",
                     lambda: gru_sequence_bwd(*a1), plain_one, tol,
                     _gru_bounds(T_c, C, H, x.element_size())[1],
                     path=single)
        name1 = f"gru bwd H={H} [{T_c},{C}] {dname} ({single})"
        _tc_bwd_checks(name1, gru_sequence_bwd, a1[:5], (a1[5],), a1[6],
                       got1, row_args={0: 1, 1: 1, 4: 0},
                       row_outs={0: 1, 3: 0}, weight_outs=(1, 2))
        _tc_fwd_checks(f"gru fwd H={H} [{T_c},{C}] {dname}",
                       lambda *a: (gru_sequence_fwd(*a),), a1[:5],
                       (gru_sequence_fwd(*a1[:5]),), {4: 0})
        _gru_tc_timing(results["gru_sequence_bwd"]["wide"][str(H)][dname]
                       ["learn"], a1[:5], a1[5], a1[6])


def _chunked_step_inputs(gen, B, C, F, H, layers, P, dtype):
    """fused_policy_step_chunked operands: ``_step_inputs``' draws as
    [P, ...] stacks (the LayerNorm affines f32), chunk_policy [B] (in
    [0, P), every policy present), x, c and h over the B * C rows."""
    import torch

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dt)

    mlp, fin = [], F
    for _ in range(layers):
        mlp.append((rnd(P, fin, H, scale=(2 / fin) ** 0.5),
                    1 + rnd(P, H, scale=0.1, dt=torch.float32),
                    rnd(P, H, scale=0.1, dt=torch.float32)))
        fin = H
    idx = torch.randint(0, P, (B,), device="cuda", generator=gen,
                        dtype=torch.int32)
    idx[:P] = torch.arange(P, device="cuda", dtype=torch.int32)
    N = B * C
    return (rnd(N, F), mlp, rnd(P, H, 4 * H, scale=H ** -0.5),
            rnd(P, H, 4 * H, scale=H ** -0.5), rnd(P, 4 * H, scale=0.1), idx,
            rnd(N, H, scale=0.5), rnd(N, H, scale=0.5))


def _chunked_step_bound(N, F, H, layers, policies_used, B, itemsize):
    """``_step_bound`` over N rows with the weights of the policies in use
    read and the chunk indices read."""
    weights = F * H + (layers - 1) * H * H + 8 * H * H + 4 * H
    nbytes = (itemsize * (N * F + policies_used * weights + 5 * N * H)
              + policies_used * 8 * H * layers + 4 * B)
    product = 2 * N * (F * H + (layers - 1) * H * H + 8 * H * H)
    return bound(nbytes, {"bf16_tensor": product,
                          "f32": 10 * N * H * layers + 30 * N * H})


def _one_policy(mlp, p):
    """Policy p's (W, ln_scale, ln_bias) layers of the stacks."""
    return [tuple(t[p] for t in layer) for layer in mlp]


def check_policy_step_chunked(results, H):
    """fused_policy_step_chunked at width H (the model's 256, and the
    two-block-cluster instances at 384 and 512, whose numbers go under the
    record's ``wide``) at headline_pbt_fused's collect step (the chunk size
    and count init_training derives for headline_pbt, 12 policies, F = 2:
    layer 0's W a [12, 2, H] stack, whose rows past F must arrive as zeros
    for every policy), bf16 on tensor cores, and at chunks of 37 rows (no
    multiple of the 32-row tile) in a shuffled order in bf16 (at 256 also
    at H = 128; at 384 and 512 also at F = 128, one layer) and in f32
    (CUDA cores): against its plain twin; row for row bitwise
    ``fused_policy_step`` with the row's policy's weights (each policy's
    rows in one call); bitwise over two calls and for the first chunk
    alone; chunks of index P and -1 NaN, the others unchanged; its time
    against one ``fused_policy_step`` a policy over the same rows (the
    per-policy loop's launches) and its bound. At 384 and 512 also
    ``fused_policy_step`` on one policy's rows of each case against its
    twin, rows 0-255 of the collect step's bitwise the step at N = 256,
    and the collect step's timed."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.policy_step import (
        POLICY_STEP, POLICY_STEP_CHUNKED, fused_policy_step,
        fused_policy_step_chunked, fused_policy_step_chunked_reference,
        fused_policy_step_reference, uses_tensor_cores)

    P, C, B = _pbt_chunk_geometry()
    F, layers = 2, 2
    wide = H != CHANNELS
    log(f"fused_policy_step_chunked at headline_pbt_fused's collect step: "
        f"{P} policies, {B} chunks of C = {C} rows, F = {F}, MLP {layers} x "
        f"{H}, LSTM {H}")
    gen = torch.Generator(device="cuda").manual_seed(26 + wide * H)
    res = results.setdefault("fused_policy_step_chunked",
                             {"max_abs_err": 0.0})
    bf16, f32 = torch.bfloat16, torch.float32
    shuffled = [2, 0, 3, 2, 1, 0]      # policy 4 of 5 owns no chunk
    # (chunks, C, P, F, H, layers, dtype, on the main path).
    cases = [(B, C, P, F, H, layers, bf16, True),
             (len(shuffled), 37, 5, F, H, layers, bf16, False),
             (len(shuffled), 37, 5, F, H, layers, f32, False)]
    cases.insert(2, (len(shuffled), 37, 5, 128, H, 1, bf16, False) if wide
                 else (len(shuffled), 37, 5, 3, 128, 1, bf16, False))
    for chunks, chunk, P_c, F_c, H_c, layers_c, dtype, main_path in cases:
        dname = str(dtype).split(".")[-1]
        args = list(_chunked_step_inputs(gen, chunks, chunk, F_c, H_c,
                                         layers_c, P_c, dtype))
        if not main_path:
            args[5] = torch.tensor(shuffled, dtype=torch.int32,
                                   device="cuda")
        x, mlp, wi, wr, bias, idx, c, h = args
        (feats, (c1, h1)), path = _routed(
            POLICY_STEP_CHUNKED, uses_tensor_cores(dtype, H_c, F_c),
            fused_policy_step_chunked, *args)
        tag = (f"[{chunks} x {chunk}, {F_c}->{H_c}x{layers_c}, LSTM {H_c}] "
               f"P={P_c} {dname} ({path})")
        if main_path and path != "tensor_core":
            raise AssertionError(f"fused_policy_step_chunked {tag}: the main "
                                 f"path took the {path} route")
        want = fused_policy_step_chunked_reference(*args)
        err = 0.0
        for name, g, w in (("feats", feats, want[0]), ("c'", c1, want[1][0]),
                           ("h'", h1, want[1][1])):
            err = max(err, compare(f"fused_policy_step_chunked {name} {tag}",
                                   g, w, **TOL[("step", dname)]))
        by_policy = _policy_rows(idx, chunk, P_c)
        for p, rows in by_policy:
            f1, (c_1, h_1) = fused_policy_step(
                x[rows].contiguous(), _one_policy(mlp, p), wi[p], wr[p],
                bias[p], c[rows], h[rows])
            if not (torch.equal(f1, feats[rows]) and torch.equal(c_1, c1[rows])
                    and torch.equal(h_1, h1[rows])):
                raise AssertionError(f"fused_policy_step_chunked {tag}: "
                                     f"policy {p}'s rows differ from "
                                     f"fused_policy_step's")
        log(f"  fused_policy_step_chunked {tag}: every row bitwise "
            f"fused_policy_step's with its policy's weights "
            f"({len(by_policy)} calls) ok")
        again = fused_policy_step_chunked(*args)
        bitwise(f"fused_policy_step_chunked {tag} over two calls",
                torch.stack([again[0], *again[1]]),
                torch.stack([feats, c1, h1]))
        alone = fused_policy_step_chunked(
            x[:chunk].contiguous(), mlp, wi, wr, bias, idx[:1].contiguous(),
            c[:chunk], h[:chunk])
        bitwise(f"fused_policy_step_chunked {tag} the first chunk alone",
                torch.stack([alone[0], *alone[1]]),
                torch.stack([feats[:chunk], c1[:chunk], h1[:chunk]]))
        per_policy = [(x[rows].contiguous(), _one_policy(mlp, p), wi[p],
                       wr[p], bias[p], c[rows], h[rows])
                      for p, rows in by_policy]
        if wide:
            # The single-policy kernel on one policy's rows, against its
            # twin (its rows are the chunked kernel's, checked above).
            a1 = per_policy[0]
            one, single_path = _routed(
                POLICY_STEP, uses_tensor_cores(dtype, H_c, F_c),
                fused_policy_step, *a1)
            ref = fused_policy_step_reference(*a1)
            single_err = max(
                compare(f"fused_policy_step H={H_c} {dname} {name} on "
                        f"policy 0's {a1[0].shape[0]} rows", g, w,
                        **TOL[("step", dname)])
                for name, g, w in (("feats", one[0], ref[0]),
                                   ("c'", one[1][0], ref[1][0]),
                                   ("h'", one[1][1], ref[1][1])))
        if not main_path:
            bad = idx.clone()
            bad[1], bad[3] = P_c, -1
            out = fused_policy_step_chunked(x, mlp, wi, wr, bias, bad, c, h)
            rows = _skipped_rows(chunks, chunk)
            got = torch.stack([out[0], *out[1]])
            ref = torch.stack([feats, c1, h1])
            if not (bool(got[:, rows].isnan().all())
                    and torch.equal(got[:, ~rows], ref[:, ~rows])):
                raise AssertionError(f"fused_policy_step_chunked {tag}: a "
                                     f"chunk of index P or -1 was not "
                                     f"skipped alone")
            log(f"  fused_policy_step_chunked {tag}: chunks of index P and "
                f"-1 NaN, the others unchanged ok")
            if wide:
                for name in ("fused_policy_step_chunked",
                             "fused_policy_step"):
                    _wide_record(results, name, H_c, dname,
                                 f"ragged F={F_c}", shape=tag,
                                 max_abs_err=(err if name.endswith("chunked")
                                              else single_err))
            continue
        ms = time_ms(lambda: fused_policy_step_chunked(*args))
        loop_ms = time_ms(lambda: [fused_policy_step(*a) for a in per_policy])
        plain_ms = time_ms(lambda: fused_policy_step_chunked_reference(*args),
                           reps=3, warmup=1)
        b = _chunked_step_bound(chunks * chunk, F_c, H_c, layers_c,
                                len(by_policy), chunks, x.element_size())
        log(f"  fused_policy_step_chunked {tag}: kernel {ms:.4f} ms, "
            f"{len(per_policy)} fused_policy_step over the same rows "
            f"{loop_ms:.4f} ms, plain {plain_ms:.3f} ms, no library call "
            f"(no single PyTorch call computes the trunk), bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=None, path=path, per_policy_ms=loop_ms,
                   chunk=chunk, chunks=chunks, policies=P_c, **b)
        if not wide:
            res.update(rec)
            continue
        _wide_record(results, "fused_policy_step_chunked", H_c, dname,
                     "collect", shape=tag, **rec)
        # The single-policy kernel at the collect step's per-policy shape:
        # batch invariance (its first 256 rows alone), its time and bound.
        sub = fused_policy_step(a1[0][:256].contiguous(), *a1[1:5],
                                a1[5][:256].contiguous(),
                                a1[6][:256].contiguous())
        bitwise(f"fused_policy_step H={H_c} {dname} rows 0-255 against the "
                f"step at N = 256", torch.stack([sub[0], *sub[1]]),
                torch.stack([one[0][:256], one[1][0][:256],
                             one[1][1][:256]]))
        n1 = a1[0].shape[0]
        s_ms = time_ms(lambda: fused_policy_step(*a1))
        s_plain = time_ms(lambda: fused_policy_step_reference(*a1), reps=3,
                          warmup=1)
        s_b = _step_bound(n1, F_c, H_c, layers_c, x.element_size())
        log(f"  fused_policy_step H={H_c} {dname} at the collect step's "
            f"policy 0 rows [{n1}, {F_c}->{H_c}x{layers_c}] ({single_path}):"
            f" kernel {s_ms:.4f} ms, plain {s_plain:.3f} ms, bound "
            f"{s_b['bound_ms']:.4f} ms ({s_b['bound_by']}), no library call")
        _wide_record(results, "fused_policy_step", H_c, dname, "collect",
                     max_abs_err=single_err, ms=s_ms, plain_ms=s_plain,
                     library_ms=None, path=single_path, rows=n1, **s_b)


def _chunked_proj_bounds(T, B, C, F, H, policies_used, itemsize):
    """``_proj_bounds`` over the B * C rows with the weights of the
    policies in use (read, and backward their dWi / dWr / db written) and
    the chunk indices read: (forward, backward)."""
    N = B * C
    seq, state, rows = T * N * H, N * H, T * N
    weights = policies_used * (F * 4 * H + 4 * H * H + 4 * H)
    fwd_bytes = (itemsize * (rows * F + rows + weights + 2 * state + 2 * seq)
                 + 4 * B)
    bwd_bytes = (itemsize * (rows * F + rows + weights + 2 * state + 3 * seq
                             + rows * F + weights + 2 * state) + 4 * B)
    products = 2 * rows * 4 * H * (F + H)
    return (bound(fwd_bytes, {"bf16_tensor": products, "f32": 30 * seq}),
            bound(bwd_bytes, {"bf16_tensor": 3 * products, "f32": 40 * seq}))


def check_lstm_proj_chunked(results, H):
    """lstm_sequence_proj_fwd_chunked and lstm_sequence_proj_bwd_chunked at
    width H (the model's 256, and the two-block-cluster instances at 384
    and 512, whose numbers go under the record's ``wide``) at
    headline_pbt_fused's learn step (8 train policies, one chunk of a
    minibatch's 1280 sequences each, T = 16, F = H -> 4H, bf16 on tensor
    cores) and at chunks of 37 rows in a shuffled order with a policy
    owning two chunks and one owning none, in bf16 and f32 (CUDA cores; at
    384 and 512 also at F = 4H, the largest x tile, and in bf16 at F =
    128, where one block of a cluster owns no dx feature): against their
    plain twins (the backward against its twin's
    autograd); every row's ys / cs bitwise ``lstm_sequence_proj_fwd``'s
    with its policy's weights, every chunk's dx / dh0 / dc0 bitwise
    ``lstm_sequence_proj_bwd``'s on its rows, each policy's dwi / dwr / db
    within the backward's tolerance of that kernel's (summed over its
    chunks) and, at C = 1280 (64 divides it), bitwise it; bitwise over two
    calls and, for a policy of one chunk, its dwi / dwr / db bitwise its
    chunk alone; chunks of index P and -1 NaN and in no policy's
    gradients; the times against one single-policy launch a policy over
    the same rows, and the bounds. At 384 and 512 also the single-policy
    kernels on one policy's rows of each case against their twins, and at
    the learn step's (bf16): the weight gradients bitwise over two calls,
    rows 0-255 bitwise the kernels' at N = 256, the batch rolled, the
    forward's T = 1 steps, the products' witness
    (``_lstm_proj_witness``) and their times."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        LSTM_PROJ_BWD_CHUNKED, LSTM_PROJ_FWD_CHUNKED,
        lstm_sequence_proj_bwd, lstm_sequence_proj_bwd_chunked,
        lstm_sequence_proj_chunked_reference, lstm_sequence_proj_fwd,
        lstm_sequence_proj_fwd_chunked,
        lstm_sequence_proj_fwd_chunked_reference, uses_tensor_cores)

    T, P = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS, PBT_TRAIN
    wide = H != CHANNELS
    log(f"lstm_sequence_proj_*_chunked at headline_pbt_fused's learn step: "
        f"{P} train policies, one chunk of a minibatch's C = {PBT_MINIBATCH} "
        f"sequences each, T = {T}, F = {H} -> {4 * H}")
    gen = torch.Generator(device="cuda").manual_seed(27 + wide * H)
    fwd = results.setdefault("lstm_sequence_proj_fwd_chunked",
                             {"max_abs_err": 0.0})
    bwd = results.setdefault("lstm_sequence_proj_bwd_chunked",
                             {"max_abs_err": 0.0})
    bf16, f32 = torch.bfloat16, torch.float32
    shuffled = [2, 0, 3, 2, 1, 0]      # policy 4 of 5 owns no chunk
    cases = [(bf16, T, PBT_MINIBATCH, H, H, list(range(P)), True),
             (bf16, 5, 37, H, H, shuffled, False),
             (bf16, 4, 37, 256, 128, shuffled, False),
             (f32, 5, 37, H, H, shuffled, False)]
    if wide:
        cases[2:3] = [(bf16, 3, 37, 4 * H, H, shuffled, False),
                      (bf16, 3, 37, 128, H, shuffled, False),
                      (f32, 2, 37, 4 * H, H, shuffled, False)]
    for dtype, T_c, C, F, H_c, order, main_path in cases:
        P_c = P if main_path else 5
        B = len(order)
        dname = str(dtype).split(".")[-1]

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, device="cuda", generator=gen)
                    * scale).to(dtype)

        N = B * C
        args = [rnd(T_c, N, F),
                (torch.rand(T_c, N, device="cuda", generator=gen) > 0.2)
                .to(dtype),
                rnd(P_c, F, 4 * H_c, scale=F ** -0.5),
                rnd(P_c, H_c, 4 * H_c, scale=H_c ** -0.5),
                rnd(P_c, 4 * H_c),
                torch.tensor(order, dtype=torch.int32, device="cuda"),
                rnd(N, H_c), rnd(N, H_c)]
        x, keep, wi, wr, bias, idx, c0, h0 = args
        probe = rnd(T_c, N, H_c)
        (ys, cs), fpath = _routed(
            LSTM_PROJ_FWD_CHUNKED, uses_tensor_cores(dtype, H_c),
            lstm_sequence_proj_fwd_chunked, *args)
        got, path = _routed(
            LSTM_PROJ_BWD_CHUNKED, uses_tensor_cores(dtype, H_c),
            lstm_sequence_proj_bwd_chunked, *args, ys, cs, probe)
        tag = (f"[{T_c}, {B} x {C}, {F}->{4 * H_c}] P={P_c} {dname} chunks "
               f"{order if not main_path else 'arange'} ({path})")
        if main_path and not fpath == path == "tensor_core":
            raise AssertionError(f"lstm_sequence_proj_*_chunked {tag}: the "
                                 f"main path took the {fpath} / {path} "
                                 f"routes")
        want = lstm_sequence_proj_fwd_chunked_reference(*args)
        tol = TOL[("fwd", dname)]
        f_err = max(compare(f"lstm_sequence_proj_fwd_chunked {tag} ys", ys,
                            want[0], **tol),
                    compare(f"lstm_sequence_proj_fwd_chunked {tag} cs", cs,
                            want[1], **tol))
        leaves = [a.detach().clone().requires_grad_(i in (0, 2, 3, 4, 6, 7))
                  for i, a in enumerate(args)]
        diff = [leaves[i] for i in (0, 2, 3, 4, 6, 7)]

        def plain_bwd():
            out = lstm_sequence_proj_chunked_reference(*leaves)
            return torch.autograd.grad(
                (out.float() * probe.float()).sum(), diff)

        tol = TOL[("bwd", dname)]
        b_err = 0.0
        for name, g, w in zip(("dx", "dwi", "dwr", "db", "dc0", "dh0"), got,
                              plain_bwd()):
            b_err = max(b_err, compare(
                f"lstm_sequence_proj_bwd_chunked {name} {tag}", g, w, **tol))
        dx, dwi, dwr, db, dc0, dh0 = got
        # Row for row, the single-policy kernels on each chunk's rows.
        sums, singles = {}, {}
        for b, p in enumerate(order):
            rows = slice(b * C, (b + 1) * C)
            sub = (x[:, rows].contiguous(), keep[:, rows].contiguous(),
                   wi[p], wr[p], bias[p], c0[rows], h0[rows])
            y1, c_1 = lstm_sequence_proj_fwd(*sub)
            one = lstm_sequence_proj_bwd(
                *sub, *(t[:, rows].contiguous() for t in (ys, cs, probe)))
            if not (torch.equal(y1, ys[:, rows]) and torch.equal(c_1, cs[:, rows])
                    and torch.equal(one[0], dx[:, rows])
                    and torch.equal(one[4], dc0[rows])
                    and torch.equal(one[5], dh0[rows])):
                raise AssertionError(f"lstm_sequence_proj_*_chunked {tag}: "
                                     f"chunk {b}'s rows differ from the "
                                     f"single-policy kernels'")
            singles[p] = one
            acc = sums.get(p, (0.0, 0.0, 0.0))
            sums[p] = tuple(a + o.float() for a, o in zip(acc, one[1:4]))
        log(f"  lstm_sequence_proj_*_chunked {tag}: every chunk's ys / cs "
            f"and dx / dc0 / dh0 bitwise the single-policy kernels' on its "
            f"rows ({B} calls each) ok")
        for p in range(P_c):
            for name, g in (("dwi", dwi[p]), ("dwr", dwr[p]), ("db", db[p])):
                w = (sums[p][("dwi", "dwr", "db").index(name)] if p in sums
                     else torch.zeros_like(g))
                compare(f"lstm_sequence_proj_bwd_chunked {name}[{p}] {tag} "
                        f"vs lstm_sequence_proj_bwd", g, w, **tol)
                if p not in sums and g.any():
                    raise AssertionError(f"lstm_sequence_proj_bwd_chunked "
                                         f"{tag}: policy {p} owns no chunk "
                                         f"and got a gradient")
        again = lstm_sequence_proj_fwd_chunked(*args)
        bitwise(f"lstm_sequence_proj_fwd_chunked {tag} over two calls",
                torch.stack(again), torch.stack((ys, cs)))
        again = lstm_sequence_proj_bwd_chunked(*args, ys, cs, probe)
        for i, name in enumerate(("dx", "dwi", "dwr", "db", "dc0", "dh0")):
            bitwise(f"lstm_sequence_proj_bwd_chunked {tag} {name} over two "
                    f"calls", again[i], got[i])
        # A policy of one chunk: its chunk alone gives the same gradients.
        alone = sorted(p for p in set(order) if order.count(p) == 1)
        for p in alone:
            b = order.index(p)
            rows = slice(b * C, (b + 1) * C)
            one = lstm_sequence_proj_bwd_chunked(
                *(t[:, rows].contiguous() for t in (x, keep)), wi, wr, bias,
                idx[b:b + 1].contiguous(), c0[rows], h0[rows],
                *(t[:, rows].contiguous() for t in (ys, cs, probe)))
            if not all(torch.equal(one[i][p], got[i][p]) for i in (1, 2, 3)):
                raise AssertionError(f"lstm_sequence_proj_bwd_chunked {tag}: "
                                     f"policy {p}'s weight gradients differ "
                                     f"from its chunk's alone")
        log(f"  lstm_sequence_proj_bwd_chunked {tag}: dwi / dwr / db of "
            f"policies {alone} bitwise their chunk's alone ok")
        label = "learn" if main_path else f"ragged F={F}"
        if wide:
            rows = slice(0, C)
            _lstm_proj_single_wide(
                results, label, (x[:, rows].contiguous(),
                                 keep[:, rows].contiguous(), wi[order[0]],
                                 wr[order[0]], bias[order[0]], c0[rows],
                                 h0[rows]),
                probe[:, rows].contiguous(), main_path)
        if not main_path:
            bad = idx.clone()
            bad[1], bad[3] = P_c, -1
            yb, cb = lstm_sequence_proj_fwd_chunked(x, keep, wi, wr, bias,
                                                    bad, c0, h0)
            gb = lstm_sequence_proj_bwd_chunked(x, keep, wi, wr, bias, bad,
                                                c0, h0, yb, cb, probe)
            rows = _skipped_rows(B, C)
            nan_rows = (bool(yb[:, rows].isnan().all())
                        and bool(cb[:, rows].isnan().all())
                        and bool(gb[0][:, rows].isnan().all())
                        and bool(gb[4][rows].isnan().all())
                        and bool(gb[5][rows].isnan().all()))
            others = (torch.equal(yb[:, ~rows], ys[:, ~rows])
                      and torch.equal(cb[:, ~rows], cs[:, ~rows])
                      and torch.equal(gb[0][:, ~rows], dx[:, ~rows])
                      and torch.equal(gb[4][~rows], dc0[~rows])
                      and torch.equal(gb[5][~rows], dh0[~rows])
                      and all(bool(torch.isfinite(gb[i]).all())
                              for i in (1, 2, 3)))
            if not (nan_rows and others):
                raise AssertionError(f"lstm_sequence_proj_*_chunked {tag}: a "
                                     f"chunk of index P or -1 was not "
                                     f"skipped alone")
            log(f"  lstm_sequence_proj_*_chunked {tag}: chunks of index P "
                f"and -1 NaN and in no policy's dwi / dwr / db, the others "
                f"unchanged ok")
            if wide:
                for name, e in (("lstm_sequence_proj_fwd_chunked", f_err),
                                ("lstm_sequence_proj_bwd_chunked", b_err)):
                    _wide_record(results, name, H_c, dname, label,
                                 max_abs_err=e, shape=tag)
            continue
        same = all(torch.equal(singles[p][i], got[i][p])
                   for p in range(P_c) for i in (1, 2, 3))
        log(f"  lstm_sequence_proj_bwd_chunked {tag}: dwi / dwr / db bitwise "
            f"lstm_sequence_proj_bwd's a policy (64 divides C: the same "
            f"boxes and splits): {'yes' if same else 'no'}")
        if not same:
            raise AssertionError(f"lstm_sequence_proj_bwd_chunked {tag}: 64 "
                                 f"divides C, and a policy's dwi / dwr / db "
                                 f"are not the single-policy pass's")
        per_policy = [(x[:, b * C:(b + 1) * C].contiguous(),
                       keep[:, b * C:(b + 1) * C].contiguous(), wi[p], wr[p],
                       bias[p], c0[b * C:(b + 1) * C], h0[b * C:(b + 1) * C])
                      for b, p in enumerate(order)]
        per_states = [tuple(t[:, b * C:(b + 1) * C].contiguous()
                            for t in (ys, cs, probe)) for b in range(B)]
        f_ms = time_ms(lambda: lstm_sequence_proj_fwd_chunked(*args))
        f_loop = time_ms(lambda: [lstm_sequence_proj_fwd(*a)
                                  for a in per_policy])
        f_plain = time_ms(lambda: lstm_sequence_proj_fwd_chunked_reference(
            *args), reps=3, warmup=1)
        b_ms = time_ms(lambda: lstm_sequence_proj_bwd_chunked(*args, ys, cs,
                                                              probe))
        b_loop = time_ms(lambda: [lstm_sequence_proj_bwd(*a, *s) for a, s in
                                  zip(per_policy, per_states)])
        b_plain = time_ms(plain_bwd, reps=3, warmup=1)
        f_b, b_b = _chunked_proj_bounds(T_c, B, C, F, H_c, P_c,
                                        x.element_size())
        log(f"  lstm_sequence_proj_*_chunked {tag}: fwd kernel {f_ms:.4f} ms, "
            f"{B} lstm_sequence_proj_fwd over the same rows {f_loop:.4f} ms, "
            f"plain {f_plain:.3f} ms, bound {f_b['bound_ms']:.4f} ms "
            f"({f_b['bound_by']}); bwd kernel {b_ms:.4f} ms, {B} "
            f"lstm_sequence_proj_bwd {b_loop:.4f} ms, plain {b_plain:.3f} "
            f"ms, bound {b_b['bound_ms']:.4f} ms ({b_b['bound_by']}); no "
            f"library call (cuDNN's LSTM takes one weight a call and no "
            f"keep mask)")
        common = dict(library_ms=None, path=path, chunk=C, chunks=B,
                      policies=P_c)
        f_rec = dict(max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
                     per_policy_ms=f_loop, **common, **f_b)
        b_rec = dict(max_abs_err=b_err, ms=b_ms, plain_ms=b_plain,
                     per_policy_ms=b_loop, dw_bitwise_single=same, **common,
                     **b_b)
        if not wide:
            fwd.update(f_rec)
            bwd.update(b_rec)
            continue
        _wide_record(results, "lstm_sequence_proj_fwd_chunked", H_c, dname,
                     label, shape=tag, **f_rec)
        _wide_record(results, "lstm_sequence_proj_bwd_chunked", H_c, dname,
                     label, shape=tag, **b_rec)


def _lstm_proj_witness(tag, args, probe):
    """The witness that the tensor-core projection backward differentiates
    the forward that ran: on ``args`` (x, keep, Wi, Wr, bias, c0, h0), the
    forward's round(x . Wi) and round(x . Wi) + h . Wr of every step
    (``_fwd_tc``'s ``wit``) and the backward's recomputed ones (``_bwd_tc``'s,
    from the forward's ys), both f32 [2, T, N, 4H], bitwise equal."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import _bwd_tc, _fwd_tc

    T, N = args[0].shape[:2]
    H = args[3].shape[0]
    fwd_wit, bwd_wit = (torch.full((2, T, N, 4 * H), float("nan"),
                                   device="cuda") for _ in range(2))
    ys, cs = _fwd_tc(*args, wit=fwd_wit)
    _bwd_tc(*args, ys, cs, probe, phases=1, wit=bwd_wit)
    for i, what in enumerate(("round(x . Wi)", "round(x . Wi) + h . Wr")):
        f, b = fwd_wit[i], bwd_wit[i]
        if not (bool(torch.isfinite(f).all()) and torch.equal(f, b)):
            bad = (f != b).sum().item()
            raise AssertionError(f"{tag}: the backward's recomputed {what} "
                                 f"differs from the forward's at {bad} of "
                                 f"{f.numel()} elements")
    log(f"  {tag}: the backward's recomputed round(x . Wi) and round(x . Wi)"
        f" + h . Wr bitwise the forward's at every step "
        f"({2 * fwd_wit[0].numel()} f32) ok")


def _lstm_proj_single_wide(results, label, args, probe, main_path):
    """``lstm_sequence_proj_fwd`` / ``_bwd`` at H = 384 or 512 on one
    policy's rows (``args``, at the chunk-indexed check's ``label`` shape)
    against their twins (the backward against the twin's autograd), into
    results[name]["wide"]. At the learn step (``main_path``, bf16) also
    the tensor-core forward's and backward's bitwise checks
    (``_tc_fwd_checks``, ``_tc_bwd_checks``), the products' witness, and
    their times and bounds."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        LSTM_PROJ_BWD, LSTM_PROJ_FWD, lstm_sequence_proj_bwd,
        lstm_sequence_proj_fwd, lstm_sequence_proj_reference,
        uses_tensor_cores)

    T, N, F = args[0].shape
    H = args[3].shape[0]
    dtype = args[0].dtype
    dname = str(dtype).split(".")[-1]
    tag = f"H={H} {dname} [{T},{N},{F}->{4 * H}]"
    (ys, cs), fpath = _routed(LSTM_PROJ_FWD, uses_tensor_cores(dtype, H),
                              lstm_sequence_proj_fwd, *args)
    f_err = compare(f"lstm_sequence_proj_fwd {tag} ({fpath})", ys,
                    lstm_sequence_proj_reference(*args),
                    **TOL[("fwd", dname)])
    leaves = [a.detach().clone().requires_grad_(i != 1)
              for i, a in enumerate(args)]
    diff = [leaves[i] for i in (0, 2, 3, 4, 5, 6)]

    def plain_bwd():
        out = lstm_sequence_proj_reference(*leaves)
        return torch.autograd.grad((out.float() * probe.float()).sum(), diff)

    got, path = _routed(LSTM_PROJ_BWD, uses_tensor_cores(dtype, H),
                        lstm_sequence_proj_bwd, *args, ys, cs, probe)
    b_err = max(compare(f"lstm_sequence_proj_bwd {name} {tag} ({path})", g,
                        w, **TOL[("bwd", dname)])
                for name, g, w in zip(("dx", "dwi", "dwr", "db", "dc0",
                                       "dh0"), got, plain_bwd()))
    if not main_path:
        _wide_record(results, "lstm_sequence_proj_fwd", H, dname, label,
                     max_abs_err=f_err, path=fpath, shape=tag)
        _wide_record(results, "lstm_sequence_proj_bwd", H, dname, label,
                     max_abs_err=b_err, path=path, shape=tag)
        return
    _tc_fwd_checks("lstm_sequence_proj_fwd " + tag, lstm_sequence_proj_fwd,
                   args, (ys, cs), {5: 1, 6: 0})
    _tc_bwd_checks("lstm_sequence_proj_bwd " + tag, lstm_sequence_proj_bwd,
                   args, (ys, cs), probe, got,
                   row_args={0: 1, 1: 1, 5: 0, 6: 0},
                   row_outs={0: 1, 4: 0, 5: 0}, weight_outs=(1, 2, 3))
    _lstm_proj_witness("lstm_sequence_proj " + tag, args, probe)
    f_b, b_b = _proj_bounds(T, N, F, H, 2)
    for name, run, plain, err, p, b in (
            ("lstm_sequence_proj_fwd",
             lambda: lstm_sequence_proj_fwd(*args),
             lambda: lstm_sequence_proj_reference(*args), f_err, fpath, f_b),
            ("lstm_sequence_proj_bwd",
             lambda: lstm_sequence_proj_bwd(*args, ys, cs, probe),
             plain_bwd, b_err, path, b_b)):
        ms = time_ms(run)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        log(f"  {name} {tag} ({p}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}), no library call (cuDNN cannot clear the "
            f"carry mid-sequence)")
        _wide_record(results, name, H, dname, label, max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, library_ms=None, path=p, shape=tag,
                     **b)


def check_grouped_matmul_pbt(results):
    """grouped_matmul at the batched pass's shapes of headline_pbt's
    collect step (B chunks of C rows, 12 policies, bf16): the MLP's first
    layer (IN = 2, the CUDA-core route), its second (256 -> 256) and the
    LSTM's input projection (256 -> 1024); each against its plain version,
    timed beside ``torch.bmm(x, W[idx])``, with its bound. Then its
    float16 instance at the same shapes (headline_pbt_fp16's collect
    step; on tensor cores at 256 -> 256 and 256 -> 1024, on CUDA cores at
    IN = 2, as ``tc_launches`` must show): against its plain version,
    every policy's rows bitwise one single-policy launch over that
    policy's chunks, indices P and -1 giving NaN rows alone, timed beside
    those 12 launches, its plain version and
    ``torch.bmm``, into ``float16`` (the 256 -> 1024 projection's times,
    and every shape's rows in ``float16["pbt_shapes"]``)."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import (
        GROUPED_MATMUL, grouped_matmul, grouped_matmul_reference,
        uses_tensor_cores)

    P, C, B = _pbt_chunk_geometry()
    gen = torch.Generator(device="cuda").manual_seed(22)
    res = results["grouped_matmul"]
    for dtype in (torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[-1]
        half = dtype == torch.float16
        rows = (res.setdefault("float16", {}) if half
                else res).setdefault("pbt_shapes", [])
        for IN, OUT in ((2, CHANNELS), (CHANNELS, CHANNELS),
                        (CHANNELS, 4 * CHANNELS)):
            x, w, idx = _gmm_inputs(gen, B, C, IN, P, OUT, dtype)
            y, path = _routed(GROUPED_MATMUL, uses_tensor_cores(x, w),
                              grouped_matmul, x, w, idx)
            tag = f"[{B}x{C}, {IN}->{OUT}, P={P}] {dname} ({path})"
            if path != ("cuda_core" if IN % 8 else "tensor_core"):
                raise AssertionError(f"grouped_matmul {tag}: took the {path} "
                                     f"route")
            err = compare(f"grouped_matmul headline_pbt {tag}", y,
                          grouped_matmul_reference(x, w, idx),
                          **TOL[("gmm", dname)])
            idx64 = idx.long()
            ms = time_ms(lambda: grouped_matmul(x, w, idx))
            library_ms = time_ms(lambda: torch.bmm(x, w[idx64]))
            b = _gmm_bound(B, C, IN, int(idx.unique().numel()), OUT,
                           x.element_size())
            row = dict(shape=[B, C, IN, P, OUT], path=path, max_abs_err=err,
                       ms=ms, library_ms=library_ms, **b)
            msg = (f"  grouped_matmul headline_pbt {tag}: kernel {ms:.4f} "
                   f"ms, torch.bmm(x, W[idx]) {library_ms:.4f} ms, bound "
                   f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            if half:
                # One single-policy launch a policy over its chunks.
                one = torch.zeros(1, dtype=torch.int32, device="cuda")
                per_policy = []
                for p in range(P):
                    chunks = torch.nonzero(idx == p).flatten()
                    if chunks.numel():
                        per_policy.append((x[chunks].contiguous(),
                                           w[p:p + 1], chunks))
                ones = [one.expand(xp.shape[0]).contiguous()
                        for xp, _, _ in per_policy]
                for (xp, wp, chunks), o in zip(per_policy, ones):
                    if not torch.equal(grouped_matmul(xp, wp, o),
                                       y[chunks]):
                        raise AssertionError(
                            f"grouped_matmul {tag}: a policy's rows differ "
                            f"from its own launch's")
                _gmm_out_of_range(tag, x, w, idx)
                loop_ms = time_ms(lambda: [
                    grouped_matmul(xp, wp, o)
                    for (xp, wp, _), o in zip(per_policy, ones)])
                plain_ms = time_ms(lambda: grouped_matmul_reference(
                    x, w, idx))
                row.update(per_policy_ms=loop_ms, plain_ms=plain_ms)
                msg += (f"; every policy's rows bitwise its own launch, "
                        f"{len(per_policy)} launches {loop_ms:.4f} ms, "
                        f"plain {plain_ms:.4f} ms")
                if OUT == 4 * CHANNELS:
                    rec = res["float16"]
                    rec.update({k: row[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "library_ms",
                        "per_policy_ms", "bound_ms", "bound_by", "path",
                        "shape")})
                    rec["max_abs_err"] = max(r["max_abs_err"]
                                             for r in rows + [row])
            log(msg)
            rows.append(row)


# The recurrences' widths past the model's: their CUDA-core instances, and
# the bf16 LSTM forward's two-block-cluster tensor-core instance.
WIDE_HIDDEN = (384, 512)


# -- layer_norm's chunk-indexed pair ------------------------------------------

def _ln_chunked_inputs(gen, B, C, D, P, dtype, order=None):
    """x [B * C, D], the f32 [P, D] scale (near 1) and bias stacks,
    chunk_policy [B] (every policy present, or ``order``), dy."""
    import torch

    x = (2 * torch.randn(B * C, D, device="cuda", generator=gen)
         + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn(P, D, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(P, D, device="cuda", generator=gen)
    if order is None:
        idx = torch.randint(0, P, (B,), device="cuda", generator=gen,
                            dtype=torch.int32)
        idx[:P] = torch.arange(P, device="cuda", dtype=torch.int32)
    else:
        idx = torch.tensor(order, device="cuda", dtype=torch.int32)
    dy = torch.randn(B * C, D, device="cuda", generator=gen).to(dtype)
    return x, scale, bias, idx, dy


def _check_layer_norm_chunked_case(results, B, C, D, P, dtype, order=None,
                                   main=None):
    """The pair over B chunks of C rows of P policies: y / mu / rsigma
    against the twin and each policy's rows bitwise one ``layer_norm_fwd``
    call with its weights; dx, dscale and dbias against the twin's
    autograd, dx rows bitwise ``layer_norm_bwd``'s, dscale / dbias bitwise
    over two calls and within the f32 sums' tolerance of the single-policy
    backward's; a chunk of index P and -1 NaN, a policy without a chunk
    zero gradients. ``main`` "fwd" or "bwd": that kernel's times."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
        layer_norm_bwd, layer_norm_bwd_chunked, layer_norm_chunked_reference,
        layer_norm_fwd, layer_norm_fwd_chunked)

    dname = str(dtype).split(".")[-1]
    tag = f"[{B} x {C}, {D}] P={P} {dname}"
    gen = torch.Generator(device="cuda").manual_seed(B + C + D)
    x, scale, bias, idx, dy = _ln_chunked_inputs(gen, B, C, D, P, dtype,
                                                 order)
    live = ((idx >= 0) & (idx < P)).repeat_interleave(C)
    y, mu, rsigma = layer_norm_fwd_chunked(x, scale, bias, idx)
    err_f = compare(f"layer_norm_fwd_chunked {tag}", y[live],
                    layer_norm_chunked_reference(x, scale, bias, idx)[live],
                    **TOL[("ln_fwd", dname)])
    again = layer_norm_fwd_chunked(x, scale, bias, idx)
    for name, a, b_ in zip(("y", "mu", "rsigma"), again, (y, mu, rsigma)):
        bitwise(f"layer_norm_fwd_chunked {tag} {name} over two calls", a, b_)
    by_policy = _policy_rows(idx, C, P)
    for p, rows in by_policy:
        y1, mu1, rs1 = layer_norm_fwd(x[rows], scale[p], bias[p])
        if not (torch.equal(y1, y[rows]) and torch.equal(mu1, mu[rows])
                and torch.equal(rs1, rsigma[rows])):
            raise AssertionError(f"layer_norm_fwd_chunked {tag}: policy "
                                 f"{p}'s rows differ from layer_norm_fwd's")
    log(f"  layer_norm_fwd_chunked {tag}: every row's y, mu and rsigma "
        f"bitwise one layer_norm_fwd call's with its policy's weights ok")
    dx, dscale, dbias = layer_norm_bwd_chunked(x, scale, idx, mu, rsigma, dy)
    leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]

    def plain_bwd():
        out = layer_norm_chunked_reference(*leaves, idx)
        return torch.autograd.grad(
            (out[live].float() * dy[live].float()).sum(), leaves)

    pdx, pds, pdb = plain_bwd()
    err_b = max(compare(f"layer_norm_bwd_chunked {tag} dx", dx[live],
                        pdx[live], **TOL[("ln_bwd", dname)]),
                compare(f"layer_norm_bwd_chunked {tag} dscale", dscale, pds,
                        **TOL["ln_dwdb"]),
                compare(f"layer_norm_bwd_chunked {tag} dbias", dbias, pdb,
                        **TOL["ln_dwdb"]))
    again = layer_norm_bwd_chunked(x, scale, idx, mu, rsigma, dy)
    for name, a, b_ in zip(("dx", "dscale", "dbias"), again,
                           (dx, dscale, dbias)):
        bitwise(f"layer_norm_bwd_chunked {tag} {name} over two calls", a, b_)
    present = {p for p, _ in by_policy}
    for p in set(range(P)) - present:
        if dscale[p].any() or dbias[p].any():
            raise AssertionError(f"layer_norm_bwd_chunked {tag}: policy {p} "
                                 f"owns no chunk but has nonzero gradients")
    for p, rows in by_policy:
        dx1, dw1, db1 = layer_norm_bwd(x[rows], scale[p], mu[rows],
                                       rsigma[rows], dy[rows])
        if not torch.equal(dx1, dx[rows]):
            raise AssertionError(f"layer_norm_bwd_chunked {tag}: policy "
                                 f"{p}'s dx rows differ from "
                                 f"layer_norm_bwd's")
        err_b = max(err_b, compare(
            f"layer_norm_bwd_chunked {tag} policy {p} dscale / dbias "
            f"against layer_norm_bwd", torch.stack([dscale[p], dbias[p]]),
            torch.stack([dw1, db1]), **TOL["ln_dwdb"]))
    log(f"  layer_norm_bwd_chunked {tag}: every row's dx bitwise "
        f"layer_norm_bwd's with its policy's weights ok")
    bad = idx.clone()
    bad[0], bad[-1] = P, -1
    skipped = torch.zeros(B, dtype=torch.bool, device="cuda")
    skipped[0] = skipped[-1] = True
    rows_bad = skipped.repeat_interleave(C)
    yb, mub, rsb = layer_norm_fwd_chunked(x, scale, bias, bad)
    dxb, _, _ = layer_norm_bwd_chunked(x, scale, bad, mu, rsigma, dy)
    if not (bool(yb[rows_bad].isnan().all())
            and bool(mub[rows_bad].isnan().all())
            and bool(dxb[rows_bad].isnan().all())
            and torch.equal(yb[~rows_bad], y[~rows_bad])
            and torch.equal(dxb[~rows_bad], dx[~rows_bad])):
        raise AssertionError(f"layer_norm chunked {tag}: a chunk of index P "
                             f"or -1 was not skipped alone")
    log(f"  layer_norm chunked {tag}: chunks of index P and -1 NaN, the "
        f"others unchanged ok")
    if main is None:
        return
    rec = results.setdefault(f"layer_norm_{main}_chunked", {})
    # _layer_norm_bounds' bytes with the scale and bias of the policies in
    # use (read; dscale / dbias written backward) and the chunk indices.
    elems, item, used = B * C * D, x.element_size(), len(by_policy)
    fwd_b = bound(2 * item * elems + 8 * D * used + 8 * B * C + 4 * B,
                  {"f32": 8 * elems})
    bwd_b = bound(3 * item * elems + 12 * D * used + 8 * B * C + 4 * B,
                  {"f32": 12 * elems})
    per_policy = [(x[rows].contiguous(), scale[p], bias[p], mu[rows],
                   rsigma[rows], dy[rows].contiguous())
                  for p, rows in by_policy]
    # No one call computes LayerNorm with a weight a row: the yardstick is
    # native_layer_norm (and its backward) over the same rows with one
    # policy's weight, the same work but the weights' gather.
    # (PyTorch takes the affine only in x's dtype.)
    w0, b0 = scale[0].to(x.dtype), bias[0].to(x.dtype)
    _, lmu, lrs = torch.ops.aten.native_layer_norm(x, [D], w0, b0, 1e-6)
    if main == "fwd":
        ms = time_ms(lambda: layer_norm_fwd_chunked(x, scale, bias, idx))
        loop_ms = time_ms(lambda: [layer_norm_fwd(a[0], a[1], a[2])
                                   for a in per_policy])
        plain_ms = time_ms(lambda: layer_norm_chunked_reference(
            x, scale, bias, idx))
        lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm(
            x, [D], w0, b0, 1e-6))
        b_ = fwd_b
        rec.update(max_abs_err=err_f, **b_)
    else:
        ms = time_ms(lambda: layer_norm_bwd_chunked(x, scale, idx, mu,
                                                    rsigma, dy))
        loop_ms = time_ms(lambda: [layer_norm_bwd(a[0], a[1], a[3], a[4],
                                                  a[5]) for a in per_policy])
        plain_ms = time_ms(plain_bwd)
        lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [D], lmu, lrs, w0, b0, [True, True, True]))
        b_ = bwd_b
        rec.update(max_abs_err=err_b, **b_)
    rec.update(ms=ms, per_policy_ms=loop_ms, plain_ms=plain_ms,
               library_ms=lib_ms, path="cuda_core", shape=tag)
    log(f"  layer_norm_{main}_chunked {tag}: kernel {ms:.4f} ms, one "
        f"layer_norm_{main} a policy over the same rows {loop_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, native_layer_norm"
        f"{'' if main == 'fwd' else '_backward'} with one policy's weight "
        f"{lib_ms:.4f} ms, bound {b_['bound_ms']:.4f} ms ({b_['bound_by']})")


def check_layer_norm_chunked(results):
    """layer_norm_{fwd,bwd}_chunked at headline_pbt_lnkernel's shapes, bf16
    D = 256: the collect step's rows (75 chunks of 512, 12 policies; the
    forward's times) and a learn minibatch's (8 chunks of 16 x 1280 rows, 8
    policies; the backward's times), and ragged chunks of 37 rows in a
    shuffled order in float32 and bf16 (D = 48 and 100, the backward's
    element-by-element path) (``_check_layer_norm_chunked_case``)."""
    import torch

    P, C, B = _pbt_chunk_geometry()
    bf16, f32 = torch.bfloat16, torch.float32
    log(f"layer_norm_fwd_chunked / _bwd_chunked at headline_pbt_lnkernel's "
        f"shapes and ragged chunks:")
    _check_layer_norm_chunked_case(results, B, C, CHANNELS, P, bf16,
                                   main="fwd")
    _check_layer_norm_chunked_case(results, PBT_TRAIN, 16 * PBT_MINIBATCH,
                                   CHANNELS, PBT_TRAIN, bf16, main="bwd")
    # Policy 2 owns two chunks, 3 none (of P = 4).
    for D, dtype in ((48, f32), (100, bf16)):
        _check_layer_norm_chunked_case(results, 5, 37, D, 4, dtype,
                                       order=[2, 0, 1, 2, 0])


# -- infer_512: multi-policy inference at 512 channels ----------------------

# benchmarks/infer_bench.py's defaults (BASELINE.md:49, "Multi-policy
# inference, 32 policies x 16k agents, 512ch LSTM"): 16384 agents served by
# 32 policies, a fresh random assignment every step, 200 steps, MLP 2 x 512
# over 64 features -> LSTM 1 x 512, a 5-way actor and a dense critic, in
# bf16 (the bench's dtype on the TPU).
INFER_POLICIES, INFER_AGENTS, INFER_STEPS = 32, 16384, 200
INFER_CHANNELS, INFER_FEATURES = 512, 64


def _infer_geometry():
    """infer_bench.py's chunk size, the port's heuristic_policy_chunk_size
    over its agents and policies (256), and chunk count (95)."""
    from madrona_learn_tpu_torch.ops.reorder import \
        heuristic_policy_chunk_size

    C = heuristic_policy_chunk_size(INFER_AGENTS, INFER_POLICIES,
                                    INFER_AGENTS // INFER_POLICIES)
    return C, -(-INFER_AGENTS // C) + INFER_POLICIES - 1


def _infer_actor_critic(seed, channels, dtype):
    """infer_bench.py's model: MLP 2 x channels over the 64 features ->
    LSTM 1 x channels, a 5-way actor and a dense critic."""
    import torch
    from madrona_learn_tpu_torch.config import DiscreteActionsConfig
    from madrona_learn_tpu_torch.models import (
        LSTM, MLP, ActorCritic, BackboneShared, DenseLayerCritic,
        DenseLayerDiscreteActor, DictActor, RecurrentBackboneEncoder)

    gen = torch.Generator().manual_seed(seed)
    return ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs: obs["feat"],
            encoder=RecurrentBackboneEncoder(
                net=MLP(INFER_FEATURES, channels, 2, dtype, generator=gen),
                rnn=LSTM(channels, channels, 1, dtype, generator=gen))),
        actor=DictActor({"move": DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), channels, dtype,
            generator=gen)}),
        critic=DenseLayerCritic(channels, dtype, generator=gen))


def _infer_loop(device, policies, agents, channels, chunk, dtype, seed=0):
    """The bench's loop in the port: the population, and ``step()``, which
    draws a fresh assignment, computes its policy-chunk layout
    (``compute_policy_chunks``), gathers the obs and the recurrent state
    into it, runs ``rollout_chunked`` (sampled actions) and gathers the new
    state and the actions back; it returns the layout and the step's
    chunk-order inputs."""
    import torch
    from madrona_learn_tpu_torch.models.common import StackedParams
    from madrona_learn_tpu_torch.rollouts import compute_policy_chunks

    acs = [_infer_actor_critic(seed + p, channels, dtype).to(device)
           for p in range(policies)]
    params = StackedParams.of(acs)
    cfg = types.SimpleNamespace(
        policy_chunk_size=chunk,
        pbt=types.SimpleNamespace(
            total_num_policies=policies, num_current_policies=policies,
            complex_matchmaking=True, custom_policy_ids=()))
    gen = torch.Generator(device=device).manual_seed(seed)
    obs = {"feat": torch.randn(agents, INFER_FEATURES, device=device,
                               generator=gen).to(dtype)}
    state = {"rnn": acs[0].init_recurrent_state(agents, device)}

    def step():
        assignments = torch.randint(0, policies, (agents,), device=device,
                                    generator=gen, dtype=torch.int32)
        layout = compute_policy_chunks(assignments, cfg)
        rnn_in, obs_in = layout.to_policy(state["rnn"]), layout.to_policy(obs)
        with torch.no_grad():
            out, rnn = acs[0].rollout_chunked(params, layout, gen, rnn_in,
                                              obs_in)
        state["rnn"] = layout.to_sim(rnn)
        state["actions"] = layout.to_sim(out["actions"]["move"])
        return layout, rnn_in, obs_in

    return acs, params, step


def infer_phase(card):
    """infer_512: benchmarks/infer_bench.py's shape in the port (32
    policies x 16384 agents, 512-channel LSTM, bf16, a fresh random
    assignment every step, 200 steps of ``rollout_chunked``): launches
    exact (one ``lstm_sequence_fwd_chunked`` at H = 512 and five
    ``grouped_matmul`` a step, none other; the LSTM's on tensor cores, its
    two-block cluster) and no step on the plain twin;
    then, at one more step, four chunks' critic values and new state
    against each chunk's policy alone (``ActorCritic.rollout``, its LSTM a
    single-policy ``lstm_sequence_fwd`` launch) within the step rule;
    agent-steps/s."""
    import torch
    import madrona_learn_tpu_torch.models.lstm as lstm_model
    from madrona_learn_tpu_torch.utils import tree_map

    C, B = _infer_geometry()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"infer_512: {INFER_POLICIES} policies x {INFER_AGENTS} agents, "
        f"MLP 2 x {INFER_CHANNELS} over {INFER_FEATURES} features -> LSTM "
        f"{INFER_CHANNELS}, bf16, chunks of {C} (heuristic_policy_chunk_size)"
        f", {B} chunks, {INFER_STEPS} steps, a fresh assignment a step")
    acs, params, step = _infer_loop("cuda", INFER_POLICIES, INFER_AGENTS,
                                    INFER_CHANNELS, C, torch.bfloat16)
    plain = [0]
    twin = lstm_model.lstm_step_chunked_reference

    def counted(*args):
        plain[0] += 1
        return twin(*args)

    lstm_model.lstm_step_chunked_reference = counted
    try:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        _zero_launch_counts()
        t0 = time.perf_counter()
        for _ in range(INFER_STEPS):
            step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        lstm_model.lstm_step_chunked_reference = twin
    launches = _check_launches("infer_512",
                               _chunked_step_launches(INFER_STEPS),
                               tensor_cores=_tc_kernels(torch.bfloat16,
                                                        INFER_CHANNELS))
    if plain[0]:
        raise AssertionError(f"infer_512: {plain[0]} steps on the plain twin")
    log(f"  infer_512: 0 steps on the plain twin")
    layout, rnn_in, obs_in = step()
    with torch.no_grad():
        out, rnn = acs[0].rollout_chunked(params, layout, None, rnn_in,
                                          obs_in, sample_actions=False)
        seen = set()
        for b, p in enumerate(layout.chunk_policy.tolist()):
            if p in seen or len(seen) == 4:
                continue
            seen.add(p)
            one, new = acs[p].rollout(
                None, tree_map(lambda s: s[b], rnn_in),
                {"feat": obs_in["feat"][b]}, sample_actions=False)
            tol = TOL[("step", "bfloat16")]
            compare(f"infer_512 chunk {b} (policy {p}) critic against its "
                    f"policy alone", out["critic"][b], one["critic"], **tol)
            compare(f"infer_512 chunk {b} (policy {p}) new h against its "
                    f"policy alone", rnn[1][b], new[1], **tol)
    sps = INFER_STEPS * INFER_AGENTS / seconds
    log(f"  infer_512: {sps:.0f} agent-steps/s ({seconds * 1e3 / INFER_STEPS:.3f} "
        f"ms a step) on {card}")
    return launches, dict(sps=sps, ms_per_step=seconds * 1e3 / INFER_STEPS)


def _population_card_vs_cpu(name, mgr):
    """A trained population's policy-batched passes on the card against the
    CPU, from the same parameters and inputs: one collect step
    (``rollout_chunked`` over 16 chunks of 64 rows of every policy, the
    chunks' policies shuffled; the critic and the new state) and one learn
    pass (``update_batched`` over the train policies' [16, 256]
    minibatches; log-probs and critic values, and the gradients of their
    sum). Outputs within the bf16 step rule (3.2e-2 absolute); gradients
    within 3.2e-2 of their norm (bf16 products rounded in another order,
    through 16 recurrent steps)."""
    import copy
    import torch
    from madrona_learn_tpu_torch.models.common import StackedParams
    from madrona_learn_tpu_torch.ops.reorder import PolicyBatchReorderState
    from madrona_learn_tpu_torch.utils import tree_map

    pop = mgr.state.policy_states
    Pall, P = len(pop), len(mgr.state.train_states)
    ac = pop[0].actor_critic
    ac_cpu = copy.deepcopy(ac).cpu()
    gen = torch.Generator().manual_seed(17)
    dtype = torch.bfloat16
    tol = TOL[("step", "bfloat16")]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    def state(*lead):
        return tree_map(lambda s: 0.5 * rnd(*lead, *s.shape[1:]),
                        ac_cpu.init_recurrent_state(1))

    def leaves(policies, device):
        with torch.no_grad():
            stacked = StackedParams.of([pop[p].actor_critic
                                        for p in policies])
        return {k: v.detach().to(device).clone().requires_grad_()
                for k, v in stacked.leaves.items()}

    # One collect step.
    B, C = 16, 64
    idx = torch.randperm(B, generator=gen) % Pall
    obs = {k: rnd(B, C, 1) for k in ("time", "acc")}
    rnn = state(B, C)
    outs = {}
    for dev, model in (("cuda", ac), ("cpu", ac_cpu)):
        cp = idx.to(dev, torch.int32)
        layout = PolicyBatchReorderState(
            to_policy_idxs=None, to_sim_idxs=None, policy_dims=(B, C),
            sim_dims=(B * C,), chunk_policy=cp, chunk_index=cp.long())
        with torch.no_grad():
            outs[dev] = model.rollout_chunked(
                StackedParams(leaves(range(Pall), dev)), layout, None,
                tree_map(lambda t: t.to(dev), rnn),
                tree_map(lambda t: t.to(dev), obs), sample_actions=False)
    (o_g, r_g), (o_c, r_c) = outs["cuda"], outs["cpu"]
    compare(f"{name} collect step critic, card vs CPU", o_g["critic"].cpu(),
            o_c["critic"], **tol)
    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)
    for i, (g, c) in enumerate(zip(as_tuple(r_g), as_tuple(r_c))):
        compare(f"{name} collect step state {i}, card vs CPU", g.cpu(), c,
                **tol)
    # One learn pass.
    T, mb = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS, 256
    obs = {k: rnd(P, T, mb, 1) for k in ("time", "acc")}
    rnn = state(P, mb)
    ends = torch.rand(P, T, mb, 1, generator=gen) < 0.1
    actions = {"move": torch.randint(0, 5, (P, T, mb, 1), generator=gen,
                                     dtype=torch.int32)}
    res = {}
    for dev, model in (("cuda", ac), ("cpu", ac_cpu)):
        lv = leaves(range(P), dev)
        mv = lambda t: t.to(dev)
        out = model.update_batched(StackedParams(lv), tree_map(mv, rnn),
                                   mv(ends), tree_map(mv, actions),
                                   tree_map(mv, obs))
        # The log-probs of the move head and the critic values.
        out = {"log_probs": out["log_probs"]["move"], "critic": out["critic"]}
        loss = out["log_probs"].float().sum() + out["critic"].float().sum()
        grads = torch.autograd.grad(loss, list(lv.values()))
        res[dev] = (out, dict(zip(lv, grads)))
    (o_g, g_g), (o_c, g_c) = res["cuda"], res["cpu"]
    for k in ("log_probs", "critic"):
        compare(f"{name} learn pass {k}, card vs CPU", o_g[k].detach().cpu(),
                o_c[k].detach(), **tol)
    worst = 0.0
    for k in g_c:
        rel = ((g_g[k].cpu().float() - g_c[k].float()).norm()
               / g_c[k].float().norm().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not rel <= 3.2e-2:
            raise AssertionError(f"{name}: gradient {k} on the card is "
                                 f"{rel:.3e} of its norm away from the CPU's")
    log(f"  {name} learn pass gradients, card vs CPU: the largest relative "
        f"difference {worst:.3e} over {len(g_c)} stacked parameters (tol "
        f"3.2e-2 of the norm) ok")


def kernel_phase():
    results = {}
    log("kernels against their plain versions:")
    check_gae(results)
    check_lstm(results)
    check_mha(results)
    check_policy_step(results)
    check_lstm_proj(results)
    check_gru(results)
    check_layer_norm(results)
    check_mha_flash(results)
    check_grouped_matmul(results)
    check_grouped_matmul_pbt(results)
    for H in (CHANNELS, *WIDE_HIDDEN):
        check_lstm_chunked(results, H)
        check_lstm_bwd_chunked(results, H)
        check_gru_chunked(results, H)
        check_gru_bwd_chunked(results, H)
        check_policy_step_chunked(results, H)
        check_lstm_proj_chunked(results, H)
    check_layer_norm_chunked(results)
    return results


def _small_actor_critic(dtype, hidden, seed, fused=False, gru=False,
                        feed_forward=False, steer=None, window=None,
                        separate=False):
    """The headline's MLP + LSTM actor-critic; ``fused`` turns on the fused
    trunk (``use_fused_step`` and ``fuse_input_proj``), ``gru`` puts a GRU
    in the LSTM's place, ``window`` a ``WindowAttentionMemory`` over that
    many steps (``WINDOW_HEADS`` heads), ``feed_forward`` drops the LSTM (a
    ``BackboneEncoder`` over the MLP), ``separate`` gives the actor and
    the critic a tower each (``BackboneSeparate``), and ``steer`` (a
    ``ContinuousActionsConfig``) puts a continuous head in the discrete
    one's place."""
    import torch
    from madrona_learn_tpu_torch.config import DiscreteActionsConfig
    from madrona_learn_tpu_torch.models import (
        GRU, LSTM, MLP, ActorCritic, BackboneEncoder, BackboneSeparate,
        BackboneShared, DenseLayerCritic, DenseLayerDiscreteActor,
        DictActor, RecurrentBackboneEncoder, WindowAttentionMemory)

    gen = torch.Generator().manual_seed(seed)
    move = DiscreteActionsConfig(actions_num_buckets=[5])

    def tower():
        net = MLP(3, hidden, 2, dtype, generator=gen)
        if feed_forward:
            return BackboneEncoder(net=net)
        if window is not None:
            rnn = WindowAttentionMemory(hidden, window, WINDOW_HEADS, dtype,
                                        generator=gen)
        elif gru:
            rnn = GRU(hidden, hidden, 1, dtype, generator=gen)
        else:
            rnn = LSTM(hidden, hidden, 1, dtype, generator=gen,
                       fuse_input_proj=fused)
        return RecurrentBackboneEncoder(net=net, rnn=rnn,
                                        use_fused_step=fused)

    def prefix(obs):
        return torch.cat([obs["delta"], obs["time"]], -1)

    backbone = (BackboneSeparate(prefix, tower(), tower()) if separate
                else BackboneShared(prefix=prefix, encoder=tower()))
    head = (_steer_actor(steer, hidden, dtype, gen) if steer is not None
            else DenseLayerDiscreteActor(move, hidden, dtype, generator=gen))
    return ActorCritic(
        backbone=backbone,
        actor=DictActor({"steer" if steer is not None else "move": head}),
        critic=DenseLayerCritic(hidden, dtype, generator=gen))


def _steer_actor(cfg, hidden, dtype, gen):
    """The continuous head of the JAX package's
    ``tests/test_train_variants.py``: one Dense to the raw means and stds
    of a ``ContinuousActionsConfig``'s dimensions."""
    import torch
    from madrona_learn_tpu_torch.models import Dense
    from madrona_learn_tpu_torch.ops.dists import (
        ContinuousActionDistributions)

    class SteerActor(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(hidden, 2 * cfg.num_dims, dtype,
                                 generator=gen)

        def forward(self, features):
            out = self.Dense_0(features)
            d = cfg.num_dims
            return ContinuousActionDistributions(
                [cfg], out[..., None, :d], out[..., None, d:])

    return SteerActor()


# The flagship's observations (__graft_entry__.py): self [16], allies
# [5, 12], enemies [6, 12] (flagship_large: allies and enemies [255, 12]);
# its action space move [5, 3].
ENTITY_OBS = {"self": 16, "allies": 12, "enemies": 12}
FLAGSHIP_BUCKETS = [5, 3]
LARGE_SET = dict(allies=255, enemies=255)


def _flagship_actor_critic(dtype, embed, out, heads, hidden, seed,
                           embed_concat_self=False,
                           remat_trunk_sequence=False):
    import torch
    from madrona_learn_tpu_torch.config import DiscreteActionsConfig
    from madrona_learn_tpu_torch.models import (
        LSTM, ActorCritic, BackboneShared, DenseLayerDiscreteActor,
        DictActor, DreamerV3Critic, EntitySelfAttentionNet,
        RecurrentBackboneEncoder)

    gen = torch.Generator().manual_seed(seed)
    return ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs: obs,
            encoder=RecurrentBackboneEncoder(
                net=EntitySelfAttentionNet(
                    ENTITY_OBS, embed, out, heads, dtype, generator=gen,
                    embed_concat_self=embed_concat_self),
                rnn=LSTM(out, hidden, 1, dtype, generator=gen),
                remat_trunk_sequence=remat_trunk_sequence)),
        actor=DictActor({"move": DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=FLAGSHIP_BUCKETS),
            hidden, dtype, generator=gen)}),
        critic=DreamerV3Critic(hidden, dtype))


def _entity_env(base, allies=5, enemies=6, keys=("delta", "time"),
                width=3):
    """A toy env's obs as the flagship's entity sets: with f the ``width``
    features of ``keys`` concatenated (the gridworld's delta and time; the
    duel's time and acc), self = f @ A_self and ally / enemy j = f @ A[j],
    the matrices drawn once from numpy's default_rng(0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    a_self, a_ally, a_enemy = (
        torch.from_numpy((rng.standard_normal(shape) * width ** -0.5)
                         .astype(np.float32)).cuda()
        for shape in ((width, ENTITY_OBS["self"]),
                      (allies, width, ENTITY_OBS["allies"]),
                      (enemies, width, ENTITY_OBS["enemies"])))

    def wrap(obs):
        f = torch.cat([obs[k] for k in keys], dim=-1)
        return {"self": f @ a_self,
                "allies": torch.einsum("bf,jfe->bje", f, a_ally),
                "enemies": torch.einsum("bf,jfe->bje", f, a_enemy)}

    def init_fn():
        out = base["init"]()
        return {"state": out["state"], "obs": wrap(out["obs"])}

    def step_fn(step_input):
        out = dict(base["step"](step_input))
        out["obs"] = wrap(out["obs"])
        return out

    return {"init": init_fn, "step": step_fn}


def _card_vs_cpu(ac_cpu, obs, dones, actions, start, loss_fn):
    """The update pass and its gradients on the card (kernels) against the
    same module on the CPU (plain versions)."""
    import copy

    import torch
    from madrona_learn_tpu_torch.utils import tree_map

    ac_gpu = copy.deepcopy(ac_cpu).cuda()

    def run(ac, dev):
        out = ac.update(tree_map(lambda s: s.to(dev), start), dones.to(dev),
                        {k: v.to(dev) for k, v in actions.items()},
                        {k: v.to(dev) for k, v in obs.items()})
        names, params = zip(*ac.named_parameters())
        grads = torch.autograd.grad(loss_fn(out, dev), params)
        return out, dict(zip(names, grads))

    out_cpu, g_cpu = run(ac_cpu, "cpu")
    out_gpu, g_gpu = run(ac_gpu, "cuda")
    # Same f32 math; the products sum in another order on the card.
    tol = dict(atol=1e-4, rtol=1e-4)
    compare("log_probs", out_gpu["log_probs"]["move"].cpu(),
            out_cpu["log_probs"]["move"], **tol)
    critic_gpu, critic_cpu = out_gpu["critic"], out_cpu["critic"]
    if not isinstance(critic_cpu, torch.Tensor):
        critic_gpu, critic_cpu = critic_gpu.mean(), critic_cpu.mean()
    compare("critic", critic_gpu.cpu(), critic_cpu, **tol)
    for name in g_cpu:
        compare(f"grad {name}", g_gpu[name].cpu(), g_cpu[name], **tol)


def _rollout_card_vs_cpu(ac, start, step_obs):
    """One rollout step (the critic and the new recurrent state) on the card
    against the CPU."""
    import copy

    import torch
    from madrona_learn_tpu_torch.utils import tree_map

    with torch.no_grad():
        out_cpu, carry_cpu = ac.rollout(None, start, step_obs,
                                        sample_actions=False)
        out_gpu, carry_gpu = copy.deepcopy(ac).cuda().rollout(
            None, tree_map(lambda s: s.cuda(), start),
            {k: v.cuda() for k, v in step_obs.items()}, sample_actions=False)
    tol = dict(atol=1e-4, rtol=1e-4)
    compare("rollout step critic", out_gpu["critic"].cpu(), out_cpu["critic"],
            **tol)
    carry_gpu = carry_gpu if isinstance(carry_gpu, tuple) else (carry_gpu,)
    carry_cpu = carry_cpu if isinstance(carry_cpu, tuple) else (carry_cpu,)
    for i, (g, w) in enumerate(zip(carry_gpu, carry_cpu)):
        compare(f"rollout step state {i}", g.cpu(), w, **tol)


def layer_norm_module_phase():
    """LayerNorm(use_kernel=True), the entry point the layer_norm kernels
    serve, forward and backward on the card against the CPU, at the
    headline trunk's update rows in bf16 and a small float32 input. Returns
    the kernel launches of this path."""
    import torch
    from madrona_learn_tpu_torch.models import LayerNorm
    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    log("LayerNorm(use_kernel=True) module, card against CPU:")
    gen = torch.Generator().manual_seed(12)
    cases = [((131072, 256), torch.bfloat16), ((300, 128), torch.float32)]
    inputs = []
    for shape, dtype in cases:
        ln = LayerNorm(shape[-1], dtype, use_kernel=True)
        with torch.no_grad():
            ln.impl.scale.add_(0.1 * torch.randn(shape[-1], generator=gen))
            ln.impl.bias.add_(0.1 * torch.randn(shape[-1], generator=gen))
        x = (2 * torch.randn(*shape, generator=gen) + 0.5).to(dtype)
        dy = torch.randn(*shape, generator=gen).to(dtype)
        inputs.append((ln, x, dy))

    def run(ln, x, dy):
        x = x.clone().requires_grad_()
        out = ln(x)
        grads = torch.autograd.grad((out.float() * dy.float()).sum(),
                                    [x, ln.impl.scale, ln.impl.bias])
        return [out, *grads]

    want = [run(*case) for case in inputs]
    for k in KERNELS:
        k.launches = 0
    got = [run(ln.cuda(), x.cuda(), dy.cuda()) for ln, x, dy in inputs]
    launches = {k.name: k.launches for k in KERNELS}
    torch.cuda.synchronize()
    for (_, x, _), g, w in zip(inputs, got, want):
        dname = str(x.dtype).split(".")[-1]
        tag = f"{list(x.shape)} {dname}"
        for name, a, b in zip(("y", "dx", "dscale", "dbias"), g, w):
            tol = (TOL[("ln_fwd", dname)] if name == "y" else
                   TOL[("ln_bwd", dname)] if name == "dx" else TOL["ln_dwdb"])
            compare(f"LayerNorm module {name} {tag}", a.cpu(), b, **tol)
    for name in ("layer_norm_fwd", "layer_norm_bwd"):
        if launches[name] != len(cases):
            raise AssertionError(f"LayerNorm module: {name} launched "
                                 f"{launches[name]} times, expected "
                                 f"{len(cases)}")
    log(f"  launches on this path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def grouped_matmul_op_phase():
    """grouped_matmul, the op's one entry point (the JAX package routes it
    nowhere), at the three grouped_matmul_bench.py shapes in bf16, each
    output checked against the plain version on the card. Returns the
    kernel launches of this path."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda import KERNELS
    from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import (
        grouped_matmul, grouped_matmul_reference)

    log("grouped_matmul op path:")
    gen = torch.Generator(device="cuda").manual_seed(16)
    inputs = [_gmm_inputs(gen, *shape, torch.bfloat16)
              for shape in GMM_SHAPES]
    for k in KERNELS:
        k.launches = 0
    outs = [grouped_matmul(*args) for args in inputs]
    launches = {k.name: k.launches for k in KERNELS}
    torch.cuda.synchronize()
    for (B, C, IN, P, OUT), args, y in zip(GMM_SHAPES, inputs, outs):
        if y.shape != (B, C, OUT) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"grouped_matmul op: output of shape "
                                 f"{tuple(y.shape)} or not finite")
        compare(f"grouped_matmul op [{B}x{C}, {IN}->{OUT}, P={P}] bf16", y,
                grouped_matmul_reference(*args), **TOL[("gmm", "bfloat16")])
    if launches["grouped_matmul"] != len(GMM_SHAPES):
        raise AssertionError(f"grouped_matmul op: launched "
                             f"{launches['grouped_matmul']} times, expected "
                             f"{len(GMM_SHAPES)}")
    log(f"  launches on this path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def model_phase():
    """The MLP model, a small GRU model, a small flagship model, a small
    fused-trunk model and the value side (a two-part HL-Gauss critic and a
    value-normalized dense critic), float32, small input."""
    import torch

    log("model update pass, card (kernels) against CPU (plain), float32:")
    T, N, H = 8, 96, 128
    gen = torch.Generator().manual_seed(3)
    obs = {"delta": torch.randn(T, N, 2, generator=gen),
           "time": torch.rand(T, N, 1, generator=gen)}
    dones = torch.rand(T, N, 1, generator=gen) < 0.2
    actions = {"move": torch.randint(0, 5, (T, N, 1), generator=gen)}
    start = tuple(torch.randn(N, 1, H, generator=gen) for _ in range(2))

    def mlp_loss(out, dev):
        return (out["log_probs"]["move"].sum()
                + out["critic"].square().sum()
                + out["entropies"]["move"].sum())

    _card_vs_cpu(_small_actor_critic(torch.float32, H, seed=4), obs, dones,
                 actions, start, mlp_loss)
    step_obs = {k: v[0] for k, v in obs.items()}

    log("GRU model (MLP 2x128, GRU 128) rollout step and update pass, card "
        "against CPU, float32:")
    ac = _small_actor_critic(torch.float32, H, seed=13, gru=True)
    # Nonzero GRU biases (zero at init), so the check sees them.
    with torch.no_grad():
        for p in (ac.backbone.encoder.rnn.layer_0.bias_h,
                  ac.backbone.encoder.rnn.layer_0.input_proj.bias):
            p.normal_(0, 0.3, generator=gen)
    _rollout_card_vs_cpu(ac, start[1], step_obs)
    _card_vs_cpu(ac, obs, dones, actions, start[1], mlp_loss)

    log("fused-trunk model (MLP 2x128, LSTM 128, fused step and input "
        "projection), card against CPU, float32:")
    ac = _small_actor_critic(torch.float32, H, seed=8, fused=True)
    _rollout_card_vs_cpu(ac, start, step_obs)
    _card_vs_cpu(ac, obs, dones, actions, start, mlp_loss)

    log("flagship model (embed 32, out 64, 2 heads, LSTM 128) update pass, "
        "card against CPU, float32:")
    _small_flagship_card_vs_cpu(gen, T, N, H, 5, 6, seed=6)
    log("large-entity flagship model (the same, 150 allies and 130 enemies: "
        "281 entities through mha_flash) update pass, card against CPU, "
        "float32:")
    _small_flagship_card_vs_cpu(gen, T, 32, H, 150, 130, seed=17)
    _value_side_card_vs_cpu(gen, obs, dones, actions, start, H)


def _value_side_card_vs_cpu(gen, obs, dones, actions, start, H):
    """The value side of PPO on the small MLP model: the two-part HL-Gauss
    critic's loss, and the dense critic's value-normalized, clipped Huber
    loss with the normalizer's update, card against CPU."""
    import types

    import torch
    from madrona_learn_tpu_torch.models import HLGaussTwoPartCritic
    from madrona_learn_tpu_torch.ops.ema import EMANormalizer
    from madrona_learn_tpu_torch.ppo import PPO, _value_loss

    T, N = dones.shape[:2]
    # Targets on both sides of the two-part split at |t| = 2 and past the
    # fine table's range.
    returns = 5 * torch.randn(T, N, 1, generator=gen)
    log("two-part HL-Gauss critic model (MLP 2x128, LSTM 128, "
        "HLGaussTwoPartCritic) update pass, card against CPU, float32:")
    ac = _small_actor_critic(torch.float32, H, seed=21)
    ac.critic = HLGaussTwoPartCritic.create(H, torch.float32)
    # Heads away from their zero init, so the check sees them.
    with torch.no_grad():
        for p in ac.critic.parameters():
            p.normal_(0, 0.1, generator=gen)

    def hlgauss_loss(out, dev):
        return (out["log_probs"]["move"].sum()
                + out["entropies"]["move"].sum()
                + out["critic"].loss(returns.to(dev)).sum())

    _card_vs_cpu(ac, obs, dones, actions, start, hlgauss_loss)

    log("value-normalized dense critic (MLP 2x128, LSTM 128, "
        "normalize_values, clipped Huber value loss) update pass and the "
        "normalizer's update, card against CPU, float32:")
    cfg = _train_config([5], dreamer_v3_critic=False, num_worlds=N,
                        algo_kwargs=dict(clip_value_loss=True,
                                         huber_value_loss=True),
                        normalize_values=True)
    norm = EMANormalizer(decay=cfg.value_normalizer_decay,
                         norm_dtype=torch.float32)
    # A state away from the identity, then the minibatch's update.
    norm_state, _ = norm.normalize_and_update_estimates(
        norm.init_estimates(returns), 2 * returns + 1)
    old_values = 0.3 * torch.randn(T, N, 1, generator=gen)
    hyper_params = PPO().init_hyperparams(cfg)
    new_states = {}

    def valuenorm_loss(out, dev):
        state = types.SimpleNamespace(
            hyper_params=hyper_params, value_normalizer=norm,
            value_normalizer_state={k: v.to(dev)
                                    for k, v in norm_state.items()})
        losses, errs, new_states[dev] = _value_loss(
            cfg, {"returns": returns.to(dev), "values": old_values.to(dev)},
            out["critic"], state)
        return (out["log_probs"]["move"].sum() + losses.sum()
                + errs.square().sum())

    _card_vs_cpu(_small_actor_critic(torch.float32, H, seed=22), obs, dones,
                 actions, start, valuenorm_loss)
    for k, want in new_states["cpu"].items():
        compare(f"value normalizer {k}", new_states["cuda"][k].cpu(), want,
                atol=1e-6, rtol=1e-6)


def _small_flagship_card_vs_cpu(gen, T, N, H, allies, enemies, seed):
    """A small flagship (embed 32, out 64, 2 heads, LSTM H) over random
    entity sets: the update pass and every gradient, card against CPU."""
    import torch

    obs = {"self": torch.randn(T, N, 16, generator=gen),
           "allies": torch.randn(T, N, allies, 12, generator=gen),
           "enemies": torch.randn(T, N, enemies, 12, generator=gen)}
    dones = torch.rand(T, N, 1, generator=gen) < 0.2
    actions = {"move": torch.stack(
        [torch.randint(0, 5, (T, N), generator=gen),
         torch.randint(0, 3, (T, N), generator=gen)], dim=-1)}
    start = tuple(torch.randn(N, 1, H, generator=gen) for _ in range(2))
    returns = 3 * torch.randn(T, N, 1, generator=gen)
    ac = _flagship_actor_critic(torch.float32, 32, 64, 2, H, seed=seed)
    # A critic head away from its zero init, so the check sees it.
    with torch.no_grad():
        ac.critic.Dense_0.kernel.normal_(0, 0.1, generator=gen)

    def flagship_loss(out, dev):
        return (out["log_probs"]["move"].sum()
                + out["entropies"]["move"].sum()
                + out["critic"].two_hot_cross_entropy_loss(
                    returns.to(dev)).sum())

    _card_vs_cpu(ac, obs, dones, actions, start, flagship_loss)


NUM_WORLDS = 16384
# flagship_large's worlds: one minibatch then holds 16 x 256 x 512 entity
# rows, as many as the flagship's 16 x 8192 x 16.
LARGE_WORLDS = 512
STEPS_PER_UPDATE = 32
NUM_BPTT_CHUNKS = 2
NUM_MINIBATCHES = 4
CHANNELS = 256
CLIP_COEF = 0.2


def _train_config(actions, dreamer_v3_critic, num_worlds=NUM_WORLDS,
                  algo_kwargs=None, **kwargs):
    """The trainers' TrainConfig; ``actions`` are the move head's buckets
    or a dict of action configs, ``algo_kwargs`` go to PPOConfig and the
    other keywords to TrainConfig."""
    import madrona_learn_tpu_torch as mlt

    algo = dict(num_epochs=1,
                minibatch_size=NUM_BPTT_CHUNKS * num_worlds // NUM_MINIBATCHES,
                clip_coef=CLIP_COEF, value_loss_coef=0.5, entropy_coef=0.01,
                max_grad_norm=0.5)
    algo.update(algo_kwargs or {})
    return mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        actions=(actions if isinstance(actions, dict) else
                 {"move": mlt.DiscreteActionsConfig(
                     actions_num_buckets=actions)}),
        steps_per_update=STEPS_PER_UPDATE,
        num_bptt_chunks=NUM_BPTT_CHUNKS,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(**algo),
        dreamer_v3_critic=dreamer_v3_critic,
        **kwargs,
    )


def _toy_env(num_worlds=NUM_WORLDS):
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env

    return make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=40, grid_size=8, seed=0),
        device="cuda")


def _headline_trainer(hooks, cfg, actor_critic=None, obs_preprocess=None,
                      sim_fns=None, restore_ckpt=None):
    """``init_training`` on the card: the headline's model, obs normalizer
    and toy gridworld unless others are given; from checkpoint
    ``restore_ckpt`` if given."""
    import torch
    import madrona_learn_tpu_torch as mlt

    dtype = torch.bfloat16
    policy = mlt.Policy(
        actor_critic=(actor_critic if actor_critic is not None
                      else _small_actor_critic(dtype, CHANNELS, seed=0)),
        obs_preprocess=(obs_preprocess if obs_preprocess is not None
                        else mlt.ObservationsEMANormalizer.create(
                            decay=0.99999, dtype=dtype)))
    return mlt.init_training(
        "cuda", cfg, sim_fns or _toy_env(), policy,
        torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks, restore_ckpt=restore_ckpt)


def _headline_policy():
    """The headline's policy: its MLP + LSTM (seed 0) and obs normalizer,
    in bf16."""
    import torch
    import madrona_learn_tpu_torch as mlt

    return mlt.Policy(
        actor_critic=_small_actor_critic(torch.bfloat16, CHANNELS, seed=0),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=torch.bfloat16))


def build_headline(hooks, restore_ckpt=None):
    return _headline_trainer(hooks, _train_config([5],
                                                  dreamer_v3_critic=False),
                             restore_ckpt=restore_ckpt)


def build_headline_valuenorm(hooks):
    """The headline with value normalization (decay 0.99999), the clipped
    value loss and the Huber value loss."""
    return _headline_trainer(hooks, _train_config(
        [5], dreamer_v3_critic=False,
        algo_kwargs=dict(clip_value_loss=True, huber_value_loss=True),
        normalize_values=True, value_normalizer_decay=0.99999))


def build_headline_hlgauss(hooks):
    """The headline with HLGaussCritic (127 bins over [-100, 100]) in the
    dense critic's place."""
    import torch
    from madrona_learn_tpu_torch.models import HLGaussCritic

    ac = _small_actor_critic(torch.bfloat16, CHANNELS, seed=0)
    ac.critic = HLGaussCritic.create(CHANNELS, torch.bfloat16)
    return _headline_trainer(
        hooks, _train_config([5], dreamer_v3_critic=False,
                             hlgauss_critic=True), actor_critic=ac)


def build_headline_gru(hooks):
    """The headline with GRU(256, 256, 1, bf16) in the LSTM's place."""
    import torch

    return _headline_trainer(
        hooks, _train_config([5], dreamer_v3_critic=False),
        actor_critic=_small_actor_critic(torch.bfloat16, CHANNELS, seed=0,
                                         gru=True))


def build_headline_fused(hooks, sim_fns=None):
    """The headline with the fused trunk, over the toy gridworld or
    ``sim_fns``."""
    import torch

    return _headline_trainer(
        hooks, _train_config([5], dreamer_v3_critic=False),
        actor_critic=_small_actor_critic(torch.bfloat16, CHANNELS, seed=0,
                                         fused=True), sim_fns=sim_fns)


# The advantage side: importance sampling draws 2 of the headline's 4
# minibatches of sequences; stratification splits the 32768 sequences
# into 4 blocks of 8192, each minibatch taking 2048 of each; filtering
# works on time-flattened rows, in minibatches of the headline's 8192 x 16
# rows, so at most 4 an epoch.
IMPORTANCE_MINIBATCHES = 2
STRATIFY = 4
FILTER_MINIBATCH_ROWS = NUM_WORLDS * STEPS_PER_UPDATE // NUM_MINIBATCHES
STEER = dict(stddev_min=0.05, stddev_max=0.5, num_dims=2)


def build_headline_importance(hooks):
    """The headline with trajectory importance sampling."""
    return _headline_trainer(hooks, _train_config(
        [5], dreamer_v3_critic=False, importance_sample_trajectories=True,
        importance_sample_num_minibatches=IMPORTANCE_MINIBATCHES))


def build_headline_stratified(hooks):
    """The headline with minibatches stratified over 4 blocks."""
    return _headline_trainer(hooks, _train_config(
        [5], dreamer_v3_critic=False, minibatch_stratify=STRATIFY))


def build_mlp_filter(hooks):
    """The headline's MLP, actor and critic without the LSTM
    (``BackboneEncoder``), bf16, with advantage filtering."""
    import torch

    return _headline_trainer(
        hooks, _train_config(
            [5], dreamer_v3_critic=False,
            algo_kwargs=dict(minibatch_size=FILTER_MINIBATCH_ROWS),
            filter_advantages=True),
        actor_critic=_small_actor_critic(torch.bfloat16, CHANNELS, seed=0,
                                         feed_forward=True))


def build_mlp_fp16(hooks):
    """The headline's MLP, actor and critic without the LSTM in float16,
    the obs cast to float16, with dynamic loss scaling."""
    import torch
    import madrona_learn_tpu_torch as mlt

    return _headline_trainer(
        hooks, _train_config([5], dreamer_v3_critic=False,
                             compute_dtype=torch.float16),
        actor_critic=_small_actor_critic(torch.float16, CHANNELS, seed=0,
                                         feed_forward=True),
        obs_preprocess=mlt.ObservationsCaster.create(dtype=torch.float16))


def _steer_env(base):
    """The toy gridworld behind the JAX package's continuous-action
    adapter (tests/test_train_variants.py): a coordinate of the [B, 1, 2]
    action past +-0.3 moves the agent along it, x first."""
    import torch

    def step_fn(step_input):
        cont = step_input["actions"]["steer"][:, 0, :]
        dx = torch.where(cont[:, 0].abs() > 0.3,
                         torch.where(cont[:, 0] > 0, 3, 4), 0)
        dy = torch.where(cont[:, 1].abs() > 0.3,
                         torch.where(cont[:, 1] > 0, 1, 2), 0)
        move = torch.where(dx > 0, dx, dy).to(torch.int32)[:, None]
        return base["step"](dict(step_input, actions={"move": move}))

    return {"init": base["init"], "step": step_fn}


def build_headline_continuous(hooks):
    """The headline's trunk and critic with a 2-dim continuous head."""
    import torch
    import madrona_learn_tpu_torch as mlt

    steer = mlt.ContinuousActionsConfig(**STEER)
    return _headline_trainer(
        hooks, _train_config({"steer": steer}, dreamer_v3_critic=False),
        actor_critic=_small_actor_critic(torch.bfloat16, CHANNELS, seed=0,
                                         steer=steer),
        sim_fns=_steer_env(_toy_env()))


def build_native(hooks):
    """The headline_fused model over the C++ batch simulator."""
    from madrona_learn_tpu_torch.envs import NativeSimConfig, make_native_sim

    return build_headline_fused(hooks, make_native_sim(NativeSimConfig(
        num_worlds=NUM_WORLDS, episode_len=40, grid_size=8, seed=0),
        device="cuda"))


def build_flagship(hooks, num_worlds=NUM_WORLDS, allies=5, enemies=6,
                   **model_kwargs):
    import torch
    import madrona_learn_tpu_torch as mlt

    # __graft_entry__.py's model at its published width; no obs
    # preprocessing, as there.
    policy = mlt.Policy(actor_critic=_flagship_actor_critic(
        torch.bfloat16, 128, 256, 4, CHANNELS, seed=0, **model_kwargs))
    return mlt.init_training(
        "cuda", _train_config(FLAGSHIP_BUCKETS, dreamer_v3_critic=True,
                              num_worlds=num_worlds),
        _entity_env(_toy_env(num_worlds), allies, enemies), policy,
        torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks)


def build_flagship_large(hooks):
    """The flagship over 511 entities (self, 255 allies, 255 enemies), which
    pad to 512 and take mha_flash, at LARGE_WORLDS worlds."""
    return build_flagship(hooks, num_worlds=LARGE_WORLDS, **LARGE_SET)


# The rest of the model zoo at the headline's width and PPO settings:
# separate actor and critic towers, float16 recurrences, the windowed
# attention memory (its window the BPTT chunk's 16 steps) and the flagship
# with self-concatenated entity embeddings and its trunk rematerialized in
# the update pass.
WINDOW = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
WINDOW_HEADS = 4


def build_headline_separate(hooks):
    """The headline with an MLP 2 x 256 -> LSTM 256 tower for the actor
    and another for the critic (``BackboneSeparate``), bf16."""
    import torch

    return _headline_trainer(
        hooks, _train_config([5], dreamer_v3_critic=False),
        actor_critic=_small_actor_critic(torch.bfloat16, CHANNELS, seed=0,
                                         separate=True))


def _fp16_trainer(hooks, **model_kwargs):
    """The headline's model in float16 (``model_kwargs`` as
    ``_small_actor_critic`` takes them), the obs cast to float16, with
    dynamic loss scaling."""
    import torch
    import madrona_learn_tpu_torch as mlt

    return _headline_trainer(
        hooks, _train_config([5], dreamer_v3_critic=False,
                             compute_dtype=torch.float16),
        actor_critic=_small_actor_critic(torch.float16, CHANNELS, seed=0,
                                         **model_kwargs),
        obs_preprocess=mlt.ObservationsCaster.create(dtype=torch.float16))


def build_headline_fp16(hooks):
    """The headline in float16: its LSTM on the float16 kernels."""
    return _fp16_trainer(hooks)


def build_headline_gru_fp16(hooks):
    """headline_gru in float16: its GRU on the float16 kernels."""
    return _fp16_trainer(hooks, gru=True)


def build_headline_window(hooks):
    """The headline with WindowAttentionMemory(256, window 16, 4 heads) in
    the LSTM's place, bf16: plain PyTorch, no recurrent kernel."""
    import torch

    return _headline_trainer(
        hooks, _train_config([5], dreamer_v3_critic=False),
        actor_critic=_small_actor_critic(torch.bfloat16, CHANNELS, seed=0,
                                         window=WINDOW))


def build_flagship_concat_self_remat(hooks):
    """The flagship with ``embed_concat_self`` (each entity's features
    followed by the self features) and ``remat_trunk_sequence``."""
    return build_flagship(hooks, embed_concat_self=True,
                          remat_trunk_sequence=True)


def check_remat(mgr, updates_run, update_stats):
    """flagship_concat_self_remat: from one saved state and rollout copy,
    one update with the trunk rematerialized and one without must launch
    ``mha`` 41 and 37 times and give bitwise equal parameters; the peak
    device memory of each is printed."""
    import shutil
    import torch

    ckpt_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "_checkpoint_smoke")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    encoder = mgr.state.policy_states.actor_critic.backbone.encoder
    try:
        mgr.save_ckpt(ckpt_root)
        path = os.path.join(ckpt_root, str(mgr.update_idx))
        rollout = _copy_rollout(mgr.rollout)
        runs = {}
        for remat in (True, False):
            mgr.load_ckpt(path)
            mgr.rollout = _copy_rollout(rollout)
            encoder.remat_trunk_sequence = remat
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _zero_launch_counts()
            (_, ms) = _timed(mgr.update_iter)
            mha = _launch_counts()[0]["mha"]
            want = STEPS_PER_UPDATE + 1 + NUM_MINIBATCHES * (1 + remat)
            if mha != want:
                raise AssertionError(f"remat={remat}: mha launched {mha} "
                                     f"times, expected {want}")
            runs[remat] = dict(
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, ms=ms,
                params={k: p.detach().clone() for k, p in mgr.state
                        .policy_states.actor_critic.named_parameters()})
    finally:
        encoder.remat_trunk_sequence = True
        shutil.rmtree(ckpt_root, ignore_errors=True)
    differ = [k for k, p in runs[True]["params"].items()
              if not torch.equal(p, runs[False]["params"][k])]
    log(f"  remat against no remat from one state: "
        f"{len(runs[True]['params']) - len(differ)} of "
        f"{len(runs[True]['params'])} parameters bitwise equal; peak "
        f"{runs[True]['peak_gib']:.2f} GiB with remat, "
        f"{runs[False]['peak_gib']:.2f} GiB without; update "
        f"{runs[True]['ms']:.1f} ms with, {runs[False]['ms']:.1f} ms "
        f"without; mha {STEPS_PER_UPDATE + 1 + 2 * NUM_MINIBATCHES} / "
        f"{STEPS_PER_UPDATE + 1 + NUM_MINIBATCHES} launches")
    if differ:
        raise AssertionError(f"remat changed parameters: {differ}")


def _phase_timer():
    import torch
    from madrona_learn_tpu_torch.train import TrainHooks

    class PhaseTimer(TrainHooks):
        """Synchronizing timestamps at the collect / learn boundary, only
        while ``active`` (the timed trials run with it off)."""

        def __init__(self):
            self.active = False
            self.marks = []

        def mark(self, name):
            if self.active:
                torch.cuda.synchronize()
                self.marks.append((name, time.perf_counter()))

        def start_rollouts(self, rollout_state, user_state):
            self.mark("collect")
            return rollout_state, user_state

        def rollout_metrics(self, metrics, rollouts, user_state):
            self.mark("learn")
            return metrics

    return PhaseTimer()


def _profile_update(one_update):
    """Device time over one update, with torch.profiler: the kernels with
    the most time, their total against the wall time, and the inclusive
    device time of the port's autograd functions around the kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_update()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def self_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    def total_ms(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0)) / 1e3

    rows = prof.key_averages()
    # The named ranges (utils/profile.py) also appear on the device, as
    # annotations under their own names spanning their kernels: not
    # kernels.
    ops = {e.key for e in rows if e.device_type == DeviceType.CPU}
    kernels = sorted((e for e in rows if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and e.key not in ops),
                     key=self_ms, reverse=True)
    busy_ms = sum(self_ms(e) for e in kernels)
    log(f"  profile of one update (profiler on): kernels {busy_ms:.1f} ms "
        f"of {wall_ms:.1f} ms wall, {sum(e.count for e in kernels)} "
        f"launches")
    for e in kernels[:12]:
        log(f"    {self_ms(e):9.3f} ms {e.count:6d}x  {e.key[:100]}")
    for e in rows:
        if e.key in ("_MHA", "_MHABackward", "_MHAFlash",
                     "_MHAFlashBackward", "_LSTMSequence",
                     "_LSTMSequenceBackward", "_LSTMSequenceChunked",
                     "_LSTMSequenceChunkedBackward", "_LSTMSequenceProj",
                     "_LSTMSequenceProjBackward", "_GRUSequence",
                     "_GRUSequenceBackward", "_GRUSequenceChunked",
                     "_GRUSequenceChunkedBackward"):
            log(f"    {total_ms(e):9.3f} ms {e.count:6d}x  {e.key} "
                f"(inclusive)")


# The kernels whose wrappers count their tensor-core launches
# (Kernel.tc_launches): their path rules send bf16 there (the recurrences
# and the fused step at H = 128 or 256).
TC_ROUTED = ("lstm_sequence_fwd", "lstm_sequence_bwd",
             "lstm_sequence_proj_fwd", "lstm_sequence_proj_bwd",
             "gru_sequence_fwd", "gru_sequence_bwd", "mha",
             "fused_policy_step", "lstm_sequence_fwd_chunked",
             "lstm_sequence_bwd_chunked", "gru_sequence_fwd_chunked",
             "gru_sequence_bwd_chunked", "fused_policy_step_chunked",
             "lstm_sequence_proj_fwd_chunked",
             "lstm_sequence_proj_bwd_chunked")


def _tc_kernels(dtype, hidden):
    """The kernels of TC_ROUTED whose launches take the tensor-core route
    in a model of this dtype and recurrent width: in bfloat16 every one at
    every width (at 384 and 512 the LSTM, GRU and fused step's two-block
    clusters); in float16 the eight LSTM and GRU sequence kernels at 128
    and 256, and the four GRU ones at 384 and 512."""
    from madrona_learn_tpu_torch.ops.cuda import gru, lstm

    rules = {"lstm_sequence_fwd": lstm.fwd_uses_tensor_cores,
             "lstm_sequence_fwd_chunked": lstm.fwd_uses_tensor_cores,
             "lstm_sequence_bwd": lstm.bwd_uses_tensor_cores,
             "lstm_sequence_bwd_chunked": lstm.bwd_uses_tensor_cores,
             "gru_sequence_fwd": gru.fwd_uses_tensor_cores,
             "gru_sequence_fwd_chunked": gru.fwd_uses_tensor_cores,
             "gru_sequence_bwd": gru.bwd_uses_tensor_cores,
             "gru_sequence_bwd_chunked": gru.bwd_uses_tensor_cores}
    return {name for name in TC_ROUTED
            if rules.get(name, lstm.uses_tensor_cores)(dtype, hidden)}


def trainer_phase(card, name, build, per_update, trials, timed_updates,
                  last_rewards, num_worlds=NUM_WORLDS, ratio_zero=False,
                  final_check=None, setting=None, rising_reward=True,
                  tensor_cores=TC_ROUTED):
    """One trainer: launch counts, finite metrics, rising reward (only
    logged without ``rising_reward``), env-steps/s, memory, the ratio at
    the first minibatch (exactly 0 with ``ratio_zero``), the minibatches
    of every update, the phase split and a profile; then
    ``final_check(mgr, updates run, per-update stats)``, if given.
    ``setting`` describes the run in its first line (default: the
    headline's bf16 and 4 minibatches). Every launch of a kernel that
    ``tensor_cores`` names takes the tensor-core route (by default every
    kernel with one; ``_tc_kernels`` of a float16 model), and no launch of
    the others does."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    # Start from an empty allocator cache, whatever ran before.
    gc.collect()
    torch.cuda.empty_cache()
    timer = _phase_timer()
    mgr = build(timer)
    per_update = {k.name: per_update.get(k.name, 0) for k in KERNELS}
    num_updates = 1 + trials * timed_updates
    setting = setting or f"bf16, {NUM_MINIBATCHES} minibatches"
    log(f"{name} trainer: {num_worlds} worlds, T={STEPS_PER_UPDATE} in "
        f"{NUM_BPTT_CHUNKS} chunks, {setting}; expected launches per "
        f"update {per_update}")
    updates_run = [0]

    losses, rewards, update_stats = [], [], []

    def one_update():
        mgr.update_iter()
        updates_run[0] += 1
        stats = mgr.first_minibatch_stats
        losses.append(stats["loss"])
        rewards.append(mgr.metrics.latest("Rewards").mean[0])
        update_stats.append({k: stats[k] for k in (
            "num_minibatches", "nonfinite_steps", "epoch_inds",
            "traj_weights") if k in stats})

    for k in KERNELS:
        k.launches = 0
        k.tc_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one_update()
    torch.cuda.synchronize()
    log(f"  warm-up update: {time.perf_counter() - t0:.3f} s")
    stats = mgr.first_minibatch_stats
    ratio_dev = stats["max_abs_ratio_dev"].item()
    clip_frac = stats["clip_fraction"].item()
    log(f"  first update, first minibatch: max |ratio - 1| {ratio_dev:.3e}, "
        f"clip fraction {clip_frac:.3e}")
    if not ratio_dev < CLIP_COEF:
        raise AssertionError(f"{name}: first-minibatch max |ratio - 1| "
                             f"{ratio_dev} is not below the clip "
                             f"coefficient {CLIP_COEF}")
    if ratio_zero and ratio_dev != 0:
        raise AssertionError(f"{name}: first-minibatch max |ratio - 1| "
                             f"{ratio_dev}, not 0: the critic must not "
                             f"touch the actor's log-probabilities")

    trial_s = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_updates):
            one_update()
        torch.cuda.synchronize()
        trial_s.append(time.perf_counter() - t0)
        for metric, m in mgr.metrics.metrics.items():
            if not bool(torch.isfinite(m.mean).all()):
                raise AssertionError(f"{name}: metric {metric} is not "
                                     f"finite")
    launches = {k.name: k.launches for k in KERNELS}
    tc_launches = {k.name: k.tc_launches for k in KERNELS
                   if k.name in TC_ROUTED}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    loss_hist = torch.stack(losses).float().cpu()
    reward_hist = torch.stack(rewards).float().cpu()
    if not bool(torch.isfinite(loss_hist).all()):
        raise AssertionError(f"{name}: non-finite loss: "
                             f"{loss_hist.tolist()}")
    for kernel, per in per_update.items():
        if launches[kernel] != per * num_updates:
            raise AssertionError(
                f"{name}: {kernel}: {launches[kernel]} launches over "
                f"{num_updates} updates, expected {per * num_updates}")
    log(f"  launches over {num_updates} updates: {launches} (expected "
        f"{ {k: v * num_updates for k, v in per_update.items()} })")
    # The trainers run bf16 at H = 256: every launch of a kernel with a
    # counted tensor-core route (the four LSTM kernels, the two GRU
    # kernels, mha, the fused step) takes it. In float16 the LSTM and GRU
    # sequence kernels take theirs (_tc_kernels).
    for kernel, tc in tc_launches.items():
        if tc != (launches[kernel] if kernel in tensor_cores else 0):
            raise AssertionError(
                f"{name}: {kernel}: {tc} of {launches[kernel]} launches on "
                f"the tensor-core route")
    log(f"  of those on the tensor-core route: {tc_launches}")
    env_steps = timed_updates * STEPS_PER_UPDATE * num_worlds
    sps = [env_steps / s for s in trial_s]
    log(f"  trials: "
        f"{[f'{s * 1e3 / timed_updates:.1f} ms/update' for s in trial_s]}")
    log(f"  {name} env-steps/s (best of {trials}x{timed_updates}): "
        f"{max(sps):.0f} on {card}")
    log(f"  peak device memory: {peak_gib:.2f} GiB")
    log(f"  mean reward: update 1 {reward_hist[0]:.4f}, update "
        f"{num_updates} {reward_hist[-1]:.4f}")
    log(f"  minibatches an epoch, by update: "
        f"{[u['num_minibatches'] for u in update_stats]}")
    if not rising_reward:
        log(f"  mean reward by update (logged, not held to rise): "
            f"{[round(r, 4) for r in reward_hist.tolist()]}")
    elif not reward_hist[-last_rewards:].mean() > reward_hist[:3].mean():
        raise AssertionError(
            f"{name}: mean reward did not rise: {reward_hist.tolist()}")

    # Collect / learn split over a few synchronized updates.
    timer.active = True
    for _ in range(3):
        one_update()
    timer.mark("end")
    timer.active = False
    spans = {}
    for (span, t), (_, t_next) in zip(timer.marks, timer.marks[1:]):
        spans.setdefault(span, []).append((t_next - t) * 1e3)
    log(f"  phase split (ms, synchronized): "
        f"{ {k: [round(v, 2) for v in vs] for k, vs in spans.items()} }")
    _profile_update(one_update)
    if final_check is not None:
        final_check(mgr, updates_run[0], update_stats)
    return launches, dict(sps=max(sps), ratio_dev=ratio_dev,
                          clip_frac=clip_frac, peak_gib=peak_gib)


PBT_TRAIN, PBT_PAST = 8, 4
PBT_PORTIONS = (0.25, 0.5, 0.25)
PBT_EVAL_STEPS = 64
# Train agents a policy: 32768 * (0.25 + 0.5 / 2 + 0.25 / 2) / 8 = 2560;
# sequences a policy 2 x 2560, in 4 minibatches.
PBT_TRAIN_AGENTS = 2560
PBT_MINIBATCH = NUM_BPTT_CHUNKS * PBT_TRAIN_AGENTS // NUM_MINIBATCHES


def _pbt_actor_critic(seed, rnn="lstm", critic="dense", fused=False,
                      separate=False, flagship=False, dtype=None,
                      window=None, channels=CHANNELS, ln_kernel=False):
    """The headline's MLP + LSTM in bf16 (or ``dtype``: headline_fp16's
    model in float16) over the duel's 2 obs; with ``window``
    headline_window's WindowAttentionMemory(256, window, WINDOW_HEADS) in
    the LSTM's place; with ``rnn="gru"`` GRU(256, 256, 1) in its place, with
    ``critic`` "dreamer" or "hlgauss_two_part" that distributional critic
    in the dense critic's place, with ``fused`` the headline_fused tower
    (``use_fused_step`` and ``fuse_input_proj``, as
    ``_small_actor_critic(fused=True)`` builds it), with ``separate`` an
    MLP 2 x 256 -> LSTM 256 tower for the actor and another for the
    critic (headline_separate's ``BackboneSeparate``); with ``flagship``
    the flagship's model (``_flagship_actor_critic`` at its published
    width) over the duel's obs as entity sets (``_entity_env``); with
    ``channels`` another width of the MLP, the recurrence and the heads
    (512: infer_bench.py's; 32: a width the recurrent kernels are not
    built for, JAX's jnp-twin route); with ``ln_kernel`` each MLP LayerNorm
    replaced after construction by ``LayerNorm(use_kernel=True)`` with the
    same parameters (JAX's ``MLP`` has no such option: the kernel
    LayerNorm's population is built here)."""
    import torch
    from madrona_learn_tpu_torch.config import DiscreteActionsConfig
    from madrona_learn_tpu_torch.models import (
        GRU, LSTM, MLP, ActorCritic, BackboneSeparate, BackboneShared,
        DenseLayerCritic, DenseLayerDiscreteActor, DictActor,
        DreamerV3Critic, HLGaussTwoPartCritic, LayerNorm,
        RecurrentBackboneEncoder, WindowAttentionMemory)

    dtype = dtype or torch.bfloat16
    if flagship:
        return _flagship_actor_critic(dtype, 128, 256, 4, CHANNELS, seed)
    gen = torch.Generator().manual_seed(seed)

    def tower():
        net = MLP(2, channels, 2, dtype, generator=gen)
        if ln_kernel:
            for i in range(net.num_layers):
                old = getattr(net, f"LayerNorm_{i}")
                new = LayerNorm(channels, dtype, use_kernel=True)
                new.load_state_dict(old.state_dict())
                setattr(net, f"LayerNorm_{i}", new)
        if window is not None:
            recurrence = WindowAttentionMemory(channels, window,
                                               WINDOW_HEADS, dtype,
                                               generator=gen)
        elif fused:
            recurrence = LSTM(channels, channels, 1, dtype, generator=gen,
                              fuse_input_proj=True)
        else:
            recurrence = {"lstm": LSTM, "gru": GRU}[rnn](
                channels, channels, 1, dtype, generator=gen)
        return RecurrentBackboneEncoder(net=net, rnn=recurrence,
                                        use_fused_step=fused)

    prefix = lambda obs: torch.cat([obs["time"], obs["acc"]], -1)
    backbone = (BackboneSeparate(prefix, tower(), tower()) if separate
                else BackboneShared(prefix=prefix, encoder=tower()))
    actor = DictActor({"move": DenseLayerDiscreteActor(
        DiscreteActionsConfig(actions_num_buckets=[5]), channels, dtype,
        generator=gen)})
    critics = {
        "dense": lambda: DenseLayerCritic(channels, dtype, generator=gen),
        "dreamer": lambda: DreamerV3Critic(channels, dtype),
        "hlgauss_two_part": lambda: HLGaussTwoPartCritic.create(channels,
                                                                dtype)}
    return ActorCritic(backbone=backbone, actor=actor,
                       critic=critics[critic]())


def _duel_scores(er):
    """(team 0, team 1) scores from the winning team (-1: a draw)."""
    import torch

    winner = er[0]
    a = torch.where(winner == 0, 1.0, torch.where(winner == 1, 0.0, 0.5))
    return a, 1.0 - a


def _pbt_policy(**model):
    """The obs cast to the model's dtype."""
    import torch
    import madrona_learn_tpu_torch as mlt

    return mlt.Policy(
        actor_critic=lambda seed: _pbt_actor_critic(seed, **model),
        obs_preprocess=mlt.ObservationsCaster.create(
            dtype=model.get("dtype") or torch.bfloat16),
        get_episode_scores=_duel_scores)


def _duel_env():
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_duel_env

    return make_duel_env(ToyEnvConfig(
        num_worlds=NUM_WORLDS, episode_len=32, num_teams=2, team_size=1,
        seed=0), device="cuda")


def build_headline_pbt(hooks, restore_ckpt=None, custom_policy_ids=(),
                       sim_fns=None, **model):
    """BASELINE config #4 as ``benchmarks/profile_pbt.py`` builds it; from
    checkpoint ``restore_ckpt`` if given, with ``custom_policy_ids`` over
    ``sim_fns`` (the duel) if given; ``model`` picks the recurrence, the
    critic and the dtype (``_pbt_actor_critic``), a distributional critic
    under its TrainConfig flag, a float16 model with
    ``compute_dtype=float16`` (dynamic loss scaling). The flagship
    (``flagship=True``) plays the duel through its entity sets, with its
    action space and critic."""
    import torch
    import madrona_learn_tpu_torch as mlt

    sp, cp, pp = PBT_PORTIONS
    flagship = model.get("flagship", False)
    if flagship and sim_fns is None:
        sim_fns = _entity_env(_duel_env(), keys=("time", "acc"), width=2)
    buckets = FLAGSHIP_BUCKETS if flagship else [5]
    cfg = mlt.TrainConfig(
        num_worlds=NUM_WORLDS, num_agents_per_world=2,
        actions={"move": mlt.DiscreteActionsConfig(
            actions_num_buckets=buckets)},
        steps_per_update=STEPS_PER_UPDATE, num_bptt_chunks=NUM_BPTT_CHUNKS,
        lr=mlt.ParamExplore(base=1e-3, min_scale=0.1, max_scale=10.0,
                            log10_scale=True),
        gamma=0.99, gae_lambda=0.95, seed=0, metrics_buffer_size=1,
        algo=mlt.PPOConfig(num_epochs=1, minibatch_size=PBT_MINIBATCH,
                           clip_coef=CLIP_COEF, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        pbt=mlt.PBTConfig(num_teams=2, team_size=1,
                          num_train_policies=PBT_TRAIN,
                          num_past_policies=PBT_PAST, self_play_portion=sp,
                          cross_play_portion=cp, past_play_portion=pp,
                          # As tests/test_pbt_e2e.py: the cull then copies
                          # whenever the top policy is not below the
                          # bottom one, so the copy checks run.
                          policy_overwrite_threshold=0.5),
        dreamer_v3_critic=flagship or model.get("critic") == "dreamer",
        hlgauss_critic=model.get("critic") == "hlgauss_two_part",
        compute_dtype=model.get("dtype") or torch.bfloat16,
        custom_policy_ids=list(custom_policy_ids))
    return mlt.init_training(
        "cuda", cfg, sim_fns or _duel_env(), _pbt_policy(**model),
        torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks, restore_ckpt=restore_ckpt)


class _AssignmentChecks:
    """While ``active``, checks the assignments after every rollout step
    (wrapping the rollout's ``pbt_update_matchmaking``) on the device,
    folding the results into ``ok`` without a host synchronization
    (``verify`` reads them), and counts the per-policy loop's ``[P]`` host
    copies (``_PolicyRows``, one a step there; none on the chunked path).
    With ``route_pending`` set, the first step of the next chunked rollout
    loop that starts past step 0 is also checked for which policy ran
    which rows (``check_routes``)."""

    NAMES = ("self-play block constant", "team 0 of cross play kept",
             "team 0 of past play kept", "cross opponents in [0, 8)",
             "cross opponents differ from team 0",
             "past opponents in [8, 12)", "train agents play their policy")

    def __init__(self, mgr):
        import torch
        import madrona_learn_tpu_torch.rollouts as rollouts

        self.rollouts = rollouts
        self.active = False
        self.steps_checked = 0
        self.host_copies = 0
        cfg = mgr.rollout.cfg
        self.pbt = cfg.pbt
        self.initial = mgr.rollout.policy_assignments.clone()
        self.ok = torch.ones(len(self.NAMES), dtype=torch.bool,
                             device="cuda")
        idx = rollouts._compute_sim_to_train_indices(cfg).cuda()
        if idx.shape != (PBT_TRAIN, PBT_TRAIN_AGENTS):
            raise AssertionError(f"headline_pbt: train agents a policy "
                                 f"{tuple(idx.shape)}")
        self.train_idx = idx
        self.policy_ids = torch.arange(PBT_TRAIN, device="cuda")[:, None]
        self.update = rollouts.pbt_update_matchmaking
        self.rows = rollouts._PolicyRows
        self.loop = rollouts.chunked_rollout_loop
        self.route_pending = False
        self.route_report = None
        checks = self

        def update(assignments, dones, generator, mm_cfg):
            out = checks.update(assignments, dones, generator, mm_cfg)
            if checks.active:
                checks.check(out)
            return out

        class CountedRows(self.rows):
            def __init__(self, *args):
                super().__init__(*args)
                checks.host_copies += 1

        def loop(rollout_state, population, num_steps, post_inference_cb,
                 post_step_cb, cb_state, start_step_idx=0, **kwargs):
            if checks.route_pending and start_step_idx > 0:
                checks.route_pending = False
                rnn = rollout_state.rnn_states
                assignments = rollout_state.policy_assignments
                value_fn = kwargs.get("value_fn", rollouts._value_estimate)
                emit = post_inference_cb

                def post_inference_cb(step_idx, obs, pre, out, state):
                    if step_idx == start_step_idx:
                        checks.check_routes(population, rnn, assignments,
                                            pre, out["critic"], value_fn)
                    return emit(step_idx, obs, pre, out, state)
            return checks.loop(rollout_state, population, num_steps,
                               post_inference_cb, post_step_cb, cb_state,
                               start_step_idx=start_step_idx, **kwargs)

        rollouts.pbt_update_matchmaking = update
        rollouts._PolicyRows = CountedRows
        rollouts.chunked_rollout_loop = loop

    def restore(self):
        self.rollouts.pbt_update_matchmaking = self.update
        self.rollouts._PolicyRows = self.rows
        self.rollouts.chunked_rollout_loop = self.loop

    def check_routes(self, population, rnn, assignments, pre, values,
                     value_fn):
        """Every row's value at this step is its own policy's: each
        policy's module runs over all rows (T = 1, the state before the
        step) and row i is read from policy ``assignments[i]``'s output.
        The check must be able to fail: the rows of every policy, read
        from the next policy's output instead, must lie more than twice
        the tolerance away. The launches made here are not counted."""
        import torch
        from madrona_learn_tpu_torch.ops.cuda import KERNELS

        saved = [(k, k.launches, k.tc_launches) for k in KERNELS]
        num_policies = PBT_TRAIN + PBT_PAST
        with torch.no_grad():
            outs = torch.stack([value_fn(population[q].actor_critic
                                         .critic_only(rnn, pre)[0]["critic"])
                                for q in range(num_policies)]).float()
        for k, launches, tc_launches in saved:
            k.launches, k.tc_launches = launches, tc_launches
        a = assignments.long()
        rows = torch.arange(a.shape[0], device=a.device)
        values = values.float()
        err = float((outs[a, rows] - values).abs().max())
        wrong = (outs[(a + 1) % num_policies, rows] - values).abs()
        sep = [float(wrong[a == p].max()) for p in range(num_policies)]
        tol = TOL[("fwd", "bfloat16")]["atol"]
        self.route_report = (err, min(sep))
        log(f"  rows by policy at one rollout step: max |value - its "
            f"policy's| {err:.3e} (tolerance {tol}); read from the next "
            f"policy, each policy's rows would differ by at least "
            f"{min(sep):.3e}")
        if not err <= tol:
            raise AssertionError(f"headline_pbt: a row's value is not its "
                                 f"policy's ({err:.3e} > {tol})")
        if not min(sep) > 2 * tol:
            raise AssertionError(f"headline_pbt: the routing check cannot "
                                 f"tell the policies apart ({sep})")

    def check(self, a):
        import torch

        pbt = self.pbt
        self_end = pbt.self_play_batch_size
        cross_end = self_end + pbt.cross_play_batch_size
        past_end = cross_end + pbt.past_play_batch_size
        init = self.initial
        cross = a[self_end:cross_end].reshape(-1, 2)
        past = a[cross_end:past_end].reshape(-1, 2)
        init_cross = init[self_end:cross_end].reshape(-1, 2)
        init_past = init[cross_end:past_end].reshape(-1, 2)
        self.ok &= torch.stack([
            (a[:self_end] == init[:self_end]).all(),
            (cross[:, 0] == init_cross[:, 0]).all(),
            (past[:, 0] == init_past[:, 0]).all(),
            ((cross[:, 1] >= 0) & (cross[:, 1] < PBT_TRAIN)).all(),
            (cross[:, 1] != cross[:, 0]).all(),
            ((past[:, 1] >= PBT_TRAIN)
             & (past[:, 1] < PBT_TRAIN + PBT_PAST)).all(),
            (a[self.train_idx] == self.policy_ids).all()])
        self.steps_checked += 1

    def verify(self):
        failed = [name for name, ok in zip(self.NAMES, self.ok.tolist())
                  if not ok]
        if failed:
            raise AssertionError(f"headline_pbt: assignments: {failed} "
                                 f"failed within {self.steps_checked} "
                                 f"steps")


def pbt_phase(card):
    """headline_pbt (phase 11 of the module docstring)."""
    import torch
    import madrona_learn_tpu_torch as mlt
    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    gc.collect()
    torch.cuda.empty_cache()
    timer = _phase_timer()
    mgr = build_headline_pbt(timer)
    checks = _AssignmentChecks(mgr)
    try:
        return _pbt_phase(card, mgr, timer, checks)
    finally:
        checks.restore()


def _pbt_phase(card, mgr, timer, checks):
    import torch
    import madrona_learn_tpu_torch as mlt
    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    trials, timed_updates = 2, 5
    num_updates = 1 + trials * timed_updates
    _log_population_path("headline_pbt", mgr.rollout.cfg)
    if not mgr.rollout.cfg.policy_chunked:
        raise AssertionError("headline_pbt: the population does not take "
                             "the policy-chunk layout")
    log(f"  headline_pbt: the population learns "
        f"{'batched' if mgr.batched_learn else 'on the per-policy loop'} "
        f"(init_training's rule, rollouts.batched_learn_missing)")
    if not mgr.batched_learn:
        raise AssertionError("headline_pbt: the population does not take "
                             "the batched learn")
    per_update = {k.name: 0 for k in KERNELS}
    per_update.update({
        "gae": 1,
        # Collect, in the policy-chunk layout: one batched pass a rollout
        # step over every chunk, and one batched critic_only over the
        # train policies' rows for the bootstrap value. Each runs the LSTM
        # recurrence once, on the chunk-indexed kernel; grouped_matmul runs
        # every product: the MLP's two Dense layers, the LSTM's input
        # projection, the actor's head and the critic's (5 a step), the
        # bootstrap without the actor's head (4).
        # Learn, batched: one sequence forward and backward a minibatch
        # over every train policy, each policy's minibatch one chunk of the
        # chunk-indexed kernels (the MLP's and heads' products in torch.bmm,
        # no grouped_matmul); no single-policy LSTM kernel.
        "lstm_sequence_fwd_chunked": STEPS_PER_UPDATE + 1 + NUM_MINIBATCHES,
        "lstm_sequence_bwd_chunked": NUM_MINIBATCHES,
        "grouped_matmul": 5 * STEPS_PER_UPDATE + 4})
    agents = NUM_WORLDS * 2
    log(f"headline_pbt trainer: {NUM_WORLDS} worlds x 2 agents, "
        f"{PBT_TRAIN} train + {PBT_PAST} past policies, portions "
        f"{PBT_PORTIONS}, T={STEPS_PER_UPDATE} in "
        f"{NUM_BPTT_CHUNKS} chunks, bf16, {NUM_MINIBATCHES} minibatches of "
        f"{PBT_MINIBATCH} a policy; expected launches per update "
        f"{ {k: v for k, v in per_update.items() if v} }")
    lrs = [float(ts.hyper_params.lr) for ts in mgr.state.train_states]
    log(f"  learning rates drawn: {[f'{lr:.3e}' for lr in lrs]}")
    if len(set(lrs)) != PBT_TRAIN or not all(1e-4 <= lr <= 1e-2
                                             for lr in lrs):
        raise AssertionError(f"headline_pbt: learning rates {lrs}")

    losses, rewards = [], []

    def one_update():
        mgr.update_iter()
        stats = mgr.first_minibatch_stats
        losses.append(torch.stack([s["loss"] for s in stats]))
        rewards.append(mgr.metrics.latest("Rewards").mean.mean())

    for k in KERNELS:
        k.launches = 0
        k.tc_launches = 0
    torch.cuda.reset_peak_memory_stats()
    # Every training step's assignments are checked, on the device, and
    # the warm-up's second BPTT chunk's first step for the rows each
    # policy ran.
    checks.active = True
    checks.route_pending = True
    t0 = time.perf_counter()
    one_update()
    torch.cuda.synchronize()
    checks.verify()
    if checks.route_report is None:
        raise AssertionError("headline_pbt: the routing check did not run")
    log(f"  warm-up update: {time.perf_counter() - t0:.3f} s")
    ratios = [s["max_abs_ratio_dev"].item()
              for s in mgr.first_minibatch_stats]
    log(f"  first update, first minibatch, max |ratio - 1| by train "
        f"policy: {[f'{r:.3e}' for r in ratios]} (the rollout's products "
        f"round in grouped_matmul, learn's in cuBLAS's batched products; "
        f"both pass the recurrence through the chunk-indexed kernels)")
    if not all(r < PBT_RATIO_DEV for r in ratios):
        raise AssertionError(f"headline_pbt: first-minibatch max |ratio - "
                             f"1| {ratios} not all below {PBT_RATIO_DEV}")

    trial_s = []
    copies_before = checks.host_copies
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_updates):
            one_update()
        torch.cuda.synchronize()
        trial_s.append(time.perf_counter() - t0)
        for metric, m in mgr.metrics.metrics.items():
            if not bool(torch.isfinite(m.mean).all()):
                raise AssertionError(f"headline_pbt: metric {metric} is "
                                     f"not finite")
    copies_per_update = ((checks.host_copies - copies_before)
                         / (trials * timed_updates))
    launches = {k.name: k.launches for k in KERNELS}
    tc_launches = {k.name: k.tc_launches for k in KERNELS
                   if k.name in TC_ROUTED}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_hist = torch.stack(losses).float().cpu()
    if not bool(torch.isfinite(loss_hist).all()):
        raise AssertionError(f"headline_pbt: non-finite loss: "
                             f"{loss_hist.tolist()}")
    for kernel, per in per_update.items():
        if launches[kernel] != per * num_updates:
            raise AssertionError(
                f"headline_pbt: {kernel}: {launches[kernel]} launches over "
                f"{num_updates} updates, expected {per * num_updates}")
    for kernel, tc in tc_launches.items():
        if tc != launches[kernel]:
            raise AssertionError(
                f"headline_pbt: {kernel}: {tc} of {launches[kernel]} "
                f"launches on the tensor-core route")
    log(f"  launches over {num_updates} updates: "
        f"{ {k: v for k, v in launches.items() if v} }, all on the "
        f"tensor-core route where it exists")
    checks.verify()
    log(f"  [P] host copies a collect: {copies_per_update:.1f} (the "
        f"chunked path's layout stays on the device); assignments held "
        f"after each of {checks.steps_checked} steps")
    if copies_per_update:
        raise AssertionError("headline_pbt: the chunked path copied "
                             "policy counts to the host")
    counts = torch.bincount(mgr.rollout.policy_assignments.long(),
                            minlength=PBT_TRAIN + PBT_PAST)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        counts.tolist()
    log(f"  one [P] host copy alone, the stream idle: "
        f"{(time.perf_counter() - t0) * 1e4:.1f} us")
    sps = [timed_updates * STEPS_PER_UPDATE * agents / s for s in trial_s]
    log(f"  trials: "
        f"{[f'{s * 1e3 / timed_updates:.1f} ms/update' for s in trial_s]}")
    log(f"  headline_pbt agent-steps/s (best of {trials}x{timed_updates}): "
        f"{max(sps):.0f} on {card}")
    log(f"  peak device memory: {peak_gib:.2f} GiB")
    log(f"  mean reward by update (zero-sum, logged only): "
        f"{[round(float(r), 4) for r in rewards]}")

    timer.active = True
    for _ in range(3):
        one_update()
    timer.mark("end")
    timer.active = False
    spans = {}
    for (span, t), (_, t_next) in zip(timer.marks, timer.marks[1:]):
        spans.setdefault(span, []).append((t_next - t) * 1e3)
    log(f"  phase split (ms, synchronized): "
        f"{ {k: [round(v, 2) for v in vs] for k, vs in spans.items()} }")
    _profile_update(one_update)

    # The tournament's static matchmaking has its own invariants.
    checks.active = False
    checks.verify()
    ab = _pbt_collect_ab(card, mgr)
    ab.update(_pbt_learn_ab(card, mgr))
    zeros = torch.zeros((1,), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr, deltas = mlt.eval_elo(mgr, PBT_EVAL_STEPS, zeros, zeros)
    torch.cuda.synchronize()
    elos = mgr.state.policy_states.mmr.elo
    log(f"  eval_elo over {PBT_EVAL_STEPS} steps: "
        f"{time.perf_counter() - t0:.3f} s, Elo "
        f"{[round(e, 2) for e in elos.tolist()]}")
    if not bool(torch.isfinite(elos).all()) or float(elos[0]) != 1500.0:
        raise AssertionError(f"headline_pbt: Elo {elos.tolist()}")
    if mgr.rollout.cfg.pbt.self_play_portion != PBT_PORTIONS[0] or \
            mgr.rollout.cfg.pbt.static_play_portion != 0.0:
        raise AssertionError("headline_pbt: training portions not "
                             "restored after eval_elo")

    population = mgr.state.policy_states
    gens = [ts.generator for ts in mgr.state.train_states]
    mlt.update_population(mgr)
    log(f"  update_population copies (source, destination): "
        f"{mgr.population_copies}")
    if not any(dst < PBT_TRAIN for _, dst in mgr.population_copies):
        raise AssertionError("headline_pbt: the cull copied nothing")
    # A copy's source is not written after it is read (the past snapshot
    # may read the cull's destination), so it still holds what it gave.
    for src, dst in mgr.population_copies:
        source = dict(population[src].actor_critic.named_parameters())
        for name, p in population[dst].actor_critic.named_parameters():
            if not torch.equal(p, source[name]):
                raise AssertionError(f"headline_pbt: copy {src} -> {dst}: "
                                     f"{name} not bitwise the source's")
        if dst < PBT_TRAIN:
            ts = mgr.state.train_states[dst]
            if ts.generator is not gens[dst] or not math.isfinite(
                    float(ts.hyper_params.lr)):
                raise AssertionError(f"headline_pbt: copy {src} -> {dst}: "
                                     f"generator or lr")
    # Training goes on from the restored matchmaking.
    checks.active = True
    one_update()
    checks.verify()
    log(f"  assignments held after each of {checks.steps_checked} training "
        f"steps")
    return launches, dict(sps=max(sps), ratio_dev=max(ratios),
                          peak_gib=peak_gib, mgr=mgr, **ab)


# The first minibatch's max |ratio - 1| a headline_pbt train policy may
# show: the rollout's products round in grouped_matmul and learn's in
# cuBLAS, each once to bf16, so a logit may differ by a bf16 ulp.
PBT_RATIO_DEV = 1e-3


def _pbt_learn_ab(card, mgr, force=None):
    """One update's learn of the trained population, from one collect's
    rollout data and copies of one learn state: batched (the stacks,
    ``ppo._ppo_population``, the write-back) and on the per-policy loop
    (``ppo._ppo`` a train policy), each timed (synchronized) with its
    launches by kernel, the batched one once more under the profiler (the
    loop's ~20,000-90,000 launches are no longer traced, as in
    ``_pbt_collect_ab``); then the largest parameter difference between
    the two. The learn state (the loss
    scalers' too) is restored after.

    With ``force`` (a train policy, float16 populations), each path runs
    once, unprofiled, with that policy's loss scale set to 2^40 first, so
    that its float16 backward overflows at every minibatch: on the
    batched path its Adam state must stay bitwise as it was, its
    parameters too where no per-step projection applies again (the
    tracked kernels and the LayerNorm affines within 1e-6 relative), its
    scale halve a minibatch; every policy's scaler must equal the loop's
    bitwise and every parameter the loop's by the usual rule."""
    import copy
    import torch
    from madrona_learn_tpu_torch.train_state import StackedTrainState

    hooks, cfg, algo = mgr.user_hooks, mgr.cfg, mgr.algo
    population = mgr.state.policy_states
    train_states = mgr.state.train_states
    P = len(train_states)
    data, _ = mgr.rollout_mgr.collect(
        mgr.state, _copy_rollout(mgr.rollout), copy.deepcopy(mgr.metrics),
        hooks.start_rollouts, hooks.finish_rollouts, hooks.rollout_metrics)

    def scaler_copy(ts):
        return (None if ts.scaler_state is None else
                {k: v.clone() for k, v in ts.scaler_state.items()})

    def snapshot():
        return [({k: v.detach().clone() for k, v in
                  population[p].actor_critic.named_parameters()},
                 copy.deepcopy(ts.opt_state), ts.generator.get_state(),
                 scaler_copy(ts))
                for p, ts in enumerate(train_states)]

    def restore(saved):
        with torch.no_grad():
            for p, (params, opt, gen, scaler) in enumerate(saved):
                for k, v in population[p].actor_critic.named_parameters():
                    v.copy_(params[k])
                train_states[p].opt_state = copy.deepcopy(opt)
                train_states[p].generator.set_state(gen)
                if scaler is not None:
                    train_states[p].scaler_state = {
                        k: v.clone() for k, v in scaler.items()}
                    if p == force:
                        train_states[p].scaler_state["scale"].fill_(2.0 ** 40)

    start = snapshot()

    def learn(path, metrics):
        if path == "batched":
            stacked = StackedTrainState.stack(population.policies[:P],
                                              train_states)
            algo.update_population(cfg, stacked, data,
                                   hooks.optimize_metrics, metrics)
            stacked.write_back()
        else:
            for p in range(P):
                algo.update(cfg, population[p], train_states[p],
                            data.policy(p), hooks.optimize_metrics,
                            metrics.for_policy(p))

    def fresh():
        """The learn state restored, and a copy of the metrics."""
        restore(start)
        return copy.deepcopy(mgr.metrics)

    out, after = {}, {}
    for path in ("batched", "per-policy loop"):
        if force is None:
            learn(path, fresh())   # warm-up
        metrics = fresh()
        _zero_launch_counts()
        _, ms = _timed(lambda: learn(path, metrics))
        launches = {k: v for k, v in _launch_counts()[0].items() if v}
        after[path] = snapshot()
        if force is not None or path != "batched":
            out[path] = dict(learn_ms=ms, launches=launches)
            log(f"  learn ({path}): {ms:.1f} ms, launches {launches} on "
                f"{card}")
            continue
        metrics = fresh()
        _, n, busy_ms, wall_ms = _count_launches(
            lambda: learn(path, metrics))
        out[path] = dict(learn_ms=ms, launches=launches, kernel_ms=busy_ms,
                         all_launches=n, profiled_wall_ms=wall_ms)
        log(f"  learn ({path}): {ms:.1f} ms, launches {launches}; "
            f"profiled: {n} launches, kernels {busy_ms:.1f} ms of "
            f"{wall_ms:.1f} ms on {card}")
    force, forced = None, force
    restore(start)
    diff = max((a[k].float() - b[k].float()).abs().max().item()
               for (a, *_), (b, *_) in zip(after["batched"],
                                           after["per-policy loop"])
               for k in a)
    moved = max((a[k].float() - b[k].float()).abs().max().item()
                for (a, *_), (b, *_) in zip(after["per-policy loop"], start)
                for k in a)
    speedup = out["per-policy loop"]["learn_ms"] / out["batched"]["learn_ms"]
    what = ("" if forced is None
            else f" (train policy {forced}'s scale forced to 2^40)")
    log(f"  learn{what}, batched vs per-policy loop: largest parameter "
        f"difference {diff:.3e} (the loop moved a parameter by up to "
        f"{moved:.3e}); learn ms, per-policy loop / batched: "
        f"{speedup:.2f}")
    # Adam's first steps are about lr * sign(g): where a gradient is near
    # 0, bf16 products in another order may flip its sign, and the entry
    # moves the other way; never more than twice the largest move.
    if not math.isfinite(diff) or diff > 2 * moved:
        raise AssertionError(f"headline_pbt: the batched learn and the "
                             f"per-policy loop differ by {diff}, more than "
                             f"twice the loop's largest move ({moved})")
    if forced is None:
        return dict(learn_ab=dict(out, max_param_diff=diff,
                                  max_param_move=moved))
    _check_forced_nonfinite(forced, train_states[forced], start[forced],
                            after)
    return dict(nonfinite_ab=dict(out, policy=forced, max_param_diff=diff,
                                  max_param_move=moved))


def _check_forced_nonfinite(p, train_state, start, after):
    """``_pbt_learn_ab``'s checks of policy p, whose scale was 2^40 at the
    start of the learn (``start``: its parameters, Adam state, generator
    and scaler before; ``after``: every policy's after each path)."""
    import torch

    params0, opt0, _, _ = start
    params, opt, _, scaler = after["batched"][p]
    new = dict(_tree_leaves(vars(opt)))
    for name, v in _tree_leaves(vars(opt0)):
        if not torch.equal(v, new[name]):
            raise AssertionError(f"forced non-finite policy {p}: Adam "
                                 f"{name} changed")
    projected = set(train_state.initial_weight_norms)
    worst = 0.0
    for name, v in params0.items():
        if name in projected or "LayerNorm" in name:
            rel = ((params[name] - v).abs().max()
                   / v.abs().max().clamp(min=1e-30)).item()
            worst = max(worst, rel)
            if not rel <= 1e-6:
                raise AssertionError(f"forced non-finite policy {p}: {name} "
                                     f"moved by {rel:.3e} of its largest "
                                     f"value")
        elif not torch.equal(params[name], v):
            raise AssertionError(f"forced non-finite policy {p}: {name} "
                                 f"changed")
    want_scale = 2.0 ** 40 * 0.5 ** NUM_MINIBATCHES
    if float(scaler["scale"]) != want_scale or int(scaler["fin_steps"]):
        raise AssertionError(f"forced non-finite policy {p}: scaler "
                             f"{ {k: v.item() for k, v in scaler.items()} }, "
                             f"expected scale {want_scale} and fin_steps 0")
    for q, (b, l) in enumerate(zip(after["batched"],
                                   after["per-policy loop"])):
        for k in b[3]:
            if not torch.equal(b[3][k], l[3][k]):
                raise AssertionError(f"policy {q}: scaler {k} "
                                     f"{b[3][k].item()} batched, "
                                     f"{l[3][k].item()} on the loop")
    log(f"  forced non-finite policy {p} (scale 2^40 before the learn): "
        f"Adam state bitwise kept, parameters bitwise kept (the projected "
        f"ones within {worst:.1e} relative), scale {want_scale:.0f} after "
        f"{NUM_MINIBATCHES} minibatches; every policy's scaler bitwise the "
        f"loop's ok")


def _count_launches(fn):
    """fn's kernel launches and kernel ms (torch.profiler) and its wall
    ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    ops = {e.key for e in rows if e.device_type == DeviceType.CPU}
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key not in ops]
    busy_ms = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
                  for e in kernels) / 1e3
    return out, sum(e.count for e in kernels), busy_ms, wall_ms


def pbt_variant_phase(card, name, model, per_update, timed_updates,
                      collect_ab, final_check=None, gmm_tc=None):
    """headline_pbt's population with another model (``model``, the
    keywords of ``_pbt_actor_critic``): it must take the policy-chunk
    layout and the batched learn; one warm-up update, whose first
    minibatch's max |ratio - 1| must stay below PBT_RATIO_DEV for every
    train policy, and ``timed_updates`` timed ones (agent-steps/s; their
    collect and the rest of the update split by CUDA events), with
    the launches exact (``per_update``, every other kernel 0), finite
    losses and metrics; then, with ``collect_ab``, the collect A/B, and
    the learn A/B (``_pbt_collect_ab``, ``_pbt_learn_ab``). Each kernel
    with a tensor-core route takes it on every launch or on none, as
    ``_tc_kernels`` says for the model's dtype and width: a float16 model
    the LSTM and GRU forwards and backwards; at 384 and 512
    (``channels``) the LSTM and GRU forwards and backwards. With
    ``gmm_tc``, ``grouped_matmul``'s tensor-core launches an update must be
    exactly that many (the products with IN and OUT multiples of 8). A
    float16 model's policies' loss scales and non-finite steps are printed
    after the updates, and the learn A/B runs again with train policy 1's
    scale forced to 2^40 (``_pbt_learn_ab(force=1)``). ``final_check(name,
    mgr)``, where given, runs last."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda import KERNELS
    from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import \
        GROUPED_MATMUL
    from madrona_learn_tpu_torch.train import TrainHooks

    gc.collect()
    torch.cuda.empty_cache()
    mgr = build_headline_pbt(TrainHooks(), **model)
    cfg = mgr.rollout.cfg
    _log_population_path(name, cfg)
    if not (cfg.policy_chunked and mgr.batched_learn):
        raise AssertionError(f"{name}: the population does not take the "
                             f"policy-chunk layout and the batched learn")
    expected = {k.name: 0 for k in KERNELS}
    expected.update(per_update)
    dtype = model.get("dtype") or torch.bfloat16
    half = dtype == torch.float16
    # Every kernel with a tensor-core route takes it where _tc_kernels says.
    tensor_cores = _tc_kernels(dtype, model.get("channels", CHANNELS))
    log(f"{name} trainer: headline_pbt's population with {model}, "
        f"{str(dtype).split('.')[-1]}; expected launches per update "
        f"{ {k: v for k, v in expected.items() if v} }")
    _zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mgr.update_iter()
    torch.cuda.synchronize()
    log(f"  warm-up update: {time.perf_counter() - t0:.3f} s")
    ratios = [s["max_abs_ratio_dev"].item()
              for s in mgr.first_minibatch_stats]
    log(f"  first update, first minibatch, max |ratio - 1| by train "
        f"policy: {[f'{r:.3e}' for r in ratios]}")
    if not all(r < PBT_RATIO_DEV for r in ratios):
        raise AssertionError(f"{name}: first-minibatch max |ratio - 1| "
                             f"{ratios} not all below {PBT_RATIO_DEV}")
    losses = [torch.stack([s["loss"] for s in mgr.first_minibatch_stats])]
    # Each timed update's split on the card's clock: an event as the update
    # starts, one as its collect returns, one as it ends.
    events = []

    def mark():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    collect = mgr.rollout_mgr.collect

    def marked_collect(*args, **kwargs):
        out = collect(*args, **kwargs)
        mark()
        return out

    mgr.rollout_mgr.collect = marked_collect
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_updates):
        mark()
        mgr.update_iter()
        mark()
        losses.append(torch.stack([s["loss"]
                                   for s in mgr.first_minibatch_stats]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del mgr.rollout_mgr.collect
    collect_ms = sum(events[k].elapsed_time(events[k + 1])
                     for k in range(0, len(events), 3)) / timed_updates
    learn_ms = sum(events[k + 1].elapsed_time(events[k + 2])
                   for k in range(0, len(events), 3)) / timed_updates
    num_updates = 1 + timed_updates
    launches = _check_launches(
        f"{name} over {num_updates} updates",
        {k: v * num_updates for k, v in expected.items()}, tensor_cores)
    if gmm_tc is not None:
        if GROUPED_MATMUL.tc_launches != gmm_tc * num_updates:
            raise AssertionError(
                f"{name}: grouped_matmul: {GROUPED_MATMUL.tc_launches} "
                f"launches on tensor cores over {num_updates} updates, "
                f"expected {gmm_tc * num_updates}")
        log(f"  grouped_matmul on tensor cores: "
            f"{GROUPED_MATMUL.tc_launches} of "
            f"{launches['grouped_matmul']} launches, {gmm_tc} an update "
            f"(the products with IN and OUT multiples of 8)")
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError(f"{name}: non-finite loss")
    for metric, m in mgr.metrics.metrics.items():
        if not bool(torch.isfinite(m.mean).all()):
            raise AssertionError(f"{name}: metric {metric} is not finite")
    sps = timed_updates * STEPS_PER_UPDATE * 2 * NUM_WORLDS / seconds
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {name} agent-steps/s ({timed_updates} updates, "
        f"{seconds * 1e3 / timed_updates:.1f} ms/update): {sps:.0f} on "
        f"{card}; peak {peak_gib:.2f} GiB")
    if half:
        scales = [(ts.scaler_state["scale"].item(),
                   int(s["nonfinite_steps"]))
                  for ts, s in zip(mgr.state.train_states,
                                   mgr.first_minibatch_stats)]
        log(f"  loss scale and the last update's non-finite steps by train "
            f"policy: {scales}")
    ab = _pbt_collect_ab(card, mgr) if collect_ab else {}
    ab.update(_pbt_learn_ab(card, mgr))
    update_ms = seconds * 1e3 / timed_updates
    ab["split"] = dict(update_ms=update_ms, collect_ms=collect_ms,
                       learn_ms=learn_ms)
    log(f"  {name} update split ({timed_updates} timed updates, CUDA "
        f"events): {update_ms:.1f} ms an update on the host's clock; "
        f"collect {collect_ms:.1f} ms, learn and the rest {learn_ms:.1f} "
        f"ms on the card's, on {card}")
    if half:
        ab.update(_pbt_learn_ab(card, mgr, force=1))
    if final_check is not None:
        final_check(name, mgr)
    return launches, dict(sps=sps, ratio_dev=max(ratios), peak_gib=peak_gib,
                          **ab)


def entity_large_set_check(card):
    """The flagship net (EntitySelfAttentionNet(128, 256, 4 heads), bf16)
    of a population of 3 over LARGE_SET's entities (511 with self: padded
    to 512, past 256, so mha_flash): its ``chunked`` form over 6 chunks of
    64 rows in a shuffled order, one of them of no policy (index 3), and
    its ``batched`` form over the 3 policies' 128 rows, forward and
    backward, with the launches counted: ``mha_flash_fwd`` 2,
    ``mha_flash_bwd_dkdv`` and ``_dq`` 1 each, ``grouped_matmul`` 9 (the
    chunked form's 3 embeds, q, k, v, out, ff_0 and ff_1), every other
    kernel 0. Each chunk's and policy's output against its policy's own
    forward on the card within check_routes' tolerance (3.2e-2), the chunk
    of no policy all NaN, the gradients finite."""
    import types

    import torch
    from madrona_learn_tpu_torch.models import EntitySelfAttentionNet
    from madrona_learn_tpu_torch.models.common import StackedParams

    P, C = 3, 64
    order = [2, 0, P, 1, 2, 0]
    gen = torch.Generator().manual_seed(23)
    nets = [EntitySelfAttentionNet(ENTITY_OBS, 128, 256, 4, torch.bfloat16,
                                   generator=gen).cuda() for _ in range(P)]
    # LayerNorm affines and attention biases moved off their init.
    with torch.no_grad():
        for net in nets:
            for name, param in net.named_parameters():
                if "LayerNorm" in name or name.endswith("bias"):
                    param.add_(0.3 * torch.randn(param.shape,
                                                 generator=gen).cuda())

    def obs(*lead):
        return {k: torch.randn(*lead, *([LARGE_SET[k]] if k in LARGE_SET
                                        else []), w, generator=gen).cuda()
                for k, w in ENTITY_OBS.items()}

    idx = torch.tensor(order, dtype=torch.int32, device="cuda")
    layout = types.SimpleNamespace(chunk_policy=idx,
                                   chunk_index=idx.clamp(max=P - 1).long())
    chunk_obs, policy_obs = obs(len(order), C), obs(P, 2 * C)
    leaves = {k: v.requires_grad_() for k, v in
              StackedParams.of(nets).leaves.items()}
    _zero_launch_counts()
    with torch.no_grad():
        chunked = nets[0].chunked(StackedParams.of(nets), layout, chunk_obs)
    batched = nets[0].batched(StackedParams(leaves), policy_obs)
    grads = torch.autograd.grad(batched.float().square().mean(),
                                list(leaves.values()))
    torch.cuda.synchronize()
    launches = _check_launches(
        "entity_large_set", {"mha_flash_fwd": 2, "mha_flash_bwd_dkdv": 1,
                             "mha_flash_bwd_dq": 1, "grouped_matmul": 9})
    tol = TOL[("fwd", "bfloat16")]["atol"]
    errs = []
    with torch.no_grad():
        for b, p in enumerate(order):
            if p == P:
                if not bool(torch.isnan(chunked[b]).all()):
                    raise AssertionError("entity_large_set: a chunk of no "
                                         "policy gave numbers")
                continue
            want = nets[p]({k: v[b] for k, v in chunk_obs.items()})
            errs.append(float((chunked[b].float() - want.float()).abs()
                              .max()))
        for p in range(P):
            want = nets[p]({k: v[p] for k, v in policy_obs.items()})
            errs.append(float((batched[p].float() - want.float()).abs()
                              .max()))
    if not all(e <= tol for e in errs):
        raise AssertionError(f"entity_large_set: max |form - its policy's "
                             f"forward| {errs} (tolerance {tol})")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("entity_large_set: non-finite gradients")
    log(f"entity_large_set: flagship net, 3 policies, 511 entities "
        f"(mha_flash): max |form - its policy's forward| by chunk, then by "
        f"policy {[f'{e:.3e}' for e in errs]} (tolerance {tol}); the chunk "
        f"of no policy NaN; gradients finite on {card}")
    return launches


def _pbt_collect_ab(card, mgr):
    """One collect of the trained population, from copies of one rollout
    state and of the metrics, through the chunked path, through the
    per-policy loop (``population_rollout_loop`` called in the chunked
    loop's place: the same collect, store and bootstrap around it) and
    with ``chunkwise_rnn`` on: each timed (synchronized), the chunked
    collect once more under the profiler for its launches and kernel
    time. The chunkwise collect must give the chunked one's rollout data
    bitwise. (The profiler's processing takes ~0.6 ms a launch on the
    host, so the per-policy loop's ~35,000-90,000 launches a collect are
    no longer traced: its launches are in PERF.md from earlier runs.)"""
    import copy
    import torch
    import madrona_learn_tpu_torch.rollouts as rollouts

    env = "MADRONA_LEARN_TPU_CHUNKWISE_RNN"
    hooks = mgr.user_hooks
    start = _copy_rollout(mgr.rollout)
    chunked_loop = rollouts.chunked_rollout_loop

    def per_policy_loop(rollout_state, population, *args, stack=None,
                        chunkwise_rnn=False, **kwargs):
        return rollouts.population_rollout_loop(rollout_state, population,
                                                *args, **kwargs)

    def collect(path):
        os.environ[env] = "1" if path == "chunkwise" else "0"
        rollouts.chunked_rollout_loop = (per_policy_loop
                                         if path == "per-policy loop"
                                         else chunked_loop)
        try:
            state = _copy_rollout(start)
            data, _ = mgr.rollout_mgr.collect(
                mgr.state, state, copy.deepcopy(mgr.metrics),
                hooks.start_rollouts, hooks.finish_rollouts,
                hooks.rollout_metrics)
            return data.all(), state
        finally:
            rollouts.chunked_rollout_loop = chunked_loop
            os.environ.pop(env, None)

    agents = 2 * NUM_WORLDS
    out = {}
    runs = {}
    for path in ("chunked", "per-policy loop", "chunkwise"):
        collect(path)   # warm-up
        runs[path], ms = _timed(lambda: collect(path))
        out[path] = dict(collect_ms=ms,
                         agent_steps_per_s=STEPS_PER_UPDATE * agents / ms
                         * 1e3)
        msg = (f"  collect through the {path}: {ms:.1f} ms "
               f"({out[path]['agent_steps_per_s']:.0f} agent-steps/s)")
        if path == "chunked":
            _, n, busy_ms, wall_ms = _count_launches(lambda: collect(path))
            out[path].update(launches_per_step=n / STEPS_PER_UPDATE,
                             kernel_ms=busy_ms, profiled_wall_ms=wall_ms,
                             idle=1 - busy_ms / wall_ms)
            msg += (f"; profiled: {n} launches ({n / STEPS_PER_UPDATE:.0f} "
                    f"a collect step), kernels {busy_ms:.1f} ms of "
                    f"{wall_ms:.1f} ms, idle {out[path]['idle']:.1%}")
        log(f"{msg} on {card}")
    (data, state), (want, want_state) = runs["chunkwise"], runs["chunked"]
    for name, x in _tree_leaves(want):
        if not torch.equal(x, dict(_tree_leaves(data))[name]):
            raise AssertionError(f"headline_pbt: chunkwise_rnn changed the "
                                 f"rollout data's {name}")
    for (_, x), (_, y) in zip(_tree_leaves(state.rnn_states),
                              _tree_leaves(want_state.rnn_states)):
        if not torch.equal(x, y):
            raise AssertionError("headline_pbt: chunkwise_rnn changed the "
                                 "recurrent state")
    log(f"  chunkwise_rnn on: rollout data and recurrent state bitwise "
        f"the chunked collect's ok")
    ratio = (out["per-policy loop"]["collect_ms"]
             / out["chunked"]["collect_ms"])
    log(f"  collect ms, per-policy loop / chunked: {ratio:.2f}")
    return dict(collect_ab=out)


# checkpoint_eval: the eval steps of the headline's checkpoint, of the
# competitive eval and of the custom-policy tournament.
CKPT_EVAL_STEPS = 64
COMPETITIVE_EVAL_STEPS = 32
CUSTOM_EVAL_STEPS = 32
CUSTOM_ID, CUSTOM_BID = 100, 2
# The resumed update must equal the uninterrupted one bitwise: every
# kernel of the update is deterministic at fixed shapes on one card (the
# checks of phase 3: bitwise weight gradients over two calls, batch
# invariance), and the resume restores every input of the update.


def _log_population_path(what, cfg):
    """Which rollout path a population's phase runs (init_training's
    rule), and the chunk layout's sizes."""
    log(f"  {what}: the population runs "
        + (f"the policy-chunk layout (chunked_rollout_loop), chunks of "
           f"{cfg.policy_chunk_size} rows, {cfg.num_policy_chunks} chunks"
           if cfg.policy_chunked else
           "the per-policy loop (population_rollout_loop)"))


def _chunked_step_launches(steps):
    """The launches of ``steps`` steps of the headline's MLP + LSTM in the
    policy-chunk layout, whatever the policies and chunks: one batched
    pass a step, its recurrence one chunk-indexed forward and its five
    products (the MLP's two Dense layers, the LSTM's input projection, the
    actor's and the critic's heads) grouped_matmul's."""
    return {"lstm_sequence_fwd_chunked": steps, "grouped_matmul": 5 * steps}


def _launch_counts():
    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    return ({k.name: k.launches for k in KERNELS},
            {k.name: k.tc_launches for k in KERNELS if k.name in TC_ROUTED})


def _zero_launch_counts():
    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    for k in KERNELS:
        k.launches = 0
        k.tc_launches = 0


def _check_launches(what, expected, tensor_cores=TC_ROUTED):
    """The launches since the counts were last zeroed must be
    ``expected`` (the others 0), every launch of a kernel named in
    ``tensor_cores`` on the tensor-core route and none of the other
    kernels' (``_tc_kernels``: at 384 / 512 the LSTM forwards alone);
    returns them."""
    launches, tc = _launch_counts()
    want = {name: expected.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{ {k: v for k, v in want.items() if v} }")
    for name, n in tc.items():
        if n != (launches[name] if name in tensor_cores else 0):
            raise AssertionError(f"{what}: {name}: {n} of "
                                 f"{launches[name]} launches on the "
                                 f"tensor-core route")
    on_tc = sorted(k for k in tensor_cores if launches[k])
    log(f"  {what}: launches {({k: v for k, v in launches.items() if v})}"
        f", on tensor cores: {on_tc or 'none'}")
    return launches


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix, tree


def _check_restored(what, got, want):
    """Every tensor (and generator state) and scalar of two checkpoint
    trees bitwise equal."""
    import torch

    got, want = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: restored entries differ: "
                             f"{sorted(set(got) ^ set(want))[:8]}")
    tensors = 0
    for name, w in want.items():
        g = got[name]
        if isinstance(w, torch.Tensor):
            tensors += 1
            same = g.dtype == w.dtype and torch.equal(g, w)
        else:
            same = g == w
        if not same:
            raise AssertionError(f"{what}: {name} not restored bitwise")
    log(f"  {what}: {tensors} tensors and {len(want) - tensors} scalars "
        f"restored bitwise, generator states included")


def _copy_rollout(rollout):
    """A deep copy of a rollout state, its generator's state included."""
    import copy
    import dataclasses
    import torch

    generator = torch.Generator(device=rollout.generator.device)
    generator.set_state(rollout.generator.get_state())
    state = copy.deepcopy(dataclasses.replace(rollout, generator=None))
    return dataclasses.replace(state, generator=generator)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _fixed_bid_duel():
    """The duel, with every row assigned ``CUSTOM_ID`` bidding
    ``CUSTOM_BID``: the custom policy that the simulator plays."""
    import torch

    env = _duel_env()
    step = env["step"]

    def fixed_step(step_input):
        move = step_input["actions"]["move"]
        assignments = step_input["pbt"]["policy_assignments"].reshape(
            move.shape[0], 1)
        move = torch.where(assignments == CUSTOM_ID, CUSTOM_BID, move)
        return step(dict(step_input, actions={"move": move}))

    return dict(env, step=fixed_step)


def checkpoint_eval_phase(card, pbt_mgr):
    """checkpoint_eval (phase 12 of the module docstring); returns the
    launches of its runs on the main path."""
    import shutil

    ckpt_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "_checkpoint_smoke")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        return _checkpoint_eval_phase(card, pbt_mgr, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def _checkpoint_eval_phase(card, pbt_mgr, ckpt_root):
    import torch
    import madrona_learn_tpu_torch as mlt
    import madrona_learn_tpu_torch.rollouts as rollouts
    from madrona_learn_tpu_torch.train import TrainHooks

    gc.collect()
    torch.cuda.empty_cache()
    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    # (a) headline resume.
    headline_dir = os.path.join(ckpt_root, "headline")
    mgr = build_headline(TrainHooks())
    for _ in range(3):
        mgr.update_iter()
    _, save_ms = _timed(lambda: mgr.save_ckpt(headline_dir))
    path = mlt.latest_checkpoint(headline_dir)
    saved = mgr.state.checkpoint(mgr.update_idx)
    rollout = _copy_rollout(mgr.rollout)
    log(f"checkpoint_eval: headline checkpoint after the warm-up and 2 "
        f"updates: {os.path.getsize(path)} bytes, saved in {save_ms:.1f} "
        f"ms on {card}")
    mgr.update_iter()
    want = {name: p.detach().clone() for name, p in
            mgr.state.policy_states.actor_critic.named_parameters()}
    resumed = build_headline(TrainHooks(), restore_ckpt=path)
    if resumed.update_idx != 3 or resumed.metrics.update_idx != 3:
        raise AssertionError(f"checkpoint_eval: resumed at update "
                             f"{resumed.update_idx}, not 3")
    _check_restored("headline", resumed.state.checkpoint(3), saved)
    _, load_ms = _timed(lambda: resumed.load_ckpt(path))
    log(f"  headline load_ckpt: {load_ms:.1f} ms")
    resumed.rollout = rollout
    steps = STEPS_PER_UPDATE + 1 + NUM_MINIBATCHES
    _zero_launch_counts()
    resumed.update_iter()
    add(_check_launches("resumed update", {
        "gae": 1, "lstm_sequence_fwd": steps,
        "lstm_sequence_bwd": NUM_MINIBATCHES}))
    got = {name: p.detach() for name, p in
           resumed.state.policy_states.actor_critic.named_parameters()}
    delta = max(float((got[n].float() - w.float()).abs().max())
                for n, w in want.items())
    differ = [n for n, w in want.items() if not torch.equal(got[n], w)]
    log(f"  resumed update against the uninterrupted one: parameters max "
        f"|delta| {delta:.3e}, {len(want) - len(differ)} of {len(want)} "
        f"bitwise equal")
    if differ:
        raise AssertionError(f"checkpoint_eval: the resumed update is not "
                             f"bitwise the uninterrupted one: {differ[:4]}, "
                             f"max |delta| {delta}")
    del mgr, resumed, rollout

    # (b) headline eval: the deterministic policy, twice.
    eval_cfg = mlt.EvalConfig(
        num_worlds=NUM_WORLDS, num_teams=1, team_size=1,
        num_eval_steps=CKPT_EVAL_STEPS,
        actions={"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        reward_gamma=0.99, policy_dtype=torch.bfloat16,
        eval_competitive=False)
    runs = []
    for run in range(2):
        states, n = mlt.eval_load_ckpt(_headline_policy(), path)
        actions = []

        def step_cb(step_data):
            actions.append(step_data["actions"]["move"].clone())
            return step_data["sim_state"]

        _zero_launch_counts()
        result, ms = _timed(lambda: mlt.eval_policies(
            "cuda", eval_cfg, _toy_env(), _headline_policy(),
            torch.zeros((1,), dtype=torch.int32, device="cuda"), states,
            step_cb))
        # eval_policies takes the policy-chunk layout (one chunk here):
        # the chunk-indexed forward once a step, grouped_matmul for the
        # five products of a step.
        add(_check_launches(f"headline eval run {run + 1} "
                            f"({CKPT_EVAL_STEPS} steps)",
                            _chunked_step_launches(CKPT_EVAL_STEPS)))
        runs.append(torch.stack(actions))
        log(f"  headline eval run {run + 1}: {NUM_WORLDS} worlds x "
            f"{CKPT_EVAL_STEPS} steps in {ms:.1f} ms: "
            f"{NUM_WORLDS * CKPT_EVAL_STEPS / ms * 1e3:.0f} eval "
            f"env-steps/s on {card}")
    if n != 1 or result.tolist() != [0.0]:
        raise AssertionError(f"checkpoint_eval: headline eval of {n} "
                             f"policies returned {result.tolist()}")
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("checkpoint_eval: two deterministic evals "
                             "gave different actions")
    log(f"  two headline evals: actions [steps, worlds, heads] "
        f"{tuple(runs[0].shape)} bitwise equal")
    del runs

    # (c) headline_pbt checkpoint.
    pbt_dir = os.path.join(ckpt_root, "headline_pbt")
    _, save_ms = _timed(lambda: pbt_mgr.save_ckpt(pbt_dir))
    path = mlt.latest_checkpoint(pbt_dir)
    saved = pbt_mgr.state.checkpoint(pbt_mgr.update_idx)
    log(f"  headline_pbt checkpoint ({PBT_TRAIN} + {PBT_PAST} policies): "
        f"{os.path.getsize(path)} bytes, saved in {save_ms:.1f} ms on "
        f"{card}")
    fresh = build_headline_pbt(TrainHooks(), restore_ckpt=path)
    _check_restored("headline_pbt", fresh.state.checkpoint(
        pbt_mgr.update_idx), saved)
    _, load_ms = _timed(lambda: fresh.load_ckpt(path))
    log(f"  headline_pbt load_ckpt: {load_ms:.1f} ms")
    del fresh

    # (d) competitive eval of the train policies.
    states, n = mlt.eval_load_ckpt(_pbt_policy(), path, train_only=True)
    if n != PBT_TRAIN or len(states) != PBT_TRAIN:
        raise AssertionError(f"checkpoint_eval: eval_load_ckpt gave {n} "
                             f"policies")
    competitive = mlt.EvalConfig(
        num_worlds=NUM_WORLDS, num_teams=2, team_size=1,
        num_eval_steps=COMPETITIVE_EVAL_STEPS,
        actions={"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        reward_gamma=0.99, policy_dtype=torch.bfloat16,
        eval_competitive=True)
    path = rollouts.chunked_path_missing(states[0].actor_critic,
                                         states[0].obs_preprocess)
    path = ("the policy-chunk layout" if path is None
            else "the per-policy loop")
    log(f"  competitive eval: the population runs {path} (eval_policies, "
        f"init_training's rule)")
    _zero_launch_counts()
    mmr, ms = _timed(lambda: mlt.eval_policies(
        "cuda", competitive, _duel_env(), _pbt_policy(),
        torch.zeros((1,), dtype=torch.int32, device="cuda"), states,
        lambda step_data: step_data["sim_state"]))
    add(_check_launches(
        f"competitive eval ({COMPETITIVE_EVAL_STEPS} steps)",
        _chunked_step_launches(COMPETITIVE_EVAL_STEPS)))
    log(f"  competitive eval: {NUM_WORLDS} worlds x 2 agents x "
        f"{COMPETITIVE_EVAL_STEPS} steps in {ms:.1f} ms "
        f"({2 * NUM_WORLDS * COMPETITIVE_EVAL_STEPS / ms * 1e3:.0f} "
        f"agent-steps/s), Elo {mmr.elo.tolist()} on {card}")
    if mmr.elo.tolist() != [1500.0] * PBT_TRAIN:
        raise AssertionError(f"checkpoint_eval: competitive eval Elo "
                             f"{mmr.elo.tolist()}")
    del states

    # (e) a custom policy in the Elo tournament.
    mgr = build_headline_pbt(TrainHooks(), custom_policy_ids=[CUSTOM_ID],
                             sim_fns=_fixed_bid_duel())
    _log_population_path(f"tournament with custom policy {CUSTOM_ID}",
                         mgr.rollout.cfg)
    zeros = torch.zeros((1,), dtype=torch.int32, device="cuda")
    _zero_launch_counts()
    (mgr, deltas), ms = _timed(lambda: mlt.eval_elo(
        mgr, CUSTOM_EVAL_STEPS, zeros, zeros))
    add(_check_launches(
        f"tournament with custom policy {CUSTOM_ID} "
        f"({CUSTOM_EVAL_STEPS} steps)",
        _chunked_step_launches(CUSTOM_EVAL_STEPS)))
    elos = mgr.state.policy_states.mmr.elo
    log(f"  tournament with custom policy {CUSTOM_ID}: {ms:.1f} ms, Elo "
        f"{[round(e, 2) for e in elos.tolist()]}")
    if not bool(torch.isfinite(elos).all()) or float(elos[0]) != 1500.0 \
            or not bool(torch.isfinite(deltas).all()):
        raise AssertionError(f"checkpoint_eval: custom-policy Elo "
                             f"{elos.tolist()}")
    return total


# tools: the trainer's tools on the card at the headline's width.
# Ranges whose split the phase prints: the update's top-level ones, then
# the collect's and the learn's inner ones.
TOP_RANGES = ("Collect Rollouts", "Update Observations Stats", "Learn")
INNER_RANGES = ("Policy Inference", "Obs Preprocess", "Policy Apply",
                "Pre Step Rollout Store", "Rollout Step", "Sim Step",
                "Post Step Rollout Store", "Cache RNN state",
                "Bootstrap Values", "Finalize Rollouts",
                "Compute Minibatch Indices", "Gather Minibatch", "Optimize",
                "AC Forward", "rnn.fwd_sequence", "Record Metrics",
                "Metrics Callback")
# (kernel, substring of its CUDA function's name, the ranges it may run
# in): the recurrence's forward runs in the rollout steps, the bootstrap
# value and every minibatch, its backward and gae once each phase.
RANGE_KERNELS = (("lstm_sequence_fwd", "lstm_fwd", ("Collect Rollouts",
                                                    "Learn")),
                 ("lstm_sequence_bwd", "lstm_bwd", ("Learn",)),
                 ("gae", "gae_kernel", ("Collect Rollouts",)))
TOOLS_PAIRS = 5
TOOLS_UPDATES = 3


def tools_phase(card):
    """tools (phase 14 of the module docstring); returns the launches of
    its profiled update."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_tools_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _tools_phase(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _range_split(prof):
    """Per named range: its occurrences, wall ms (their CPU intervals) and
    device ms (the device work launched inside those intervals); and, per
    kernel of ``RANGE_KERNELS``, the top-level ranges its launches fall
    in. A device event is matched to its launch, a CUDA runtime call, by
    CUPTI's correlation id: the kernels launched from the port's library
    outside any PyTorch op (the rollout step's recurrence, ``gae``) are
    linked to no op, and the backward's launch from autograd's device
    thread. Also returns the count of device events whose launch was not
    found (placed after the device work before them), the positions in
    launch order of the kernel launches whose device event is not in the
    trace, and the count of all device events."""
    from torch.autograd import DeviceType

    events = prof.events()
    names = ("Update Iter",) + TOP_RANGES + INNER_RANGES
    spans = {name: [] for name in names}
    launched_at = {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("cu"):  # cudaLaunchKernel, cudaMemcpyAsync
            launched_at[e.id] = e.time_range.start
    # One stream runs the update, so device order is launch order: work
    # whose launch was not found takes the launch time of the work before
    # it on the device.
    # The ranges' own device-side annotations are not work.
    device_work = (e for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.name not in spans)
    work, last = [], None
    for e in sorted(device_work, key=lambda e: e.time_range.start):
        t = launched_at.get(e.id)
        work.append((t if t is not None else last, e, t is None))
        last = t if t is not None else last

    def inside(t, intervals):
        return t is not None and any(s <= t <= u for s, u in intervals)

    split = {}
    for name, intervals in spans.items():
        device_us = sum(e.time_range.end - e.time_range.start
                        for t, e, _ in work if inside(t, intervals))
        split[name] = dict(
            count=len(intervals),
            wall_ms=sum(u - s for s, u in intervals) / 1e3,
            device_ms=device_us / 1e3)
    placed = {}
    for kernel, pattern, _ in RANGE_KERNELS:
        where = {}
        for t, e, _ in work:
            if pattern in e.name:
                homes = [r for r in TOP_RANGES if inside(t, spans[r])]
                key = (homes[0] if len(homes) == 1 else
                       "no launch found" if t is None else "outside")
                where[key] = where.get(key, 0) + 1
        placed[kernel] = where
    unmatched = sum(inferred for _, _, inferred in work)
    # Kernel launches whose device work is not in the trace: records the
    # profiler lost.
    worked = {e.id for _, e, _ in work}
    launches = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.name.startswith(("cudaLaunch", "cuLaunch"))),
                      key=lambda e: e.time_range.start)
    lost = [i for i, e in enumerate(launches) if e.id not in worked]
    return split, placed, unmatched, lost, len(work)


def _tools_profiled_update(mgr, expected):
    """One update under torch.profiler: every range present, the three
    kernels in their ranges, the split printed; returns the launches."""
    # A trace of ~10,000 kernels now and then lacks one of them (seen once
    # in a run of this script on an H100: 37 launches counted, 36 in the
    # trace). A trace that holds fewer launches of a kernel than its count
    # is taken again, and three such traces in a row fail; a launch
    # outside its ranges, or more in the trace than counted, fails at
    # once.
    for attempt in range(3):
        launches, split, short = _tools_trace_update(mgr, expected)
        if not short:
            return launches, split
        log(f"  (trace {attempt + 1} of 3 lacks launches: {short})")
    raise AssertionError(f"tools: three traces in a row lack launches: "
                         f"{short}")


def _tools_trace_update(mgr, expected):
    """One traced update; returns its launches, its split, and the kernels
    of ``RANGE_KERNELS`` with fewer launches in the trace than counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    # A trace can lack device records (a whole script's run on an H100
    # lost ~80 launches' in each of three traces in a row, one counted
    # lstm_sequence_fwd among them), so the profiler first traces one
    # update and discards it (its warm-up step), then traces the one
    # checked here; the lost launches' positions are printed.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        mgr.update_iter()
        torch.cuda.synchronize()
        prof.step()
        _zero_launch_counts()
        t0 = time.perf_counter()
        mgr.update_iter()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    launches = _check_launches("profiled update", expected)
    split, placed, unmatched, lost, device_events = _range_split(prof)
    missing = [n for n, r in split.items() if not r["count"]]
    if missing:
        raise AssertionError(f"tools: ranges missing from the trace: "
                             f"{missing}")
    where = (f", launches {lost[0]}-{lost[-1]} of the update's" if lost
             else "")
    log(f"  ranges of one update (profiler on, {wall_ms:.1f} ms wall, "
        f"{device_events} device events, {unmatched} with no launch "
        f"found, {len(lost)} launches with no device event{where}): device "
        f"ms / wall ms / occurrences")
    for name in ("Update Iter",) + TOP_RANGES + INNER_RANGES:
        r = split[name]
        log(f"    {name:28s} {r['device_ms']:9.3f} {r['wall_ms']:9.3f} "
            f"{r['count']:5d}")
    short = {}
    for kernel, _, homes in RANGE_KERNELS:
        where = placed[kernel]
        log(f"  {kernel} kernels by range: {where}")
        if set(where) - set(homes) or \
                sum(where.values()) > launches[kernel]:
            raise AssertionError(
                f"tools: {kernel}: {launches[kernel]} launches, in the "
                f"trace {where}; expected only in {homes}")
        if sum(where.values()) < launches[kernel]:
            short[kernel] = (launches[kernel], where)
    return launches, split, short


def _tools_sps(mgr, card):
    """Env-steps/s with the ranges enabled and disabled, no profiler
    active, ``TOOLS_PAIRS`` alternating pairs of ``TOOLS_UPDATES``
    updates."""
    import torch
    from madrona_learn_tpu_torch.utils.profile import profile

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TOOLS_UPDATES):
            mgr.update_iter()
        torch.cuda.synchronize()
        return (TOOLS_UPDATES * STEPS_PER_UPDATE * NUM_WORLDS
                / (time.perf_counter() - t0))

    if torch.autograd._profiler_enabled():
        raise AssertionError("tools: a profiler is active")
    sps = {"enabled": [], "disabled": []}
    try:
        for pair in range(TOOLS_PAIRS):
            for state in (("enabled", "disabled") if pair % 2 == 0
                          else ("disabled", "enabled")):
                (profile.enable if state == "enabled"
                 else profile.disable)()
                sps[state].append(run())
    finally:
        profile.enable()
    med = {k: statistics.median(v) for k, v in sps.items()}
    log(f"  env-steps/s with the ranges enabled "
        f"{[round(x) for x in sps['enabled']]} (median "
        f"{med['enabled']:.0f}), disabled "
        f"{[round(x) for x in sps['disabled']]} (median "
        f"{med['disabled']:.0f}): enabled / disabled "
        f"{med['enabled'] / med['disabled']:.4f}, {TOOLS_PAIRS} alternating "
        f"pairs of {TOOLS_UPDATES} updates on {card}")
    return med


COLLECT_RANGES = ("Collect Rollouts", "Policy Inference", "Obs Preprocess",
                  "Policy Apply", "Pre Step Rollout Store", "Rollout Step",
                  "Sim Step", "Post Step Rollout Store", "Cache RNN state",
                  "Bootstrap Values", "Finalize Rollouts")


def _tools_range_cost(split, sps):
    """The host's cost of one range, entered and left with no profiler
    active (NVTX pushed: CUDA is initialized), and of the ranges of one
    update and of its collect, against the update's time at the median
    env-steps/s with the ranges enabled."""
    from madrona_learn_tpu_torch.utils.profile import profile

    calls = 100000

    def us_a_range():
        t0 = time.perf_counter()
        for _ in range(calls):
            with profile("Sim Step"):
                pass
        return (time.perf_counter() - t0) / calls * 1e6

    enabled = us_a_range()
    profile.disable()
    disabled = us_a_range()
    profile.enable()
    ranges = sum(r["count"] for r in split.values())
    collect = sum(split[name]["count"] for name in COLLECT_RANGES)
    update_ms = STEPS_PER_UPDATE * NUM_WORLDS / sps["enabled"] * 1e3
    log(f"  a range costs the host {enabled:.3f} us enabled, "
        f"{disabled:.3f} us disabled (no profiler); {ranges} ranges an "
        f"update ({collect} in collect): {ranges * enabled / 1e3:.3f} ms "
        f"an update ({collect * enabled / 1e3:.3f} ms in collect), "
        f"{100 * ranges * enabled / 1e3 / update_ms:.2f}% of the "
        f"{update_ms:.1f} ms update")


def _tools_snapshot(mgr):
    """The gridworld's snapshot of the headline's rollout, restored after
    an update: pos / target / t and the obs bitwise, on the card."""
    import torch

    rollout = mgr.rollout
    ckpts = rollout.get_current_checkpoints()
    if not (ckpts.is_cuda and ckpts.dtype == torch.int32
            and tuple(ckpts.shape) == (NUM_WORLDS, 5)):
        raise AssertionError(f"tools: snapshot {ckpts.dtype} "
                             f"{tuple(ckpts.shape)} on {ckpts.device}")
    state = {k: v.clone() for k, v in rollout.sim_state.items()}
    obs = {k: v.clone() for k, v in rollout.cur_obs.items()}
    mgr.update_iter()
    moved = not torch.equal(rollout.sim_state["pos"], state["pos"])
    rollout.load_checkpoints_into_sim(ckpts)
    for k in ("pos", "target", "t"):
        if not torch.equal(rollout.sim_state[k], state[k]):
            raise AssertionError(f"tools: snapshot {k} not restored")
    for k, v in obs.items():
        if not torch.equal(rollout.cur_obs[k], v):
            raise AssertionError(f"tools: snapshot obs {k} not restored")
    if rollout.sim_state["tick"].any() or not torch.equal(
            rollout.sim_state["rid"][:, 0],
            torch.arange(NUM_WORLDS, device="cuda", dtype=torch.int32)):
        raise AssertionError("tools: restored rid / tick are not "
                             "arange / 0")
    log(f"  snapshot of {NUM_WORLDS} worlds restored bitwise after an "
        f"update (the update moved the agents: {moved})")


def _tools_tensorboard(mgr, root):
    """A real update's metrics through ``log_metrics_tensorboard``, read
    back by the port's reader (every CRC checked): every tag, step and
    float32 value."""
    import numpy as np
    import madrona_learn_tpu_torch as mlt
    from madrona_learn_tpu_torch.utils.tensorboard import read_events

    writer = mlt.TensorboardWriter(os.path.join(root, "tb"))
    mgr.log_metrics_tensorboard(writer)
    writer.close()

    class Recorder:
        def __init__(self):
            self.calls = []

        def scalar(self, tag, value, step):
            self.calls.append((tag, int(step),
                               np.float32(np.asarray(value)).tobytes()))

    recorder = Recorder()
    mgr.metrics.tensorboard_log(mgr.update_idx - 1, recorder)
    read = [(v["tag"], e["step"], np.float32(v["simple_value"]).tobytes())
            for e in read_events(writer.path)[1:] for v in e["values"]]
    if read != recorder.calls or not read:
        raise AssertionError(f"tools: {len(read)} scalars read back, "
                             f"{len(recorder.calls)} logged, not equal")
    values = [np.frombuffer(v, np.float32)[0] for _, _, v in read]
    if not np.isfinite(values).all():
        raise AssertionError("tools: a logged metric is not finite")
    log(f"  tensorboard_log: {len(read)} scalars of update "
        f"{mgr.update_idx} read back bitwise, "
        f"{os.path.getsize(writer.path)} bytes")


def _tools_examples(root):
    """``examples/torch_train_toy.py`` (3 updates, TensorBoard and a
    checkpoint) and ``examples/torch_evaluate.py`` of that checkpoint,
    both at their default sizes on the card."""
    import importlib.util
    import math as pymath
    from madrona_learn_tpu_torch.utils.tensorboard import read_events

    examples = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples")
    sys.path.insert(0, examples)
    try:
        def load(name):
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(examples, f"{name}.py"))
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module

        t0 = time.perf_counter()
        mgr = load("torch_train_toy").main([
            "--num-updates", "3", "--tb-dir", os.path.join(root, "ex_tb"),
            "--ckpt-dir", os.path.join(root, "ex_ckpt")])
        train_s = time.perf_counter() - t0
        (name,) = os.listdir(os.path.join(root, "ex_tb"))
        events = read_events(os.path.join(root, "ex_tb", name))
        t0 = time.perf_counter()
        totals = load("torch_evaluate").main([
            "--ckpt", os.path.join(root, "ex_ckpt", "3"),
            "--eval-steps", "64"])
        eval_s = time.perf_counter() - t0
    finally:
        sys.path.remove(examples)
    if mgr.update_idx != 3 or len(events) < 2 or not all(
            pymath.isfinite(v) for v in totals.values()):
        raise AssertionError(f"tools: examples: update {mgr.update_idx}, "
                             f"{len(events)} events, {totals}")
    log(f"  examples: torch_train_toy.py 3 updates {train_s:.2f} s "
        f"({len(events) - 1} scalar events), torch_evaluate.py 64 steps "
        f"{eval_s:.2f} s ({totals['episodes']} episodes)")


def _tools_eval_elo(card):
    """The first and the second ``eval_elo`` of a fresh headline_pbt
    population after one update: the first call's extra cost decides
    whether a warm-up is worth porting."""
    import torch
    import madrona_learn_tpu_torch as mlt
    from madrona_learn_tpu_torch.train import TrainHooks

    gc.collect()
    torch.cuda.empty_cache()
    mgr = build_headline_pbt(TrainHooks())
    mgr.update_iter()
    zeros = torch.zeros((1,), dtype=torch.int32, device="cuda")
    ms = []
    for _ in range(2):
        _, t = _timed(lambda: mlt.eval_elo(mgr, PBT_EVAL_STEPS, zeros,
                                           zeros))
        ms.append(t)
    elos = mgr.state.policy_states.mmr.elo
    if not bool(torch.isfinite(elos).all()) or float(elos[0]) != 1500.0:
        raise AssertionError(f"tools: Elo {elos.tolist()}")
    log(f"  eval_elo over {PBT_EVAL_STEPS} steps at headline_pbt "
        f"({PBT_TRAIN} + {PBT_PAST} policies): first {ms[0]:.1f} ms, "
        f"second {ms[1]:.1f} ms, first - second {ms[0] - ms[1]:.1f} ms "
        f"on {card}")
    return ms


def _tools_phase(card, root):
    import torch
    from madrona_learn_tpu_torch.train import TrainHooks

    log(f"tools: the headline ({NUM_WORLDS} worlds, bf16) with the named "
        f"ranges, snapshots, TensorBoard, the examples and eval_elo")
    gc.collect()
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    mgr = build_headline(TrainHooks())
    mgr.update_iter()
    steps = STEPS_PER_UPDATE + 1 + NUM_MINIBATCHES
    launches, split = _tools_profiled_update(
        mgr, {"gae": 1, "lstm_sequence_fwd": steps,
              "lstm_sequence_bwd": NUM_MINIBATCHES})
    sps = _tools_sps(mgr, card)
    _tools_range_cost(split, sps)
    _tools_snapshot(mgr)
    _tools_tensorboard(mgr, root)
    del mgr
    _tools_examples(root)
    eval_elo_ms = _tools_eval_elo(card)
    log(f"  tools phase: {time.perf_counter() - phase_t0:.1f} s")
    return launches, dict(split=split, sps=sps, eval_elo_ms=eval_elo_ms)


def check_value_normalizer(mgr, updates_run, update_stats):
    """headline_valuenorm: the value normalizer's state is finite, folded
    in once a minibatch, and moved from its initial mu = 0, sigma = 1."""
    import torch

    state = mgr.state.train_states.value_normalizer_state
    text = {k: [round(x, 6) for x in v.float().reshape(-1).tolist()]
            for k, v in state.items()}
    log(f"  value normalizer after {updates_run} updates: {text}")
    for k, v in state.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"value normalizer {k} is not finite: "
                                 f"{text[k]}")
    if int(state["N"]) != updates_run * NUM_MINIBATCHES:
        raise AssertionError(f"value normalizer N = {int(state['N'])}, "
                             f"expected {updates_run * NUM_MINIBATCHES}")
    if not (bool((state["mu"] != 0).all())
            and bool((state["sigma"] != 1).all())):
        raise AssertionError(f"value normalizer did not move: {text}")


def check_importance(mgr, updates_run, update_stats):
    """headline_importance: every update's first epoch drew, from the
    sequences of its own rollout, 2 minibatches of distinct sequences, and
    every weight is finite and positive."""
    import torch

    cfg = mgr.cfg
    num_seqs = NUM_BPTT_CHUNKS * NUM_WORLDS
    num_sampled = IMPORTANCE_MINIBATCHES * cfg.algo.minibatch_size
    counts = {u["num_minibatches"] for u in update_stats}
    if counts != {IMPORTANCE_MINIBATCHES}:
        raise AssertionError(f"importance sampling ran {counts} "
                             f"minibatches an update")
    for update, u in enumerate(update_stats):
        inds, weights = u["epoch_inds"], u["traj_weights"]
        distinct = int(torch.unique(inds).numel())
        in_range = bool(((inds >= 0) & (inds < num_seqs)).all())
        if inds.numel() != num_sampled or distinct != num_sampled \
                or not in_range:
            raise AssertionError(
                f"update {update}: importance sampling drew {distinct} "
                f"distinct of {inds.numel()} indices (want {num_sampled} "
                f"in [0, {num_seqs})), in range {in_range}")
        if weights.shape[0] != num_seqs or not (
                bool(torch.isfinite(weights).all())
                and bool((weights > 0).all())):
            raise AssertionError(f"update {update}: importance weights "
                                 f"not finite and positive")
    last = update_stats[-1]
    weights, drawn = last["traj_weights"], last["traj_weights"][
        last["epoch_inds"]]
    log(f"  importance sampling, each of {len(update_stats)} updates' first "
        f"epoch: {num_sampled} distinct of {num_seqs} sequences; the last "
        f"update's weights min {weights.min().item():.6g} mean "
        f"{weights.mean().item():.6g} max {weights.max().item():.6g}, of "
        f"the drawn min {drawn.min().item():.6g} mean "
        f"{drawn.mean().item():.6g} max {drawn.max().item():.6g}")


def check_stratified(mgr, updates_run, update_stats):
    """headline_stratified: every update's first epoch (its index stream as
    the update drew it) visits every sequence once, and every minibatch
    takes minibatch_size / 4 rows from each of the 4 blocks, block-major."""
    import torch

    mb = mgr.cfg.algo.minibatch_size
    num_seqs = NUM_BPTT_CHUNKS * NUM_WORLDS
    block_ids = torch.arange(STRATIFY, device="cuda")[None, :, None]
    for update, u in enumerate(update_stats):
        inds = u["epoch_inds"]
        blocks = (inds // (num_seqs // STRATIFY)).reshape(
            num_seqs // mb, STRATIFY, mb // STRATIFY)
        counts = torch.stack([(blocks == b).sum(dim=(1, 2))
                              for b in range(STRATIFY)], dim=1)
        block_major = bool((blocks == block_ids).all())
        visits = torch.bincount(inds, minlength=num_seqs)
        if update == 0:
            log(f"  stratified epoch: {STRATIFY} blocks of "
                f"{num_seqs // STRATIFY}; rows a block by minibatch "
                f"{counts.tolist()}, block-major {block_major}, sequences "
                f"visited once {int((visits == 1).sum())} of {num_seqs}")
        if not block_major or not bool((counts == mb // STRATIFY).all()):
            raise AssertionError(f"update {update}: stratified minibatches,"
                                 f" rows a block {counts.tolist()}, "
                                 f"block-major {block_major}")
        if visits.numel() != num_seqs or not bool((visits == 1).all()):
            raise AssertionError(f"update {update}: the stratified epoch "
                                 f"did not visit every sequence once")
    log(f"  all {len(update_stats)} updates' first epochs stratified so")


def check_filter(mgr, updates_run, update_stats):
    """mlp_filter: the max-|advantage| EMA moved once an update and every
    update ran 1 to 4 minibatches."""
    import torch

    est = mgr.state.train_states.max_advantage_est_state
    counts = [u["num_minibatches"] for u in update_stats]
    log(f"  max-|advantage| estimate after {updates_run} updates: mu "
        f"{est['mu'].item():.6g}, mu_biased {est['mu_biased'].item():.6g}, "
        f"N {int(est['N'])}")
    if int(est["N"]) != updates_run:
        raise AssertionError(f"max-|advantage| estimate N = "
                             f"{int(est['N'])}, expected {updates_run}")
    if not (bool(torch.isfinite(est["mu"]).all())
            and est["mu"].item() > 0):
        raise AssertionError(f"max-|advantage| estimate mu = {est['mu']}")
    if not all(1 <= c <= NUM_MINIBATCHES for c in counts):
        raise AssertionError(f"filtered minibatches by update: {counts}")


def check_scaler(mgr, updates_run, update_stats):
    """mlp_fp16: the loss scaler's state, the non-finite steps counted on
    the card, and finite float32 parameters. Below the growth interval the
    scale only backs off, once a non-finite step."""
    import torch

    ts = mgr.state.train_states
    state = ts.scaler_state
    nonfinite = sum(int(u["nonfinite_steps"]) for u in update_stats)
    steps = sum(u["num_minibatches"] for u in update_stats)
    scale, fin_steps = state["scale"].item(), int(state["fin_steps"])
    log(f"  loss scaler after {steps} steps: scale {scale}, fin_steps "
        f"{fin_steps}, non-finite steps {nonfinite}")
    for name, p in mgr.state.policy_states.actor_critic.named_parameters():
        if p.dtype != torch.float32 or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"parameter {name} ({p.dtype}) is not "
                                 f"finite float32")
    # The scale starts at flax's 2^16.
    if (steps < ts.scaler.growth_interval
            and scale != 2.0 ** 16 * 0.5 ** nonfinite):
        raise AssertionError(f"scale {scale} after {nonfinite} non-finite "
                             f"steps of {steps}")


def two_hot_loss_timing(card):
    """The DreamerV3 value loss (two-hot cross entropy and its gradient) at
    one minibatch of the flagship's update pass, [16, 8192] x 63 bins."""
    import torch
    from madrona_learn_tpu_torch.ops.dists import SymExpTwoHotDistribution

    T, N = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS, (
        NUM_BPTT_CHUNKS * NUM_WORLDS // NUM_MINIBATCHES)
    gen = torch.Generator(device="cuda").manual_seed(7)
    logits = torch.randn(T, N, 63, device="cuda", generator=gen,
                         requires_grad=True)
    targets = 3 * torch.randn(T, N, 1, device="cuda", generator=gen)

    def loss_fwd_bwd():
        loss = SymExpTwoHotDistribution.create(
            logits).two_hot_cross_entropy_loss(targets).mean()
        return torch.autograd.grad(loss, logits)

    log(f"two-hot loss + gradient at [{T}, {N}, 63]: "
        f"{time_ms(loss_fwd_bwd):.3f} ms on {card}")


def digest_phase():
    """``--digests``: the SHA-256 of each bf16 recurrence kernel's outputs
    (the four LSTM kernels, the two GRU kernels) and of ``mha``'s at the
    update pass's shapes, from seeded inputs, then of the other kernels
    and instances (each group from a generator of its own, so a later
    group leaves the earlier digests as they were), as one JSON line.
    Copied into another checkout and run there, it holds that checkout's
    kernels bitwise to this one's."""
    import hashlib

    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        gru_sequence_bwd, gru_sequence_fwd)
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        lstm_sequence_bwd, lstm_sequence_fwd, lstm_sequence_proj_bwd,
        lstm_sequence_proj_fwd)
    from madrona_learn_tpu_torch.ops.cuda.mha import mha_fwd

    def digest(outs):
        h = hashlib.sha256()
        for t in outs:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    T, N, F, H, bf16 = 16, 8192, 256, 256, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(11)
    xp, keep, wr, bias, c0, h0 = _lstm_inputs(gen, T, N, H, bf16)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(bf16)

    # The backwards' ys / cs are inputs like the others: drawn, not taken
    # from a forward, so that the forwards' digests do not reach them.
    ys, cs, dys = rnd(T, N, H), rnd(T, N, H), rnd(T, N, H)
    x, wi = rnd(T, N, F), rnd(F, 4 * H, scale=F ** -0.5)
    gru_args = _gru_inputs(gen, T, N, H, bf16)
    qkv = [rnd(8 * NUM_WORLDS, 16, 4, 32) for _ in range(3)]
    log(json.dumps({"digests": {
        "lstm_sequence_fwd": digest(
            lstm_sequence_fwd(xp, keep, wr, bias, c0, h0)),
        "lstm_sequence_bwd": digest(lstm_sequence_bwd(
            xp, keep, wr, bias, c0, h0, ys, cs, dys)),
        "lstm_sequence_proj_fwd": digest(
            lstm_sequence_proj_fwd(x, keep, wi, wr, bias, c0, h0)),
        "lstm_sequence_proj_bwd": digest(lstm_sequence_proj_bwd(
            x, keep, wi, wr, bias, c0, h0, ys, cs, dys)),
        "gru_sequence_fwd": digest([gru_sequence_fwd(*gru_args)]),
        "gru_sequence_bwd": digest(gru_sequence_bwd(*gru_args, ys, dys)),
        "mha": digest([mha_fwd(*qkv, 12)]),
        **_cuda_core_digests(digest),
        **_chunked_digests(digest),
        **_bwd_route_digests(digest),
        **_f16_route_digests(digest),
        **_gru_fwd_route_digests(digest),
        **_gru_wide_route_digests(digest),
    }}))


def _bwd_route_inputs(gen, dtype, H, T=16, N=None, chunks=None):
    """The LSTM backward's operands at width H: lstm_sequence_bwd's
    (x_proj, keep, wr, bias, c0, h0, ys, cs, dys) over N rows, or, with
    ``chunks``, lstm_sequence_bwd_chunked's over that many chunks of
    PBT_MINIBATCH rows, one a policy. ys / cs / dys are drawn, not taken
    from a forward."""
    import torch

    if chunks is None:
        args = list(_lstm_inputs(gen, T, N, H, dtype))
        n = N
    else:
        args = list(_chunked_lstm_inputs(gen, T, chunks, PBT_MINIBATCH, H,
                                         chunks, dtype))
        args[4] = torch.arange(chunks, dtype=torch.int32, device="cuda")
        n = chunks * PBT_MINIBATCH
    return args + [torch.randn(T, n, H, device="cuda",
                               generator=gen).to(dtype) for _ in range(3)]


def _bwd_route_digests(digest):
    """The LSTM backward's digests at its tensor-core instances beyond
    bf16 at 256, from a generator of their own: bf16 at H = 128, bf16 at
    384 and 512 (the two-block cluster) and float16 at 128 and 256 (f16
    wgmma), single-policy and chunk-indexed at headline_pbt's learn
    step."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        lstm_sequence_bwd, lstm_sequence_bwd_chunked)

    gen = torch.Generator(device="cuda").manual_seed(27)
    bf16, f16 = torch.bfloat16, torch.float16
    out = {}
    for dtype, H, N in ((bf16, 128, 2048), (bf16, 384, PBT_MINIBATCH),
                        (bf16, 512, PBT_MINIBATCH), (f16, 128, 2048),
                        (f16, 256, 8192)):
        dname = str(dtype).split(".")[-1]
        out[f"lstm_sequence_bwd {dname} H={H}"] = digest(lstm_sequence_bwd(
            *_bwd_route_inputs(gen, dtype, H, N=N)))
    for dtype, H in ((bf16, 384), (bf16, 512), (f16, 256)):
        dname = str(dtype).split(".")[-1]
        out[f"lstm_sequence_bwd_chunked {dname} H={H}"] = digest(
            lstm_sequence_bwd_chunked(*_bwd_route_inputs(
                gen, dtype, H, chunks=PBT_TRAIN)))
    return out


def _f16_route_digests(digest):
    """The float16 LSTM forward's and GRU backward's digests at H = 128 and
    256 (f16 wgmma since the float16 forward and GRU backward moved onto
    tensor cores), from a generator of their own: single-policy at
    headline_fp16's and headline_gru_fp16's update minibatch (and at 2048
    rows at 128), chunk-indexed at headline_pbt_fp16's collect step (the
    LSTM forward) and headline_pbt_gru_fp16's learn step (the GRU
    backward). The GRU backward's ys / dys are drawn, not taken from a
    forward."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        gru_sequence_bwd, gru_sequence_bwd_chunked)
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        lstm_sequence_fwd, lstm_sequence_fwd_chunked)

    gen = torch.Generator(device="cuda").manual_seed(28)
    f16, T = torch.float16, STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    P, C, B = _pbt_chunk_geometry()

    def drawn(n, H):
        return [torch.randn(T, n, H, device="cuda", generator=gen).to(f16)
                for _ in range(2)]

    out = {}
    for H, N in ((128, 2048), (256, 8192)):
        out[f"lstm_sequence_fwd float16 H={H}"] = digest(
            lstm_sequence_fwd(*_lstm_inputs(gen, T, N, H, f16)))
        out[f"gru_sequence_bwd float16 H={H}"] = digest(gru_sequence_bwd(
            *_gru_inputs(gen, T, N, H, f16), *drawn(N, H)))
    out[f"lstm_sequence_fwd_chunked float16 H={CHANNELS}"] = digest(
        lstm_sequence_fwd_chunked(*_chunked_lstm_inputs(
            gen, 1, B, C, CHANNELS, P, f16)))
    learn = list(_chunked_gru_inputs(gen, T, PBT_TRAIN, PBT_MINIBATCH,
                                     CHANNELS, PBT_TRAIN, f16))
    learn[4] = torch.arange(PBT_TRAIN, dtype=torch.int32, device="cuda")
    out[f"gru_sequence_bwd_chunked float16 H={CHANNELS}"] = digest(
        gru_sequence_bwd_chunked(*learn, *drawn(PBT_TRAIN * PBT_MINIBATCH,
                                                CHANNELS)))
    return out


def _gru_fwd_route_digests(digest):
    """The GRU forward's digests at the instances that moved onto tensor
    cores after the others' (float16 at H = 128 and 256, bf16 at 384 and
    512: the two-block cluster), from a generator of their own:
    single-policy at headline_gru_fp16's update minibatch (and at 2048 rows
    at 128), chunk-indexed at headline_pbt_gru_fp16's collect step, and at
    384 / 512 at headline_pbt's collect and learn steps."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        gru_sequence_fwd, gru_sequence_fwd_chunked)

    gen = torch.Generator(device="cuda").manual_seed(29)
    bf16, f16 = torch.bfloat16, torch.float16
    T = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    P, C, B = _pbt_chunk_geometry()
    out = {}
    for H, N in ((128, 2048), (256, 8192)):
        out[f"gru_sequence_fwd float16 H={H}"] = digest(
            [gru_sequence_fwd(*_gru_inputs(gen, T, N, H, f16))])
    out[f"gru_sequence_fwd_chunked float16 H={CHANNELS}"] = digest(
        [gru_sequence_fwd_chunked(*_chunked_gru_inputs(
            gen, 1, B, C, CHANNELS, P, f16))])
    for H in WIDE_HIDDEN:
        step = _chunked_gru_inputs(gen, 1, B, C, H, P, bf16)
        learn = list(_chunked_gru_inputs(gen, T, PBT_TRAIN, PBT_MINIBATCH, H,
                                         PBT_TRAIN, bf16))
        learn[4] = torch.arange(PBT_TRAIN, dtype=torch.int32, device="cuda")
        out[f"gru_sequence_fwd_chunked bf16 H={H} collect"] = digest(
            [gru_sequence_fwd_chunked(*step)])
        out[f"gru_sequence_fwd_chunked bf16 H={H} learn"] = digest(
            [gru_sequence_fwd_chunked(*learn)])
    return out


def _gru_wide_inputs(gen, dtype, H, T, chunks=None):
    """gru_sequence_bwd's operands at width H over one policy's
    PBT_MINIBATCH rows, or, with ``chunks``, gru_sequence_bwd_chunked's
    over that many chunks of PBT_MINIBATCH rows, one a policy; ys and dys
    drawn, not taken from a forward."""
    import torch

    if chunks is None:
        args, n = list(_gru_inputs(gen, T, PBT_MINIBATCH, H, dtype)), \
            PBT_MINIBATCH
    else:
        args = list(_chunked_gru_inputs(gen, T, chunks, PBT_MINIBATCH, H,
                                        chunks, dtype))
        args[4] = torch.arange(chunks, dtype=torch.int32, device="cuda")
        n = chunks * PBT_MINIBATCH
    return args + [torch.randn(T, n, H, device="cuda",
                               generator=gen).to(dtype) for _ in range(2)]


def _gru_wide_route_digests(digest):
    """The GRU's digests at the instances that moved onto tensor cores
    last (the backward in bf16 and float16 at H = 384 and 512, the two-block
    cluster, and the float16 forward there), from a generator of their own:
    the backward single-policy on one policy's [16, 1280] and chunk-indexed
    at headline_pbt's learn step, the float16 forward chunk-indexed at its
    collect and learn steps."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        gru_sequence_bwd, gru_sequence_bwd_chunked, gru_sequence_fwd_chunked)

    gen = torch.Generator(device="cuda").manual_seed(30)
    T = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    P, C, B = _pbt_chunk_geometry()
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[-1]
        for H in WIDE_HIDDEN:
            out[f"gru_sequence_bwd {dname} H={H}"] = digest(
                gru_sequence_bwd(*_gru_wide_inputs(gen, dtype, H, T)))
            out[f"gru_sequence_bwd_chunked {dname} H={H}"] = digest(
                gru_sequence_bwd_chunked(*_gru_wide_inputs(
                    gen, dtype, H, T, chunks=PBT_TRAIN)))
    for H in WIDE_HIDDEN:
        step = _chunked_gru_inputs(gen, 1, B, C, H, P, torch.float16)
        learn = _gru_wide_inputs(gen, torch.float16, H, T,
                                 chunks=PBT_TRAIN)[:6]
        out[f"gru_sequence_fwd_chunked float16 H={H} collect"] = digest(
            [gru_sequence_fwd_chunked(*step)])
        out[f"gru_sequence_fwd_chunked float16 H={H} learn"] = digest(
            [gru_sequence_fwd_chunked(*learn)])
    return out


def _chunked_digests(digest):
    """The chunk-indexed recurrences' digests at headline_pbt's collect
    step (T = 1, 12 policies) and learn step (T = 16, 8 policies of one
    chunk each), bf16, from a generator of their own. The GRU's are left
    out where the checkout has no chunk-indexed GRU kernels."""
    import torch
    import madrona_learn_tpu_torch.ops.cuda.gru as gru
    import madrona_learn_tpu_torch.ops.cuda.lstm as lstm
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        lstm_sequence_bwd_chunked, lstm_sequence_fwd_chunked)

    gen = torch.Generator(device="cuda").manual_seed(13)
    P, C, B = _pbt_chunk_geometry()
    H, T, bf16 = CHANNELS, STEPS_PER_UPDATE // NUM_BPTT_CHUNKS, torch.bfloat16
    learn_idx = torch.arange(PBT_TRAIN, dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf16)

    step = _chunked_lstm_inputs(gen, 1, B, C, H, P, bf16)
    learn = list(_chunked_lstm_inputs(gen, T, PBT_TRAIN, PBT_MINIBATCH, H,
                                      PBT_TRAIN, bf16))
    learn[4] = learn_idx
    ys, cs, dys = (rnd(T, PBT_TRAIN * PBT_MINIBATCH, H) for _ in range(3))
    out = {
        "lstm_sequence_fwd_chunked": digest(lstm_sequence_fwd_chunked(*step)),
        "lstm_sequence_bwd_chunked": digest(lstm_sequence_bwd_chunked(
            *learn, ys, cs, dys)),
    }
    if hasattr(gru, "gru_sequence_fwd_chunked"):
        step = _chunked_gru_inputs(gen, 1, B, C, H, P, bf16)
        learn = list(_chunked_gru_inputs(gen, T, PBT_TRAIN, PBT_MINIBATCH, H,
                                         PBT_TRAIN, bf16))
        learn[4] = learn_idx
        out["gru_sequence_fwd_chunked"] = digest(
            [gru.gru_sequence_fwd_chunked(*step)])
        out["gru_sequence_bwd_chunked"] = digest(
            gru.gru_sequence_bwd_chunked(*learn, ys, dys))
    if hasattr(lstm, "lstm_sequence_proj_fwd_chunked"):
        out.update(_fused_chunked_digests(digest))
    return out


def _fused_chunked_digests(digest):
    """The fused trunk's chunk-indexed kernels' digests, from a generator
    of their own: ``fused_policy_step_chunked`` at headline_pbt_fused's
    collect step, the projection instances at its learn step."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        lstm_sequence_proj_bwd_chunked, lstm_sequence_proj_fwd_chunked)
    from madrona_learn_tpu_torch.ops.cuda.policy_step import (
        fused_policy_step_chunked)

    gen = torch.Generator(device="cuda").manual_seed(14)
    P, C, B = _pbt_chunk_geometry()
    H, T, bf16 = CHANNELS, STEPS_PER_UPDATE // NUM_BPTT_CHUNKS, torch.bfloat16
    N = PBT_TRAIN * PBT_MINIBATCH

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(bf16)

    x, mlp, wi, wr, bias, idx, c, h = _chunked_step_inputs(
        gen, B, C, 2, H, 2, P, bf16)
    feats, (c1, h1) = fused_policy_step_chunked(x, mlp, wi, wr, bias, idx, c,
                                                h)
    learn = (rnd(T, N, H), (torch.rand(T, N, device="cuda", generator=gen)
                            > 0.2).to(bf16),
             rnd(PBT_TRAIN, H, 4 * H, scale=H ** -0.5),
             rnd(PBT_TRAIN, H, 4 * H, scale=H ** -0.5),
             rnd(PBT_TRAIN, 4 * H),
             torch.arange(PBT_TRAIN, dtype=torch.int32, device="cuda"),
             rnd(N, H), rnd(N, H))
    ys, cs, dys = (rnd(T, N, H) for _ in range(3))
    return {
        "fused_policy_step_chunked": digest([feats, c1, h1]),
        "lstm_sequence_proj_fwd_chunked": digest(
            lstm_sequence_proj_fwd_chunked(*learn)),
        "lstm_sequence_proj_bwd_chunked": digest(
            lstm_sequence_proj_bwd_chunked(*learn, ys, cs, dys)),
    }


def _ln_bwd_inputs(gen, N=131072, D=256):
    """x, w, b, mu, rsigma, dy at the update's rows in bf16, mu and rsigma
    from the forward kernel."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.layer_norm import layer_norm_fwd

    x = (2 * torch.randn(N, D, device="cuda", generator=gen)
         + 0.5).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
    b = 0.1 * torch.randn(D, device="cuda", generator=gen)
    dy = torch.randn(N, D, device="cuda", generator=gen).to(torch.bfloat16)
    _, mu, rsigma = layer_norm_fwd(x, w, b)
    return x, w, b, mu, rsigma, dy


def _cuda_core_digests(digest):
    """gae's and the layer_norm kernels' digests, from a generator of
    their own (the other kernels' inputs stay as they were drawn
    before)."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gae import gae
    from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
        layer_norm_bwd, layer_norm_fwd)

    gen = torch.Generator(device="cuda").manual_seed(12)
    gae_args = _gae_inputs(gen, 32, 16384)
    x, w, b, mu, rsigma, dy = _ln_bwd_inputs(gen)
    return {"gae": digest([gae(0.99, 0.95, *gae_args)]),
            "layer_norm_fwd": digest(layer_norm_fwd(x, w, b)),
            "layer_norm_bwd": digest(layer_norm_bwd(x, w, mu, rsigma, dy))}


def timing_phase():
    """``--timings``: gae at [32, 16384] and layer_norm_fwd and
    layer_norm_bwd at [131072, 256] bf16, each timed three ways
    (`call_timings`), and PyTorch's native_layer_norm and
    native_layer_norm_backward on the same inputs; then (`_route_timings`)
    the float16 grouped_matmul at headline_pbt_fp16's pass shapes beside
    ``torch.bmm(x, W[idx])``, the bf16 lstm_sequence_fwd_chunked at H =
    384 and 512 at infer_512's step, headline_pbt's collect step and its
    learn step, the LSTM backward's bf16 384 / 512 and float16 instances
    at their learn shapes, and the float16 LSTM forward's and GRU
    backward's instances at headline_fp16's, headline_gru_fp16's and their
    populations' shapes, with their bounds; as one JSON line.
    It calls the wrappers' public signatures only, so a copy of this
    script run in another checkout times that checkout's kernels."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gae import gae
    from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
        layer_norm_bwd, layer_norm_fwd)

    gen = torch.Generator(device="cuda").manual_seed(12)
    gae_args = _gae_inputs(gen, 32, 16384)
    x, w, b, mu, rsigma, dy = _ln_bwd_inputs(gen)
    D = x.shape[1]
    wb = (w.to(x.dtype), b.to(x.dtype))
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [D], *wb, 1e-6)
    log(json.dumps({"timings": {
        "gae": call_timings(lambda: gae(0.99, 0.95, *gae_args)),
        "layer_norm_fwd": call_timings(lambda: layer_norm_fwd(x, w, b)),
        "native_layer_norm": call_timings(
            lambda: torch.ops.aten.native_layer_norm(x, [D], *wb, 1e-6)),
        "layer_norm_bwd": call_timings(
            lambda: layer_norm_bwd(x, w, mu, rsigma, dy)),
        "native_layer_norm_backward": call_timings(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [D], mean, rstd, *wb, [True, True, True])),
        **_route_timings(),
    }}))


def _route_timings():
    """The kernels whose route a checkout may change at the shapes their
    paths run, each a median of CUDA-event timings (`time_ms`) with its
    bound: the float16 grouped_matmul at headline_pbt_fp16's three pass
    shapes (12 policies, 75 chunks of 512 rows) beside
    ``torch.bmm(x, W[idx])``, and lstm_sequence_fwd_chunked in bf16 at H =
    512 and 384 at infer_512's step (512 only: 95 chunks of 256, 32
    policies), headline_pbt's collect step (T = 1, 75 x 512, 12 policies)
    and its learn step (T = 16, 8 x 1280, 8 policies); and the LSTM
    backward's tensor-core instances: lstm_sequence_bwd_chunked bf16 at
    H = 512 and 384 and float16 at 256 at headline_pbt's learn step,
    lstm_sequence_bwd bf16 at 512 on one policy's [16, 1280] and float16
    at 256 at headline_fp16's minibatch [16, 8192]; and (``_f16_timings``)
    the float16 LSTM forward and GRU backward at 256."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import \
        grouped_matmul
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        lstm_sequence_bwd, lstm_sequence_bwd_chunked,
        lstm_sequence_fwd_chunked)

    gen = torch.Generator(device="cuda").manual_seed(26)
    P, C, B = _pbt_chunk_geometry()
    out = {}
    for IN, OUT in ((2, CHANNELS), (CHANNELS, CHANNELS),
                    (CHANNELS, 4 * CHANNELS)):
        x, w, idx = _gmm_inputs(gen, B, C, IN, P, OUT, torch.float16)
        idx64 = idx.long()
        b = _gmm_bound(B, C, IN, int(idx.unique().numel()), OUT, 2)
        out[f"grouped_matmul float16 [{B}x{C}, {IN}->{OUT}, P={P}]"] = dict(
            ms=time_ms(lambda: grouped_matmul(x, w, idx)),
            library_ms=time_ms(lambda: torch.bmm(x, w[idx64])),
            bound_ms=b["bound_ms"])
    infer_c, infer_b = _infer_geometry()
    learn_T = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    for H in (INFER_CHANNELS, 384):
        shapes = [("collect", 1, B, C, P),
                  ("learn", learn_T, PBT_TRAIN, PBT_MINIBATCH, PBT_TRAIN)]
        if H == INFER_CHANNELS:
            shapes.insert(0, ("infer", 1, infer_b, infer_c, INFER_POLICIES))
        for label, T, chunks, chunk, P_c in shapes:
            args = _chunked_lstm_inputs(gen, T, chunks, chunk, H, P_c,
                                        torch.bfloat16)
            b = _chunked_lstm_bound(T, chunks, chunk, H,
                                    int(args[4].unique().numel()), 2)
            out[f"lstm_sequence_fwd_chunked bf16 H={H} {label} "
                f"[{T}, {chunks} x {chunk}] P={P_c}"] = dict(
                    ms=time_ms(lambda: lstm_sequence_fwd_chunked(*args)),
                    bound_ms=b["bound_ms"])
    bf16, f16 = torch.bfloat16, torch.float16
    for dtype, H in ((bf16, INFER_CHANNELS), (bf16, 384), (f16, CHANNELS)):
        args = _bwd_route_inputs(gen, dtype, H, T=learn_T, chunks=PBT_TRAIN)
        b = _chunked_lstm_bwd_bound(learn_T, PBT_TRAIN, PBT_MINIBATCH, H,
                                    PBT_TRAIN, 2)
        out[f"lstm_sequence_bwd_chunked {str(dtype).split('.')[-1]} H={H} "
            f"learn [{learn_T}, {PBT_TRAIN} x {PBT_MINIBATCH}] "
            f"P={PBT_TRAIN}"] = dict(
                ms=time_ms(lambda: lstm_sequence_bwd_chunked(*args)),
                bound_ms=b["bound_ms"])
    for dtype, H, N in ((bf16, INFER_CHANNELS, PBT_MINIBATCH),
                        (f16, CHANNELS, 8192)):
        args = _bwd_route_inputs(gen, dtype, H, T=learn_T, N=N)
        b = _lstm_bounds(learn_T, N, H, 2)[1]
        out[f"lstm_sequence_bwd {str(dtype).split('.')[-1]} H={H} "
            f"[{learn_T}, {N}]"] = dict(
                ms=time_ms(lambda: lstm_sequence_bwd(*args)),
                bound_ms=b["bound_ms"])
    out.update(_f16_timings(gen))
    out.update(_gru_fwd_timings(gen))
    out.update(_gru_wide_timings(gen))
    return out


def _gru_wide_timings(gen):
    """The GRU at the instances that moved onto tensor cores last, each a
    median of CUDA-event timings with its bound (the dtype's tensor-core
    rate): gru_sequence_bwd_chunked in bf16 and float16 at H = 512 and 384
    at headline_pbt's learn step (T = 16, 8 x 1280, 8 policies),
    gru_sequence_bwd on one policy's [16, 1280], and the float16
    gru_sequence_fwd_chunked at the collect step (T = 1, 75 x 512, 12
    policies) and the learn step."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        gru_sequence_bwd, gru_sequence_bwd_chunked, gru_sequence_fwd_chunked)

    P, C, B = _pbt_chunk_geometry()
    T = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[-1]
        tensor = "bf16_tensor" if dtype == torch.bfloat16 else "f16_tensor"
        for H in (INFER_CHANNELS, 384):
            args = _gru_wide_inputs(gen, dtype, H, T, chunks=PBT_TRAIN)
            b = _chunked_gru_bounds(T, PBT_TRAIN, PBT_MINIBATCH, H,
                                    PBT_TRAIN, 2, tensor=tensor)[1]
            out[f"gru_sequence_bwd_chunked {dname} H={H} learn [{T}, "
                f"{PBT_TRAIN} x {PBT_MINIBATCH}] P={PBT_TRAIN}"] = dict(
                    ms=time_ms(lambda: gru_sequence_bwd_chunked(*args)),
                    bound_ms=b["bound_ms"])
            args = _gru_wide_inputs(gen, dtype, H, T)
            b = _gru_bounds(T, PBT_MINIBATCH, H, 2, tensor=tensor)[1]
            out[f"gru_sequence_bwd {dname} H={H} [{T}, {PBT_MINIBATCH}]"] = \
                dict(ms=time_ms(lambda: gru_sequence_bwd(*args)),
                     bound_ms=b["bound_ms"])
    for H in (INFER_CHANNELS, 384):
        for label, T_c, chunks, chunk, P_c in (
                ("collect", 1, B, C, P),
                ("learn", T, PBT_TRAIN, PBT_MINIBATCH, PBT_TRAIN)):
            args = list(_chunked_gru_inputs(gen, T_c, chunks, chunk, H, P_c,
                                            torch.float16))
            if label == "learn":
                args[4] = torch.arange(P_c, dtype=torch.int32,
                                       device="cuda")
            b = _chunked_gru_bounds(T_c, chunks, chunk, H,
                                    int(args[4].unique().numel()), 2,
                                    tensor="f16_tensor")[0]
            out[f"gru_sequence_fwd_chunked float16 H={H} {label} "
                f"[{T_c}, {chunks} x {chunk}] P={P_c}"] = dict(
                    ms=time_ms(lambda: gru_sequence_fwd_chunked(*args)),
                    bound_ms=b["bound_ms"])
    return out


def _gru_fwd_timings(gen):
    """The GRU forward at the instances that moved onto tensor cores after
    the others', each a median of CUDA-event timings with its bound: float16
    gru_sequence_fwd at headline_gru_fp16's minibatch [16, 8192] and rollout
    step [1, 16384], float16 gru_sequence_fwd_chunked at
    headline_pbt_gru_fp16's collect step (T = 1, 75 x 512, 12 policies) and
    learn step (T = 16, 8 x 1280, 8 policies), and bf16
    gru_sequence_fwd_chunked at H = 512 and 384 at the same two steps."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        gru_sequence_fwd, gru_sequence_fwd_chunked)

    f16, bf16 = torch.float16, torch.bfloat16
    P, C, B = _pbt_chunk_geometry()
    learn_T = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    out = {}
    for T, N in ((learn_T, 8192), (1, 16384)):
        args = _gru_inputs(gen, T, N, CHANNELS, f16)
        b = _gru_bounds(T, N, CHANNELS, 2, tensor="f16_tensor")[0]
        out[f"gru_sequence_fwd float16 H={CHANNELS} [{T}, {N}]"] = dict(
            ms=time_ms(lambda: gru_sequence_fwd(*args)),
            bound_ms=b["bound_ms"])
    for dtype, H in ((f16, CHANNELS), (bf16, INFER_CHANNELS), (bf16, 384)):
        for label, T, chunks, chunk, P_c in (
                ("collect", 1, B, C, P),
                ("learn", learn_T, PBT_TRAIN, PBT_MINIBATCH, PBT_TRAIN)):
            args = list(_chunked_gru_inputs(gen, T, chunks, chunk, H, P_c,
                                            dtype))
            if label == "learn":
                args[4] = torch.arange(P_c, dtype=torch.int32,
                                       device="cuda")
            b = _chunked_gru_bounds(T, chunks, chunk, H,
                                    int(args[4].unique().numel()), 2)[0]
            out[f"gru_sequence_fwd_chunked {str(dtype).split('.')[-1]} "
                f"H={H} {label} [{T}, {chunks} x {chunk}] P={P_c}"] = dict(
                    ms=time_ms(lambda: gru_sequence_fwd_chunked(*args)),
                    bound_ms=b["bound_ms"])
    return out


def _f16_timings(gen):
    """The float16 LSTM forward and GRU backward at H = 256, each a median
    of CUDA-event timings with its bound (f16 tensor-core rate):
    lstm_sequence_fwd at headline_fp16's minibatch [16, 8192] and rollout
    step [1, 16384], lstm_sequence_fwd_chunked at headline_pbt_fp16's
    collect step (T = 1, 75 x 512, 12 policies) and learn step (T = 16,
    8 x 1280, 8 policies), gru_sequence_bwd at headline_gru_fp16's
    minibatch and gru_sequence_bwd_chunked at headline_pbt_gru_fp16's learn
    step."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        gru_sequence_bwd, gru_sequence_bwd_chunked)
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        lstm_sequence_fwd, lstm_sequence_fwd_chunked)

    f16, H = torch.float16, CHANNELS
    P, C, B = _pbt_chunk_geometry()
    learn_T = STEPS_PER_UPDATE // NUM_BPTT_CHUNKS
    out = {}
    for T, N in ((learn_T, 8192), (1, 16384)):
        args = _lstm_inputs(gen, T, N, H, f16)
        b = _lstm_bounds(T, N, H, 2, tensor="f16_tensor")[0]
        out[f"lstm_sequence_fwd float16 H={H} [{T}, {N}]"] = dict(
            ms=time_ms(lambda: lstm_sequence_fwd(*args)),
            bound_ms=b["bound_ms"])
    for label, T, chunks, chunk, P_c in (
            ("collect", 1, B, C, P),
            ("learn", learn_T, PBT_TRAIN, PBT_MINIBATCH, PBT_TRAIN)):
        args = list(_chunked_lstm_inputs(gen, T, chunks, chunk, H, P_c, f16))
        if label == "learn":
            args[4] = torch.arange(P_c, dtype=torch.int32, device="cuda")
        b = _chunked_lstm_bound(T, chunks, chunk, H,
                                int(args[4].unique().numel()), 2)
        out[f"lstm_sequence_fwd_chunked float16 H={H} {label} "
            f"[{T}, {chunks} x {chunk}] P={P_c}"] = dict(
                ms=time_ms(lambda: lstm_sequence_fwd_chunked(*args)),
                bound_ms=b["bound_ms"])

    def drawn(n):
        return [torch.randn(learn_T, n, H, device="cuda",
                            generator=gen).to(f16) for _ in range(2)]

    args = [*_gru_inputs(gen, learn_T, 8192, H, f16), *drawn(8192)]
    b = _gru_bounds(learn_T, 8192, H, 2, tensor="f16_tensor")[1]
    out[f"gru_sequence_bwd float16 H={H} [{learn_T}, 8192]"] = dict(
        ms=time_ms(lambda: gru_sequence_bwd(*args)), bound_ms=b["bound_ms"])
    args = list(_chunked_gru_inputs(gen, learn_T, PBT_TRAIN, PBT_MINIBATCH,
                                    H, PBT_TRAIN, f16))
    args[4] = torch.arange(PBT_TRAIN, dtype=torch.int32, device="cuda")
    args += drawn(PBT_TRAIN * PBT_MINIBATCH)
    b = _chunked_gru_bounds(learn_T, PBT_TRAIN, PBT_MINIBATCH, H, PBT_TRAIN,
                            2)[1]
    out[f"gru_sequence_bwd_chunked float16 H={H} learn [{learn_T}, "
        f"{PBT_TRAIN} x {PBT_MINIBATCH}] P={PBT_TRAIN}"] = dict(
            ms=time_ms(lambda: gru_sequence_bwd_chunked(*args)),
            bound_ms=b["bound_ms"])
    return out


def main():
    import torch

    t0 = time.perf_counter()

    def elapsed(what):
        log(f"elapsed after {what}: {time.perf_counter() - t0:.0f} s")

    card = device_phase()
    build_phase()
    results = kernel_phase()
    elapsed("the kernel checks")
    model_phase()
    launches_by_path = {"layer_norm_module": layer_norm_module_phase(),
                        "grouped_matmul_op": grouped_matmul_op_phase()}

    # Per update: one rollout step per collect step, the bootstrap value's
    # critic step, and the sequence forward and backward of every minibatch.
    steps = STEPS_PER_UPDATE + 1 + NUM_MINIBATCHES
    lstm = {"gae": 1, "lstm_sequence_fwd": steps,
            "lstm_sequence_bwd": NUM_MINIBATCHES}
    gru = {"gae": 1, "gru_sequence_fwd": steps,
           "gru_sequence_bwd": NUM_MINIBATCHES}
    # The fused trunk: one fused_policy_step per rollout step and for the
    # bootstrap value, the projection kernels once per minibatch.
    fused = {"gae": 1, "fused_policy_step": STEPS_PER_UPDATE + 1,
             "lstm_sequence_proj_fwd": NUM_MINIBATCHES,
             "lstm_sequence_proj_bwd": NUM_MINIBATCHES}
    paths = {
        "headline": trainer_phase(card, "headline", build_headline, lstm,
                                  trials=3, timed_updates=10,
                                  last_rewards=10),
        # The value side of PPO on the headline: the critic changes, so
        # do the value targets and losses, but not the kernels' path.
        "headline_valuenorm": trainer_phase(
            card, "headline_valuenorm", build_headline_valuenorm, lstm,
            trials=3, timed_updates=10, last_rewards=10, ratio_zero=True,
            final_check=check_value_normalizer),
        "headline_hlgauss": trainer_phase(
            card, "headline_hlgauss", build_headline_hlgauss, lstm,
            trials=3, timed_updates=10, last_rewards=10, ratio_zero=True),
        # The advantage side of PPO: how minibatches are chosen and
        # weighted, float16 loss scaling and continuous actions. The MLP
        # phases run no kernel but gae.
        "headline_importance": trainer_phase(
            card, "headline_importance", build_headline_importance,
            dict(lstm, lstm_sequence_fwd=STEPS_PER_UPDATE + 1
                 + IMPORTANCE_MINIBATCHES,
                 lstm_sequence_bwd=IMPORTANCE_MINIBATCHES),
            trials=2, timed_updates=5, last_rewards=5, ratio_zero=True,
            final_check=check_importance,
            setting=f"bf16, {IMPORTANCE_MINIBATCHES} importance-sampled "
                    f"minibatches"),
        "headline_stratified": trainer_phase(
            card, "headline_stratified", build_headline_stratified, lstm,
            trials=2, timed_updates=5, last_rewards=5, ratio_zero=True,
            final_check=check_stratified,
            setting=f"bf16, {NUM_MINIBATCHES} minibatches stratified over "
                    f"{STRATIFY} blocks"),
        "mlp_filter": trainer_phase(
            card, "mlp_filter", build_mlp_filter, {"gae": 1}, trials=2,
            timed_updates=5, last_rewards=5, final_check=check_filter,
            setting=f"bf16 MLP, advantage-filtered minibatches of "
                    f"{FILTER_MINIBATCH_ROWS} rows"),
        "mlp_fp16": trainer_phase(
            card, "mlp_fp16", build_mlp_fp16, {"gae": 1}, trials=2,
            timed_updates=5, last_rewards=5, final_check=check_scaler,
            setting=f"float16 MLP with loss scaling, {NUM_MINIBATCHES} "
                    f"minibatches"),
        "headline_continuous": trainer_phase(
            card, "headline_continuous", build_headline_continuous, lstm,
            trials=2, timed_updates=5, last_rewards=5, rising_reward=False,
            setting=f"bf16, 2-dim continuous actions, {NUM_MINIBATCHES} "
                    f"minibatches"),
        "flagship": trainer_phase(card, "flagship", build_flagship,
                                  dict(lstm, mha=steps), trials=3,
                                  timed_updates=5, last_rewards=5),
        "headline_fused": trainer_phase(card, "headline_fused",
                                        build_headline_fused, fused,
                                        trials=3, timed_updates=10,
                                        last_rewards=10),
        "native": trainer_phase(card, "native", build_native, fused,
                                trials=2, timed_updates=4, last_rewards=4),
        "headline_gru": trainer_phase(card, "headline_gru",
                                      build_headline_gru, gru, trials=3,
                                      timed_updates=10, last_rewards=10),
        # Past 256 padded entities the attention takes mha_flash: its
        # forward at every step, its two backward kernels per minibatch.
        # With 32x fewer samples an update than the flagship, its mean
        # reward first rises near update 70, so it runs 3 trials of 30.
        "flagship_large": trainer_phase(
            card, "flagship_large", build_flagship_large,
            dict(lstm, mha_flash_fwd=steps,
                 mha_flash_bwd_dkdv=NUM_MINIBATCHES,
                 mha_flash_bwd_dq=NUM_MINIBATCHES),
            trials=3, timed_updates=30, last_rewards=5,
            num_worlds=LARGE_WORLDS),
    }
    two_hot_loss_timing(card)
    elapsed("the single-policy trainer phases")
    headline_sps = paths["headline"][1]["sps"]
    for name, (launches, r) in paths.items():
        launches_by_path[name] = launches
        log(f"{name}: {r['sps']:.0f} env-steps/s (headline {headline_sps:.0f} "
            f"in this run), max |ratio - 1| {r['ratio_dev']:.3e}, peak "
            f"{r['peak_gib']:.2f} GiB on {card}")
    launches, r = pbt_phase(card)
    launches_by_path["headline_pbt"] = launches
    paths_pbt_sps = r["sps"]
    log(f"headline_pbt: {r['sps']:.0f} agent-steps/s (headline "
        f"{headline_sps:.0f} env-steps/s in this run), max |ratio - 1| over "
        f"the train policies {r['ratio_dev']:.3e}, peak {r['peak_gib']:.2f} "
        f"GiB on {card}")
    launches_by_path["checkpoint_eval"] = checkpoint_eval_phase(card,
                                                                r.pop("mgr"))
    elapsed("headline_pbt and checkpoint_eval")
    # headline_pbt's population with the GRU, with each distributional
    # critic and with the fused trunk: one batched pass a rollout step
    # (five products a step, four for the bootstrap; the two-part critic
    # has two heads; the fused trunk's step is one fused_policy_step_chunked
    # launch, its heads two products a step and the critic's one for the
    # bootstrap) and one batched learn step a minibatch, on the
    # chunk-indexed recurrence kernels (the fused trunk's on the projection
    # kernels').
    steps = STEPS_PER_UPDATE + 1 + NUM_MINIBATCHES
    pbt_lstm = {"gae": 1, "lstm_sequence_fwd_chunked": steps,
                "lstm_sequence_bwd_chunked": NUM_MINIBATCHES,
                "grouped_matmul": 5 * STEPS_PER_UPDATE + 4}
    pbt_fused = {"gae": 1, "fused_policy_step_chunked": STEPS_PER_UPDATE + 1,
                 "lstm_sequence_proj_fwd_chunked": NUM_MINIBATCHES,
                 "lstm_sequence_proj_bwd_chunked": NUM_MINIBATCHES,
                 "grouped_matmul": 2 * STEPS_PER_UPDATE + 1}
    # The float16 models' grouped_matmul launches on tensor cores: of the
    # five products a step (2 -> 256, 256 -> 256, the recurrence's input
    # projection 256 -> 1024 or 768, the actor's 256 -> 5 and the critic's
    # 256 -> 1), the two with IN and OUT multiples of 8; two of the
    # bootstrap's four (no actor).
    gmm_tc = {name: 2 * STEPS_PER_UPDATE + 2
              for name in ("headline_pbt_fp16", "headline_pbt_gru_fp16")}
    for name, model, per_update, timed, collect_ab in (
            ("headline_pbt_gru", dict(rnn="gru"),
             {"gae": 1, "gru_sequence_fwd_chunked": steps,
              "gru_sequence_bwd_chunked": NUM_MINIBATCHES,
              "grouped_matmul": 5 * STEPS_PER_UPDATE + 4}, 3, True),
            ("headline_pbt_dreamer", dict(critic="dreamer"), pbt_lstm, 1,
             False),
            ("headline_pbt_hlgauss", dict(critic="hlgauss_two_part"),
             dict(pbt_lstm, grouped_matmul=6 * STEPS_PER_UPDATE + 5), 1,
             False),
            ("headline_pbt_fused", dict(fused=True), pbt_fused, 1, True),
            # The flagship: mha over every chunk's entities once a step,
            # for the bootstrap and a minibatch (the chunk and policy axes
            # folded into its batch); grouped_matmul 12 times a step (3
            # embeds, q, k, v, out, ff_0, ff_1, the LSTM's input
            # projection, the actor's and the critic's heads), 11 for the
            # bootstrap (no actor).
            ("headline_pbt_flagship", dict(flagship=True),
             dict(pbt_lstm, mha=steps,
                  grouped_matmul=12 * STEPS_PER_UPDATE + 11), 1, True),
            # Separate towers: each tower's LSTM a step and a minibatch,
            # the critic's alone for the bootstrap; grouped_matmul 8 times
            # a step (each tower's two Dense layers and input projection,
            # the two heads), 4 for the bootstrap.
            ("headline_pbt_separate", dict(separate=True),
             {"gae": 1, "lstm_sequence_fwd_chunked": 2 * STEPS_PER_UPDATE
              + 1 + 2 * NUM_MINIBATCHES,
              "lstm_sequence_bwd_chunked": 2 * NUM_MINIBATCHES,
              "grouped_matmul": 8 * STEPS_PER_UPDATE + 4}, 1, False),
            # The headline's model in float16 (headline_fp16's) and the GRU
            # in float16: headline_pbt's and headline_pbt_gru's launches, the
            # recurrences on their float16 instances (all on tensor cores)
            # and
            # grouped_matmul on tensor cores at its aligned products (gmm_tc),
            # loss scaling a policy.
            ("headline_pbt_fp16", dict(dtype=torch.float16), pbt_lstm, 1,
             True),
            ("headline_pbt_gru_fp16", dict(rnn="gru", dtype=torch.float16),
             {"gae": 1, "gru_sequence_fwd_chunked": steps,
              "gru_sequence_bwd_chunked": NUM_MINIBATCHES,
              "grouped_matmul": 5 * STEPS_PER_UPDATE + 4}, 1, False),
            # headline_window's memory: no recurrent kernel; grouped_matmul
            # 8 times a step (the MLP's two Dense layers, q, k, v, out, the
            # two heads), 7 for the bootstrap (no actor). The learn's
            # products are torch.bmm.
            ("headline_pbt_window", dict(window=WINDOW),
             {"gae": 1, "grouped_matmul": 8 * STEPS_PER_UPDATE + 7}, 1,
             True)):
        launches, r = pbt_variant_phase(card, name, model, per_update, timed,
                                        collect_ab,
                                        gmm_tc=gmm_tc.get(name))
        elapsed(name)
        launches_by_path[name] = launches
        log(f"{name}: {r['sps']:.0f} agent-steps/s (headline_pbt "
            f"{paths_pbt_sps:.0f} in this run), max |ratio - 1| over the "
            f"train policies {r['ratio_dev']:.3e}, peak {r['peak_gib']:.2f} "
            f"GiB on {card}")
    launches_by_path["entity_large_set"] = entity_large_set_check(card)
    # Every width the JAX package takes (the 384 / 512 instances, JAX's
    # twin route below 128) and the kernel LayerNorm's population.
    launches_by_path["infer_512"], r = infer_phase(card)
    elapsed("infer_512")
    splits = {}
    for name, model, per_update, timed, collect_ab, check in (
            # infer_bench.py's width: headline_pbt's launches, the LSTM
            # forward and backward on their 512-wide
            # tensor-core instances (two-block clusters).
            ("headline_pbt_512", dict(channels=INFER_CHANNELS), pbt_lstm, 2,
             False, None),
            # The fused trunk at that width (MLP 2 x 512, LSTM 512 on an
            # input of 512): headline_pbt_fused's launches, the fused step
            # and the projection kernels on their 512-wide tensor-core
            # instances (two-block clusters).
            ("headline_pbt_fused_512",
             dict(fused=True, channels=INFER_CHANNELS), pbt_fused, 1, False,
             None),
            # The same population with GRU(512): the GRU forward and
            # backward on their 512-wide tensor-core instances (two-block
            # clusters), headline_pbt_gru's launches.
            ("headline_pbt_gru_512", dict(rnn="gru", channels=INFER_CHANNELS),
             {"gae": 1, "gru_sequence_fwd_chunked": steps,
              "gru_sequence_bwd_chunked": NUM_MINIBATCHES,
              "grouped_matmul": 5 * STEPS_PER_UPDATE + 4}, 1, False, None),
            # A width no recurrent kernel is built for: the LSTM on its
            # plain twins, as JAX takes its jnp twin; the card against the
            # CPU, and the chunked collect (the twins' gathered batched
            # product) against the per-policy loop.
            ("headline_pbt_h32", dict(channels=32),
             {"gae": 1, "grouped_matmul": 5 * STEPS_PER_UPDATE + 4}, 1,
             True, _population_card_vs_cpu),
            # Each MLP LayerNorm on the kernel: two layer_norm_fwd_chunked
            # a trunk pass (a rollout step, the bootstrap, a minibatch), two
            # layer_norm_bwd_chunked a minibatch.
            ("headline_pbt_lnkernel", dict(ln_kernel=True),
             dict(pbt_lstm, layer_norm_fwd_chunked=2 * steps,
                  layer_norm_bwd_chunked=2 * NUM_MINIBATCHES), 1, False,
             None)):
        launches, r = pbt_variant_phase(card, name, model, per_update, timed,
                                        collect_ab, final_check=check)
        elapsed(name)
        splits[name] = r["split"]
        launches_by_path[name] = launches
        log(f"{name}: {r['sps']:.0f} agent-steps/s (headline_pbt "
            f"{paths_pbt_sps:.0f} in this run), max |ratio - 1| over the "
            f"train policies {r['ratio_dev']:.3e}, peak {r['peak_gib']:.2f} "
            f"GiB on {card}")
    fused, unfused = (splits[k] for k in ("headline_pbt_fused_512",
                                          "headline_pbt_512"))
    log(f"headline_pbt_fused_512 against headline_pbt_512 (this run, CUDA "
        f"events, on {card}): collect {fused['collect_ms']:.1f} against "
        f"{unfused['collect_ms']:.1f} ms an update, learn and the rest "
        f"{fused['learn_ms']:.1f} against {unfused['learn_ms']:.1f} ms")
    zoo = {
        # The rest of the model zoo. Separate towers: each tower's LSTM at
        # every rollout step and every minibatch, the critic's alone for
        # the bootstrap value.
        "headline_separate": trainer_phase(
            card, "headline_separate", build_headline_separate,
            dict(lstm, lstm_sequence_fwd=2 * STEPS_PER_UPDATE + 1
                 + 2 * NUM_MINIBATCHES,
                 lstm_sequence_bwd=2 * NUM_MINIBATCHES),
            trials=2, timed_updates=5, last_rewards=5, ratio_zero=True,
            setting=f"bf16, an MLP + LSTM tower for the actor and one for "
                    f"the critic, {NUM_MINIBATCHES} minibatches"),
        # Float16 recurrences: the headline's launches on the kernels'
        # float16 instances, all on tensor cores; the rollout step is the
        # update pass's step, so the ratio starts at exactly 1.
        "headline_fp16": trainer_phase(
            card, "headline_fp16", build_headline_fp16, lstm, trials=2,
            timed_updates=5, last_rewards=5, ratio_zero=True,
            final_check=check_scaler,
            tensor_cores=_tc_kernels(torch.float16, CHANNELS),
            setting=f"float16 MLP + LSTM with loss scaling, "
                    f"{NUM_MINIBATCHES} minibatches"),
        "headline_gru_fp16": trainer_phase(
            card, "headline_gru_fp16", build_headline_gru_fp16, gru,
            trials=2, timed_updates=3, last_rewards=3, ratio_zero=True,
            final_check=check_scaler,
            tensor_cores=_tc_kernels(torch.float16, CHANNELS),
            setting=f"float16 MLP + GRU with loss scaling, "
                    f"{NUM_MINIBATCHES} minibatches"),
        # The windowed attention memory runs no recurrent kernel.
        "headline_window": trainer_phase(
            card, "headline_window", build_headline_window, {"gae": 1},
            trials=2, timed_updates=5, last_rewards=5,
            setting=f"bf16, WindowAttentionMemory(256, window {WINDOW}, "
                    f"{WINDOW_HEADS} heads), {NUM_MINIBATCHES} minibatches"),
        # Rematerialization runs the trunk's mha again in each minibatch's
        # backward. The flagship's schedule: its reward rises slowly.
        "flagship_concat_self_remat": trainer_phase(
            card, "flagship_concat_self_remat",
            build_flagship_concat_self_remat,
            dict(lstm, mha=steps + NUM_MINIBATCHES), trials=3,
            timed_updates=5, last_rewards=5, final_check=check_remat,
            setting=f"bf16 flagship, entity embeds concatenating the self "
                    f"features, trunk rematerialized, {NUM_MINIBATCHES} "
                    f"minibatches"),
    }
    for name, (launches, r) in zoo.items():
        launches_by_path[name] = launches
        log(f"{name}: {r['sps']:.0f} env-steps/s (headline {headline_sps:.0f} "
            f"in this run), max |ratio - 1| {r['ratio_dev']:.3e}, peak "
            f"{r['peak_gib']:.2f} GiB on {card}")
    elapsed("the model zoo")
    launches_by_path["tools"], _ = tools_phase(card)
    elapsed("tools")

    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    kernels = []
    for k in KERNELS:
        r = results[k.name]
        by_path = {name: launches[k.name]
                   for name, launches in launches_by_path.items()}
        if not sum(by_path.values()):
            raise AssertionError(f"{k.name} was launched on no path")
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "path": r.get("path", "cuda_core"),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("float16", "recurrence_ms", "weight_grad_ms",
                                 "main_pass_ms", "reduction_ms",
                                 "device_ms", "host_us", "library_device_ms",
                                 "library_host_us", "per_policy_ms",
                                 "pbt_shapes", "learn_shape", "wide",
                                 "shape") if k in r}})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] in (["--digests"], ["--timings"]):
        device_phase()
        build_phase()
        (digest_phase if sys.argv[1] == "--digests" else timing_phase)()
    else:
        main()
