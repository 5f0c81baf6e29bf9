#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

(``python3 chip_smoke.py --digests`` runs phases 1 and 2, then prints the
SHA-256 of the bf16 LSTM and GRU kernels', ``mha``'s, ``gae``'s and the
two ``layer_norm`` kernels' outputs from seeded inputs, to hold two
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
   write no row past N; the GRU forward is also timed at each rows-a-block
   and ring-depth pair it is built for; ``gae`` must equal its plain
   version bitwise at four shapes and on the columns two calls share, and
   is timed at each steps-a-chunk and columns-a-block pair it is built
   for; ``layer_norm_fwd``'s y and ``layer_norm_bwd``'s dx at N = 131072
   must equal N = 16384's on the shared rows, and the forward's y, mu and
   rsigma and the backward's dw / db must be bitwise equal over two calls;
   the three are also timed on the device alone (torch.profiler) and on
   the host (the enqueue), ``layer_norm_bwd`` by launch, and
   ``native_layer_norm`` the same way;
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
    1 warm-up update and 3 trials of 30 (its reward rises late).

Each trainer phase sets every launch count to 0 just before it and checks
just after it that every kernel of its path launched as often as the
configuration implies and that every launch of the kernels with a
tensor-core route took it; it checks finite losses and metrics and a rising
mean reward and a first-minibatch max |ratio - 1| below the clip
coefficient, and prints env-steps/s (beside the headline's of the same
run at the end), peak memory, that ratio, a synchronized collect / learn
split and a torch.profiler breakdown of one update.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel with its launches on the main paths, error, times and bound,
and the script fails if a kernel was launched on no path.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

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
}

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates, at the
# full 700 W power limit): device memory bandwidth and the rates of the
# operation types the kernels do. "sfu": exponentials on the
# special-function units, 16 a clock an SM, ~3.9e12 a second (the figure
# the FlashAttention-3 paper gives for the H100 SXM). Tensor cores, f32
# pipes and special-function units run side by side, so a kernel's least
# time on operations is that of its busiest unit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32": 67e12, "sfu": 3.9e12}


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
    if not split:
        raise AssertionError("the profiler recorded no device time")
    return split


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


def _lstm_bounds(T, N, H, itemsize):
    """Bytes and operations of the forward and backward kernels: each
    input read once, each output written once; the h . Wr products (and in
    the backward dgates . Wr^T and h^T . dgates) on bf16 tensor cores, and
    about 30 f32 operations of gate math per unit and step (40 backward)."""
    seq, state = T * N * H, N * H
    fwd_bytes = itemsize * (4 * seq + T * N + 4 * H * H + 4 * H + 2 * state
                            + 2 * seq)
    bwd_bytes = itemsize * (4 * seq + T * N + 4 * H * H + 4 * H + 2 * state
                            + 3 * seq
                            + 4 * seq + 4 * H * H + 4 * H + 2 * state)
    product = 2 * T * N * H * 4 * H
    return (bound(fwd_bytes, {"bf16_tensor": product, "f32": 30 * seq}),
            bound(bwd_bytes, {"bf16_tensor": 3 * product, "f32": 40 * seq}))


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
    log(f"  {name} tensor-core split (R = {tc_rows(wi is not None)} rows a "
        f"block): recurrence {split['recurrence_ms']:.3f} ms, weight "
        f"gradients {split['weight_grad_ms']:.3f} ms")
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


def check_lstm(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        LSTM_BWD, LSTM_FWD, _fwd_tc, fwd_tc_rows, lstm_sequence_bwd,
        lstm_sequence_fwd, lstm_sequence_reference, uses_tensor_cores)

    gen = torch.Generator(device="cuda").manual_seed(2)
    fwd = results["lstm_sequence_fwd"] = {"max_abs_err": 0.0}
    bwd = results["lstm_sequence_bwd"] = {"max_abs_err": 0.0}
    # (T, N, H, dtype, on the main path): the update minibatch, the rollout
    # step, flagship_large's minibatch, a ragged batch at both widths (the
    # bf16 kernels on tensor cores), and float32 at both instantiated
    # widths (CUDA cores).
    cases = [
        (16, 8192, 256, torch.bfloat16, True),
        (1, 16384, 256, torch.bfloat16, True),
        (16, 256, 256, torch.bfloat16, False),
        (16, 1000, 256, torch.bfloat16, False),
        (5, 70, 128, torch.bfloat16, False),
        (5, 1000, 256, torch.float32, False),
        (4, 70, 128, torch.float32, False),
    ]
    for T, N, H, dtype, main_path in cases:
        dname = str(dtype).split(".")[-1]
        args = _lstm_inputs(gen, T, N, H, dtype)
        tag = f"[{T},{N},{4 * H}] {dname}"
        probe = torch.randn(T, N, H, device="cuda", generator=gen).to(dtype)

        (ys, cs), fpath = _routed(LSTM_FWD, uses_tensor_cores(dtype, H),
                                  lstm_sequence_fwd, *args)
        err = compare(f"lstm fwd {tag} ({fpath})", ys,
                      lstm_sequence_reference(*args), **TOL[("fwd", dname)])
        if main_path:
            if fpath != "tensor_core":
                raise AssertionError(f"lstm fwd {tag}: the main path took "
                                     f"the {fpath} route")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
            fwd["path"] = fpath
        elif fpath == "tensor_core" and N % fwd_tc_rows():
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

        got, path = _routed(LSTM_BWD, uses_tensor_cores(dtype, H),
                            lstm_sequence_bwd, *args, ys, cs, probe)
        for name, g, w in zip(("dxp", "dwr", "db", "dc0", "dh0"), got,
                              plain_bwd()):
            err = compare(f"lstm bwd {name} {tag} ({path})", g, w,
                          **TOL[("bwd", dname)])
            if main_path and T > 1:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)

        if main_path and T > 1:
            if path != "tensor_core":
                raise AssertionError(f"lstm bwd {tag}: the main path took "
                                     f"the {path} route")
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
        elif main_path:
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


def _gru_bounds(T, N, H, itemsize):
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
    return (bound(fwd_bytes, {"bf16_tensor": product, "f32": 25 * seq}),
            bound(bwd_bytes, {"bf16_tensor": 3 * product, "f32": 35 * seq}))


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
        TC_ROWS, _bwd_tc, _bwd_tc_buffers)

    buffers = _bwd_tc_buffers(args[0])

    def run(phases):
        return _bwd_tc(*args, ys, probe, phases=phases, buffers=buffers)

    run(3)
    split = dict(recurrence_ms=time_ms(lambda: run(1)),
                 weight_grad_ms=time_ms(lambda: run(2)))
    log(f"  gru bwd tensor-core split (R = {TC_ROWS} rows a block): "
        f"recurrence {split['recurrence_ms']:.3f} ms, weight gradients "
        f"{split['weight_grad_ms']:.3f} ms")
    results.update(split)


def _gru_fwd_sweep(update_args, step_args):
    """The tensor-core forward at each rows-a-block (R) and ring-depth pair
    that csrc/gru.cu builds at H = 256, timed at the update minibatch and
    the rollout step; each variant's ys against the wrapper's, bitwise."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        FWD_TC_ROWS, FWD_TC_STAGES, _fwd_tc)

    want = _fwd_tc(*update_args)
    for rows, stages in ((16, 4), (32, 2), (32, 3), (32, 4)):
        update_ms = time_ms(
            lambda: _fwd_tc(*update_args, rows=rows, stages=stages))
        step_ms = time_ms(
            lambda: _fwd_tc(*step_args, rows=rows, stages=stages))
        same = torch.equal(
            _fwd_tc(*update_args, rows=rows, stages=stages), want)
        log(f"  gru fwd sweep: R = {rows}, {stages} ring stages: "
            f"{update_ms:.3f} ms at [16, 8192], {step_ms:.3f} ms at [1, "
            f"16384]; ys bitwise equal to R = {FWD_TC_ROWS}, "
            f"{FWD_TC_STAGES} stages: {same}")


def check_gru(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gru import (
        FWD_TC_ROWS, GRU_BWD, GRU_FWD, _fwd_tc, gru_sequence_bwd,
        gru_sequence_fwd, gru_sequence_reference, uses_tensor_cores)

    gen = torch.Generator(device="cuda").manual_seed(10)
    fwd = results["gru_sequence_fwd"] = {"max_abs_err": 0.0}
    bwd = results["gru_sequence_bwd"] = {"max_abs_err": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    # (T, N, H, dtype, on the main path): the headline_gru update minibatch,
    # its rollout step, ragged batches at both widths (bf16 on tensor
    # cores), and float32 at both widths (CUDA cores).
    cases = [
        (16, 8192, 256, bf16, True),
        (1, 16384, 256, bf16, True),
        (16, 1000, 256, bf16, False),
        (5, 70, 128, bf16, False),
        (16, 1000, 128, bf16, False),
        (5, 1000, 256, f32, False),
        (4, 70, 128, f32, False),
    ]
    main_args = {}
    for T, N, H, dtype, main_path in cases:
        dname = str(dtype).split(".")[-1]
        tag = f"[{T},{N},{3 * H}] {dname}"
        args = _gru_inputs(gen, T, N, H, dtype)
        probe = torch.randn(T, N, H, device="cuda", generator=gen).to(dtype)

        ys, fpath = _routed(GRU_FWD, uses_tensor_cores(dtype, H),
                            gru_sequence_fwd, *args)
        err = compare(f"gru fwd {tag} ({fpath})", ys,
                      gru_sequence_reference(*args),
                      **TOL[("gru_fwd", dname)])
        if main_path:
            if fpath != "tensor_core":
                raise AssertionError(f"gru fwd {tag}: the main path took "
                                     f"the {fpath} route")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
            fwd["path"] = fpath
            main_args[T] = args
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

        got, path = _routed(GRU_BWD, uses_tensor_cores(dtype, H),
                            gru_sequence_bwd, *args, ys, probe)
        for name, g, w in zip(("dxp", "dwh", "dbh", "dh0"), got,
                              plain_bwd()):
            err = compare(f"gru bwd {name} {tag} ({path})", g, w,
                          **TOL[("gru_bwd", dname)])
            if main_path and T > 1:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)

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
    _gru_fwd_sweep(main_args[16], main_args[1])


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
        grouped_matmul, grouped_matmul_reference, uses_tensor_cores)

    gen = torch.Generator(device="cuda").manual_seed(15)
    res = results["grouped_matmul"] = {"max_abs_err": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, C, IN, P, OUT, dtype, on the main path): the three shapes of
    # benchmarks/grouped_matmul_bench.py (tensor cores); ragged bf16 on the
    # tensor-core path (C and OUT not multiples of its 128 x 128 tile, IN
    # not of its 64-deep slice); bf16 with IN = 70, not a multiple of 8, and
    # bf16 with x one element off a 16-byte boundary, both on the CUDA-core
    # path; float32 with no dimension a multiple of the CUDA-core kernel's
    # tiles. The last field shifts x's start by that many elements.
    cases = [(*GMM_SHAPES[0], bf16, True, 0), (*GMM_SHAPES[1], bf16, False, 0),
             (*GMM_SHAPES[2], bf16, False, 0),
             (7, 100, 72, 3, 136, bf16, False, 0),
             (5, 64, 70, 3, 96, bf16, False, 0),
             (5, 64, 72, 3, 96, bf16, False, 1),
             (7, 100, 72, 3, 130, f32, False, 0)]
    for B, C, IN, P, OUT, dtype, main_path, shift in cases:
        dname = str(dtype).split(".")[-1]
        x, w, idx = _gmm_inputs(gen, B, C, IN, P, OUT, dtype)
        if shift:
            x = torch.cat([x.new_zeros(shift), x.flatten()])[shift:].view(
                B, C, IN)
        path = "tensor_core" if uses_tensor_cores(x, w) else "cuda_core"
        tag = (f"[{B}x{C}, {IN}->{OUT}, P={P}] {dname}"
               f"{f' x {2 * shift} bytes off' if shift else ''} ({path})")
        err = compare(f"grouped_matmul {tag}", grouped_matmul(x, w, idx),
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
    return results


def _small_actor_critic(dtype, hidden, seed, fused=False, gru=False):
    """The headline's MLP + LSTM actor-critic; ``fused`` turns on the fused
    trunk (``use_fused_step`` and ``fuse_input_proj``), ``gru`` puts a GRU
    in the LSTM's place."""
    import torch
    from madrona_learn_tpu_torch.config import DiscreteActionsConfig
    from madrona_learn_tpu_torch.models import (
        GRU, LSTM, MLP, ActorCritic, BackboneShared, DenseLayerCritic,
        DenseLayerDiscreteActor, DictActor, RecurrentBackboneEncoder)

    gen = torch.Generator().manual_seed(seed)
    move = DiscreteActionsConfig(actions_num_buckets=[5])
    net = MLP(3, hidden, 2, dtype, generator=gen)
    if gru:
        rnn = GRU(hidden, hidden, 1, dtype, generator=gen)
    else:
        rnn = LSTM(hidden, hidden, 1, dtype, generator=gen,
                   fuse_input_proj=fused)
    return ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=RecurrentBackboneEncoder(net=net, rnn=rnn,
                                             use_fused_step=fused)),
        actor=DictActor({"move": DenseLayerDiscreteActor(
            move, hidden, dtype, generator=gen)}),
        critic=DenseLayerCritic(hidden, dtype, generator=gen))


# The flagship's observations (__graft_entry__.py): self [16], allies
# [5, 12], enemies [6, 12] (flagship_large: allies and enemies [255, 12]);
# its action space move [5, 3].
ENTITY_OBS = {"self": 16, "allies": 12, "enemies": 12}
FLAGSHIP_BUCKETS = [5, 3]
LARGE_SET = dict(allies=255, enemies=255)


def _flagship_actor_critic(dtype, embed, out, heads, hidden, seed):
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
                net=EntitySelfAttentionNet(ENTITY_OBS, embed, out, heads,
                                           dtype, generator=gen),
                rnn=LSTM(out, hidden, 1, dtype, generator=gen))),
        actor=DictActor({"move": DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=FLAGSHIP_BUCKETS),
            hidden, dtype, generator=gen)}),
        critic=DreamerV3Critic(hidden, dtype))


def _entity_env(base, allies=5, enemies=6):
    """The toy gridworld's obs as the flagship's entity sets: with f =
    concat(delta, time), self = f @ A_self and ally / enemy j = f @ A[j],
    the matrices drawn once from numpy's default_rng(0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    a_self, a_ally, a_enemy = (
        torch.from_numpy((rng.standard_normal(shape) * 3 ** -0.5)
                         .astype(np.float32)).cuda()
        for shape in ((3, ENTITY_OBS["self"]),
                      (allies, 3, ENTITY_OBS["allies"]),
                      (enemies, 3, ENTITY_OBS["enemies"])))

    def wrap(obs):
        f = torch.cat([obs["delta"], obs["time"]], dim=-1)
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
    """The trainers' TrainConfig; ``algo_kwargs`` go to PPOConfig and the
    other keywords to TrainConfig."""
    import madrona_learn_tpu_torch as mlt

    return mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        actions={"move": mlt.DiscreteActionsConfig(
            actions_num_buckets=actions)},
        steps_per_update=STEPS_PER_UPDATE,
        num_bptt_chunks=NUM_BPTT_CHUNKS,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            minibatch_size=NUM_BPTT_CHUNKS * num_worlds // NUM_MINIBATCHES,
            clip_coef=CLIP_COEF,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
            **(algo_kwargs or {}),
        ),
        dreamer_v3_critic=dreamer_v3_critic,
        **kwargs,
    )


def _toy_env(num_worlds=NUM_WORLDS):
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env

    return make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=40, grid_size=8, seed=0),
        device="cuda")


def build_headline(hooks):
    import torch
    import madrona_learn_tpu_torch as mlt

    dtype = torch.bfloat16
    policy = mlt.Policy(
        actor_critic=_small_actor_critic(dtype, CHANNELS, seed=0),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))
    return mlt.init_training(
        "cuda", _train_config([5], dreamer_v3_critic=False), _toy_env(),
        policy, torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks)


def build_headline_valuenorm(hooks):
    """The headline with value normalization (decay 0.99999), the clipped
    value loss and the Huber value loss."""
    import torch
    import madrona_learn_tpu_torch as mlt

    dtype = torch.bfloat16
    policy = mlt.Policy(
        actor_critic=_small_actor_critic(dtype, CHANNELS, seed=0),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))
    cfg = _train_config([5], dreamer_v3_critic=False,
                        algo_kwargs=dict(clip_value_loss=True,
                                         huber_value_loss=True),
                        normalize_values=True, value_normalizer_decay=0.99999)
    return mlt.init_training(
        "cuda", cfg, _toy_env(), policy,
        torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks)


def build_headline_hlgauss(hooks):
    """The headline with HLGaussCritic (127 bins over [-100, 100]) in the
    dense critic's place."""
    import torch
    import madrona_learn_tpu_torch as mlt
    from madrona_learn_tpu_torch.models import HLGaussCritic

    dtype = torch.bfloat16
    ac = _small_actor_critic(dtype, CHANNELS, seed=0)
    ac.critic = HLGaussCritic.create(CHANNELS, dtype)
    policy = mlt.Policy(
        actor_critic=ac,
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))
    return mlt.init_training(
        "cuda", _train_config([5], dreamer_v3_critic=False,
                              hlgauss_critic=True),
        _toy_env(), policy,
        torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks)


def build_headline_gru(hooks):
    """The headline with GRU(256, 256, 1, bf16) in the LSTM's place."""
    import torch
    import madrona_learn_tpu_torch as mlt

    dtype = torch.bfloat16
    policy = mlt.Policy(
        actor_critic=_small_actor_critic(dtype, CHANNELS, seed=0, gru=True),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))
    return mlt.init_training(
        "cuda", _train_config([5], dreamer_v3_critic=False), _toy_env(),
        policy, torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks)


def build_headline_fused(hooks, sim_fns=None):
    """The headline with the fused trunk, over the toy gridworld or
    ``sim_fns``."""
    import torch
    import madrona_learn_tpu_torch as mlt

    dtype = torch.bfloat16
    policy = mlt.Policy(
        actor_critic=_small_actor_critic(dtype, CHANNELS, seed=0, fused=True),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))
    return mlt.init_training(
        "cuda", _train_config([5], dreamer_v3_critic=False),
        sim_fns or _toy_env(), policy,
        torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks)


def build_native(hooks):
    """The headline_fused model over the C++ batch simulator."""
    from madrona_learn_tpu_torch.envs import NativeSimConfig, make_native_sim

    return build_headline_fused(hooks, make_native_sim(NativeSimConfig(
        num_worlds=NUM_WORLDS, episode_len=40, grid_size=8, seed=0),
        device="cuda"))


def build_flagship(hooks, num_worlds=NUM_WORLDS, allies=5, enemies=6):
    import torch
    import madrona_learn_tpu_torch as mlt

    # __graft_entry__.py's model at its published width; no obs
    # preprocessing, as there.
    policy = mlt.Policy(actor_critic=_flagship_actor_critic(
        torch.bfloat16, 128, 256, 4, CHANNELS, seed=0))
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
    kernels = sorted((e for e in rows if e.device_type == DeviceType.CUDA),
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
                     "_LSTMSequenceBackward", "_LSTMSequenceProj",
                     "_LSTMSequenceProjBackward", "_GRUSequence",
                     "_GRUSequenceBackward"):
            log(f"    {total_ms(e):9.3f} ms {e.count:6d}x  {e.key} "
                f"(inclusive)")


# The kernels whose wrappers count their tensor-core launches
# (Kernel.tc_launches): their path rules send bf16 there (the recurrences
# and the fused step at H = 128 or 256).
TC_ROUTED = ("lstm_sequence_fwd", "lstm_sequence_bwd",
             "lstm_sequence_proj_fwd", "lstm_sequence_proj_bwd",
             "gru_sequence_fwd", "gru_sequence_bwd", "mha",
             "fused_policy_step")


def trainer_phase(card, name, build, per_update, trials, timed_updates,
                  last_rewards, num_worlds=NUM_WORLDS, ratio_zero=False,
                  final_check=None):
    """One trainer: launch counts, finite metrics, rising reward,
    env-steps/s, memory, the ratio at the first minibatch (exactly 0 with
    ``ratio_zero``), the phase split and a profile; then
    ``final_check(mgr, updates run)``, if given."""
    import torch
    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    # Start from an empty allocator cache, whatever ran before.
    gc.collect()
    torch.cuda.empty_cache()
    timer = _phase_timer()
    mgr = build(timer)
    per_update = {k.name: per_update.get(k.name, 0) for k in KERNELS}
    num_updates = 1 + trials * timed_updates
    log(f"{name} trainer: {num_worlds} worlds, bf16, T={STEPS_PER_UPDATE} "
        f"in {NUM_BPTT_CHUNKS} chunks, {NUM_MINIBATCHES} minibatches; "
        f"expected launches per update {per_update}")
    updates_run = [0]

    losses, rewards = [], []

    def one_update():
        mgr.update_iter()
        updates_run[0] += 1
        losses.append(mgr.first_minibatch_stats["loss"])
        rewards.append(mgr.metrics.latest("Rewards").mean[0])

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
    # kernels, mha, the fused step) takes it.
    for kernel, tc in tc_launches.items():
        if tc != launches[kernel]:
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
    if not reward_hist[-last_rewards:].mean() > reward_hist[:3].mean():
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
        final_check(mgr, updates_run[0])
    return launches, dict(sps=max(sps), ratio_dev=ratio_dev,
                          clip_frac=clip_frac, peak_gib=peak_gib)


def check_value_normalizer(mgr, updates_run):
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
    update pass's shapes, from seeded inputs, as one JSON line. Copied into
    another checkout and run there, it holds that checkout's kernels
    bitwise to this one's."""
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
    }}))


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
    native_layer_norm_backward on the same inputs, as one JSON line. It
    calls the wrappers' public signatures only, so a copy of this script
    run in another checkout times that checkout's kernels."""
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
    }}))


def main():
    card = device_phase()
    build_phase()
    results = kernel_phase()
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
    headline_sps = paths["headline"][1]["sps"]
    for name, (launches, r) in paths.items():
        launches_by_path[name] = launches
        log(f"{name}: {r['sps']:.0f} env-steps/s (headline {headline_sps:.0f} "
            f"in this run), max |ratio - 1| {r['ratio_dev']:.3e}, peak "
            f"{r['peak_gib']:.2f} GiB on {card}")

    import torch
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
            **{k: r[k] for k in ("recurrence_ms", "weight_grad_ms",
                                 "main_pass_ms", "reduction_ms",
                                 "device_ms", "host_us", "library_device_ms",
                                 "library_host_us") if k in r}})
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
