"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py [--seed 0] [--batch 2048] [--audio-batch 128]
                          [--mc-rounds 4] [--profile]

Every kernel check, path and time below is made twice: in float32 (inside
the two kernels that means 3xTF32 on the tensor cores, elsewhere full
float32: TF32 is switched off for cuDNN and cuBLAS) and with
``compute_dtype=torch.bfloat16``. Gates: max |kernel - plain| <=
1e-4 * max(1, max |plain|) in float32, <= 2**-6 * max(1, max |plain|) in
bfloat16 (two bf16 ulps at the top of the range; kernel and plain version
take the same bf16 values, accumulate in float32 and round once, so the order
of the sum is the only difference).

Phases (any failure ends the run with a non-zero exit):

1. set-up: the card's name and power limit, TF32 off, build of the CUDA
   kernels from ``imagecfgen_torch/csrc`` (one ``nvcc`` each, in parallel);
2. each kernel against its plain PyTorch version at the MNIST path's shapes
   (the full-width ``mnist_bigan_config()`` encoder trunk at ``--batch``,
   its launch plan printed), and again after one weight was scaled in place
   (the packed weights must follow);
3. the MNIST path end to end: ``CounterfactualEngine.counterfactual`` with
   ``do(thickness + 2)`` and ``reconstruct`` at full width, with the kernels'
   launch counts read around that run only;
4. times with CUDA events: each kernel, its plain version, the PyTorch
   library stack computing the same function (its device time under
   ``torch.profiler`` too), and the engine's rate;

and for the AudioMNIST scoring path (``--audio-batch``):

A2. ``fused_dense`` against its plain version at the classifier head's
    shape (``--audio-batch``, 4096, 1024) and at ragged shapes (one with a
    row stride that is no multiple of 16 bytes), and
    ``fused_encoder`` on the full-width ``audio_mnist_bigan_config()``
    encoder trunk (5x5 kernels, 7 input channels, 128^2 input), and on the
    narrow trunks of ``--d 8`` and ``--d 48`` at batch 4 (later layers on
    ``conv_window`` or with their channels padded for ``conv_wgmma``);
A3. the path end to end: ``cf_effectiveness_score`` (target ``digit``,
    ``--mc-rounds`` rounds) over the full-width AudioMNIST BiGAN, attribute
    SCM and classifier, with both kernels' launch counts read around that
    run only; then one counterfactual with a resampled digit, checked
    attribute by attribute, and the classifier against its plain head;
A4. times: each kernel at the path's shapes beside its plain version, the
    library call and its bound, and the score's rate with its stages.

and for the training paths, all in float32 (100 steps a timed epoch):

T1. GAN training on MNIST at full width: ``GANTrainer`` on
    ``mnist_bigan_config()``, batch 64, ``d_updates_per_g_update=3``, a
    device-resident synthetic set, one warm-up ``fit_epoch`` and one timed:
    finite metrics, every parameter of E, G and D changed and left with a
    gradient, D's running statistics moved, Adam's D count twice the step
    count, one ``fused_encoder`` launch a step; steps/s, images/s;
T6. checkpoint: T1's state saved, loaded into a fresh trainer, one more step
    from each on the same batch, each drawing its noise from its own
    (restored) generator, compared bit for bit;
T1b. the time of each phase of a step (E+G update, recompute, D real, D fake),
    and of one Adam step over D's parameters: the port's ``Adam`` with a
    float32 and a bfloat16 ``mu`` beside ``torch.optim.Adam``;
T1c. ``fused_encoder`` against its plain version at the shape the recompute
    phase gives it, (64, 28, 28, 5), whose launch plan differs from the
    serving batch's: on the trainer's own weights and attribute channels, and
    on fan-in-scaled weights, whose O(1) outputs make the gate bite; its
    times there beside its plain version's and the ``F.conv2d`` stack's;
T2. the gradient routes: the encoder's gradients through its
    ``PlanSequential`` against the plain im2col version's, ``fused_dense``'s
    ``dx``, ``dw``, ``db`` at (128, 4096, 1024) against autograd through its
    plain version (float32 gate; the plain side takes each LeakyReLU on the
    side of its kink that the checked route's activation lies on, since a
    value within rounding of zero can differ in sign between two routes and
    the gradient jumps there; such values may number at most 4 or 1e-5 of all and
    each must lie within 1e-5 * max(1, max |input|) of zero in both routes),
    and ``fused_encoder_forward`` raising when asked for a gradient on the
    card;
T3. classifier training on AudioMNIST at full width: ``SupervisedTrainer`` on
    ``audio_mnist_classifier_config(10)``, batch 128, 20 steps of ``ce``: the
    loss on a fixed batch falls, one ``fused_dense`` launch a step, the head's
    weight changed; steps/s;
T4. GAN training on AudioMNIST at full width, batch 32, 5 steps (``init_std``
    0.01, the value the JAX package's audio battery trains with: at the
    config's 0.001 the first steps' gradients are too small to tell a moved
    parameter from a still one), then ``fused_encoder`` against its plain
    version at that path's shape, (32, 128, 128, 7), as in T1c;
T5. both attribute SCMs' MLE ``fit`` on a few thousand synthetic rows: the
    NLL falls, and ``sample_cf`` on the fitted SCM passes the serving checks.

and for checkpoints of the original PyTorch ImageCFGen (the reference), first
in the CLI block:

R. reference-format state-dict files written from ``--seed`` at full width
   (``imagecfgen_torch/tools/reference_fixtures.py``): the main path's MNIST
   BiGAN and the AudioMNIST digit classifier. ``python -m
   imagecfgen_torch.cli.convert_reference_checkpoint`` converts both at once,
   in two processes (the BiGAN with ``--data-dir`` on ``--batch`` rows of
   the phase's own); the port's loaders read the files, every reference
   tensor must sit where the fixture's map puts it, bit for bit; the engine
   on the converted BiGAN at ``--batch``, ``do(thickness + 2)``, launches
   ``fused_encoder`` once and the converted classifier on ``--audio-batch``
   images launches ``fused_dense`` once at (``--audio-batch``, 4096, 1024),
   each count read around that run alone, and both kernels are held against
   their plain versions on those launches' inputs; the converters' seconds go
   into a ``cli_seconds`` line.

and for the port's MNIST CLIs, run through their ``main`` with ``--device
cuda`` as a user runs them:

C1. a Morpho-MNIST-layout dataset in a temporary directory: 6,400 training
    and 2,048 test rows of ``synthetic_digits`` glyphs, attributes from the
    ground-truth SCM's closed form, packed by ``pack_mnist_attrs``;
C2. training at full width: ``train_mnist_attribute_scm``,
    ``train_mnist_clf`` (one epoch), ``train_mnist_image_scm`` (batch 64,
    ``--d-updates-per-g-update 3``, one 100-step epoch), then ``--resume``
    for a second, then ``--throughput`` for one into a fresh directory, and
    ``train_morphomnist_ae`` (one epoch);
C3. serving from those artifacts: ``mnist_gan_counterfactuals``,
    ``mnist_bigan_score`` (``--limit 2048 --batch-size 512``),
    ``mnist_generator_score`` (``--n 2048``);
C4. checks: every artifact loads back, every PNG decodes to its size, the
    scores lie in [0, 1], the resumed run goes from step 100 to 200, Adam's D
    count is the step count with ``--throughput`` and twice it without, and
    ``fused_encoder`` launches once a step (and once for the epoch's grid) in
    both training modes, twice in the counterfactual CLI and at least once in
    the score CLI, each count read around that CLI alone; then, for each
    training mode, kernels a step and idle share under ``torch.profiler`` of
    a trainer built as the CLI builds it (on the CLI's training rows, with a
    seed of its own: not the CLI's run, whose steps/s sit beside them).

and for the paper's Morpho-MNIST comparison, the same way, on C1-C4's
artifacts:

M1. synthesis: ``create_train_dataset --synthetic 128 --scale 16`` and
    ``create_test_dataset --synthetic 256`` with ``--workers`` one below the
    host's core count, and the test split once more with ``--noise-std 8``
    into a second directory, in a background process started before R (host
    work only, beside R and C1-C4, whose host thread keeps a core): shapes and the 13-column layout, no glyph whose
    maximum is 50 or less, the attribute columns equal to the port's
    ``GroundTruthSCM`` draws for the seed, the noisy split's attributes
    unchanged and its pixels not; glyphs/s and the core count;
M2. the oracle: ``measure_batch`` and ``measure_attributes`` on M1's test
    split with the native and the python engine (equal to 1e-9), the median
    |measured - target| of thickness, intensity and slant under
    ``ORACLE_BOUNDS``; images/s of each engine;
M3. ``train_mnist_vae`` at full width, batch 64, 4 MC samples, ``kl_weight``
    10, one 100-step epoch on C1's rows: a finite -ELBO, every parameter
    changed, no ``fused_encoder`` launch (the trunk needs a gradient), the
    checkpoint loads back; steps/s, and kernels a step and the idle share of
    a VAE trainer built as the CLI builds it;
M4. serving from C2's BiGAN, SCM and classifier and M3's VAE:
    ``mnist_gan_measured_cf`` and ``mnist_vae_measured_cf`` on M1's test
    split (``--limit 256``: three finite median errors, the PNG's size, one
    ``fused_encoder`` launch for each intervened attribute),
    ``mnist_vae_counterfactuals`` (``--limit 64``: both models' pixel MAE),
    ``mnist_vae_score`` (``--limit 2048``, on C1's test rows) and
    ``mnist_vae_generator_score`` (``--n 2048``: in [0, 1]), ``test_vae``
    (``ok``), each CLI's launches read around it alone;
M5. ``fused_encoder`` against its plain version at the measured-CF CLIs'
    shape (256, 28, 28, 5), on M3's VAE trunk and on fan-in-scaled weights,
    timed beside its plain version and the ``F.conv2d`` stack, with its
    bound (a ``kernel_at_serving_shape`` line).

and for the paper's counterfactual explainers, on the same artifacts (every
model at full width; the CLIs that write into the working directory run in
a directory of their own):

X1. ``fused_encoder`` against its plain version at the explainers' shape
    (1, 28, 28, 5): every explainer encodes one image. On C2's BiGAN trunk
    and M3's VAE trunk (their own weights and attribute channels) and on
    fan-in-scaled weights, launch plans printed, timed beside its plain
    version and the ``F.conv2d`` stack, with its bound (a
    ``kernel_at_explainer_shape`` line for each trunk);
X2. ``train_morphomnist_oracles`` (``--epochs 1``), per-digit autoencoders
    (``train_morphomnist_ae --cls 0..9``, one epoch each, for the realism
    columns), then ``mnist_cf_explain`` (``--steps 20``),
    ``mnist_cf_comparisons`` (``--n-images 8 --steps 20``),
    ``make_mnist_cf_matrix`` (``--per-digit 1``) and ``show_cf_matrix``,
    ``mnist_oracle_scores`` and ``morphomnist_cf_metrics`` (``--limit 8
    --steps 20``; the latter with the VAE's explainers),
    ``morphomnist_attribute_shap`` (``--limit 2``): their artifacts (PNG
    sizes, the pickle's keys, the CSVs' rows and columns, the SHAP arrays'
    shape), and each CLI's ``fused_encoder`` launches equal to its ``explain``
    calls (0 where it encodes nothing); then the pixel baselines on the card
    as those CLIs run them: ``ok`` masks that agree with the labels, every
    image in [-1, 1], pertinent positives inside x (an ``explainers`` line);
X3. ``finetune_mnist_bigan`` for one epoch with ``--metric mse`` and
    ``ssim``: 0 ``fused_encoder`` launches (E needs a gradient), every
    tensor of E moved, G and D bit for bit unchanged, the written file loads
    into ``CounterfactualEngine`` and reconstructs; ``mnist_reconstructions``
    renders the three files (3 launches); steps/s, and kernels a step and the
    idle share of a fine-tuner built as the CLI builds it
    (``{"cli_training": "finetune_mnist_bigan ..."}`` lines).

and for the AudioMNIST pipeline through the port's own entry points, at full
width (``audio_mnist_bigan_config(d=64)``, ``audio_mnist_classifier_config(
width=1.0)``) on the synthetic stand-in (60 subjects x 10 digits x 4 runs:
2,400 clips, 1,800 training and 600 validation), synthesised once and
copied for each CLI of the AU, AV, G and P1 phases (``shared_stand_in``; AU1
times a synthesis):

AU1. the spectrograms of all 2,400 clips on the card, (128, 128) each:
     shape, finiteness, the power held against the plain framing +
     ``torch.fft.rfft`` version (4e-6 of its max), clips/s; a Griffin-Lim
     round trip on 8 clips (32 iterations), timed, its magnitude
     spectrogram correlating with the target's at 0.99 or more;
AU2. the training CLIs: ``train_audio_mnist_attribute_scm``,
     ``train_audio_mnist_clf`` for ``digit`` and ``subject`` (one epoch each;
     ``fused_dense`` at least once a step), ``train_audio_mnist_bigan`` for
     one epoch of 14 steps at batch 128 (``--init-std 0.01``) in float32 and
     with ``--compute-dtype bfloat16``: ``fused_encoder`` once a step in both,
     every parameter moved, parameters and Adam state float32; kernels a
     step, device time and idle share of a like trainer in each type and of a
     like classifier trainer (``{"cli_training": ...}`` lines);
AU3. bf16 after training: ``fused_encoder`` in bf16 on the bf16-trained trunk
     at (128, 128, 128, 7) against its plain version (2**-6 gate), timed
     (the ``fused_encoder:audio_train_bf16`` row); the trainer's recompute
     (the kernel on its cached bf16 weight copies) against the plain version
     on copies cast afresh, after the epoch, after one more Adam step and
     after an in-place scale of a kernel; then the bf16 run resumed after its
     first epoch (``--resume``) against an uninterrupted two-epoch run, bit
     for bit, under cuDNN's deterministic algorithms (as T6);
AU4. the scoring and eval CLIs on AU2's float32 artifacts, each with its
     seconds and both kernels' launches, held to the counts the data gives:
     ``audiomnist_bigan_score``, ``audiomnist_generator_score`` (``--n
     512``), ``test_audio_gan``, ``audiomnist_generate`` (non-silent 8 kHz
     int16 wavs and their JSON), ``audio_mnist_reconstruction --write-wavs``
     (the grid's size, the wavs), ``audiomnist_cf_eval`` (the ratio
     matrices' shape, finite) and ``audiomnist_cf_classifier_metric``;
AU5. ``fused_encoder`` at the shape ``audiomnist_cf_eval`` gives it,
     (16, 128, 128, 7), on AU2's trunk and on fan-in weights, timed beside
     its plain version and the ``F.conv2d`` stack, with its bound (a
     ``kernel_at_cf_eval_shape`` line, the ``fused_encoder:audio_cf_eval``
     row); then both kernels against their plain versions on the inputs of
     the first launch at each (type, shape) that the AU2-AU4 CLIs gave them
     (the last, short batches of the score and eval CLIs, batch 256 of
     ``audiomnist_cf_classifier_metric`` and ``_generator_score``, the ten
     clips of ``audiomnist_generate``, ...), each shape the data's counts
     call for required among them (a ``launch_shapes`` line). Copying those
     inputs adds to the seconds of the CLI run that first launches a shape.

and for the last MNIST and AudioMNIST CLIs and the repaired float32 sums:

F1. the four MNIST figure CLIs on C1's dataset and C2's and M3's models:
    ``display_thickness`` (the kernel at (8, 28, 28, 5)), ``causal_graph_cf``
    (at (40, 28, 28, 5)), ``uncertainty_evolution`` and ``cf_automatic_mix``
    on the VAE and on the BiGAN (at (1, 28, 28, 5)): each PNG read back with
    ``read_png`` at its size and not blank, one ``fused_encoder`` launch each;
    then ``mnist_mix_vae_gui --headless``: its 4 x 5 grid (112 x 140) not
    blank, exactly 16 launches, all at (1, 28, 28, 5) (15 counterfactuals and
    the digit mix's one encode); the kernel held against its plain version
    and float64 at every shape they launch (AU5's recording shim);
AV1. ``train_audio_mnist_vae`` at d = 64 for one epoch, then ``--resume`` for
     a second, against an uninterrupted two-epoch run, bit for bit (cuDNN's
     deterministic algorithms); 0 ``fused_encoder`` launches (E needs a
     gradient); steps/s, and kernels a step and the idle share of a like
     trainer;
AV2. ``audiomnist_vae_score`` (``fused_encoder`` once a batch at 128 and
     the last 88, ``fused_dense`` once a round) and
     ``audiomnist_vae_generator_score`` (``--n 512``: ``fused_dense`` at 256)
     on AV1's VAE and AU2's SCM and classifier; ``fused_encoder`` at
     (128, 128, 128, 7) on the trained VAE trunk and fan-in weights, timed
     (the ``fused_encoder:audio_vae`` row); then
     ``finetune_audio_mnist_bigan`` for one epoch on AU2's BiGAN: 0 kernel
     launches, every tensor of E moved, G and D bit for bit unchanged; both
     kernels held at every shape these CLIs launch;
G1. ``train_audio_gan`` at d = 64, batch 64, one epoch in ``--loss-mode gan``
    and ``wgan`` (every parameter of G and D moved, but for D's output bias
    under the Wasserstein loss, which it does not enter; no kernel launched), the
    wgan run then ``--resume``d for a second epoch against an uninterrupted
    two-epoch run, bit for bit (cuDNN's deterministic algorithms);
    steps/s, and kernels a step and the idle share of a like trainer;
P1. the float32 sums against float64 (``tools/trunk_precision.py``): AU2's
    trained trunk at B = 256, whole (within a quarter of the kernel's gate)
    and each layer alone (its mean signed error a tenth or less of the same
    layer's with one tensor-core sum over its K, as recorded in
    ``P1_UNPROMOTED_LEAN``), ``fused_dense`` on
    U(0, 1) products at K = 256 ... 16,384 (|mean| <= 2.1e-6 at 16,384), and
    the ESRF encoder's layers 6-8 at d = 64 and batch 2 (K = 25,600, 51,200
    and 102,400; within a quarter of their gates), with the peak of device
    memory and the bytes of the packed hi/lo weights.

and for the marine slice, at full width (d = 64, latent 512) on the
synthetic stand-ins, float32, with both kernels' inputs recorded at the
first launch of each shape and held against their plain versions (and,
printed, float64) at every shape a CLI gave them:

W1. the whale-call CLIs: ``train_whale_clf`` (one epoch at batch 32, one
    ``fused_dense`` launch a step), ``train_whale_bigan`` with ``--remat``
    (one epoch, ``--resume`` for a second, bit for bit against an
    uninterrupted two-epoch run; one ``fused_encoder`` launch a step),
    ``train_whale_vae`` and ``finetune_whale_bigan`` (no kernel launch: E is
    differentiated), ``whale_generator_score`` and ``whale_cf_score`` with
    ``--bigan-ft`` and ``--vae`` (launches checked against the data's counts;
    each of ``whale_cf_score``'s launches told apart by the first conv kernel
    of the trunk it ran: the BiGAN's, the fine-tuned BiGAN's or the VAE's,
    as their files hold them); each CLI's
    seconds, steps/s, launches and launch shapes; the trunk kernel at the
    recompute's (32, 256, 256, 2) on the trained BiGAN's and VAE's trunks and
    fan-in weights, timed;
W2. the whale trunk, whole, at B = 32 against float64 within a quarter of
    the float32 gate, on the trained weights and on fan-in weights (P1's
    check; each layer alone printed);
S1. the ESRF CLIs: ``train_esrf_bigan --max-batches 1`` (remat on, batch 16,
    one epoch, ``--resume`` for a second, bit for bit), with the device's peak
    memory, the checkpoint's bytes, its save and load seconds, the host's
    peak resident memory while it loads and the disk's free space;
    ``finetune_esrf_bigan`` (one epoch, no kernel launch, E and G saved
    alone) and ``esrf_quality``; the whole ESRF trunk at (16, 512, 512, 3)
    against its plain version on the trained weights and on fan-in weights,
    timed.

and for data parallelism on the main path's trainer (the full-width MNIST
BiGAN, batch 64, ``d_updates_per_g_update=3``), after the marine phases:

D1. two gloo ranks on the one card, spawned by the script, against one
    process: 3 steps on the same global batches with the same noise
    injected (drawn once, for the global batch); every rank's E, G and D
    alike, each within the CPU tests' tolerance of the one process's (all
    but one element in a thousand within rtol 2e-3 / atol 2e-4, none beyond
    ``2 lr`` an Adam update), the mean of the ranks' metrics likewise; one
    ``fused_encoder`` launch a step on each rank, and the kernel against its
    plain version at a rank's shard, (32, 28, 28, 5), timed (the
    ``fused_encoder:dp_rank`` row). gloo carries the card's tensors (its
    all-reduce and broadcast), so the two ranks share the card;
D2. an NCCL group of one, joined through ``parallel.init_from_env`` as
    under ``torchrun``, against no group: 3 steps bit for bit (cuDNN's
    deterministic algorithms), the collectives of three steps by kind, and
    steps/s of 40 steps of each, in turns, then 10 steps of each under
    ``torch.profiler``: device time, host ops, NCCL's kernels and the host
    time of each all-reduce op a step;
D3. ``train_mnist_image_scm`` for one epoch on C1's rows under ``python -m
    torch.distributed.run --standalone --nproc-per-node 1`` (``torchrun``)
    and as a plain run, both with one seed and under cuDNN's deterministic
    algorithms (a two-line driver runs the CLI module as ``__main__``): the
    two checkpoints equal bit for bit.

and last, the quality battery:

Q.  ``imagecfgen_torch/tools/quality_battery.py`` through its ``main`` on
    M1's data (no synthesis) at one epoch, every other budget at 1: every
    stage runs and has its record entry (command line, seconds, launches,
    what it printed), the record holds every score that ``compare`` reads
    and the card's line, and ``fused_encoder`` launched once a step in the
    BiGAN stage and at least once in every score stage that encodes.
QA. ``imagecfgen_torch/tools/audio_battery.py`` through its ``main`` on AU's
    stand-in (``shared_stand_in``) cut to its first 5 subjects, in bf16 at
    one epoch, cut in depth only (SCM steps, classifier epochs, ``--gen-n``;
    the VAE one epoch, the subject classifier one): all eleven stages run
    and have their record entries, every score and the card's line are in
    the record, ``fused_encoder`` launched once a step in the bf16 BiGAN
    stage and at least once in every stage that encodes, ``fused_dense`` at
    least once in every stage that classifies.

The ``kernels`` line lists every kernel row (``launches``: the count of the
row's own path, read around it alone: the serving path's, the explainer
CLIs' for ``fused_encoder:b1`` at (1, 28, 28, 5), ``audiomnist_cf_eval``'s
for ``fused_encoder:audio_cf_eval``, the bf16 training CLI's for
``fused_encoder:audio_train_bf16``, since no serving CLI runs the kernel in
bf16, and ``audiomnist_vae_score``'s for ``fused_encoder:audio_vae``, the marine
CLIs' for ``fused_encoder:whale``, ``fused_encoder:whale_vae``,
``fused_encoder:esrf`` and ``fused_dense:narw``, and D1's two ranks' for
``fused_encoder:dp_rank``; ``train_launches`` over ``train_steps``: the training path's;
``cli_launches``: each CLI run's at the row's shape, R, C, M, X, F, AU, Q and QA phases;
the ``fused_encoder:audio_mnist`` and ``fused_dense`` rows' hold the audio
CLIs' at every batch); the last line of output
is ``{"ok": true, "device": {...}}``; the line before it is ``nvidia-smi``'s
name and power limit of the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# where --profile writes its tables
PROFILE_DIR = "chiprun_out"

# dense tensor-core rates (TFLOP/s: TF32, bf16) and memory rates (TB/s) from
# NVIDIA's data sheets, by a substring of torch.cuda.get_device_name()
PEAKS = (
    ("H100 PCIe", 378.0, 756.0, 2.0),
    ("H100 NVL", 417.0, 835.0, 3.9),
    ("H200", 495.0, 989.0, 4.8),
    ("H100", 495.0, 989.0, 3.35),  # SXM: "NVIDIA H100 80GB HBM3"
)
TRAIN_STEPS = 100  # steps of each MNIST GAN-training epoch (warm-up and timed)
# rows of the CLI phases' dataset (Morpho-MNIST has 60,000 and 10,000): one
# training-CLI epoch is 100 steps at batch 64
CLI_TRAIN, CLI_TEST = 6400, 2048
F32, BF16 = torch.float32, torch.bfloat16
DTYPES = (F32, BF16)
TAG = {F32: "f32", BF16: "bf16"}
# max |kernel - plain| <= GATE * max(1, max |plain|)
GATE = {F32: 1e-4, BF16: 2.0 ** -6}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond, msg: str) -> None:
    """Fail the run (independent of ``python -O``)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def peaks(name: str):
    """{dtype: FLOP/s of the unit the kernels use} and bytes/s. float32
    tensors take three TF32 products per product, so a third of that rate."""
    for key, tf32, bf16, tbs in PEAKS:
        if key in name:
            return {F32: tf32 * 1e12 / 3, BF16: bf16 * 1e12}, tbs * 1e12
    raise RuntimeError(f"no peak rates known for {name!r}")


def agree(what: str, out, plain, dtype) -> float:
    """Hold a kernel's output against its plain version; returns the error."""
    check(out.shape == plain.shape and out.dtype == plain.dtype == dtype,
          f"{what}: {tuple(out.shape)} {out.dtype} against {tuple(plain.shape)} {plain.dtype}")
    out, plain = out.float(), plain.float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    tol = GATE[dtype] * max(1.0, plain.abs().max().item())
    err = (out - plain).abs().max().item()
    print(f"{what} [{TAG[dtype]}]: max|kernel - plain| = {err:.3e} (tol {tol:.3e})")
    check(err <= tol, f"{what} [{TAG[dtype]}] disagrees with its plain version")
    return err


def cast_pairs(params, dtype):
    """Trunk parameters in ``dtype`` and as (kernel, bias) pairs."""
    from imagecfgen_torch.ops.fused_encoder import trunk_weights

    cast = {k: v.to(dtype) for k, v in params.items()}
    flat = trunk_weights(cast)
    return cast, [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]


def check_trunk(name: str, params, feats, plan, dtype, splits=(0,)):
    """The trunk kernel against its plain version at ``feats``' shape, its
    launch plan printed, and once more after a weight changed in place.
    Returns (error, cast params, pairs, feats in dtype, plain output)."""
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_launch_plan,
    )
    from imagecfgen_torch.ops.tensor_core import sm_count

    conv_ops = plan_conv_ops(plan)
    cast, pairs = cast_pairs(params, dtype)
    x = feats.to(dtype)
    for i, lp in enumerate(trunk_launch_plan(tuple(x.shape), [tuple(w.shape) for w, _ in pairs],
                                             conv_ops, dtype, sm_count(x.device))):
        print(f"launch plan {name} [{TAG[dtype]}] layer {i + 1}: {lp.describe()}")
    plain = fused_encoder_reference(x, pairs, conv_ops)
    errs = []
    for split in splits:
        out = fused_encoder_forward(cast, x, plan, split=split)
        torch.cuda.synchronize()
        errs.append(agree(f"fused_encoder {name} split={split}", out, plain, dtype))
    # stale weights: the packed copy must follow an in-place update
    last = f"conv_{len(pairs) - 1}_kernel"
    saved = cast[last].clone()
    cast[last].mul_(1.5)
    out = fused_encoder_forward(cast, x, plan)
    torch.cuda.synchronize()
    agree(f"fused_encoder {name} after an in-place weight update", out,
          fused_encoder_reference(x, pairs, conv_ops), dtype)
    check((out.float() - plain.float()).abs().max().item() > 0, "the weight update changed nothing")
    cast[last].copy_(saved)
    return errs[0], cast, pairs, x, plain


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events, after a
    warm-up; a hard sync closes the timed region."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn``, summed over the kernels that
    torch.profiler records in ``reps`` calls after a warm-up: the time
    without the host's launch overhead, which ``time_ms`` includes when the
    host, not the device, sets the pace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3 / reps


def trunk_params(plan, seed: int, dev, c_in: int = 5, std=0.05):
    """Full-width trunk weights drawn with numpy at N(0, std) (``std=None``:
    1/sqrt(fan_in)), in the port's layout."""
    rng = np.random.default_rng(seed)
    params, i = {}, 0
    for op in plan:
        if op[0] != "conv":
            continue
        ch, k = op[1], op[2]
        sd = 1 / np.sqrt(c_in * k * k) if std is None else std
        w = rng.normal(0, sd, (ch, c_in, k, k)).astype(np.float32)
        params[f"conv_{i}_kernel"] = torch.from_numpy(w).to(dev)
        params[f"conv_{i}_bias"] = torch.from_numpy(rng.normal(0, 0.05, ch).astype(np.float32)).to(dev)
        c_in, i = ch, i + 1
    return params


def trunk_cost(feats_shape, pairs, conv_ops, esize: int = 4):
    """(FLOPs, bytes) the trunk must do and move: each input read once, each
    output written once, ``esize`` bytes an element."""
    from imagecfgen_torch.ops.conv import conv_out_size

    b, h, w, c = feats_shape
    flops, nbytes = 0, esize * b * h * w * c
    for (stride, pad, _), (wt, bias) in zip(conv_ops, pairs):
        co, ci, k, _ = wt.shape
        h, w = conv_out_size(h, k, stride, pad), conv_out_size(w, k, stride, pad)
        flops += 2 * b * h * w * co * ci * k * k
        nbytes += esize * (wt.numel() + bias.numel())
    return flops, nbytes + esize * b * h * w * co


def library_stack(feats, pairs, conv_ops):
    """The same function as PyTorch library calls (cuDNN convs on a
    channels-last view): the yardstick, never called by the port."""
    x = feats.permute(0, 3, 1, 2)
    for (stride, pad, slope), (w, b) in zip(conv_ops, pairs):
        x = F.conv2d(x, w, b, stride=stride, padding=pad)
        if slope is not None:
            x = F.leaky_relu(x, slope)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def engine_stages_ms(engine, x, attrs, do):
    """Device time of the engine's stages on one batch: attribute SCM
    (abduct-act-predict on the attributes), encoder, generator."""
    scm, scaler = engine.scm, engine.scaler
    obs = engine._to_graph_obs(attrs)
    cf = engine._to_model_attrs(scm.graph.sample_cf(scm.params, scm.state, None, obs, do))
    a, a_cf = scaler.scale(attrs), scaler.scale(cf)
    z = engine.bigan.encoder(x, a)
    return {
        "attribute_scm": time_ms(lambda: engine._to_model_attrs(
            scm.graph.sample_cf(scm.params, scm.state, None, obs, do)), reps=10),
        "scaling": time_ms(lambda: (scaler.scale(attrs), scaler.scale(cf)), reps=10),
        "encoder": time_ms(lambda: engine.bigan.encoder(x, a), reps=10),
        "generator": time_ms(lambda: engine.bigan.generator(z, a_cf), reps=10),
    }


def profile_path(fn, filename: str) -> None:
    """torch.profiler over one call of ``fn``: device time by kernel, as a
    table in ``PROFILE_DIR/<filename>``, and the device's busy time against
    the profiled call's host-clock time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, filename), "w") as f:
        f.write(events.table(sort_by="cuda_time_total", row_limit=40))
    print(f"profile: {PROFILE_DIR}/{filename}; device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"(idle {1 - busy_ms / wall_ms:.1%}), {sum(e.count for e in device)} kernels")


def mangled_name(mangled: str) -> str:
    """The last name of an Itanium-mangled nested name (``_ZN...``)."""
    i, name = 3, "?"
    while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    return name


def kernel_lines(log: str):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name, template
    arguments, registers and spills."""
    for chunk in log.split("Compiling entry function")[1:]:
        mangled = chunk.split("'")[1] if "'" in chunk else ""
        targs = re.findall(r"L[ib](\d+)E", mangled)
        spills = re.search(r"(\d+) bytes spill stores", chunk)
        used = re.search(r"Used (\d+) registers.*", chunk)
        if "__nv_bfloat16" in mangled:
            targs.insert(0, "bf16")
        elif re.search(r"(conv|dense)_\w+?If", mangled):
            targs.insert(0, "f32")
        yield (f"  kernel {mangled_name(mangled)}<{','.join(targs)}>: "
               f"{used.group(0) if used else '?'}, {spills.group(0) if spills else '?'}")


def plan_flops(plan, in_shape) -> int:
    """FLOPs per sample (two per multiply-add) of a plan's convs,
    transposed convs and dense layers."""
    from imagecfgen_torch.ops.conv import conv_out_size, conv_transpose_out_size

    shape, flops = tuple(in_shape), 0
    for op in plan:
        if op[0] in ("conv", "convT"):
            (h, w, c), (co, k, st, p) = shape, op[1:5]
            if op[0] == "conv":
                oh, ow = conv_out_size(h, k, st, p), conv_out_size(w, k, st, p)
                flops += 2 * oh * ow * co * c * k * k
            else:  # every input pixel scatters into k*k outputs
                outpad = op[5] if len(op) > 5 else 0
                oh, ow = (conv_transpose_out_size(h, k, st, p, outpad),
                          conv_transpose_out_size(w, k, st, p, outpad))
                flops += 2 * h * w * co * c * k * k
            shape = (oh, ow, co)
        elif op[0] == "dense":
            flops += 2 * shape[-1] * op[1]
            shape = (op[1],)
        elif op[0] == "flatten":
            shape = (int(np.prod(shape)),)
        elif op[0] == "reshape":
            shape = tuple(op[1])
    return flops


def row(name, dtype, source, replaces, launches, err, kernel_ms, plain_ms, library_ms,
        flops, nbytes, peak, card, **extra):
    """One entry of the ``kernels`` line; the bound is the larger of the
    operations over the rate of the unit the kernel uses in ``dtype`` (a
    third of the TF32 rate for float32, the bf16 rate) and the bytes over
    the memory rate."""
    from imagecfgen_torch.ops.tensor_core import INSTRUCTION

    t_ops, t_bytes = flops / peak[0][dtype] * 1e3, nbytes / peak[1] * 1e3
    return {
        "name": name if dtype == F32 else f"{name}:bf16", "dtype": TAG[dtype],
        "instruction": INSTRUCTION, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, **extra, "flops": flops, "bytes": nbytes, "card": card,
    }


def dense_cost(m: int, k: int, n: int, esize: int = 4):
    """(FLOPs, bytes) of ``lrelu(x @ w.T + b)``: each input read once, the
    output written once, ``esize`` bytes an element."""
    return 2 * m * n * k, esize * (m * k + n * k + n + m * n)


def layer_times(name: str, pairs, conv_ops, feats, dtype):
    """Each layer of a trunk alone (``--profile``): the kernel on that
    layer's input beside one ``F.conv2d`` (+ ``F.leaky_relu``), in ms and in
    TFLOP/s of the layer's 2 * M * N * K operations."""
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward

    x, out = feats, []
    with torch.no_grad():
        for i, ((stride, pad, slope), (w, b)) in enumerate(zip(conv_ops, pairs)):
            one = {"conv_0_kernel": w, "conv_0_bias": b}
            plan = (("conv", w.shape[0], w.shape[2], stride, pad),)
            plan += (("lrelu", slope),) if slope is not None else ()
            xi = x
            ms = time_ms(lambda: fused_encoder_forward(one, xi, plan), reps=10, warmup=2)
            lib_ms = time_ms(lambda: library_stack(xi, [(w, b)], [(stride, pad, slope)]), reps=10, warmup=2)
            y = fused_encoder_forward(one, xi, plan)
            flops = 2 * y.numel() * w[0].numel()
            out.append({"layer": i + 1, "ms": ms, "tflops": flops / ms / 1e9, "library_ms": lib_ms})
            oh = (x.shape[1] + 2 * pad - w.shape[2]) // stride + 1
            ow = (x.shape[2] + 2 * pad - w.shape[2]) // stride + 1
            x = y.reshape(x.shape[0], oh, ow, w.shape[0])
    print(json.dumps({"layers": name, "dtype": TAG[dtype], "times": out}))


def seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms inside, for runs compared bit for
    bit; both settings as they were afterwards."""
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def same_tree(a, b, path: str) -> None:
    """Two states alike bit for bit, tensor for tensor."""
    if isinstance(b, dict):
        check(set(a) == set(b), f"{path}: keys differ")
        for k in b:
            same_tree(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(b):
        check(torch.equal(a, b), f"{path} differs")
    else:
        check(a == b, f"{path}: {a} != {b}")


def audio_phases(args, dev, card, peak):
    """Phases A2-A4: the AudioMNIST scoring path in both types. Returns
    (kernel rows, score lines)."""
    import dataclasses

    from imagecfgen_torch.cf.engine import CounterfactualEngine
    from imagecfgen_torch.core.attributes import AttributeScaler
    from imagecfgen_torch.metrics.scores import cf_effectiveness_score, resample_excluding
    from imagecfgen_torch.models import layers
    from imagecfgen_torch.models.bigan import AUDIO_MNIST_SPEC, BiGAN, audio_mnist_bigan_config
    from imagecfgen_torch.models.classifier import CNNClassifier, audio_mnist_classifier_config
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu, fused_dense_reference, launch_plan
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
    )
    from imagecfgen_torch.scm.audio_mnist import AudioMNISTAttributeSCM, build_audio_mnist_graph

    b = args.audio_batch
    rng = np.random.default_rng(args.seed + 2)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # ------------------------------- A2. kernels against their plain versions
    head = (b, 4096, 1024)
    dense_in = {}
    dense_errs = {dtype: [] for dtype in DTYPES}
    for m, k, n in (head, (100, 300, 200), (100, 3000, 200), (100, 301, 200)):
        x32 = tensor(rng.normal(0, 1, (m, k)))
        w32 = tensor(rng.normal(0, 1 / np.sqrt(k), (n, k)))
        bias32 = tensor(rng.normal(0, 0.5, n))
        for dtype in DTYPES:
            x, w, bias = x32.to(dtype), w32.to(dtype), bias32.to(dtype)
            print(f"launch plan fused_dense {m}x{k}x{n} [{TAG[dtype]}]: "
                  f"{launch_plan(w, m).describe()}")
            out = fused_dense_lrelu(x, w, bias, 0.2)
            torch.cuda.synchronize()
            dense_errs[dtype].append(agree(f"fused_dense {m}x{k}x{n}", out,
                                           fused_dense_reference(x, w, bias, 0.2), dtype))
            dense_in[(m, k, n), dtype] = (x, w, bias)

    plan = audio_mnist_bigan_config().enc_plan
    conv_ops = plan_conv_ops(plan)
    params = trunk_params(plan, args.seed, dev, c_in=7, std=None)
    feats = tensor(rng.normal(0, 1, (b, 128, 128, 7)))
    trunk = {dtype: check_trunk("audio trunk", params, feats, plan, dtype) for dtype in DTYPES}
    # the narrow trunks of the CLIs' --d: a later layer on conv_window, or on conv_wgmma with its
    # input padded with zero channels to the slice depth (d = 8 and 48 reach both, in both types;
    # split 1: the trunk's own input padded)
    for d in (8, 48):
        nplan = audio_mnist_bigan_config(d=d).enc_plan
        nfeats = tensor(np.random.default_rng(args.seed + 100 + d).normal(0, 1, (4, 128, 128, 7)))
        nparams = trunk_params(nplan, args.seed + 100 + d, dev, c_in=7, std=None)
        for dtype in DTYPES:
            check_trunk(f"audio trunk d={d}", nparams, nfeats, nplan, dtype, splits=(0, 1))

    # ----------------------------------------------------- A3. the path
    graph = build_audio_mnist_graph()
    scm = AudioMNISTAttributeSCM(graph, *graph.init(seeded(args.seed), dev))
    xd = tensor(rng.uniform(-1, 1, (b, 128, 128, 1)))
    attrs = {a.name: F.one_hot(torch.from_numpy(rng.integers(0, a.n_categories, b)), a.n_categories)
             .float().to(dev) for a in AUDIO_MNIST_SPEC}
    rows, lines, x_cfs = [], [], {}
    for dtype in DTYPES:
        # the same float32 parameters in both types: one seed
        cfg = audio_mnist_bigan_config(compute_dtype=dtype)
        clf_cfg = dataclasses.replace(audio_mnist_classifier_config(10), compute_dtype=dtype)
        clf = CNNClassifier(clf_cfg, dev, seeded(args.seed + 3)).eval()
        engine = CounterfactualEngine(BiGAN(cfg, dev, seeded(args.seed + 4)), scm,
                                      AttributeScaler.fit(AUDIO_MNIST_SPEC, {}), dev)

        fused_encoder_forward.launches = 0
        fused_dense_lrelu.launches = 0
        score = cf_effectiveness_score(engine, clf, xd, attrs, seeded(args.seed + 5), "digit",
                                       args.mc_rounds)
        torch.cuda.synchronize()
        launches = {"fused_encoder": fused_encoder_forward.launches,
                    "fused_dense": fused_dense_lrelu.launches}
        print(f"audio path [{TAG[dtype]}]: cf_effectiveness_score = {score:.4f}; launches {launches}")
        check(np.isfinite(score) and 0.0 <= score <= 1.0, f"score {score}")
        for kname, count in launches.items():
            check(count > 0, f"the AudioMNIST path [{TAG[dtype]}] did not reach the {kname} kernel")

        with torch.no_grad():
            g = seeded(args.seed + 6)
            obs = engine._to_graph_obs(attrs)
            new = resample_excluding(scm.graph, scm.params, scm.state, g, "digit", obs)
            x_cf, cf_attrs = engine.counterfactual(xd, attrs, {"digit": new}, g)
            logits = clf(x_cf)
            layers.fused_dense_lrelu = fused_dense_reference
            try:
                logits_plain = clf(x_cf)
            finally:
                layers.fused_dense_lrelu = fused_dense_lrelu
        torch.cuda.synchronize()
        x_cfs[dtype] = x_cf
        check(x_cf.shape == (b, 128, 128, 1) and x_cf.dtype == F32, f"x_cf {tuple(x_cf.shape)} {x_cf.dtype}")
        check(torch.isfinite(x_cf).all(), "non-finite x_cf")
        check(x_cf.abs().max().item() <= 1.0, "x_cf outside [-1, 1]")
        check(torch.equal(cf_attrs["digit"].argmax(-1), new), "the counterfactual digit is not the new class")
        check(bool((new != obs["digit"]).all()), "the resampled digit equals the observed one in some row")
        for a in AUDIO_MNIST_SPEC:
            if a.name != "digit":
                check(torch.equal(cf_attrs[a.name], attrs[a.name]), f"{a.name} changed under do(digit)")
        check(torch.isfinite(logits).all() and logits.shape == (b, 10) and logits.dtype == F32,
              "classifier logits")
        logit_tol = GATE[dtype] * max(1.0, logits_plain.abs().max().item())
        logit_err = (logits - logits_plain).abs().max().item()
        print(f"classifier logits [{TAG[dtype]}]: max|kernel head - plain head| = {logit_err:.3e} "
              f"(tol {logit_tol:.3e})")
        check(logit_err <= logit_tol, "the classifier's fused head disagrees with its plain version")

        # -------------------------------------------------- A4. times
        x, w, bias = dense_in[head, dtype]
        trunk_err, cast, pairs, tfeats, _ = trunk[dtype]
        with torch.no_grad():
            dense_ms = time_ms(lambda: fused_dense_lrelu(x, w, bias, 0.2), reps=200, warmup=10)
            dense_plain_ms = time_ms(lambda: fused_dense_reference(x, w, bias, 0.2), reps=100, warmup=5)
            dense_lib_ms = time_ms(lambda: F.leaky_relu(F.linear(x, w, bias), 0.2), reps=200, warmup=10)
            dense_device = {
                "device_ms": device_ms(lambda: fused_dense_lrelu(x, w, bias, 0.2)),
                "plain_device_ms": device_ms(lambda: fused_dense_reference(x, w, bias, 0.2)),
                "library_device_ms": device_ms(lambda: F.leaky_relu(F.linear(x, w, bias), 0.2)),
            }
            trunk_ms = time_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=10, warmup=2)
            trunk_plain_ms = time_ms(lambda: fused_encoder_reference(tfeats, pairs, conv_ops), reps=2, warmup=1)
            trunk_lib_ms = time_ms(lambda: library_stack(tfeats, pairs, conv_ops), reps=10, warmup=2)
            trunk_device_ms = device_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=5)
            trunk_lib_device_ms = device_ms(lambda: library_stack(tfeats, pairs, conv_ops), reps=5)
            lib = library_stack(tfeats, pairs, conv_ops).float()
            plain = fused_encoder_reference(tfeats, pairs, conv_ops).float()
            lib_err = (lib - plain).abs().max().item()
            # cuDNN's bf16 stack rounds at other places than the fused trunk: printed, gated in f32 only
            print(f"library stack audio trunk [{TAG[dtype]}]: max|library - plain| = {lib_err:.3e}")
            check(dtype != F32 or lib_err <= GATE[F32] * max(1.0, plain.abs().max().item()),
                  f"library stack disagrees with the plain audio trunk ({lib_err:.3e})")
            del lib, plain
            score_ms = time_ms(lambda: cf_effectiveness_score(engine, clf, xd, attrs, g, "digit",
                                                              args.mc_rounds), reps=3, warmup=1)
            a_cf = {**attrs, "digit": cf_attrs["digit"]}
            z = engine.bigan.encoder(xd, attrs)
            stages = {
                "scm_and_resample": time_ms(lambda: engine._to_model_attrs(scm.graph.sample_cf(
                    scm.params, scm.state, g, obs, {"digit": resample_excluding(
                        scm.graph, scm.params, scm.state, g, "digit", obs)})), reps=10),
                "encoder": time_ms(lambda: engine.bigan.encoder(xd, attrs), reps=5),
                "generator": time_ms(lambda: engine.bigan.generator(z, a_cf), reps=5),
                "classifier": time_ms(lambda: clf(x_cf), reps=5),
            }
        if args.profile:
            layer_times("audio trunk", pairs, conv_ops, tfeats, dtype)
            t0 = time.perf_counter()
            cf_effectiveness_score(engine, clf, xd, attrs, g, "digit", 1)
            print(f"one scoring round [{TAG[dtype]}]: {(time.perf_counter() - t0) * 1e3:.3f} ms on the host clock")
            profile_path(lambda: cf_effectiveness_score(engine, clf, xd, attrs, g, "digit", 1),
                         f"chip_smoke_profile_audio_{TAG[dtype]}.txt")
        gflop = {
            "encoder": plan_flops(cfg.enc_plan, (128, 128, 7)) / 1e9,
            "generator": plan_flops(cfg.gen_plan, (cfg.latent_dim + 6 * cfg.embed_dim,)) / 1e9,
            "classifier": plan_flops(clf.cfg.plan, (128, 128, 1)) / 1e9,
        }
        esize = tfeats.element_size()
        tflops, tbytes = trunk_cost(tuple(tfeats.shape), pairs, conv_ops, esize)
        dflops, dbytes = dense_cost(*head, esize)
        rows += [
            row("fused_encoder:audio_mnist", dtype, "imagecfgen_torch/csrc/fused_encoder.cu",
                "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", launches["fused_encoder"], trunk_err,
                trunk_ms, trunk_plain_ms, trunk_lib_ms, tflops, tbytes, peak, card, batch=b,
                device_ms=trunk_device_ms, library_device_ms=trunk_lib_device_ms),
            row("fused_dense", dtype, "imagecfgen_torch/csrc/fused_dense.cu",
                "imagecfgen_tpu/ops/pallas/fused_dense.py:57", launches["fused_dense"],
                max(dense_errs[dtype]), dense_ms, dense_plain_ms, dense_lib_ms, dflops, dbytes, peak,
                card, shape=list(head), **dense_device),
        ]
        lines.append({
            "path": f"audio_mnist cf_effectiveness_score(digit, mc_rounds={args.mc_rounds})",
            "compute_dtype": TAG[dtype],
            "batch": b,
            "score": score,
            "ms_per_score": score_ms,
            "counterfactuals_per_s": b * args.mc_rounds / (score_ms / 1e3),
            "stages_ms": stages,
            "gflop_per_sample": gflop,
            "stage_tflops": {k: v * b / stages[k] for k, v in gflop.items()},
            "card": card,
        })
        del engine, clf
    diff = (x_cfs[BF16] - x_cfs[F32]).abs().max().item()
    print(f"audio path: max|x_cf(bf16) - x_cf(f32)| = {diff:.3e} (printed, not gated)")
    return rows, lines


def changed(before, module, what: str) -> None:
    """Every parameter of ``module`` differs from its clone in ``before``
    and holds a gradient."""
    for n, p in module.named_parameters():
        check(p.grad is not None, f"{what}: {n} ended a step with grad None")
        check(not torch.equal(p.detach(), before[n]), f"{what}: {n} did not change")


def grads_agree(what: str, got, plain) -> float:
    """Gradients against the plain route's, under the float32 gate; every
    gradient outside it is printed before the run fails."""
    worst, bad = 0.0, []
    for name in plain:
        g, p = got[name], plain[name]
        check(g is not None and g.shape == p.shape, f"{what}: gradient of {name} missing")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite gradient of {name}")
        tol = GATE[F32] * max(1.0, p.abs().max().item())
        err = (g - p).abs().max().item()
        if err > tol:
            bad.append(name)
            print(f"{what}: gradient of {name} off by {err:.3e} (tol {tol:.3e}, max|plain| "
                  f"{p.abs().max().item():.3e})")
        worst = max(worst, err / tol)
    check(not bad, f"{what}: gradients of {bad} outside the gate")
    print(f"{what}: {len(plain)} gradients within the gate (worst at {worst:.1%} of it)")
    return worst


def near_kink(what: str, a, b, total_gate: float = 1e-5) -> int:
    """The LeakyReLU inputs that lie on different sides of zero in two routes
    (``a``, ``b``: lists of pre-activations): there may be at most 4 or
    ``total_gate`` of all of them, each within float32 rounding of zero,
    ``1e-5 * max(1, max|input|)``, in both routes. Returns their number."""
    flips, total = 0, sum(t.numel() for t in a)
    most = max(4, int(total_gate * total))
    for i, (u, v) in enumerate(zip(a, b)):
        flipped = (u >= 0) != (v >= 0)
        n = int(flipped.sum())
        if n:
            near = 1e-5 * max(1.0, u.abs().max().item())
            far = max(u[flipped].abs().max().item(), v[flipped].abs().max().item())
            check(far <= near, f"{what}: a LeakyReLU input of layer {i + 1} changes sign between the "
                               f"routes at |value| {far:.3e}, beyond rounding ({near:.3e})")
        flips += n
    print(f"{what}: {flips} of {total} LeakyReLU inputs lie on different sides of zero in the two "
          f"routes (at most {most} may, each within rounding of zero)")
    check(flips <= most, f"{what}: {flips} LeakyReLU inputs change sides between the routes")
    return flips


def trunk_at_training_shape(name: str, encoder, x, attrs, plan, seed: int, dev, peak, card,
                            key: str = "kernel_at_training_shape"):
    """The trunk kernel against its plain version at the shape a trainer's
    recompute phase (or another caller, named by ``key``) gives it (the
    launch plans follow the batch): on the model's own
    encoder weights and attribute channels, and on fan-in-scaled weights and
    N(0, 1) features of that shape, whose O(1) outputs make the float32 gate
    bite. Returns a line with the kernel's times at that shape beside its
    plain version's, the ``F.conv2d`` stack's and the bound."""
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward, fused_encoder_reference, plan_conv_ops

    with torch.no_grad():
        feats = encoder.attr_channels(x, attrs)
        own = {n: p.detach() for n, p in encoder.trunk.named_parameters()}
        err, _, _, _, plain = check_trunk(f"{name}, the model's weights", own, feats, plan, F32)
        top = plain.abs().max().item()
        print(f"fused_encoder {name}, the model's weights: max|plain| = {top:.3e}, "
              f"relative error {err / top:.3e} (printed, not gated)")
        rng = np.random.default_rng(seed)
        probe = torch.from_numpy(rng.normal(0, 1, tuple(feats.shape)).astype(np.float32)).to(dev)
        err, cast, pairs, tfeats, _ = check_trunk(
            f"{name}, fan-in weights", trunk_params(plan, seed, dev, c_in=feats.shape[-1], std=None),
            probe, plan, F32)
        conv_ops = plan_conv_ops(plan)
        kernel_ms = time_ms(lambda: fused_encoder_forward(cast, tfeats, plan))
        device = device_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=20)
        plain_ms = time_ms(lambda: fused_encoder_reference(tfeats, pairs, conv_ops), reps=5, warmup=1)
        library_ms = time_ms(lambda: library_stack(tfeats, pairs, conv_ops))
        library_device = device_ms(lambda: library_stack(tfeats, pairs, conv_ops), reps=20)
    flops, nbytes = trunk_cost(tuple(tfeats.shape), pairs, conv_ops)
    t_ops, t_bytes = flops / peak[0][F32] * 1e3, nbytes / peak[1] * 1e3
    return {key: "fused_encoder", "trunk": name, "shape": list(tfeats.shape),
            "dtype": "f32", "max_abs_err": err, "ms": kernel_ms, "device_ms": device,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_device_ms": library_device,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "card": card}


def adam_steps_ms(params, tcfg):
    """One Adam step over copies of ``params`` with fixed gradients: the
    port's ``train/optim.py::Adam`` (flat moments) with a float32 and a
    bfloat16 ``mu`` beside ``torch.optim.Adam`` (the library yardstick, which
    the port does not use). The step is host-bound, so this is the host's
    time to enqueue it."""
    from imagecfgen_torch.train.optim import Adam

    def fresh():
        out = [p.detach().clone().requires_grad_(True) for p in params]
        for p in out:
            p.grad = torch.randn_like(p)
        return out

    kw = dict(lr=tcfg.learning_rate, betas=tuple(tcfg.betas), eps=1e-8)
    opts = {"port": Adam(fresh(), **kw), "port_mu_bf16": Adam(fresh(), **kw, mu_dtype=BF16),
            "torch_optim": torch.optim.Adam(fresh(), **kw, foreach=True)}
    return {name: time_ms(opt.step) for name, opt in opts.items()}


def gan_data(cfg, n: int, rng, dev):
    """A synthetic device-resident set for ``cfg``: U(-1, 1) images, uniform
    one-hot categorical attributes, U(-1, 1) continuous ones (scaled)."""
    h, w = cfg.image_size
    x = torch.from_numpy(rng.uniform(-1, 1, (n, h, w, cfg.image_channels)).astype(np.float32))
    attrs = {a.name: F.one_hot(torch.from_numpy(rng.integers(0, a.n_categories, n)),
                               a.n_categories).float() for a in cfg.attr_spec.categorical}
    attrs.update({a.name: torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
                  for a in cfg.attr_spec.continuous})
    return x.to(dev), {k: v.to(dev) for k, v in attrs.items()}


def training_phases(args, dev, card, peak):
    """Phases T1-T6. Returns ({kernel row name: (launches, steps)}, lines)."""
    import dataclasses

    from imagecfgen_torch.core.checkpoint import load_meta, load_train_state, save_train_state
    from imagecfgen_torch.ops.conv import conv2d, conv_out_size
    from imagecfgen_torch.models.bigan import (
        BiGAN,
        Encoder,
        audio_mnist_bigan_config,
        mnist_bigan_config,
    )
    from imagecfgen_torch.models.classifier import CNNClassifier, audio_mnist_classifier_config
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu, fused_dense_reference
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
        trunk_weights,
    )
    from imagecfgen_torch.scm.audio_mnist import CARDINALITIES, AudioMNISTAttributeSCM
    from imagecfgen_torch.scm.mnist import MNISTAttributeSCM
    from imagecfgen_torch.train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer
    from imagecfgen_torch.train.gan_trainer import METRICS, GANTrainConfig, GANTrainer

    rng = np.random.default_rng(args.seed + 20)
    lines, train_launches = [], {}

    # ------------------------------------------ T1. GAN training, MNIST
    steps, bsz = TRAIN_STEPS, 64
    cfg = mnist_bigan_config()
    tcfg = GANTrainConfig(batch_size=bsz, d_updates_per_g_update=3)
    tr = GANTrainer(BiGAN(cfg, dev, seeded(args.seed + 21)), tcfg, seed=args.seed + 22)
    data = tr.upload_dataset(*gan_data(cfg, steps * bsz, rng, dev))
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    stats0 = {n: b.clone() for n, b in tr.model.discriminator.named_buffers()}
    check(len(stats0) == 8, f"D has {len(stats0)} batch-norm buffers, not 8")
    fused_encoder_forward.launches = 0
    warm = tr.fit_epoch(data)
    check(fused_encoder_forward.launches == steps, "warm-up epoch: one fused_encoder launch a step")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fused_encoder_forward.launches = 0
    start.record()
    metrics = tr.fit_epoch(data)
    end.record()
    torch.cuda.synchronize()
    epoch_ms = start.elapsed_time(end)
    launches = fused_encoder_forward.launches
    train_launches["fused_encoder"] = (launches, steps)
    print(f"T1 GAN training MNIST: {steps} steps in {epoch_ms:.1f} ms; fused_encoder launched "
          f"{launches} times; metrics {metrics}")
    for m in (warm, metrics):
        check(sorted(m) == sorted(METRICS) and all(np.isfinite(v) for v in m.values()), f"metrics {m}")
    check(launches == steps, f"{launches} fused_encoder launches in {steps} steps")
    check(tr.step == 2 * steps, f"step count {tr.step}")
    changed(before, tr.model, "T1")
    for n, b in tr.model.discriminator.named_buffers():
        check(not torch.equal(b, stats0[n]) and bool(torch.isfinite(b).all()),
              f"T1: D's running statistic {n} did not move")
    state = tr.state_dict()
    check(state["opt_d"]["count"] == 2 * tr.step, f"Adam's D count {state['opt_d']['count']}")
    check(state["opt_eg"]["count"] == -(-tr.step // 3), f"Adam's E+G count {state['opt_eg']['count']}")
    gan_line = {
        "trainer": "GANTrainer mnist_bigan_config()", "compute_dtype": "f32", "batch": bsz,
        "d_updates_per_g_update": 3, "steps": steps, "ms_per_step": epoch_ms / steps,
        "steps_per_s": steps / (epoch_ms / 1e3), "images_per_s": steps * bsz / (epoch_ms / 1e3),
        "fused_encoder_launches": launches, "metrics": metrics, "card": card,
    }

    # ------------------------------------------------ T6. checkpoint
    batch = {"image": data["image"][:bsz], "attrs": {k: v[:bsz] for k, v in data["attrs"].items()}}
    other = GANTrainer(BiGAN(cfg, dev, seeded(args.seed + 23)), tcfg, seed=args.seed + 24)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mnist-bigan-train.ckpt")
        t0 = time.perf_counter()
        save_train_state(path, state, meta={"kind": "bigan-train", "step": tr.step})
        size = os.path.getsize(path)
        check(load_meta(path) == {"kind": "bigan-train", "step": tr.step}, "checkpoint meta")
        loaded, _ = load_train_state(path)
        other.load_state_dict(loaded)
        print(f"T6 checkpoint: {size / 2**20:.1f} MiB saved and loaded in {time.perf_counter() - t0:.2f} s")
    del state, loaded
    check(other.step == tr.step, "restored step")
    with deterministic():  # the same kernels in the same order on both sides
        ma, mb = tr.train_step(batch), other.train_step(batch)
        torch.cuda.synchronize()
    same_tree({k: ma[k] for k in METRICS}, {k: mb[k] for k in METRICS}, "T6 metrics after the resumed step")
    sa, sb = tr.state_dict(), other.state_dict()
    same_tree(sa, sb, "T6 state after the resumed step")
    print("T6 checkpoint: the resumed trainer's next step is bit-identical (parameters, buffers, "
          "both Adam states, metrics, generator state)")
    del other, sa, sb

    # -------------------------------------------- T1b. the step by phase
    x, attrs = batch["image"], batch["attrs"]
    z, masks = tr.draw_noise(bsz)
    ex, gz = tr.recompute(x, attrs, z)
    gan_line["phases_ms"] = {
        "draw_noise": time_ms(lambda: tr.draw_noise(bsz)),
        "eg_update": time_ms(lambda: tr.eg_update(x, attrs, z, masks[:2])),
        "recompute": time_ms(lambda: tr.recompute(x, attrs, z)),
        "d_update_real": time_ms(lambda: tr.d_update(x, ex, attrs, 1, masks[2])),
        "d_update_fake": time_ms(lambda: tr.d_update(gz, z, attrs, 0, masks[3])),
    }
    gan_line["adam_step_ms"] = adam_steps_ms(tr.params_d, tcfg)
    lines.append(gan_line)
    if args.profile:
        profile_path(lambda: [tr.train_step(batch) for _ in range(5)], "chip_smoke_profile_train_f32.txt")

    # ---------------- T1c. the kernel at the shape the recompute gives it
    lines.append(trunk_at_training_shape(f"MNIST trunk at batch {bsz}", tr.model.encoder, x, attrs,
                                         cfg.enc_plan, args.seed + 35, dev, peak, card))

    # ------------------------------------------ T2. the gradient routes
    enc = Encoder(cfg, dev, seeded(args.seed + 25))
    with torch.no_grad():  # O(1) activations, so that the gate means something
        for k, v in trunk_params(cfg.enc_plan, args.seed + 26, dev, std=None).items():
            getattr(enc.trunk, k).copy_(v)
    names = [n for n, _ in enc.trunk.named_parameters()]
    feats = torch.from_numpy(rng.normal(0, 1, (bsz, 28, 28, 5)).astype(np.float32)).to(dev)
    probe = torch.from_numpy(rng.normal(0, 1, (bsz, cfg.latent_dim)).astype(np.float32)).to(dev)

    conv_ops = plan_conv_ops(cfg.enc_plan)

    def route_grads(route):
        f = feats.clone().requires_grad_(True)
        params = dict(enc.trunk.named_parameters())
        out = route(params, f).reshape(bsz, -1)
        grads = torch.autograd.grad((out * probe).sum(), [f, *params.values()])
        return out.detach(), dict(zip(["features", *names], grads))

    def plain_layers(params, f, sides=None):
        """The plain im2col version layer by layer. ``sides``: the side of
        zero each LeakyReLU input is taken to lie on (the layer's own when
        None). Returns (output, the LeakyReLU inputs)."""
        flat, x, pre = trunk_weights(params), f, []
        for i, (stride, pad, slope) in enumerate(conv_ops):
            wt, bias = flat[2 * i], flat[2 * i + 1]
            oh = conv_out_size(x.shape[1], wt.shape[2], stride, pad)
            x = fused_encoder_reference(x, [(wt, bias)], [(stride, pad, None)]).reshape(bsz, oh, oh, -1)
            if slope is not None:
                pre.append(x)
                x = torch.where(x >= 0 if sides is None else sides[i], x, slope * x)
        return x, pre

    # The two routes round differently (1e-6), so an activation within that of
    # zero can lie on either side of a LeakyReLU's kink, where the gradient
    # jumps by the slope: the plain gradients are taken on the sides the
    # PlanSequential route's activations lie on, read from its own forward.
    # That is sound only while such activations are few and within rounding
    # of zero in both routes, which near_kink holds them to.
    with torch.no_grad():
        pre_plan, x_plan = [], feats
        for i, (stride, pad, slope) in enumerate(conv_ops):
            x_plan = conv2d(x_plan, getattr(enc.trunk, f"conv_{i}_kernel"), stride, pad) \
                + getattr(enc.trunk, f"conv_{i}_bias")
            if slope is not None:
                pre_plan.append(x_plan)
                x_plan = F.leaky_relu(x_plan, slope)
        near_kink("T2 encoder, PlanSequential against the plain im2col version", pre_plan,
                  plain_layers(dict(enc.trunk.named_parameters()), feats)[1])
    sides = [t >= 0 for t in pre_plan]

    fused_encoder_forward.launches = 0
    out_plan, g_plan = route_grads(lambda params, f: enc.trunk(f, train=True))
    out_plain, g_plain = route_grads(lambda params, f: plain_layers(params, f, sides)[0])
    check(torch.equal(out_plan.reshape(x_plan.shape), x_plan), "T2: the replayed forward is not the trunk's")
    agree("T2 encoder forward through its PlanSequential", out_plan, out_plain, F32)
    grads_agree("T2 encoder gradients, PlanSequential against the plain im2col version", g_plan, g_plain)
    z_grad = enc(x, attrs)
    check(z_grad.requires_grad and fused_encoder_forward.launches == 0,
          "T2: the encoder took the kernel while a gradient was recorded")
    with torch.no_grad():
        z_kernel = enc(x, attrs)
    check(fused_encoder_forward.launches == 1 and not z_kernel.requires_grad,
          "T2: the encoder did not take the kernel under no_grad")
    agree("T2 encoder, kernel route against differentiable route", z_kernel, z_grad.detach(), F32)
    try:
        fused_encoder_forward(dict(enc.trunk.named_parameters()), feats, cfg.enc_plan)
    except ValueError as e:
        print(f"T2 fused_encoder_forward refuses a gradient on the card: {e}")
    else:
        check(False, "T2: fused_encoder_forward returned a result while a gradient was asked of it")

    m, k, n = 128, 4096, 1024
    dx = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
    dw = torch.from_numpy(rng.normal(0, 1 / np.sqrt(k), (n, k)).astype(np.float32)).to(dev)
    db = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32)).to(dev)
    dprobe = torch.from_numpy(rng.normal(0, 1, (m, n)).astype(np.float32)).to(dev)

    def dense_grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (dx, dw, db)]
        out = fn(*leaves, 0.2)
        grads = torch.autograd.grad((out * dprobe).sum(), leaves)
        return out.detach(), dict(zip(("dx", "dw", "db"), grads))

    fused_dense_lrelu.launches = 0
    out, got = dense_grads(fused_dense_lrelu)
    check(fused_dense_lrelu.launches == 1, "T2: fused_dense_lrelu did not launch its kernel")
    # LeakyReLU keeps the sign, so the outputs' signs are the inputs'; an
    # output within rounding of zero has an input within 1 / slope of that
    near_kink("T2 fused_dense, kernel against plain version", [out],
              [fused_dense_reference(dx, dw, db, 0.2)])

    def plain_dense(x, w, b, slope):  # the plain version, on the kernel's sides of the kink
        z = x @ w.t() + b
        return torch.where(out >= 0, z, slope * z)

    grads_agree(f"T2 fused_dense backward at ({m}, {k}, {n}) against autograd through the plain version",
                got, dense_grads(plain_dense)[1])
    del enc, dx, dw, db

    # ------------------------------- T3. classifier training, AudioMNIST
    csteps, cb = 20, 128
    clf = CNNClassifier(audio_mnist_classifier_config(10), dev, seeded(args.seed + 27))
    ctr = SupervisedTrainer(clf, SupervisedTrainConfig(batch_size=cb, loss="ce"), seed=args.seed + 28)
    cx = torch.from_numpy(rng.uniform(-1, 1, (2 * cb, 128, 128, 1)).astype(np.float32)).to(dev)
    cy = F.one_hot(torch.from_numpy(rng.integers(0, 10, 2 * cb)), 10).float().to(dev)
    cbatches = [{"x": cx[i * cb:(i + 1) * cb], "y": cy[i * cb:(i + 1) * cb]} for i in range(2)]
    head0 = clf.trunk.dense_0_kernel.detach().clone()
    loss0 = ctr.compute_loss(ctr.predict(cbatches[0]["x"]), cbatches[0]["y"]).item()
    for i in range(2):  # warm-up: cuDNN picks its algorithms, the kernel library loads
        ctr.train_step(cbatches[i])
    fused_dense_lrelu.launches = 0
    torch.cuda.synchronize()
    start.record()
    losses = [ctr.train_step(cbatches[i % 2])["loss"] for i in range(csteps)]
    end.record()
    torch.cuda.synchronize()
    clf_ms = start.elapsed_time(end)
    launches = fused_dense_lrelu.launches
    train_launches["fused_dense"] = (launches, csteps)
    loss1 = ctr.compute_loss(ctr.predict(cbatches[0]["x"]), cbatches[0]["y"]).item()
    print(f"T3 classifier training AudioMNIST: {csteps} steps in {clf_ms:.1f} ms; fused_dense launched "
          f"{launches} times; loss on a fixed batch {loss0:.4f} -> {loss1:.4f}")
    check(all(np.isfinite(v) for v in torch.stack(losses).tolist()), "T3: non-finite loss")
    check(np.isfinite(loss1) and loss1 < loss0, f"T3: the loss did not fall ({loss0} -> {loss1})")
    check(launches == csteps, f"T3: {launches} fused_dense launches in {csteps} steps")
    check(not torch.equal(clf.trunk.dense_0_kernel.detach(), head0), "T3: the head's weight did not change")
    check(all(p.grad is not None for p in clf.parameters()), "T3: a parameter ended a step with grad None")
    lines.append({
        "trainer": "SupervisedTrainer audio_mnist_classifier_config(10)", "compute_dtype": "f32",
        "loss": "ce", "batch": cb, "steps": csteps, "ms_per_step": clf_ms / csteps,
        "steps_per_s": csteps / (clf_ms / 1e3), "samples_per_s": csteps * cb / (clf_ms / 1e3),
        "fused_dense_launches": launches, "loss_before": loss0, "loss_after": loss1, "card": card,
    })
    del clf, ctr, cx, cy, cbatches

    # ----------------------------------- T4. GAN training, AudioMNIST
    asteps, ab = 5, 32
    acfg = dataclasses.replace(audio_mnist_bigan_config(), init_std=0.01)
    atr = GANTrainer(BiGAN(acfg, dev, seeded(args.seed + 29)), GANTrainConfig(batch_size=ab),
                     seed=args.seed + 30)
    adata = atr.upload_dataset(*gan_data(acfg, asteps * ab, rng, dev))
    before = {n: p.detach().clone() for n, p in atr.model.named_parameters()}
    fused_encoder_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ametrics = atr.fit_epoch(adata)
    audio_s = time.perf_counter() - t0  # the first steps: cuDNN's algorithm choice included
    launches = fused_encoder_forward.launches
    train_launches["fused_encoder:audio_mnist"] = (launches, asteps)
    print(f"T4 GAN training AudioMNIST: {asteps} steps in {audio_s:.2f} s (first steps); fused_encoder "
          f"launched {launches} times; metrics {ametrics}")
    check(all(np.isfinite(v) for v in ametrics.values()), f"T4: metrics {ametrics}")
    check(launches == asteps and atr.step == asteps, f"T4: {launches} launches in {atr.step} steps")
    changed(before, atr.model, "T4")
    check(atr.state_dict()["opt_d"]["count"] == 2 * asteps, "T4: Adam's D count")
    lines.append(trunk_at_training_shape(f"audio trunk at batch {ab}", atr.model.encoder, adata["image"][:ab],
                                         {k: v[:ab] for k, v in adata["attrs"].items()}, acfg.enc_plan,
                                         args.seed + 36, dev, peak, card))
    del atr, adata, before

    # ------------------------------------------------- T5. SCM fits
    n = 4000
    t = (rng.gamma(10, 1 / 5, n) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64 + rng.normal(0, 3, n)).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, n)).astype(np.float32)
    raw = {"thickness": t, "intensity": i, "slant": s, "digit": rng.integers(0, 10, n)}
    obs = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    obs.update({k: obs[k].reshape(-1, 1) for k in MNISTAttributeSCM.CONT})

    def mnist_fit(epochs):
        return MNISTAttributeSCM.fit(raw, steps=epochs, batch_size=1000, rng=seeded(args.seed + 31))

    def nll(scm, keys):
        lp = scm.log_prob(obs)
        return -sum(lp[k].mean().item() for k in keys)

    t0 = time.perf_counter()
    start_scm, scm = mnist_fit(0), mnist_fit(40)
    fit_s = time.perf_counter() - t0
    nll0, nll1 = nll(start_scm, MNISTAttributeSCM.CONT), nll(scm, MNISTAttributeSCM.CONT)
    print(f"T5 MNISTAttributeSCM.fit: 40 epochs of 4 steps in {fit_s:.2f} s; NLL {nll0:.4f} -> {nll1:.4f}")
    check(np.isfinite(nll1) and nll1 < nll0, f"T5: the MNIST SCM's NLL did not fall ({nll0} -> {nll1})")
    check(all(v.device.type == "cuda" for v in scm.params["intensity"][0]["mlp"][0].values()),
          "T5: the fitted SCM is not on the card")
    do = {"thickness": obs["thickness"] + 2}
    cf = scm.sample_cf(seeded(args.seed + 32), obs, do)
    check(sorted(cf) == sorted(raw) and all(torch.isfinite(v.float()).all() for v in cf.values()),
          "T5: counterfactual attributes")
    check(torch.equal(cf["thickness"], do["thickness"]), "T5: do(thickness) lost")
    check(torch.equal(cf["digit"].reshape(-1), obs["digit"]), "T5: digit changed without an intervention")
    check(torch.equal(cf["slant"], obs["slant"]) or (cf["slant"] - obs["slant"]).abs().max().item() < 1e-3,
          "T5: slant changed under do(thickness)")
    check((cf["intensity"] - obs["intensity"]).abs().max().item() > 0, "T5: intensity ignored its parent")

    country = rng.integers(0, 13, n)
    native = (country % 2 + (rng.random(n) < 0.1)) % 2
    araw = {k: rng.integers(0, c, n) for k, c in CARDINALITIES.items()}
    araw.update({"country_of_origin": country, "native_speaker": native,
                 "accent": (country + 3 * native + (rng.random(n) < 0.1)) % 15})
    obs = {k: torch.from_numpy(v).to(dev) for k, v in araw.items()}

    def audio_fit(epochs):
        return AudioMNISTAttributeSCM.fit(araw, steps=epochs, batch_size=1000, rng=seeded(args.seed + 33))

    t0 = time.perf_counter()
    start_scm, ascm = audio_fit(0), audio_fit(20)
    fit_s = time.perf_counter() - t0
    keys = AudioMNISTAttributeSCM.TRAINABLE
    nll0, nll1 = nll(start_scm, keys), nll(ascm, keys)
    print(f"T5 AudioMNISTAttributeSCM.fit: 20 epochs of 4 steps in {fit_s:.2f} s; NLL {nll0:.4f} -> {nll1:.4f}")
    check(np.isfinite(nll1) and nll1 < nll0, f"T5: the audio SCM's NLL did not fall ({nll0} -> {nll1})")
    new_country = (obs["country_of_origin"] + 1) % 13
    cf = ascm.sample_cf(seeded(args.seed + 34), obs, {"country_of_origin": new_country})
    check(torch.equal(cf["country_of_origin"], new_country), "T5: do(country_of_origin) lost")
    for k in ("digit", "age", "gender"):
        check(torch.equal(cf[k], obs[k]), f"T5: {k} changed under do(country_of_origin)")
    check(bool((cf["native_speaker"] != obs["native_speaker"]).any()),
          "T5: native_speaker ignored its parent after the fit")
    return train_launches, lines


def write_mnist_dataset(path: str, n_train: int, n_test: int, seed: int) -> None:
    """A Morpho-MNIST-layout dataset: ``mnist-x-{split}.npy`` (uint8 glyphs
    from the port's ``synthetic_digits``) and ``mnist-a-{split}.npy`` (the
    13 columns of ``pack_mnist_attrs``), the attributes drawn from the
    ground-truth SCM's closed form: t = Gamma(10, rate 5) + 0.5,
    i = 191·sigmoid(0.5·e + 2t − 5) + 64 with e ~ N(0, 1), s = π·N(0, 0.1)."""
    from imagecfgen_torch.core.attributes import one_hot, pack_mnist_attrs
    from imagecfgen_torch.data.synthetic_digits import synthetic_digits

    x, labels = synthetic_digits(n_train + n_test, seed)
    rng = np.random.default_rng(seed + 1)
    n = len(x)
    t = rng.gamma(10, 1 / 5, n) + 0.5
    i = 191 / (1 + np.exp(-(0.5 * rng.normal(0, 1, n) + 2 * t - 5))) + 64
    s = np.pi * rng.normal(0, 0.1, n)
    a = pack_mnist_attrs({"digit": one_hot(labels, 10), "thickness": t, "intensity": i, "slant": s})
    os.makedirs(path, exist_ok=True)
    for split, rows in (("train", slice(0, n_train)), ("test", slice(n_train, n))):
        np.save(os.path.join(path, f"mnist-x-{split}.npy"), np.round(x[rows]).astype(np.uint8))
        np.save(os.path.join(path, f"mnist-a-{split}.npy"), a[rows])


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_cli(name: str, dev, *argv, device_flag: bool = True, phase: str = "C"):
    """One CLI through its ``main`` on ``dev`` (``--device``, unless
    ``device_flag`` is false: the dataset CLIs touch no tensor), as a user
    runs it, with both kernels' launch counts set to 0 just before and read
    just after. Returns (seconds, what it printed, {kernel: launches}); a
    non-zero exit fails."""
    import contextlib
    import importlib
    import io

    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward

    main = importlib.import_module(f"imagecfgen_torch.cli.{name}").main
    out = io.StringIO()
    sync(dev)
    fused_encoder_forward.launches = fused_dense_lrelu.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = main([*map(str, argv), *(("--device", dev.type) if device_flag else ())])
    sync(dev)
    secs = time.perf_counter() - t0
    launches = {"fused_encoder": fused_encoder_forward.launches, "fused_dense": fused_dense_lrelu.launches}
    text = out.getvalue()
    print("".join(f"  {name}| {line}\n" for line in text.splitlines()), end="")
    check(code == 0, f"{name} exited with {code}")
    print(f"{phase} {name}: {secs:.2f} s; launches {launches}")
    return secs, text, launches


def cli_runner(dev, launches, secs, phase: str):
    """``cli(label, name, *argv, device_flag=True)``: :func:`run_cli` that
    files the run's seconds under ``secs[label]`` and its launches under
    ``launches[kernel][label]``."""
    def cli(label, name, *argv, device_flag: bool = True):
        t, text, counts = run_cli(name, dev, *argv, device_flag=device_flag, phase=phase)
        secs[label] = t
        for k, n in counts.items():
            launches.setdefault(k, {})[label] = n
        return text
    return cli


def steps_per_s(text: str):
    return [float(v) for v in re.findall(r"\(([0-9.]+) steps/s", text)]


def printed_score(text: str, what: str) -> float:
    m = re.search(rf"{what}: ([0-9.]+)", text)
    check(m is not None, f"no '{what}' printed")
    value = float(m.group(1))
    check(np.isfinite(value) and 0.0 <= value <= 1.0, f"{what} {value} outside [0, 1]")
    return value


def profile_call(fn, per: int, label: str, dev, extra=None):
    """Kernels, device busy time and the idle share of one call of ``fn``
    under torch.profiler, each a ``per``-th of the call's (its steps);
    ``extra(events, per)``: more figures from the call's events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    out = {"profiled": label, "kernels_per_step": sum(e.count for e in device) / per,
           "device_ms_per_step": busy_ms / per, "profiled_ms_per_step": wall_ms / per, "idle": 1 - busy_ms / wall_ms}
    if extra:
        out.update(extra(events, per))
    return out


def collective_split(events, per: int) -> dict:
    """A step's collective work in a profile: NCCL's kernels on the card, and
    each host op of the all-reduces (nested ops are listed apart, each with
    its total host time, its children's included)."""
    cuda = torch.autograd.DeviceType.CUDA
    nccl = [e for e in events if e.device_type == cuda and "nccl" in e.key.lower()]
    host = {e.key: {"calls": e.count / per, "host_ms": e.cpu_time_total / 1e3 / per}
            for e in events if e.device_type != cuda
            and re.search(r"all_?reduce|nccl|sumacross|param_comms|broadcast|barrier", e.key, re.I)}
    return {"host_ops_per_step": sum(e.count for e in events if e.device_type != cuda) / per,
            "nccl_kernels_per_step": sum(e.count for e in nccl) / per,
            "nccl_device_ms_per_step": sum(e.self_device_time_total for e in nccl) / 1e3 / per,
            "collective_host_ops_per_step": host}


def profile_steps(train_step, data, bsz: int, label: str, dev, steps: int = 6):
    """:func:`profile_call` of ``steps`` calls of ``train_step`` on
    consecutive ``bsz``-row batches of ``data``, after three warm-up
    steps."""
    batches = [{"image": data["image"][i * bsz:(i + 1) * bsz],
                "attrs": {k: v[i * bsz:(i + 1) * bsz] for k, v in data["attrs"].items()}}
               for i in range(3 + steps)]
    for b in batches[:3]:
        train_step(b)
    sync(dev)

    def run():
        for b in batches[3:]:
            train_step(b)
    return profile_call(run, steps, f"{label}, {steps} steps", dev)


def step_profile(data, mode_kw, bsz: int, seed: int, dev, steps: int = 6):
    """:func:`profile_steps` of a GAN trainer built as the training CLI
    builds it in one mode: full-width ``mnist_bigan_config()``,
    ``--batch-size`` 64, ``--d-updates-per-g-update`` 3, on the CLI's
    training rows. It is a trainer of its own (seed ``seed``), not the CLI's
    run."""
    from imagecfgen_torch.models.bigan import BiGAN, mnist_bigan_config
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    tr = GANTrainer(BiGAN(mnist_bigan_config(), dev, seeded(seed)),
                    GANTrainConfig(batch_size=bsz, d_updates_per_g_update=3, **mode_kw), dev, seed=seed)
    return profile_steps(tr.train_step, data, bsz, f"a trainer built as the CLI builds it, seed {seed}",
                         dev, steps)


def cli_phases(args, dev, card, tmp: str):
    """Phases C1-C4: the port's MNIST CLIs end to end on a synthetic
    Morpho-MNIST dataset, as a user runs them, in ``tmp/data``,
    ``tmp/models`` and ``tmp/fast``. Returns ({kernel: {CLI run: launches}},
    lines)."""
    from imagecfgen_torch.cli.common import (
        load_attribute_scm,
        load_bigan,
        load_classifier,
        load_mnist_training_data,
        read_png,
        scale_attrs,
    )
    from imagecfgen_torch.cli.train_mnist_image_scm import parser as gan_parser
    from imagecfgen_torch.cli.train_mnist_image_scm import throughput_kw
    from imagecfgen_torch.models.classifier import AutoEncoderConfig, mnist_classifier_config

    launches, lines, secs = {"fused_encoder": {}, "fused_dense": {}}, [], {}
    bsz, steps = 64, CLI_TRAIN // 64
    cli = cli_runner(dev, launches, secs, "C")
    data, models, fast = (os.path.join(tmp, d) for d in ("data", "models", "fast"))
    # --------------------------------------------------- C1. the dataset
    t0 = time.perf_counter()
    write_mnist_dataset(data, CLI_TRAIN, CLI_TEST, args.seed + 40)
    secs["dataset"] = time.perf_counter() - t0
    print(f"C1 dataset: {CLI_TRAIN} + {CLI_TEST} glyphs in {secs['dataset']:.2f} s")

    # ------------------------------------ C2. training at full width
    cli("train_mnist_attribute_scm", "train_mnist_attribute_scm", "--data-dir", data,
        "--output-path", models, "--steps", 100)
    cli("train_mnist_clf", "train_mnist_clf", "--data-dir", data, "--output-path", models, "--epochs", 1)
    gan = ("--data-dir", data, "--batch-size", bsz, "--d-updates-per-g-update", 3, "--save-images-every", 1)
    ref = cli("train_mnist_image_scm", "train_mnist_image_scm", *gan, "--output-path", models,
              "--steps", 1)
    resumed = cli("train_mnist_image_scm --resume", "train_mnist_image_scm", *gan,
                  "--output-path", models, "--steps", 2, "--resume")
    thr = cli("train_mnist_image_scm --throughput", "train_mnist_image_scm", *gan,
              "--output-path", fast, "--steps", 1, "--throughput")
    cli("train_morphomnist_ae", "train_morphomnist_ae", "--data-dir", data, "--output-path", models,
        "--epochs", 1)

    # -------------------------------- C3. serving from those artifacts
    cf_png = os.path.join(tmp, "mnist-gan-counterfactuals.png")
    cli("mnist_gan_counterfactuals", "mnist_gan_counterfactuals", "--data-dir", data,
        "--model-dir", models, "--output", cf_png)
    cf_acc = printed_score(cli("mnist_bigan_score", "mnist_bigan_score", "--data-dir", data,
                               "--model-dir", models, "--limit", 2048, "--batch-size", 512),
                           "cf digit accuracy")
    gen_acc = printed_score(cli("mnist_generator_score", "mnist_generator_score", "--model-dir", models,
                                "--n", 2048), "generated-sample digit accuracy")

    # ------------------------------------------ C4. checks and times
    for f in ("mnist-bigan.tar", "mnist-attribute-scm.tar", "mnist_clf.tar", "ae-all.tar",
              "attribute-scm-hists.png", "epoch-1.png", "epoch-2.png"):
        check(os.path.exists(os.path.join(models, f)), f"C4: {f} was not written")
    state, _, meta = load_bigan(os.path.join(models, "mnist-bigan.tar"), dev)
    fstate, _, _ = load_bigan(os.path.join(fast, "mnist-bigan.tar"), dev)
    check(f"at epoch 1 (step {steps})" in resumed, "C4: the resumed run did not start at its step")
    check(meta["epoch"] == 2 and state["step"] == 2 * steps,
          f"C4: the resumed run ended at epoch {meta['epoch']}, step {state['step']}")
    check(state["opt_d"]["count"] == 2 * state["step"], "C4: reference mode's Adam D count")
    check(fstate["step"] == steps and fstate["opt_d"]["count"] == fstate["step"],
          f"C4: --throughput took {fstate['opt_d']['count']} D updates in {fstate['step']} steps")
    check({m.dtype for m in fstate["opt_d"]["mu"].values()} == {torch.bfloat16},
          "C4: --throughput keeps Adam's mu in float32")
    x = torch.from_numpy(load_mnist_training_data(data, "test")[0][:8]).to(dev)
    scm = load_attribute_scm(os.path.join(models, "mnist-attribute-scm.tar"), dev)
    check(all(torch.isfinite(v.float()).all() for v in scm.sample(seeded(0), n=64, device=dev).values()),
          "C4: the attribute SCM's samples")
    with torch.no_grad():
        logits = load_classifier(os.path.join(models, "mnist_clf.tar"), mnist_classifier_config(), dev)(x)
        recon = load_classifier(os.path.join(models, "ae-all.tar"), AutoEncoderConfig(), dev)(x)
    check(logits.shape == (8, 10) and bool(torch.isfinite(logits).all()), "C4: the classifier")
    check(recon.shape == (8, 28, 28, 1) and bool(torch.isfinite(recon).all()), "C4: the autoencoder")
    for path, shape in ((os.path.join(models, "attribute-scm-hists.png"), (3 * 48, 100)),
                        (os.path.join(models, "epoch-2.png"), (3 * 28, 10 * 28)),
                        (os.path.join(fast, "epoch-1.png"), (3 * 28, 10 * 28)), (cf_png, (3 * 28, 8 * 28))):
        check(read_png(path).shape == shape, f"C4: {path} decodes to {read_png(path).shape}, not {shape}")
    enc = launches["fused_encoder"]
    for label in ("train_mnist_image_scm", "train_mnist_image_scm --resume",
                  "train_mnist_image_scm --throughput"):  # once a step, once for the epoch's grid
        check(enc[label] == steps + 1, f"C4: {label}: {enc[label]} fused_encoder launches in {steps} steps")
    check(enc["mnist_gan_counterfactuals"] == 2, "C4: the counterfactual CLI's fused_encoder launches")
    check(enc["mnist_bigan_score"] >= 1, "C4: the score CLI did not reach fused_encoder")

    x_np, attrs, scaler = load_mnist_training_data(data)
    rows = {"image": torch.from_numpy(x_np[:9 * bsz]).to(dev),
            "attrs": {k: torch.from_numpy(v[:9 * bsz]).to(dev) for k, v in scale_attrs(scaler, attrs).items()}}
    for mode, flags in {"reference": [], "throughput": ["--throughput"]}.items():
        prof = step_profile(rows, throughput_kw(gan_parser.parse_args(flags)), bsz, args.seed + 41, dev)
        rates = steps_per_s(ref + resumed if mode == "reference" else thr)
        lines.append({"cli_training": f"train_mnist_image_scm {' '.join(flags)}".strip(), "batch": bsz,
                      "d_updates_per_g_update": 3, "steps_per_epoch": steps, "cli_steps_per_s": rates,
                      "profile_of_a_like_trainer": prof, "card": card})
    lines.append({"cli_seconds": secs, "cf_digit_accuracy": cf_acc,
                  "generated_sample_digit_accuracy": gen_acc, "card": card})
    return launches, lines


# M2: median |measured - target| of M1's test split may not exceed these. In
# a CPU rehearsal the 256 glyphs of that split read 0.0869, 0.0 and 0.00182
# (the oracle's own error: perturbation, downscaling and re-measurement).
ORACLE_BOUNDS = {"thickness": 0.2, "intensity": 0.01, "slant": 0.01}
M_TRAIN, M_TEST = 128, 256  # glyphs synthesised by M1 (at --scale 16, as the reference)
# M1's CLIs in a child process: each through its ``main`` with both kernels'
# launch counts, as run_cli does, then one line of their seconds and counts.
SYNTHESIS_CHILD = """
import importlib, json, sys, time
from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu
from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward
runs = {}
for label, name, argv in json.loads(sys.argv[1]):
    main = importlib.import_module(f"imagecfgen_torch.cli.{name}").main
    fused_encoder_forward.launches = fused_dense_lrelu.launches = 0
    t0 = time.perf_counter()
    code = main([str(v) for v in argv])
    runs[label] = {"seconds": time.perf_counter() - t0, "code": code, "launches": {
        "fused_encoder": fused_encoder_forward.launches, "fused_dense": fused_dense_lrelu.launches}}
    print(f"{label}: {runs[label]['seconds']:.2f} s", flush=True)
print("M1 runs " + json.dumps(runs), flush=True)
"""
PANEL = 96  # the measured-CF panels' size (cli/common.py::scatter_panel)


def printed_errors(text: str, attributes) -> dict:
    """The ``median abs errors: {...}`` a measured-CF CLI printed, each
    finite."""
    m = re.search(r"median abs errors: \{(.*)\}", text)
    check(m is not None, "no median abs errors printed")
    errors = {k: float(v) for k, v in re.findall(r"'(\w+)': ([^,]+)", m.group(1))}
    check(set(errors) == set(attributes), f"errors for {sorted(errors)}, not {sorted(attributes)}")
    check(all(np.isfinite(v) for v in errors.values()), f"non-finite errors {errors}")
    return errors


def start_synthesis(args, tmp: str) -> subprocess.Popen:
    """M1's three synthesis CLIs in a background process, writing under
    ``tmp`` (``morpho``, ``morpho-noisy``) and its output to
    ``tmp/synthesis.log``; :func:`morpho_phases` waits for it."""
    workers = max(1, (os.cpu_count() or 1) - 1)
    mdata, noisy = os.path.join(tmp, "morpho"), os.path.join(tmp, "morpho-noisy")
    test = ["--synthetic", M_TEST, "--workers", workers, "--seed", args.seed + 51]
    runs = [("create_train_dataset", "create_train_dataset", ["--synthetic", M_TRAIN, "--scale", 16, "--workers",
                                                              workers, "--seed", args.seed + 50, "--out-dir", mdata]),
            ("create_test_dataset", "create_test_dataset", [*test, "--out-dir", mdata]),
            ("create_test_dataset --noise-std 8", "create_test_dataset", [*test, "--noise-std", 8, "--out-dir", noisy])]
    with open(os.path.join(tmp, "synthesis.log"), "w") as log:
        return subprocess.Popen([sys.executable, "-c", SYNTHESIS_CHILD, json.dumps(runs)], stdout=log,
                                stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__)))


def morpho_phases(args, dev, card, peak, tmp: str, synthesis: subprocess.Popen = None):
    """Phases M1-M5: the paper's Morpho-MNIST comparison through the port's
    CLIs, after C1-C4 and on their artifacts in ``tmp``; M1 waits for
    ``synthesis`` (:func:`start_synthesis`; started here when None).
    Returns ({kernel: {CLI run: launches}}, lines)."""
    from imagecfgen_torch.cli.common import load_mnist_training_data, load_vae, read_png, scale_attrs
    from imagecfgen_torch.data.morphomnist_synth import GroundTruthSCM
    from imagecfgen_torch.metrics.measured import measure_attributes
    from imagecfgen_torch.models.vae import ConditionalVAE, mnist_vae_config
    from imagecfgen_torch.morphomnist.measure import as_array, measure_batch
    from imagecfgen_torch.train.vae_trainer import VAETrainConfig, VAETrainer

    launches, lines, secs = {"fused_encoder": {}, "fused_dense": {}}, [], {}
    cli = cli_runner(dev, launches, secs, "M")
    data, models = os.path.join(tmp, "data"), os.path.join(tmp, "models")  # C1's rows, C2's models
    mdata, noisy = os.path.join(tmp, "morpho"), os.path.join(tmp, "morpho-noisy")
    cores = os.cpu_count() or 1
    seeds = {"train": args.seed + 50, "test": args.seed + 51}

    # ------------------------------------------------- M1. synthesis
    t0 = time.perf_counter()
    code = (synthesis or start_synthesis(args, tmp)).wait()
    with open(os.path.join(tmp, "synthesis.log")) as log:
        text = log.read()
    print("".join(f"  synthesis| {line}\n" for line in text.splitlines()), end="")
    check(code == 0, f"M1: the synthesis process exited with {code}")
    runs = json.loads(re.search(r"^M1 runs (.*)$", text, re.M).group(1))
    for label, run in runs.items():
        check(run["code"] == 0, f"M1: {label} exited with {run['code']}")
        secs[label] = run["seconds"]
        for k, n in run["launches"].items():
            launches[k][label] = n
    print(f"M1: waited {time.perf_counter() - t0:.2f} s for the synthesis started before R")
    split = {}
    for name, n in (("train", M_TRAIN), ("test", M_TEST)):
        x = np.load(os.path.join(mdata, f"mnist-x-{name}.npy"))
        a = np.load(os.path.join(mdata, f"mnist-a-{name}.npy"))
        check(x.shape == (n, 28, 28) and a.shape == (n, 13), f"M1: {name} split {x.shape}, {a.shape}")
        check(bool((x.max(axis=(1, 2)) > 50).all()), f"M1: a blank glyph in the {name} split")
        check(np.array_equal(a[:, :10].sum(axis=1), np.ones(n, np.float32)), f"M1: {name} digits not one-hot")
        t, i, s = GroundTruthSCM(np.random.default_rng(seeds[name])).sample(n)
        check(np.array_equal(a[:, 10:], np.concatenate([t, i, s], axis=1)),
              f"M1: the {name} split's attributes are not the ground-truth SCM's draws")
        split[name] = (x, a)
    xn, an = np.load(os.path.join(noisy, "mnist-x-test.npy")), np.load(os.path.join(noisy, "mnist-a-test.npy"))
    check(np.array_equal(an, split["test"][1]), "M1: --noise-std changed the attributes")
    check(not np.array_equal(xn, split["test"][0]) and xn.min() >= 0 and xn.max() <= 255,
          "M1: --noise-std left the pixels as they were, or outside [0, 255]")
    synth = {"cpu_count": cores, "workers": max(1, cores - 1), "glyphs_per_s": {
        label: n / secs[label] for label, n in (("create_train_dataset", M_TRAIN), ("create_test_dataset", M_TEST),
                                                ("create_test_dataset --noise-std 8", M_TEST))}}
    print(f"M1 synthesis: {synth}")

    # -------------------------------------------------- M2. the oracle
    x, a = split["test"]
    oracle = {}
    for engine in ("native", "python"):
        t0 = time.perf_counter()
        table = measure_batch(x, engine=engine)
        t1 = time.perf_counter()
        measured = measure_attributes(x, engine=engine)
        oracle[engine] = (as_array(table), measured, len(x) / (t1 - t0))
    for k, what in enumerate(("measure_batch", "measure_attributes")):
        diff = np.abs(oracle["native"][k] - oracle["python"][k]).max()
        print(f"M2 {what}: max|native - python| = {diff:.3e}")
        check(diff <= 1e-9, f"M2: the engines' {what} differ by {diff}")
    measured = oracle["native"][1]
    errors = {name: float(np.median(np.abs(measured[:, k] - a[:, 10 + k])))
              for k, name in enumerate(("thickness", "intensity", "slant"))}
    print(f"M2 oracle: median |measured - target| {errors}, images/s "
          f"{ {e: round(v[2], 1) for e, v in oracle.items()} }")
    for name, err in errors.items():
        check(err <= ORACLE_BOUNDS[name], f"M2: median |measured - target| of {name} {err} > {ORACLE_BOUNDS[name]}")
    lines.append({"oracle": f"measure_batch on M1's test split ({len(x)} glyphs)", "median_abs_errors": errors,
                  "bounds": ORACLE_BOUNDS, "images_per_s": {e: v[2] for e, v in oracle.items()},
                  "synthesis": synth, "card": card})

    # -------------------------------------------------- M3. the VAE's training
    bsz = 64
    text = cli("train_mnist_vae", "train_mnist_vae", "--data-dir", data, "--output-path", models, "--steps", 1,
               "--batch-size", bsz)
    m = re.search(r"-elbo=(\S+) ", text)
    check(m is not None and np.isfinite(float(m.group(1))), "M3: no finite -ELBO printed")
    check(launches["fused_encoder"]["train_mnist_vae"] == 0,
          "M3: VAE training reached fused_encoder (its trunk needs a gradient)")
    cfg = mnist_vae_config()
    vae, scaler, meta = load_vae(os.path.join(models, "mnist-vae.tar"), cfg, dev)
    check(meta["epoch"] == 1, f"M3: checkpoint meta {meta}")
    init = dict(ConditionalVAE(cfg, dev, seeded(0)).named_parameters())  # the CLI's --seed 0 init
    still = [n for n, p in vae.named_parameters() if torch.equal(p, init[n])]
    check(not still, f"M3: {still} did not change in one epoch")
    x_np, attrs, _ = load_mnist_training_data(data)
    rows = {"image": torch.from_numpy(x_np[:9 * bsz]).to(dev),
            "attrs": {k: torch.from_numpy(v[:9 * bsz]).to(dev) for k, v in scale_attrs(scaler, attrs).items()}}
    vtr = VAETrainer(ConditionalVAE(cfg, dev, seeded(args.seed + 52)), VAETrainConfig(batch_size=bsz), dev,
                     seed=args.seed + 53)
    prof = profile_steps(vtr.train_step, rows, bsz, f"a VAE trainer built as the CLI builds it, seed "
                         f"{args.seed + 52}", dev)
    lines.append({"cli_training": "train_mnist_vae", "batch": bsz, "num_samples_per_step": 4, "kl_weight": 10.0,
                  "steps_per_epoch": CLI_TRAIN // bsz, "cli_steps_per_s": steps_per_s(text),
                  "neg_elbo": float(m.group(1)), "profile_of_a_like_trainer": prof, "card": card})

    # ----------------------------------------- M4. measured counterfactuals
    measured_cf = {}
    for label, name in (("bigan", "mnist_gan_measured_cf"), ("vae", "mnist_vae_measured_cf")):
        png = os.path.join(tmp, f"{name}.png")
        text = cli(name, name, "--data-dir", mdata, "--model-dir", models, "--limit", M_TEST, "--workers", cores,
                   "--output", png)
        measured_cf[label] = printed_errors(text, ("thickness", "intensity", "slant"))
        check(read_png(png).shape == (PANEL, 3 * PANEL), f"M4: {png} decodes to {read_png(png).shape}")
        check(launches["fused_encoder"][name] == 3, f"M4: {name}: {launches['fused_encoder'][name]} "
              "fused_encoder launches, not one for each attribute")
    text = cli("mnist_vae_counterfactuals", "mnist_vae_counterfactuals", "--data-dir", mdata, "--model-dir", models,
               "--limit", 64, "--workers", cores)
    mae = {k: float(v) for k, v in re.findall(r"(bigan|vae): pixel MAE vs ground-truth \S+ = ([0-9.]+)", text)}
    check(set(mae) == {"bigan", "vae"} and all(np.isfinite(v) for v in mae.values()), f"M4: pixel MAE {mae}")
    check(launches["fused_encoder"]["mnist_vae_counterfactuals"] == 2,
          "M4: mnist_vae_counterfactuals did not encode once with each model")
    # the scores on C1's 2,048 test rows, as C3 scores the BiGAN
    cf_acc = printed_score(cli("mnist_vae_score", "mnist_vae_score", "--data-dir", data, "--model-dir", models,
                               "--limit", 2048, "--batch-size", 512), "vae cf digit accuracy")
    check(launches["fused_encoder"]["mnist_vae_score"] == -(-min(2048, CLI_TEST) // 512),
          "M4: mnist_vae_score: not one fused_encoder launch a batch")
    gen_acc = printed_score(cli("mnist_vae_generator_score", "mnist_vae_generator_score", "--model-dir", models,
                                "--n", 2048), "vae generated-sample digit accuracy")
    check("\nok" in "\n" + cli("test_vae", "test_vae"), "M4: test_vae did not print ok")
    check(launches["fused_encoder"]["test_vae"] == 2, "M4: test_vae's encoder calls missed the kernel")
    lines.append({"measured_cf": measured_cf, "limit": M_TEST, "pixel_mae_do_thickness_plus_2": mae,
                  "vae_cf_digit_accuracy": cf_acc, "vae_generated_sample_digit_accuracy": gen_acc,
                  "cli_seconds": secs, "card": card})

    # ------------------------------------ M5. the kernel at the new shape
    xt, at, _ = load_mnist_training_data(mdata, "test")
    xt = torch.from_numpy(xt[:M_TEST]).to(dev)
    at = scaler.scale({k: torch.from_numpy(v[:M_TEST]).to(dev) for k, v in at.items()})
    lines.append(trunk_at_training_shape(f"MNIST VAE trunk at batch {M_TEST}", vae.encoder, xt, at, cfg.enc_plan,
                                         args.seed + 54, dev, peak, card, key="kernel_at_serving_shape"))
    return launches, lines


# X2: the explainer CLIs' cuts (the JAX scripts' defaults: --limit 64,
# --steps 100 or 30, --per-digit 4, SHAP --limit 4)
X_LIMIT, X_STEPS = 8, 20


def explainer_phases(args, dev, card, peak, tmp: str):
    """Phases X1-X3: the paper's counterfactual explainers, their
    benchmarks and the encoder fine-tune through the port's CLIs, after
    C1-C4 and M1-M5 and on their artifacts in ``tmp``; the CLIs that write
    into the working directory run in ``tmp/x``. Returns ({kernel: {CLI run:
    launches}}, lines, the B = 1 kernel row)."""
    import contextlib
    import csv
    import pickle

    from imagecfgen_torch.cf.baselines import PixelBaselineExplainers
    from imagecfgen_torch.cf.engine import CounterfactualEngine
    from imagecfgen_torch.cf.explain import HingeLossCFExplainer
    from imagecfgen_torch.cf.finetune import EncoderFinetuner, FinetuneConfig
    from imagecfgen_torch.cli.common import (
        bigan_from_state,
        load_bigan,
        load_classifier,
        load_mnist_training_data,
        load_vae,
        read_png,
        scale_attrs,
    )
    from imagecfgen_torch.models.bigan import mnist_bigan_config
    from imagecfgen_torch.models.classifier import mnist_classifier_config, mnist_oracle_config
    from imagecfgen_torch.models.vae import mnist_vae_config

    launches, lines, secs = {"fused_encoder": {}, "fused_dense": {}}, [], {}
    cli = cli_runner(dev, launches, secs, "X")
    data, models, work = os.path.join(tmp, "data"), os.path.join(tmp, "models"), os.path.join(tmp, "x")
    os.makedirs(work)
    bigan_tar = os.path.join(models, "mnist-bigan.tar")
    state, scaler, _ = load_bigan(bigan_tar, dev)
    bigan = bigan_from_state(state, mnist_bigan_config(), dev).eval()
    vae, vscaler, _ = load_vae(os.path.join(models, "mnist-vae.tar"), mnist_vae_config(), dev)
    xt, at, _ = load_mnist_training_data(data, "test")

    # --------------------------------- X1. the kernel at the explainers' shape
    x1 = torch.from_numpy(xt[:1]).to(dev)
    a1 = {k: torch.from_numpy(v[:1]).to(dev) for k, v in at.items()}
    b1 = [trunk_at_training_shape(f"{what} at batch 1", enc, x1, sc.scale(a1), cfg.enc_plan,
                                  args.seed + 60 + i, dev, peak, card, key="kernel_at_explainer_shape")
          for i, (what, enc, sc, cfg) in enumerate((("MNIST BiGAN trunk", bigan.encoder, scaler, bigan.cfg),
                                                     ("MNIST VAE trunk", vae.encoder, vscaler, vae.cfg)))]
    lines += b1

    # ------------------------------------------------ X2. the explainer CLIs
    def expect(name, count):
        got = launches["fused_encoder"][name]
        check(got == count, f"X2: {name}: {got} fused_encoder launches, not {count}")

    cases = ("--data-dir", data, "--model-dir", models)
    cli("train_morphomnist_oracles", "train_morphomnist_oracles", "--data-dir", data, "--output-path", models,
        "--epochs", 1)
    for d in range(10):
        check(os.path.exists(os.path.join(models, f"oracle-{d}.tar")), f"X2: oracle-{d}.tar was not written")
    for c in range(10):  # the realism metric's per-digit autoencoders (C2 trained ae-all)
        cli(f"train_morphomnist_ae --cls {c}", "train_morphomnist_ae", "--data-dir", data, "--output-path",
            models, "--epochs", 1, "--cls", c)
    expect("train_morphomnist_oracles", 0)

    png = os.path.join(work, "mnist-cf-explain.png")
    text = cli("mnist_cf_explain", "mnist_cf_explain", *cases, "--steps", X_STEPS, "--output", png)
    check(re.search(r"best mixture weight: (nan|[0-9.]+)", text) is not None, "X2: no mixture weight printed")
    h, w = read_png(png).shape
    check(h == 3 * 28 and w in (28, 56, 84, 112), f"X2: {png} decodes to {(h, w)}")
    expect("mnist_cf_explain", 2)  # one encode for each explainer

    png = os.path.join(work, "mnist-cf-comparisons.png")
    cli("mnist_cf_comparisons", "mnist_cf_comparisons", *cases, "--n-images", X_LIMIT, "--steps", X_STEPS,
        "--output", png)
    check(read_png(png).shape == (5 * 28, X_LIMIT * 28), f"X2: {png} decodes to {read_png(png).shape}")
    expect("mnist_cf_comparisons", 2 * X_LIMIT)

    pkl = os.path.join(work, "mnist-cf-matrix.pkl")
    cli("make_mnist_cf_matrix", "make_mnist_cf_matrix", *cases, "--per-digit", 1, "--output", pkl)
    with open(pkl, "rb") as f:
        matrix = pickle.load(f)
    check(set(matrix) == {"matrix", "counts", "metric"} and matrix["matrix"].shape == (10, 10),
          "X2: the matrix pickle")
    sources = len(set(at["digit"].argmax(axis=1).tolist()))
    expect("make_mnist_cf_matrix", 9 * sources)
    text = cli("show_cf_matrix", "show_cf_matrix", "--matrix", pkl, device_flag=False)
    check(text.startswith("src\\tgt ") and len(text.splitlines()) == 14, "X2: show_cf_matrix's printout")

    tables, limits = {}, ("--limit", X_LIMIT, "--steps", X_STEPS)
    for name, per_row in (("mnist_oracle_scores", 2), ("morphomnist_cf_metrics", 4)):
        out = os.path.join(work, f"{name}.csv")
        text = cli(name, name, *cases, *limits, "--output", out)
        with open(out, newline="") as f:
            rows = list(csv.reader(f))
        check(len(rows) == X_LIMIT + 1, f"X2: {out} has {len(rows) - 1} rows")
        tables[name] = dict(zip(rows[0], zip(*rows[1:])))
        expect(name, per_row * X_LIMIT)  # bigan (and vae): hinge + mixture, one encode each
    scores = tables["mnist_oracle_scores"]
    agree = {name: float(np.mean([int(v) for v in scores[f"{name}_oracle_agree"]]))
             for name in ("bigan", "bigan_agnostic", "cf", "pn")}
    js = {name: float(np.mean([float(v) for v in scores[f"{name}_js"]])) for name in agree}
    check(all(-1e-6 <= v <= np.log(2) + 1e-6 for v in js.values()), f"X2: JS divergences {js}")
    metrics = tables["morphomnist_cf_metrics"]
    check("l1_vae" in metrics and all(v != "" for v in metrics["o_rec_bigan"]),
          "X2: the cf-metrics CSV lacks the VAE's columns or an autoencoder's")
    realism = {name: float(np.mean([float(v) for v in metrics[f"o_rec_{name}"]]))
               for name in ("bigan", "bigan_agnostic", "vae", "vae_agnostic", "cf", "pn")}

    with contextlib.chdir(work):
        cli("morphomnist_attribute_shap", "morphomnist_attribute_shap", *cases, "--limit", 2)
    for name in ("bigan", "vae"):
        sv = np.load(os.path.join(work, f"{name}_attribute_shap.npy"))
        check(sv.shape == (2, 10, 3) and np.isfinite(sv).all(), f"X2: {name}_attribute_shap.npy {sv.shape}")
    expect("morphomnist_attribute_shap", 0)

    # the pixel baselines on the card, as the benchmark CLIs run them
    clf = load_classifier(os.path.join(models, "mnist_clf.tar"), mnist_classifier_config(), dev)
    xb = torch.from_numpy(xt[:X_LIMIT]).to(dev)
    base = PixelBaselineExplainers(clf, steps=3 * X_STEPS)
    cf, cf_ok = base.counterfactual(xb)
    pn, pn_ok, pp, pp_ok = base.contrastive(xb)
    with torch.no_grad():
        orig = clf(xb).argmax(-1)
        check(torch.equal(clf(cf).argmax(-1) != orig, cf_ok), "X2: a Wachter cf's ok disagrees with its label")
        check(torch.equal(clf(pn).argmax(-1) != orig, pn_ok), "X2: a CEM pn's ok disagrees with its label")
    for what, img in (("cf", cf), ("pn", pn), ("pp", pp)):
        check(bool(torch.isfinite(img).all()) and img.min().item() >= -1.0 and img.max().item() <= 1.0,
              f"X2: the {what} images leave [-1, 1]")
    check(bool((pp.abs() <= xb.abs()).all()), "X2: a pertinent positive is not a part of x")
    oracle = load_classifier(os.path.join(models, "oracle-0.tar"), mnist_oracle_config(), dev)
    with torch.no_grad():
        check(oracle(xb).shape == (X_LIMIT, 1), "X2: an oracle's output")
    # the steps' kernels and idle share: one hinge explanation, one Wachter run
    hinge = HingeLossCFExplainer(bigan.encoder, bigan.generator, clf, "digit", 512, ("digit",),
                                 ("slant", "intensity"))
    a1s = scaler.scale(a1)
    hinge.explain(x1, a1s, target_class=3, steps=2, rng=seeded(0))  # warm-up
    profiles = {
        "hinge_explain": profile_call(lambda: hinge.explain(x1, a1s, target_class=3, steps=X_STEPS, rng=seeded(0)),
                                      X_STEPS, f"one hinge explanation, {X_STEPS} Adam steps", dev),
        "wachter": profile_call(lambda: base.counterfactual(xb), base.steps,
                                f"Wachter on {X_LIMIT} images x {len(base.c_values)} weights, {base.steps} steps",
                                dev)}
    lines.append({"explainers": "X2", "limit": X_LIMIT, "steps": X_STEPS, "oracle_agreement": agree,
                  "mean_js": js, "mean_o_rec": realism,
                  "baselines_ok": {"cf": cf_ok.float().mean().item(), "pn": pn_ok.float().mean().item(),
                                   "pp": pp_ok.float().mean().item()}, "profiles": profiles, "card": card})

    # ---------------------------------------------- X3. the encoder fine-tune
    x_np, attrs, data_scaler = load_mnist_training_data(data)
    tars, rates = [], {}
    for metric in ("mse", "ssim"):
        label = f"finetune_mnist_bigan --metric {metric}"
        with contextlib.chdir(work):
            text = cli(label, "finetune_mnist_bigan", "--data-dir", data, "--model-file", bigan_tar, "--steps", 1,
                       "--metric", metric)
        check(launches["fused_encoder"][label] == 0, f"X3: {label} reached fused_encoder (E needs a gradient)")
        rates[metric] = steps_per_s(text)
        tar = os.path.join(work, f"mnist-bigan-finetuned-{metric}.tar")
        tuned, tscaler, meta = load_bigan(tar, dev)
        check(meta.get("finetuned") == metric, f"X3: {tar} meta {meta}")
        still = [k for k, v in tuned["E"].items() if torch.equal(v, state["E"][k])]
        check(not still, f"X3: {label} left E's {still} as they were")
        for part in ("G", "D"):
            check(all(torch.equal(v, state[part][k]) for k, v in tuned[part].items()), f"X3: {label} changed {part}")
        engine = CounterfactualEngine(bigan_from_state(tuned, mnist_bigan_config(), dev), None, tscaler, dev)
        rec = engine.reconstruct(xt[:8], {k: v[:8] for k, v in at.items()})
        check(rec.shape == (8, 28, 28, 1) and bool(torch.isfinite(rec).all()), f"X3: {tar} does not reconstruct")
        tars.append(tar)
        ft = EncoderFinetuner(bigan_from_state(tuned, mnist_bigan_config(), dev),
                              FinetuneConfig(metric=metric), dev, seed=args.seed + 62)
        rows = {"image": torch.from_numpy(x_np[:9 * 128]).to(dev),
                "attrs": {k: torch.from_numpy(v[:9 * 128]).to(dev)
                          for k, v in scale_attrs(data_scaler, attrs).items()}}
        lines.append({"cli_training": f"finetune_mnist_bigan --metric {metric}", "batch": 128,
                      "steps_per_epoch": len(x_np) // 128, "cli_steps_per_s": rates[metric],
                      "profile_of_a_like_trainer": profile_steps(
                          ft.train_step, rows, 128, f"a fine-tuner built as the CLI builds it, seed "
                          f"{args.seed + 62}", dev), "card": card})
    png = os.path.join(work, "mnist-reconstructions.png")
    text = cli("mnist_reconstructions", "mnist_reconstructions", "--data-dir", data, "--model-files", bigan_tar,
               *tars, "--output", png)
    check(read_png(png).shape == (4 * 28, 10 * 28), f"X3: {png} decodes to {read_png(png).shape}")
    expect("mnist_reconstructions", 3)  # one encode for each model file

    explain_runs = ("mnist_cf_explain", "mnist_cf_comparisons", "make_mnist_cf_matrix", "mnist_oracle_scores",
                    "morphomnist_cf_metrics")
    fan_in = b1[0]
    b1_row = row("fused_encoder:b1", F32, "imagecfgen_torch/csrc/fused_encoder.cu",
                 "imagecfgen_tpu/ops/pallas/fused_encoder.py:127",
                 sum(launches["fused_encoder"][r] for r in explain_runs), fan_in["max_abs_err"], fan_in["ms"],
                 fan_in["plain_ms"], fan_in["library_ms"], fan_in["flops"], fan_in["bytes"], peak, card, batch=1,
                 device_ms=fan_in["device_ms"], library_device_ms=fan_in["library_device_ms"],
                 cli_launches={r: launches["fused_encoder"][r] for r in explain_runs}, train_launches=None,
                 train_steps=None)
    lines.append({"cli_seconds": secs, "phase": "X", "card": card})
    return launches, lines, b1_row


# the AudioMNIST slice at full width: audio_mnist_bigan_config(d=64) and
# audio_mnist_classifier_config(width=1.0), on the synthetic stand-in at four
# runs a (subject, digit): 2,400 clips, 1,800 training and 600 validation
AU_D, AU_WIDTH, AU_RUNS, AU_BATCH = 64, 1.0, 4, 128
AU_GL_CLIPS = 8  # clips of AU1's Griffin-Lim round trip


STAND_INS: dict = {}  # (synthetic_runs, subjects) -> the stand-in, made once a process (AU and QA share it)


@contextlib.contextmanager
def shared_stand_in(subjects: int | None = None):
    """Inside, ``cli.audio_common.load_audio_dataset`` hands every call
    without a zip a copy of one synthesis of the AudioMNIST stand-in, made at
    the first call: the data is set-up, made once (AU1 times a synthesis of
    its own), not the CLIs' work; a zip that exists is read as before.
    ``subjects``: the copy cut to subjects 1..``subjects``."""
    import copy

    from imagecfgen_torch.cli import audio_common

    real, made = audio_common.load_audio_dataset, STAND_INS

    def load(zip_path, synthetic_runs: int = 4):
        if zip_path and os.path.exists(zip_path):
            return real(zip_path, synthetic_runs)
        if zip_path:
            print(f"warning: {zip_path} not found; using the synthetic AudioMNIST stand-in")
        if (synthetic_runs, None) not in made:
            made[synthetic_runs, None] = real(None, synthetic_runs)
        if (synthetic_runs, subjects) not in made:
            data = copy.deepcopy(made[synthetic_runs, None])
            keep = data.raw["subject"] <= subjects
            data.raw = {k: v[keep] for k, v in data.raw.items()}
            data._fit_encoders()
            made[synthetic_runs, subjects] = data
        return copy.deepcopy(made[synthetic_runs, subjects])

    audio_common.load_audio_dataset = load
    try:
        yield
    finally:
        audio_common.load_audio_dataset = real


def dtype_name(dtype) -> str:
    return "float32" if dtype == F32 else "bfloat16"


@contextlib.contextmanager
def recording_launches(seen: dict, label: str, firsts: list | None = None, shapes: list | None = None):
    """Both kernels' launches with the inputs of the first launch at each
    (kernel, type, shape) copied into ``seen`` under the CLI run ``label``
    that gave it (the launch plans follow the shape);
    with ``firsts``, a copy of the first conv kernel of every trunk launch,
    which tells apart the models a run launched; with ``shapes``, the input
    shape of every trunk launch. The wrappers' own launch functions still
    launch and count."""
    from imagecfgen_torch.ops import fused_dense as fd
    from imagecfgen_torch.ops import fused_encoder as fe

    enc, dense = fe._launch, fd._launch

    def enc_shim(feats, pairs, conv_ops, first):
        if firsts is not None:
            firsts.append(pairs[0][0].detach().clone())
        if shapes is not None:
            shapes.append(tuple(feats.shape))
        key = ("fused_encoder", TAG[feats.dtype], tuple(feats.shape))
        if key not in seen:
            seen[key] = (label, feats.clone(), [(w.detach().clone(), b.detach().clone()) for w, b in pairs],
                         tuple(conv_ops), first)
        return enc(feats, pairs, conv_ops, first)

    def dense_shim(x, w, b, slope):
        key = ("fused_dense", TAG[x.dtype], (x.shape[0], x.shape[1], w.shape[0]))
        if key not in seen:
            seen[key] = (label, x.detach().clone(), w.detach().clone(), b.detach().clone(), slope)
        return dense(x, w, b, slope)

    fe._launch, fd._launch = enc_shim, dense_shim
    try:
        yield
    finally:
        fe._launch, fd._launch = enc, dense


def check_seen_launches(seen: dict, plan) -> list:
    """Each kernel against its plain version on the inputs of the first
    launch at each shape in ``seen`` (the trunk through :func:`check_trunk`,
    which also updates a weight in place); returns their errors, and, in
    float32, the kernel's and the plain version's distances from the same
    function in float64 (printed, not gated)."""
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu, fused_dense_reference
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward, plan_conv_ops

    out = []
    for key in sorted(seen):
        kernel, tag, shape = key
        dtype = F32 if tag == "f32" else BF16
        what = f"{'x'.join(map(str, shape))} (first launched by {seen[key][0]})"
        with torch.no_grad():
            if kernel == "fused_encoder":
                _, feats, pairs, conv_ops, first = seen[key]
                check(first == 0 and conv_ops == plan_conv_ops(plan), f"AU5: {what} ran another trunk")
                params = {f"conv_{i}_{part}": t for i, pair in enumerate(pairs)
                          for part, t in zip(("kernel", "bias"), pair)}
                err, _, _, _, plain = check_trunk(what, params, feats, plan, dtype)
                got = fused_encoder_forward(params, feats, plan)
                exact = library_stack(feats.double(), [(w.double(), b.double()) for w, b in pairs], conv_ops)
            else:
                _, x, w, b, slope = seen[key]
                got = fused_dense_lrelu(x, w, b, slope)
                torch.cuda.synchronize()
                plain = fused_dense_reference(x, w, b, slope)
                err = agree(f"fused_dense {what}", got, plain, dtype)
                exact = F.leaky_relu(F.linear(x.double(), w.double(), b.double()), slope)
        entry = {"kernel": kernel, "dtype": tag, "shape": list(shape), "first_run": seen[key][0],
                 "max_abs_err": err, "max_abs_plain": plain.float().abs().max().item()}
        if dtype == F32:
            entry.update(kernel_vs_f64=(got.double() - exact).abs().max().item(),
                         plain_vs_f64=(plain.double() - exact).abs().max().item())
            print(f"{kernel} {what}: max|kernel - f64| = {entry['kernel_vs_f64']:.3e}, max|plain - f64| = "
                  f"{entry['plain_vs_f64']:.3e} (printed, not gated)")
        out.append(entry)
    return out


def audio_cli_phases(args, dev, card, peak, tmp: str):
    """Phases AU1-AU5: the AudioMNIST pipeline through the port's own entry
    points at full width, in ``tmp/audio*``. Returns ({kernel: {CLI run:
    launches}}, lines, the two new kernel rows)."""
    import dataclasses

    from imagecfgen_torch.cli.audio_common import (
        load_audio_bigan,
        load_audio_bigan_model,
        prepare_training_arrays,
        validation_images,
    )
    from imagecfgen_torch.cli.common import read_png
    from imagecfgen_torch.data.audio_mnist import (
        AUDIO_STFT,
        GRIFFIN_LIM_STFT,
        AudioMNISTData,
        audio_from_log_spect,
    )
    from imagecfgen_torch.models.bigan import BiGAN, audio_mnist_bigan_config
    from imagecfgen_torch.models.classifier import CNNClassifier, audio_mnist_classifier_config
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward, fused_encoder_reference, plan_conv_ops
    from imagecfgen_torch.ops.stft import spectrogram, stft_reference
    from imagecfgen_torch.train.clf_trainer import SupervisedTrainConfig, SupervisedTrainer
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer
    from scipy.io import wavfile

    launches, lines, secs = {"fused_encoder": {}, "fused_dense": {}}, [], {}
    run, seen = cli_runner(dev, launches, secs, "AU"), {}

    def cli(label, name, *argv):
        with recording_launches(seen, label):
            return run(label, name, *argv)

    models, bf16_dir = os.path.join(tmp, "audio"), os.path.join(tmp, "audio-bf16")
    work = os.path.join(tmp, "audio-out")

    # ----------------------------------------------- AU1. the data on the card
    t0 = time.perf_counter()
    data = AudioMNISTData(None, synthetic_runs=AU_RUNS)
    synth_s = time.perf_counter() - t0
    n = len(data.raw["run"])
    check(n == 600 * AU_RUNS, f"AU1: the stand-in has {n} clips")
    data.all_spectrograms(excluded_runs=[], device=dev)  # warm-up: cuFFT's plans
    sync(dev)
    t0 = time.perf_counter()
    spects, _, _ = data.all_spectrograms(excluded_runs=[], device=dev)
    sync(dev)
    spect_s = time.perf_counter() - t0
    check(tuple(spects.shape) == (n, 128, 128) and spects.dtype == F32 and spects.device.type == dev.type,
          f"AU1: spectrograms {tuple(spects.shape)} {spects.dtype} on {spects.device}")
    check(bool(torch.isfinite(spects).all()), "AU1: a non-finite spectrogram")
    power_err = 0.0
    for i in range(0, n, 512):  # against the plain framing + rfft path, in power
        audio = torch.from_numpy(data.raw["audio"][i:i + 512]).to(dev)
        power, plain = spectrogram(audio, AUDIO_STFT), stft_reference(audio, AUDIO_STFT).abs() ** 2
        power_err = max(power_err, ((power - plain).abs().max() / plain.abs().max()).item())
        check(torch.equal(spects[i:i + 512], torch.log(power + 1e-6)), "AU1: all_spectrograms is not log(power + 1e-6)")
    print(f"AU1 spectrograms: {n} clips in {spect_s:.3f} s on the card ({n / spect_s:.0f} clips/s); "
          f"max|torch.stft - plain| {power_err:.3e} of max power (gate 4e-6)")
    check(power_err <= 4e-6, "AU1: the spectrogram disagrees with its plain framing + rfft version")
    log_spec = spects[:AU_GL_CLIPS]
    audio_from_log_spect(log_spec, rng=seeded(args.seed), n_iter=1)  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    wav = audio_from_log_spect(log_spec, rng=seeded(args.seed + 70))
    sync(dev)
    gl_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(wav.shape) == (AU_GL_CLIPS, 8129) and bool(torch.isfinite(wav).all()), "AU1: Griffin-Lim's output")
    rebuilt = spectrogram(wav, GRIFFIN_LIM_STFT).sqrt().reshape(AU_GL_CLIPS, -1)
    target = torch.exp(log_spec).sqrt().reshape(AU_GL_CLIPS, -1)
    corr = [float(np.corrcoef(target[i].cpu().numpy(), rebuilt[i].cpu().numpy())[0, 1]) for i in range(AU_GL_CLIPS)]
    print(f"AU1 Griffin-Lim: {AU_GL_CLIPS} clips, 32 iterations in {gl_ms:.1f} ms; magnitude correlation with "
          f"the target {min(corr):.4f}..{max(corr):.4f} (gate 0.99)")
    check(min(corr) >= 0.99, "AU1: Griffin-Lim's round trip lost the spectrogram")
    lines.append({"audio_data": "AU1", "clips": n, "synthesis_s": synth_s, "spectrogram_s": spect_s,
                  "clips_per_s": n / spect_s, "max_rel_err_power": power_err, "griffin_lim_clips": AU_GL_CLIPS,
                  "griffin_lim_ms": gl_ms, "griffin_lim_min_corr": min(corr), "card": card})
    del spects, log_spec, wav

    # -------------------------------------------------- AU2. training CLIs
    n_train = len(data.split_indices(excluded_runs=data.training_excluded_runs))
    steps = n_train // AU_BATCH
    gan = ("--d", AU_D, "--init-std", 0.01, "--batch-size", AU_BATCH)
    cli("train_audio_mnist_attribute_scm", "train_audio_mnist_attribute_scm", "--output-path", models,
        "--steps", 200)
    for attr in ("digit", "subject"):
        cli(f"train_audio_mnist_clf --attribute {attr}", "train_audio_mnist_clf", "--output-path", models,
            "--attribute", attr, "--epochs", 1, "--width", AU_WIDTH, "--batch-size", AU_BATCH)
        got = launches["fused_dense"][f"train_audio_mnist_clf --attribute {attr}"]
        check(got >= steps, f"AU2: train_audio_mnist_clf --attribute {attr}: {got} fused_dense launches in "
                            f"{steps} steps")
    texts = {}
    for dtype, out in ((F32, models), (BF16, bf16_dir)):
        label = f"train_audio_mnist_bigan --compute-dtype {dtype_name(dtype)}"
        texts[dtype] = cli(label, "train_audio_mnist_bigan", "--output-path", out, "--steps", 1, *gan,
                           "--compute-dtype", dtype_name(dtype))
        got = launches["fused_encoder"][label]
        check(got == steps, f"AU2: {label}: {got} fused_encoder launches in {steps} steps, not one a step")
        state, _, meta = load_audio_bigan(os.path.join(out, "audio-mnist-bigan.tar"), dev)
        check(state["step"] == steps and state["opt_d"]["count"] == 2 * steps and meta["epoch"] == 1,
              f"AU2: {label} ended at step {state['step']}")
        cfg = dataclasses.replace(audio_mnist_bigan_config(AU_D, compute_dtype=dtype), init_std=0.01)
        fresh = BiGAN(cfg, dev, seeded(0))  # the CLI's initial parameters (--seed 0)
        for part, module in (("E", fresh.encoder), ("G", fresh.generator), ("D", fresh.discriminator)):
            for k, v in module.state_dict().items():
                check(state[part][k].dtype == F32, f"AU2: {label}: {part}.{k} is {state[part][k].dtype}")
                check(not torch.equal(state[part][k], v), f"AU2: {label}: {part}.{k} did not move")
        for opt in ("opt_eg", "opt_d"):
            check({t.dtype for m in ("mu", "nu") for t in state[opt][m].values()} == {F32},
                  f"AU2: {label}: Adam's {opt} is not float32")
        del state, fresh
    x_train, a_train, _ = prepare_training_arrays(data, device=dev)
    rows = {"image": x_train, "attrs": {k: torch.from_numpy(v).to(dev) for k, v in a_train.items()}}
    for dtype in DTYPES:
        cfg = dataclasses.replace(audio_mnist_bigan_config(AU_D, compute_dtype=dtype), init_std=0.01)
        like = GANTrainer(BiGAN(cfg, dev, seeded(args.seed + 71)),
                          GANTrainConfig(betas=(0.5, 0.9), batch_size=AU_BATCH), dev, seed=args.seed + 71)
        prof = profile_steps(like.train_step, rows, AU_BATCH, f"a trainer built as the CLI builds it, seed "
                             f"{args.seed + 71}", dev)
        lines.append({"cli_training": f"train_audio_mnist_bigan --compute-dtype {dtype_name(dtype)}",
                      "batch": AU_BATCH, "d": AU_D, "steps_per_epoch": steps,
                      "cli_steps_per_s": steps_per_s(texts[dtype]), "profile_of_a_like_trainer": prof,
                      "card": card})
        del like
    clf = CNNClassifier(audio_mnist_classifier_config(10, width=AU_WIDTH), dev, seeded(args.seed + 72))
    ctr = SupervisedTrainer(clf, SupervisedTrainConfig(batch_size=AU_BATCH), dev, seed=args.seed + 72)
    y = torch.from_numpy(a_train["digit"]).to(dev)
    cbatches = [{"x": x_train[i * AU_BATCH:(i + 1) * AU_BATCH], "y": y[i * AU_BATCH:(i + 1) * AU_BATCH]}
                for i in range(9)]
    for b in cbatches[:3]:
        ctr.train_step(b)
    sync(dev)
    cprof = profile_call(lambda: [ctr.train_step(b) for b in cbatches[3:]], 6,
                         f"a classifier trainer built as the CLI builds it, 6 steps, seed {args.seed + 72}", dev)
    lines.append({"cli_training": "train_audio_mnist_clf --attribute digit", "batch": AU_BATCH,
                  "steps_per_epoch": steps, "cli_seconds": secs["train_audio_mnist_clf --attribute digit"],
                  "profile_of_a_like_trainer": cprof, "card": card})
    del clf, ctr, cbatches, y

    # ------------------------------------------ AU3. bf16 after training
    plan = audio_mnist_bigan_config(AU_D).enc_plan
    conv_ops = plan_conv_ops(plan)
    state, _, _ = load_audio_bigan(os.path.join(bf16_dir, "audio-mnist-bigan.tar"), dev)
    cfg = dataclasses.replace(audio_mnist_bigan_config(AU_D, compute_dtype=BF16), init_std=0.01)
    tr = GANTrainer(BiGAN(cfg, dev, seeded(0)), GANTrainConfig(betas=(0.5, 0.9), batch_size=AU_BATCH), dev)
    tr.load_state_dict(state)
    del state
    xb, ab = rows["image"][:AU_BATCH], {k: v[:AU_BATCH] for k, v in rows["attrs"].items()}
    trunk = tr.model.encoder.trunk
    with torch.no_grad():
        feats = tr.model.encoder.attr_channels(xb, ab)
        trained = {k: p.detach().clone() for k, p in trunk.named_parameters()}
        err, cast, pairs, tfeats, plain = check_trunk("audio trunk, trained in bf16", trained, feats, plan, BF16)
        flops, nbytes = trunk_cost(tuple(tfeats.shape), pairs, conv_ops, tfeats.element_size())
        top = plain.float().abs().max().item()
        print(f"AU3 fused_encoder on the bf16-trained trunk: max|plain| {top:.3e}, relative error "
              f"{err / max(top, 1e-30):.3e} (printed, not gated)")

    def recompute_against_fresh_casts(what):
        """The recompute's codes (the kernel on the trainer's cached bf16
        weight copies) against the plain version on copies cast now."""
        z = torch.randn((AU_BATCH, 1, 1, cfg.latent_dim), generator=seeded(args.seed + 73)).to(dev)
        codes, _ = tr.recompute(xb, ab, z)
        with torch.no_grad():
            now = [(w.detach().to(BF16), b.detach().to(BF16)) for w, b in zip(*[iter(trunk.parameters())] * 2)]
            want = fused_encoder_reference(tr.model.encoder.attr_channels(xb, ab), now, conv_ops)
        got = codes.reshape(AU_BATCH, -1).to(BF16)
        agree(f"AU3 recompute after {what}", got, want, BF16)
        # the trained trunk's codes are small (~1e-3): held also relative to their own top,
        # where weights a step stale would show
        rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        print(f"AU3 recompute after {what}: max|kernel - plain| / max|plain| = {rel:.3e} (gate {2.0 ** -6:.3e})")
        check(rel <= 2.0 ** -6, f"AU3: the recompute after {what} disagrees with freshly cast weights")
        return codes

    before = recompute_against_fresh_casts("the bf16 epoch")
    tr.train_step({"image": xb, "attrs": ab})  # one more Adam step: every parameter updated in place
    after = recompute_against_fresh_casts("one more Adam step")
    with torch.no_grad():
        getattr(trunk, f"conv_{len(conv_ops) - 1}_kernel").mul_(1.5)
    scaled = recompute_against_fresh_casts("an in-place scale of the last kernel")
    check(not torch.equal(before, after) and not torch.equal(after, scaled),
          "AU3: the recompute's codes did not follow the weight updates")
    with torch.no_grad():
        bf16_ms = time_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=10, warmup=2)
        bf16_device = device_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=20)
        bf16_plain = time_ms(lambda: fused_encoder_reference(tfeats, pairs, conv_ops), reps=2, warmup=1)
        bf16_lib = time_ms(lambda: library_stack(tfeats, pairs, conv_ops), reps=10, warmup=2)
        bf16_lib_device = device_ms(lambda: library_stack(tfeats, pairs, conv_ops), reps=20)
    del tr, trained, cast, pairs, plain, feats
    train_row = row("fused_encoder:audio_train", BF16, "imagecfgen_torch/csrc/fused_encoder.cu",
                    "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", None, err, bf16_ms, bf16_plain, bf16_lib,
                    flops, nbytes, peak, card, batch=AU_BATCH, device_ms=bf16_device,
                    library_device_ms=bf16_lib_device)
    train_row["name"] = "fused_encoder:audio_train_bf16"
    del tfeats

    # the resumed bf16 run's next steps, bit for bit (cuDNN's deterministic algorithms, as T6)
    runs = {r: os.path.join(tmp, f"audio-bf16-{r}") for r in ("split", "straight")}
    bf = (*gan, "--compute-dtype", "bfloat16")
    with deterministic():
        cli("train_audio_mnist_bigan bf16 epoch 1", "train_audio_mnist_bigan", "--output-path", runs["split"],
            "--steps", 1, *bf)
        resumed = cli("train_audio_mnist_bigan bf16 --resume", "train_audio_mnist_bigan", "--output-path",
                      runs["split"], "--steps", 2, "--resume", *bf)
        cli("train_audio_mnist_bigan bf16 epochs 1-2", "train_audio_mnist_bigan", "--output-path",
            runs["straight"], "--steps", 2, *bf)
    check(f"at epoch 1 (step {steps})" in resumed, "AU3: the bf16 --resume did not start at its step")
    got, _, _ = load_audio_bigan(os.path.join(runs["split"], "audio-mnist-bigan.tar"), dev)
    want, _, _ = load_audio_bigan(os.path.join(runs["straight"], "audio-mnist-bigan.tar"), dev)
    same_tree(got, want, "AU3 resumed bf16 state")
    print(f"AU3 bf16 --resume: the resumed run's epoch 2 ({steps} steps) equals the uninterrupted run's bit for "
          "bit (parameters, both Adam states, generator state)")
    del got, want

    # --------------------------------------------- AU4. scoring and eval CLIs
    n_val = len(data.split_indices(excluded_runs=data.validation_excluded_runs))
    cases = ("--model-dir", models)
    cf_acc = printed_score(cli("audiomnist_bigan_score", "audiomnist_bigan_score", *cases),
                           "digit cf accuracy")
    gen_acc = printed_score(cli("audiomnist_generator_score", "audiomnist_generator_score", *cases, "--n", 512),
                            "generated digit accuracy")
    check("ok" in cli("test_audio_gan", "test_audio_gan").split(), "AU4: test_audio_gan did not end in ok")
    gen = os.path.join(work, "generated")
    cli("audiomnist_generate", "audiomnist_generate", *cases, "--outdir", gen,
        "--digit-clf", os.path.join(models, "audio-mnist-digit-clf.tar"))
    for i in range(10):
        sr, wav = wavfile.read(os.path.join(gen, f"sample-{i}.wav"))
        check(sr == 8000 and wav.dtype == np.int16 and np.abs(wav).max() == 32767,
              f"AU4: sample-{i}.wav is not a non-silent 8 kHz int16 wav")
        with open(os.path.join(gen, f"sample-{i}.json")) as f:
            check("digit_pred" in json.load(f), f"AU4: sample-{i}.json")
    rec = os.path.join(work, "reconstructions")
    cli("audio_mnist_reconstruction", "audio_mnist_reconstruction", *cases, "--output", rec, "--write-wavs")
    check(read_png(os.path.join(rec, "reconstructions.png")).shape == (3 * 128, 4 * 128), "AU4: the grid")
    for name in ("generated", "real", "reconstructed"):
        sr, wav = wavfile.read(os.path.join(rec, f"{name}.wav"))
        check(sr == 8000 and wav.dtype == np.int16 and np.abs(wav).max() == 32767, f"AU4: {name}.wav")
    cf_dir = os.path.join(work, "cf")
    text = cli("audiomnist_cf_eval", "audiomnist_cf_eval", *cases, "--out-dir", cf_dir)
    mats = {m: np.load(os.path.join(cf_dir, f), allow_pickle=True) for m, f in
            (("bigan", "bigan_cf_metric_mat.npy"), ("bigan_int", "bigan_int_metric_mat.npy"))}
    for m, mat in mats.items():
        # one validation clip a (subject, digit): each cell holds the nine of other digits
        check(mat.shape == (60, 10, 9) and np.isfinite(mat.astype(float)).all(),
              f"AU4: the {m} ratio matrix {mat.shape}")
    ratios = {m: float(v) for m, v in re.findall(r"(\w+): mean ratio ([0-9.]+)", text)}
    text = cli("audiomnist_cf_classifier_metric", "audiomnist_cf_classifier_metric", *cases)
    identity = {m: float(v) for m, v in re.findall(r"(\w+): subject-identity accuracy after digit CF = ([0-9.]+)",
                                                    text)}
    check(set(identity) == {"bigan", "bigan_int"}, f"AU4: identity accuracies {identity}")
    rows_per_digit = n_val - n_val // 10  # the validation clips of the nine other digits
    expect = {  # kernel launches each CLI must make, from the data's counts
        ("fused_encoder", "audiomnist_bigan_score"): -(-n_val // AU_BATCH),
        ("fused_dense", "audiomnist_bigan_score"): -(-n_val // AU_BATCH) * 4,
        ("fused_dense", "audiomnist_generator_score"): 2 * 4,
        ("fused_encoder", "test_audio_gan"): 1,
        ("fused_encoder", "audio_mnist_reconstruction"): 1,
        ("fused_encoder", "audiomnist_cf_eval"): 10 * -(-rows_per_digit // 16),
        ("fused_encoder", "audiomnist_cf_classifier_metric"): 10 * -(-rows_per_digit // 256),
        ("fused_dense", "audiomnist_cf_classifier_metric"): 2 * 10 * -(-rows_per_digit // 256),
    }
    for (kernel, label), count in expect.items():
        check(launches[kernel][label] == count, f"AU4: {label}: {launches[kernel][label]} {kernel} launches, "
                                                f"not {count}")

    # ------------------------------------ AU5. the kernel at cf_eval's chunk
    model, stats, _ = load_audio_bigan_model(os.path.join(models, "audio-mnist-bigan.tar"), dev)
    xv, av, _ = validation_images(data, stats, dev)
    a16 = {k: torch.from_numpy(v[:16]).to(dev) for k, v in av.items()}
    cf_line = trunk_at_training_shape("audio trunk at batch 16", model.encoder, xv[:16], a16, plan,
                                      args.seed + 74, dev, peak, card, key="kernel_at_cf_eval_shape")
    lines.append(cf_line)
    # every shape the AU CLIs gave either kernel, on the inputs they gave it
    shapes = check_seen_launches(seen, plan)
    want = {("fused_encoder", "bf16", AU_BATCH)} | {
        (kernel, "f32", b) for kernel in ("fused_encoder", "fused_dense")
        for b in (AU_BATCH, n_val % AU_BATCH, 256, rows_per_digit % 256)} | {
        ("fused_encoder", "f32", b) for b in (16, rows_per_digit % 16)} | {("fused_dense", "f32", 10)}
    got = {(kernel, tag, shape[0]) for kernel, tag, shape in seen}
    check(want <= got, f"AU5: no launch at {sorted(want - got)}")
    print(f"AU5: {len(shapes)} launch shapes of the AU CLIs held against the plain versions")
    lines.append({"launch_shapes": "AU", "checked": shapes, "card": card})
    cf_runs = ("audiomnist_cf_eval",)
    cf_row = row("fused_encoder:audio_cf_eval", F32, "imagecfgen_torch/csrc/fused_encoder.cu",
                 "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", launches["fused_encoder"]["audiomnist_cf_eval"],
                 cf_line["max_abs_err"], cf_line["ms"], cf_line["plain_ms"], cf_line["library_ms"],
                 cf_line["flops"], cf_line["bytes"], peak, card, batch=16, device_ms=cf_line["device_ms"],
                 library_device_ms=cf_line["library_device_ms"],
                 cli_launches={r: launches["fused_encoder"][r] for r in cf_runs},
                 train_launches=None, train_steps=None)
    bf16_runs = [r for r in launches["fused_encoder"] if "bf16" in r or "bfloat16" in r]
    bf16_steps = launches["fused_encoder"]["train_audio_mnist_bigan --compute-dtype bfloat16"]
    train_row.update(launches=bf16_steps, cli_launches={r: launches["fused_encoder"][r] for r in bf16_runs},
                     train_launches=bf16_steps, train_steps=steps)
    lines.append({"cli_seconds": secs, "phase": "AU", "cf_digit_accuracy": cf_acc,
                  "generated_digit_accuracy": gen_acc, "mean_ratio": ratios, "identity_accuracy": identity,
                  "card": card})
    del model, xv
    return launches, lines, [cf_row, train_row]


# P1: the float32 drift's bounds. Against float64 the whole trained audio
# trunk at B = 256 may use a quarter of the kernel's gate; each layer's mean
# signed error must be a tenth or less of what the same layer read when the
# kernel kept one tensor-core sum over its whole K (P1_UNPROMOTED_LEAN, layers
# 1-6 of this trunk at B = 256 relative to their tops, the smallest of the
# readings PERF.md §6 records); fused_dense on U(0, 1) products at K = 16,384
# a tenth of that kernel's -2.1e-5; the ESRF layers a quarter of their gates.
P1_GATE_SHARE, P1_LAYER_RATIO, P1_DENSE_BOUND = 0.25, 10.0, 2.1e-6
P1_UNPROMOTED_LEAN = (-8.5e-8, -1.0e-6, -3.3e-6, -7.5e-6, -1.0e-6, -4.0e-6)
P1_BATCH = 256


def precision_phase(args, dev, card, models: str):
    """Phase P1: the repaired float32 sums of both kernels against float64,
    through ``tools/trunk_precision.py`` (AU2's trained trunk at B = 256,
    whole and each layer alone; ``fused_dense`` on U(0, 1); the ESRF
    encoder's layers 6-8 at d = 64, with the peak of device memory and the
    packed weights' bytes). Returns the lines."""
    from imagecfgen_torch.cli.audio_common import load_audio_bigan_model, load_audio_dataset, validation_images
    from imagecfgen_torch.tools.trunk_precision import dense_positive, esrf_layers, trunk_layers

    model, stats, _ = load_audio_bigan_model(os.path.join(models, "audio-mnist-bigan.tar"), dev)
    xv, av, _ = validation_images(load_audio_dataset(None, synthetic_runs=AU_RUNS), stats, dev)
    with torch.no_grad():
        a = {k: torch.from_numpy(v[:P1_BATCH]).to(dev) for k, v in av.items()}
        feats = model.encoder.attr_channels(xv[:P1_BATCH], a).contiguous()
        layers = trunk_layers(model.encoder, feats, card)
        dense = dense_positive(dev, args.seed, card)
        esrf = esrf_layers(dev, args.seed, card)
    whole = layers[-1]
    gate = GATE[F32] * max(1.0, whole["max_abs_plain"])
    print(f"P1 audio trunk at B = {P1_BATCH}: max|kernel - f64| = {whole['max_abs_err_f64']:.3e} "
          f"(bound {P1_GATE_SHARE * gate:.3e}, a quarter of the gate {gate:.3e})")
    check(whole["max_abs_err_f64"] <= P1_GATE_SHARE * gate, "P1: the trunk's float32 sums still drift")
    check(len(layers) == len(P1_UNPROMOTED_LEAN) + 1, f"P1: {len(layers) - 1} trunk layers")
    for p, u in zip(layers[:-1], P1_UNPROMOTED_LEAN):
        ratio = abs(u) / max(abs(p["kernel_toward_zero"]), 1e-30)
        print(f"P1 layer {p['trunk_layer']} (K {p['k']}, {p['plan']}): mean signed error "
              f"{p['kernel_toward_zero']:.3e}, one sum over K {u:.1e} ({ratio:.1f}x), "
              f"plain {p['plain_toward_zero']:.3e}")
        check(ratio >= P1_LAYER_RATIO, f"P1: layer {p['trunk_layer']} leans toward zero {ratio:.1f}x less only")
    top = dense[-1]
    print(f"P1 fused_dense on U(0, 1) at K = {top['dense_positive']}: mean signed error "
          f"{top['kernel_toward_zero']:.3e} (bound {P1_DENSE_BOUND:.1e})")
    check(abs(top["kernel_toward_zero"]) <= P1_DENSE_BOUND, "P1: fused_dense's float32 sums still drift")
    for e in esrf:
        print(f"P1 ESRF layer {e['esrf_layer']} (K {e['k']}, {e['plan']}): max|kernel - plain| "
              f"{e['max_abs_err']:.3e} of a {e['gate']:.3e} gate; peak memory {e['max_memory_allocated'] / 2**20:.0f} "
              f"MiB, weights {e['weights_bytes'] / 2**20:.0f} MiB, packed hi/lo {e['packed_bytes'] / 2**20:.0f} MiB")
        check(e["max_abs_err"] <= P1_GATE_SHARE * e["gate"], f"P1: ESRF layer {e['esrf_layer']} beyond its bound")
    return [{"precision": "P1", "trunk": layers, "dense_positive": dense,
             "esrf": esrf, "card": card}]


def figure_phases(args, dev, card, tmp: str):
    """Phase F1: the four MNIST figure CLIs and the headless mix GUI on C1's
    dataset and C2's and M3's models, in ``tmp/figures``: each PNG read back
    at its size and not blank, one ``fused_encoder`` launch each (the GUI:
    16, all at (1, 28, 28, 5)), the kernel held at every shape they launch it
    at. Returns ({kernel: {CLI run: launches}}, lines)."""
    from imagecfgen_torch.cli.common import read_png
    from imagecfgen_torch.models.bigan import mnist_bigan_config

    launches, secs, seen = {"fused_encoder": {}, "fused_dense": {}}, {}, {}
    run = cli_runner(dev, launches, secs, "F")
    data, models, out = os.path.join(tmp, "data"), os.path.join(tmp, "models"), os.path.join(tmp, "figures")
    src = ("--data-dir", data, "--model-dir", models)
    figures = {  # label: (CLI, flags, the PNG's shape)
        "display_thickness": ("display_thickness", (), (28, 8 * 28)),
        "causal_graph_cf": ("causal_graph_cf", (), (96, 4 * 160 + 3 * 4, 3)),
        "uncertainty_evolution": ("uncertainty_evolution", (), (96, 2 * 160 + 3 * 84 + 4 * 4, 3)),
        "cf_automatic_mix --model vae": ("cf_automatic_mix", ("--model", "vae"), (96, 3 * 84 + 160 + 3 * 4, 3)),
        "cf_automatic_mix --model bigan": ("cf_automatic_mix", ("--model", "bigan"), (96, 3 * 84 + 160 + 3 * 4, 3)),
    }
    for label, (name, flags, shape) in figures.items():
        png = os.path.join(out, label.replace(" --model ", "-") + ".png")
        with recording_launches(seen, label):
            run(label, name, *src, *flags, "--output", png)
        pix = read_png(png)
        check(pix.shape == shape and np.unique(pix).size > 1, f"F1: {png} is {pix.shape}, {np.unique(pix).size} "
                                                              f"values, not a {shape} figure")
        check(launches["fused_encoder"][label] == 1, f"F1: {label}: {launches['fused_encoder'][label]} "
                                                     "fused_encoder launches, not one")
    # the headless GUI: 15 counterfactuals (one encode each) and one encode for the digit mix, all at B = 1
    label, png, gui_shapes = "mnist_mix_vae_gui --headless", os.path.join(out, "mnist-mix-gui.png"), []
    with recording_launches(seen, label, shapes=gui_shapes):
        run(label, "mnist_mix_vae_gui", *src, "--headless", "--output", png)
    pix = read_png(png)
    check(pix.shape == (4 * 28, 5 * 28) and np.unique(pix).size > 1,
          f"F1: {png} is {pix.shape} with {np.unique(pix).size} values, not a 4 x 5 grid of digits")
    check(launches["fused_encoder"][label] == 16 and gui_shapes == [(1, 28, 28, 5)] * 16,
          f"F1: the GUI launched fused_encoder {launches['fused_encoder'][label]} times at {sorted(set(gui_shapes))}, "
          "not 16 times at (1, 28, 28, 5)")
    shapes = check_seen_launches(seen, mnist_bigan_config().enc_plan)
    got = {(kernel, tag, shape[0]) for kernel, tag, shape in seen}
    want = {("fused_encoder", "f32", b) for b in (8, 40, 1)}
    check(want == got, f"F1: launches at {sorted(got)}, not {sorted(want)}")
    return launches, [{"launch_shapes": "F1", "checked": shapes, "card": card},
                      {"cli_seconds": secs, "phase": "F", "card": card}]


R_KINDS = ("mnist-bigan", "audio-clf")  # the reference files phase R converts


def reference_phase(args, dev, card, tmp: str):
    """Phase R: checkpoints in the original PyTorch ImageCFGen's format,
    written from ``--seed`` at full width (``imagecfgen_torch/tools/
    reference_fixtures.py``): the main path's MNIST BiGAN and the AudioMNIST
    digit classifier. ``python -m imagecfgen_torch.cli.convert_reference_checkpoint``
    converts each, both at once, each in a process of its own (the BiGAN's
    scaler fitted with ``--data-dir`` on the phase's ``--batch`` rows). The
    port's loaders read the files back, and the phase holds: every reference
    tensor where the fixture's map says, bit for bit; the engine on the
    converted BiGAN at ``--batch`` with ``do(thickness + 2)`` launching
    ``fused_encoder``, and the converted classifier on ``--audio-batch``
    images launching ``fused_dense`` at (``--audio-batch``, 4096, 1024), each
    count read around that run alone; both kernels against their plain
    versions on the inputs of those launches. Returns ({kernel: {run:
    launches}}, lines)."""
    from concurrent.futures import ThreadPoolExecutor

    from imagecfgen_torch.cf.engine import CounterfactualEngine
    from imagecfgen_torch.cli.audio_common import load_audio_classifier
    from imagecfgen_torch.cli.common import bigan_from_state, load_bigan
    from imagecfgen_torch.core.attributes import one_hot, pack_mnist_attrs
    from imagecfgen_torch.core.checkpoint import load_train_state
    from imagecfgen_torch.models.bigan import mnist_bigan_config
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward
    from imagecfgen_torch.scm.mnist import MNISTAttributeSCM, build_mnist_graph
    from imagecfgen_torch.tools.reference_fixtures import check_mapped, reference_checkpoint

    b, ab = args.batch, args.audio_batch
    root, here = os.path.join(tmp, "reference"), os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, "data")
    os.makedirs(data)
    rng = np.random.default_rng(args.seed + 50)
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    t = (rng.gamma(10, 1 / 5, b) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, b)).astype(np.float32)
    raw = {"digit": one_hot(rng.integers(0, 10, b), 10).astype(np.float32), "thickness": t, "intensity": i,
           "slant": s}
    np.save(os.path.join(data, "mnist-x-train.npy"), np.round((x[..., 0] + 1) * 127.5).astype(np.uint8))
    np.save(os.path.join(data, "mnist-a-train.npy"), pack_mnist_attrs(raw))

    srcs, outs, objs, maps = {}, {}, {}, {}
    for kind in R_KINDS:  # full width: latent 512; the classifier at width 1.0, ten classes
        objs[kind], maps[kind] = reference_checkpoint(kind, args.seed + 51)
        srcs[kind], outs[kind] = os.path.join(root, f"{kind}.tar"), os.path.join(root, f"{kind}-port.tar")
        torch.save(objs[kind], srcs[kind])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (here, os.environ.get("PYTHONPATH")))))

    def convert(kind):
        flags = ("--data-dir", data) if kind == "mnist-bigan" else ()
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", "imagecfgen_torch.cli.convert_reference_checkpoint",
                               "--kind", kind, "--input", srcs[kind], "--output", outs[kind], *flags,
                               "--device", dev.type], cwd=here, env=env, capture_output=True, text=True,
                              timeout=600)
        return done, time.perf_counter() - t0

    with ThreadPoolExecutor(len(R_KINDS)) as pool:
        results = dict(zip(R_KINDS, pool.map(convert, R_KINDS)))
    secs, sizes = {}, {}
    for kind, (done, sec) in results.items():
        label = f"convert_reference_checkpoint --kind {kind}"
        secs[label], sizes[kind] = sec, os.path.getsize(srcs[kind])
        print("".join(f"  {label}| {line}\n" for line in done.stdout.splitlines()), end="")
        print(f"R {label}: exit {done.returncode} in {sec:.2f} s ({sizes[kind] / 2**20:.1f} MiB in)")
        check(done.returncode == 0, f"R: {label} failed: {done.stderr[-2000:]}")

    # every reference tensor in the port's files, bit for bit
    state, scaler, meta = load_bigan(outs["mnist-bigan"], dev)
    check(meta.get("scaler_valid") is True, f"R: the BiGAN's scaler was not fitted ({meta})")
    n_bigan = check_mapped(maps["mnist-bigan"], objs["mnist-bigan"], {p: state[p] for p in "EGD"})
    clf_state = load_train_state(outs["audio-clf"], dev)[0]
    n_clf = check_mapped(maps["audio-clf"], objs["audio-clf"], {"module": clf_state["module"]})
    del clf_state
    print(f"R: {n_bigan} BiGAN and {n_clf} classifier tensors where the reference map puts them, bit for bit")

    launches, seen = {"fused_encoder": {}, "fused_dense": {}}, {}
    graph = build_mnist_graph(i.min(), i.max(), s.min(), s.max())
    scm = MNISTAttributeSCM(graph, *graph.init(seeded(args.seed + 52), dev))
    engine = CounterfactualEngine(bigan_from_state(state, mnist_bigan_config(), dev), scm, scaler, dev)
    xd = torch.from_numpy(x).to(dev)
    attrs = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    do = {"thickness": torch.from_numpy(t + 2).reshape(-1, 1).to(dev)}
    label = "R: the converted mnist-bigan's engine"
    sync(dev)
    fused_encoder_forward.launches = fused_dense_lrelu.launches = 0
    with recording_launches(seen, label):
        x_cf, cf_attrs = engine.counterfactual(xd, attrs, do)
        sync(dev)
    launches["fused_encoder"][label] = fused_encoder_forward.launches
    launches["fused_dense"][label] = fused_dense_lrelu.launches
    check(launches["fused_encoder"][label] == 1, f"{label}: {launches['fused_encoder'][label]} fused_encoder launches")
    check(x_cf.shape == (b, 28, 28, 1) and bool(torch.isfinite(x_cf).all()) and x_cf.abs().max().item() <= 1.0,
          f"{label}: image {tuple(x_cf.shape)} not finite in [-1, 1]")
    check(torch.equal(cf_attrs["thickness"], do["thickness"].reshape(-1)), f"{label}: do(thickness) lost")

    clf, _, cmeta = load_audio_classifier(outs["audio-clf"], 10, dev)
    check(cmeta["width"] == 1.0 and cmeta["kind"] == "audio-mnist-clf", f"R: classifier meta {cmeta}")
    label = "R: the converted audio-clf"
    xa = torch.from_numpy(rng.uniform(-1, 1, (ab, 128, 128, 1)).astype(np.float32)).to(dev)
    sync(dev)
    fused_encoder_forward.launches = fused_dense_lrelu.launches = 0
    with recording_launches(seen, label), torch.no_grad():
        logits = clf(xa)
        sync(dev)
    launches["fused_encoder"][label] = fused_encoder_forward.launches
    launches["fused_dense"][label] = fused_dense_lrelu.launches
    check(launches["fused_dense"][label] == 1, f"{label}: {launches['fused_dense'][label]} fused_dense launches")
    check(logits.shape == (ab, 10) and bool(torch.isfinite(logits).all()), f"{label}: logits {tuple(logits.shape)}")

    checked = check_seen_launches(seen, mnist_bigan_config().enc_plan)
    got = {(kernel, tag, shape) for kernel, tag, shape in seen}
    want = {("fused_encoder", "f32", (b, 28, 28, 5)), ("fused_dense", "f32", (ab, 4096, 1024))}
    check(got == want, f"R: launches at {sorted(got)}, not {sorted(want)}")
    return launches, [{"reference": "R", "tensors_bit_for_bit": {"mnist-bigan": n_bigan, "audio-clf": n_clf},
                       "input_bytes": sizes, "launch_shapes": checked, "card": card},
                      {"cli_seconds": secs, "phase": "R", "card": card}]


G1_D, G1_BATCH = 64, 64
G1_WGAN_FIXED = "D.trunk.dense_0_bias"  # its gradient is 0 under the Wasserstein loss


def audio_vae_gan_phases(args, dev, card, peak, tmp: str):
    """Phases AV1, AV2 and G1: the audio VAE's training CLI (one epoch, then
    ``--resume`` against an uninterrupted two-epoch run), its two scores, the
    BiGAN fine-tune, and the unconditional GAN in both loss modes, at full
    width on the stand-in, after AU1-AU5 and on their artifacts in
    ``tmp/audio``. Returns ({kernel: {CLI run: launches}}, lines, the
    ``fused_encoder:audio_vae`` row)."""
    from imagecfgen_torch.cli.audio_common import (
        load_audio_bigan,
        load_audio_dataset,
        load_audio_gan,
        load_audio_vae_model,
        load_audio_vae_state,
        prepare_training_arrays,
        validation_images,
    )
    from imagecfgen_torch.models.gan import UncondGANConfig
    from imagecfgen_torch.models.vae import ConditionalVAE, audio_mnist_vae_config
    from imagecfgen_torch.train.uncond_gan_trainer import UncondGANTrainConfig, UncondGANTrainer
    from imagecfgen_torch.train.vae_trainer import VAETrainConfig, VAETrainer

    launches, lines, secs, seen = {"fused_encoder": {}, "fused_dense": {}}, [], {}, {}
    run = cli_runner(dev, launches, secs, "AV")

    def cli(label, name, *argv):
        with recording_launches(seen, label):
            return run(label, name, *argv)

    models = os.path.join(tmp, "audio")  # AU2's SCM, classifiers and BiGAN
    vdir, vstraight = os.path.join(tmp, "audio-vae"), os.path.join(tmp, "audio-vae-straight")
    data = load_audio_dataset(None, synthetic_runs=AU_RUNS)
    x_train, a_train, _ = prepare_training_arrays(data, device=dev)
    steps = len(x_train) // AU_BATCH
    rows = {"image": x_train, "attrs": {k: torch.from_numpy(v).to(dev) for k, v in a_train.items()}}

    # ---------------------------------------- AV1. the audio VAE's training
    vae = ("--d", AU_D, "--batch-size", AU_BATCH)
    with deterministic():
        texts = [
            cli("train_audio_mnist_vae", "train_audio_mnist_vae", "--output-path", vdir, "--steps", 1, *vae),
            cli("train_audio_mnist_vae --resume", "train_audio_mnist_vae", "--output-path", vdir, "--steps", 2,
                "--resume", *vae),
            cli("train_audio_mnist_vae epochs 1-2", "train_audio_mnist_vae", "--output-path", vstraight,
                "--steps", 2, *vae)]
    check(f"at epoch 1 (step {steps})" in texts[1], "AV1: the VAE's --resume did not start at its step")
    for label in ("train_audio_mnist_vae", "train_audio_mnist_vae --resume", "train_audio_mnist_vae epochs 1-2"):
        check(launches["fused_encoder"][label] == 0, f"AV1: {label} reached fused_encoder (E needs a gradient)")
    got, _, meta = load_audio_vae_state(os.path.join(vdir, "audio-mnist-vae.tar"), dev)
    want, _, _ = load_audio_vae_state(os.path.join(vstraight, "audio-mnist-vae.tar"), dev)
    check(meta["epoch"] == 2 and got["step"] == 2 * steps, f"AV1: the resumed VAE ended at step {got['step']}")
    same_tree(got, want, "AV1 resumed VAE state")
    neg_elbo = [float(v) for v in re.findall(r"-elbo=(\S+) ", texts[0] + texts[1])]
    check(len(neg_elbo) == 2 and all(np.isfinite(neg_elbo)), f"AV1: -ELBO {neg_elbo}")
    print(f"AV1 train_audio_mnist_vae --resume: epoch 2 ({steps} steps) equals the uninterrupted run's bit for bit")
    vtr = VAETrainer(ConditionalVAE(audio_mnist_vae_config(AU_D), dev, seeded(args.seed + 80)),
                     VAETrainConfig(batch_size=AU_BATCH, kl_weight=1.0), dev, seed=args.seed + 81)
    prof = profile_steps(vtr.train_step, rows, AU_BATCH, f"a VAE trainer built as the CLI builds it, seed "
                         f"{args.seed + 80}", dev)
    lines.append({"cli_training": "train_audio_mnist_vae", "batch": AU_BATCH, "d": AU_D, "num_samples_per_step": 4,
                  "kl_weight": 1.0, "steps_per_epoch": steps, "neg_elbo": neg_elbo,
                  "cli_steps_per_s": steps_per_s("".join(texts)), "profile_of_a_like_trainer": prof, "card": card})
    del vtr

    # -------------------------------- AV2. the VAE's scores, the fine-tune
    vtar = os.path.join(vdir, "audio-mnist-vae.tar")
    n_val = len(data.split_indices(excluded_runs=data.validation_excluded_runs))
    cf_acc = printed_score(cli("audiomnist_vae_score", "audiomnist_vae_score", "--model-dir", models,
                               "--image-model", vtar), "vae digit cf accuracy")
    gen_acc = printed_score(cli("audiomnist_vae_generator_score", "audiomnist_vae_generator_score",
                                "--model-dir", models, "--image-model", vtar, "--n", 512),
                            "vae generated digit accuracy")
    expect = {("fused_encoder", "audiomnist_vae_score"): -(-n_val // AU_BATCH),
              ("fused_dense", "audiomnist_vae_score"): -(-n_val // AU_BATCH) * 4,
              ("fused_encoder", "audiomnist_vae_generator_score"): 0,
              ("fused_dense", "audiomnist_vae_generator_score"): 2 * 4}
    for (kernel, label), count in expect.items():
        check(launches[kernel][label] == count, f"AV2: {label}: {launches[kernel][label]} {kernel} launches, "
                                                f"not {count}")
    model, stats, _ = load_audio_vae_model(vtar, dev)
    xv, av, _ = validation_images(data, stats, dev)
    a128 = {k: torch.from_numpy(v[:AU_BATCH]).to(dev) for k, v in av.items()}
    vae_line = trunk_at_training_shape(f"audio VAE trunk at batch {AU_BATCH}", model.encoder, xv[:AU_BATCH], a128,
                                       model.cfg.enc_plan, args.seed + 82, dev, peak, card,
                                       key="kernel_at_vae_score_shape")
    lines.append(vae_line)
    del model, xv

    work = os.path.join(tmp, "av-finetune")
    os.makedirs(work)
    before, _, _ = load_audio_bigan(os.path.join(models, "audio-mnist-bigan.tar"), dev)
    with contextlib.chdir(work):
        text = cli("finetune_audio_mnist_bigan", "finetune_audio_mnist_bigan", "--model-file",
                   os.path.join(models, "audio-mnist-bigan.tar"), "--steps", 1, "--batch-size", AU_BATCH)
        after, _, meta = load_audio_bigan("audio-mnist-bigan-finetuned-mse.tar", dev)
    check(launches["fused_encoder"]["finetune_audio_mnist_bigan"] == 0,
          "AV2: the fine-tune reached fused_encoder (E needs a gradient)")
    still = [k for k in before["E"] if torch.equal(before["E"][k], after["E"][k])]
    check(not still, f"AV2: the fine-tune left E's {still} unmoved")
    for part in ("G", "D"):
        same_tree(after[part], before[part], f"AV2 fine-tuned {part}")
    check(meta["finetuned"] == "mse" and meta["d"] == AU_D, f"AV2: fine-tuned file meta {meta}")
    lines.append({"cli_training": "finetune_audio_mnist_bigan --metric mse", "batch": AU_BATCH,
                  "steps_per_epoch": steps, "cli_steps_per_s": steps_per_s(text), "card": card})

    # ------------------------------------------ G1. the unconditional GAN
    gan = ("--generator-size", G1_D, "--batch-size", G1_BATCH)
    g_steps = len(x_train) // G1_BATCH
    runs = {r: os.path.join(tmp, f"gan-{r}") for r in ("gan", "wgan", "wgan-straight")}

    def epoch_one(mode):
        """One epoch in ``mode``: the step and Adam counts, and every
        parameter of G and D moved from the CLI's initial one (--seed 0)."""
        label = f"train_audio_gan --loss-mode {mode}"
        text = cli(label, "train_audio_gan", "--output-path", runs[mode], "--steps", 1, *gan, "--loss-mode", mode)
        state, _, _ = load_audio_gan(os.path.join(runs[mode], f"audio-gan-{mode}.tar"), dev)
        check(state["step"] == g_steps and state["opt_g"]["count"] == state["opt_d"]["count"] == g_steps,
              f"G1: {label} ended at step {state['step']}")
        fresh = UncondGANTrainer(UncondGANConfig(d=G1_D), UncondGANTrainConfig(loss_mode=mode), dev)
        for part, module in (("G", fresh.G), ("D", fresh.D)):
            for k, v in module.state_dict().items():
                # the Wasserstein loss, E[D(fake)] - E[D(real)] + the penalty on
                # D's input gradient, does not depend on D's output bias
                fixed = mode == "wgan" and f"{part}.{k}" == G1_WGAN_FIXED
                check(torch.equal(state[part][k], v) == fixed,
                      f"G1: {label}: {part}.{k} {'moved' if fixed else 'did not move'}")
        return text

    g_texts = {"gan": epoch_one("gan")}

    wgan = (*gan, "--loss-mode", "wgan")
    with deterministic():
        g_texts["wgan"] = epoch_one("wgan")
        resumed = cli("train_audio_gan --loss-mode wgan --resume", "train_audio_gan", "--output-path", runs["wgan"],
                      "--steps", 2, "--resume", *wgan)
        cli("train_audio_gan --loss-mode wgan epochs 1-2", "train_audio_gan", "--output-path",
            runs["wgan-straight"], "--steps", 2, *wgan)
    check(f"at epoch 1 (step {g_steps})" in resumed, "G1: the wgan --resume did not start at its step")
    got, _, _ = load_audio_gan(os.path.join(runs["wgan"], "audio-gan-wgan.tar"), dev)
    want, _, _ = load_audio_gan(os.path.join(runs["wgan-straight"], "audio-gan-wgan.tar"), dev)
    same_tree(got, want, "G1 resumed wgan state")
    print(f"G1 train_audio_gan --loss-mode wgan --resume: epoch 2 ({g_steps} steps) equals the uninterrupted run's "
          "bit for bit")
    del got, want
    for label in (r for r in secs if r.startswith("train_audio_gan")):
        counts = {k: launches[k][label] for k in launches}
        check(counts == {"fused_encoder": 0, "fused_dense": 0}, f"G1: {label} launched {counts}")
    images = {"image": x_train, "attrs": {}}
    for mode in ("gan", "wgan"):
        like = UncondGANTrainer(UncondGANConfig(d=G1_D), UncondGANTrainConfig(batch_size=G1_BATCH, loss_mode=mode),
                                dev, seed=args.seed + 83)
        prof = profile_steps(like.train_step, images, G1_BATCH, f"a trainer built as the CLI builds "
                             f"it, seed {args.seed + 83}", dev)
        lines.append({"cli_training": f"train_audio_gan --loss-mode {mode}", "batch": G1_BATCH, "d": G1_D,
                      "steps_per_epoch": g_steps, "cli_steps_per_s": steps_per_s(g_texts[mode]),
                      "every_parameter_moved": True, "kernel_launches_per_step": 0,
                      "profile_of_a_like_trainer": prof, "card": card})
        del like
    del x_train, rows

    # every shape the AV CLIs gave either kernel, on the inputs they gave it
    shapes = check_seen_launches(seen, audio_mnist_vae_config(AU_D).enc_plan)
    want = {("fused_encoder", "f32", b) for b in (AU_BATCH, n_val % AU_BATCH)} | {
        ("fused_dense", "f32", b) for b in (AU_BATCH, n_val % AU_BATCH, 256)}
    got = {(kernel, tag, shape[0]) for kernel, tag, shape in seen}
    check(want == got, f"AV: launches at {sorted(got)}, not {sorted(want)}")
    lines.append({"launch_shapes": "AV", "checked": shapes, "card": card})
    lines.append({"cli_seconds": secs, "phase": "AV/G", "vae_cf_digit_accuracy": cf_acc,
                  "vae_generated_digit_accuracy": gen_acc, "card": card})
    runs = ("audiomnist_vae_score",)
    vae_row = row("fused_encoder:audio_vae", F32, "imagecfgen_torch/csrc/fused_encoder.cu",
                  "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", launches["fused_encoder"]["audiomnist_vae_score"],
                  vae_line["max_abs_err"], vae_line["ms"], vae_line["plain_ms"], vae_line["library_ms"],
                  vae_line["flops"], vae_line["bytes"], peak, card, batch=AU_BATCH, device_ms=vae_line["device_ms"],
                  library_device_ms=vae_line["library_device_ms"],
                  cli_launches={r: launches["fused_encoder"][r] for r in launches["fused_encoder"]},
                  train_launches=launches["fused_encoder"]["train_audio_mnist_vae"], train_steps=steps)
    return launches, lines, vae_row


# the marine slice at full width: whale_bigan_config(d=64), whale_vae_config(d=64) and
# narw_classifier_config(width=1.0) on the whale stand-in at 64 clips a call type (153
# training and 39 validation windows), esrf_bigan_config(d=64) on the ESRF stand-in's 24
# recordings (the first batch of recordings, --max-batches 1, holds 32 or more windows)
W_D, W_CLIPS, W_BATCH = 64, 64, 32
S_RECORDINGS, S_BATCH = 24, 16


def host_rss() -> int:
    """This process's resident memory (``VmRSS``), in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return -1


@contextlib.contextmanager
def sampling_rss(peak: list, every_s: float = 0.005):
    """Inside, a thread reads this process's resident memory every
    ``every_s`` seconds and keeps the largest reading in ``peak[0]``."""
    import threading

    done = threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], host_rss())
            done.wait(every_s)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        done.set()
        thread.join()
        peak[0] = max(peak[0], host_rss())


@contextlib.contextmanager
def timing_saves(module, seconds: list):
    """Inside, each ``save_train_state`` that ``module`` calls appends its
    seconds to ``seconds``."""
    real = module.save_train_state

    def timed(*a, **k):
        t0 = time.perf_counter()
        real(*a, **k)
        seconds.append(time.perf_counter() - t0)

    module.save_train_state = timed
    try:
        yield
    finally:
        module.save_train_state = real


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev) if torch.is_tensor(tree) else tree


def dense_row(name, seen_entry, launches, peak, card, **extra):
    """The ``fused_dense`` row at one recorded launch's inputs: the kernel,
    its plain version and ``F.linear`` + ``F.leaky_relu``, timed."""
    from imagecfgen_torch.ops.fused_dense import fused_dense_lrelu, fused_dense_reference

    label, x, w, b, slope = seen_entry
    with torch.no_grad():
        err = agree(f"fused_dense {name} {tuple(x.shape)}x{tuple(w.shape)}", fused_dense_lrelu(x, w, b, slope),
                    fused_dense_reference(x, w, b, slope), F32)
        ms = time_ms(lambda: fused_dense_lrelu(x, w, b, slope), reps=200, warmup=10)
        plain_ms = time_ms(lambda: fused_dense_reference(x, w, b, slope), reps=100, warmup=5)
        lib_ms = time_ms(lambda: F.leaky_relu(F.linear(x, w, b), slope), reps=200, warmup=10)
        dev_ms = device_ms(lambda: fused_dense_lrelu(x, w, b, slope))
        lib_dev = device_ms(lambda: F.leaky_relu(F.linear(x, w, b), slope))
    flops, nbytes = dense_cost(x.shape[0], x.shape[1], w.shape[0])
    return row(name, F32, "imagecfgen_torch/csrc/fused_dense.cu", "imagecfgen_tpu/ops/pallas/fused_dense.py:57",
               launches, err, ms, plain_ms, lib_ms, flops, nbytes, peak, card, shape=[x.shape[0], x.shape[1],
                                                                                      w.shape[0]],
               device_ms=dev_ms, library_device_ms=lib_dev, first_run=label, **extra)


def trunk_row(name, line, launches, peak, card, **extra):
    return row(name, F32, "imagecfgen_torch/csrc/fused_encoder.cu", "imagecfgen_tpu/ops/pallas/fused_encoder.py:127",
               launches, line["max_abs_err"], line["ms"], line["plain_ms"], line["library_ms"], line["flops"],
               line["bytes"], peak, card, batch=line["shape"][0], shape=line["shape"], device_ms=line["device_ms"],
               library_device_ms=line["library_device_ms"], **extra)


def marine_phases(args, dev, card, peak, tmp: str):
    """Phases W1, W2 and S1: the marine CLIs at full width in ``tmp/whale``
    and ``tmp/esrf``. Returns ({kernel: {CLI run: launches}}, lines, the four
    marine kernel rows)."""
    import shutil

    from imagecfgen_torch.cli import common as cli_common
    from imagecfgen_torch.cli.common import bigan_from_state
    from imagecfgen_torch.cli.whale_common import (
        collect_whale_arrays,
        load_esrf_dataset,
        load_whale_bigan,
        load_whale_dataset,
        load_whale_vae,
    )
    from imagecfgen_torch.core.checkpoint import load_train_state
    from imagecfgen_torch.models.bigan import Encoder, esrf_bigan_config, whale_bigan_config
    from imagecfgen_torch.tools.trunk_precision import trunk_layers

    launches, lines, secs = {"fused_encoder": {}, "fused_dense": {}}, [], {}
    run, seen = cli_runner(dev, launches, secs, "W"), {}
    shapes_of, rates = {}, {}

    def cli(label, name, *argv, firsts=None):
        before = set(seen)
        with recording_launches(seen, label, firsts):
            text = run(label, name, *argv)
        shapes_of[label] = [f"{k[0]} {'x'.join(map(str, k[2]))}" for k in sorted(set(seen) - before)]
        rates[label] = steps_per_s(text)
        print(f"W {label}: steps/s {rates[label]}, new launch shapes {shapes_of[label]}")
        return text

    whale, wstraight, esrf, estraight = (os.path.join(tmp, n) for n in ("whale", "whale-straight", "esrf",
                                                                          "esrf-straight"))
    work = os.path.join(tmp, "whale-ft")
    os.makedirs(work)
    data = load_whale_dataset(None, None, None, synthetic_clips=W_CLIPS)
    n_train = sum(len(b["call_type"]) for b in data.stream(transform=False, mode="train"))
    n_val = sum(len(b["call_type"]) for b in data.stream(transform=False, mode="validation"))
    steps, clips = n_train // W_BATCH, ("--synthetic-clips", W_CLIPS)
    check((n_train, n_val) == (153, 39), f"W1: the stand-in has {n_train} + {n_val} windows")

    # ------------------------------------------------ W1. the whale-call CLIs
    cli("train_whale_clf", "train_whale_clf", "--output-path", whale, "--epochs", 1, "--width", 1.0,
        "--batch-size", W_BATCH, *clips)
    gan = ("--d", W_D, "--init-std", 0.01, "--batch-size", W_BATCH, "--remat", *clips)
    with deterministic():
        texts = [cli("train_whale_bigan", "train_whale_bigan", "--output-path", whale, "--steps", 1, *gan),
                 cli("train_whale_bigan --resume", "train_whale_bigan", "--output-path", whale, "--steps", 2,
                     "--resume", *gan),
                 cli("train_whale_bigan epochs 1-2", "train_whale_bigan", "--output-path", wstraight, "--steps", 2,
                     *gan)]
    check(f"at epoch 1 (step {steps})" in texts[1], "W1: the whale --resume did not start at its step")
    got, _, meta = load_whale_bigan(os.path.join(whale, "whale-bigan.tar"), dev)
    want, _, _ = load_whale_bigan(os.path.join(wstraight, "whale-bigan.tar"), dev)
    check(meta["epoch"] == 2 and got["step"] == 2 * steps and got["opt_d"]["count"] == 4 * steps,
          f"W1: the resumed whale BiGAN ended at step {got['step']}")
    same_tree(got, want, "W1 resumed whale BiGAN state")
    print(f"W1 train_whale_bigan --resume: epoch 2 ({steps} steps) equals the uninterrupted run's bit for bit")
    del got, want
    cli("train_whale_vae", "train_whale_vae", "--output-path", whale, "--steps", 1, "--d", W_D,
        "--batch-size", W_BATCH, *clips)
    with contextlib.chdir(work):
        cli("finetune_whale_bigan", "finetune_whale_bigan", "--model-file", os.path.join(whale, "whale-bigan.tar"),
            "--steps", 1, "--batch-size", W_BATCH, *clips)
    shutil.copy(os.path.join(work, "whale-bigan-finetuned-mse.tar"), whale)
    gen_acc = printed_score(cli("whale_generator_score", "whale_generator_score", "--model-dir", whale, "--n", 256,
                                "--batch-size", 64), "generated call-type accuracy")
    cf_firsts = []
    text = cli("whale_cf_score", "whale_cf_score", "--model-dir", whale, "--bigan-ft",
               "whale-bigan-finetuned-mse.tar", "--vae", "whale-vae.tar", "--batch-size", W_BATCH, *clips,
               firsts=cf_firsts)
    cf_acc = {m: float(v) for m, v in re.findall(r"(\w+): call-type cf accuracy = ([0-9.]+)", text)}
    check(set(cf_acc) == {"bigan", "bigan_ft", "vae"}, f"W1: whale_cf_score printed {cf_acc}")
    cf_batches = -(-n_val // W_BATCH)
    expect = {  # each CLI's launches, from the data's counts
        "train_whale_clf": (0, steps), "train_whale_bigan": (steps, 0), "train_whale_bigan --resume": (steps, 0),
        "train_whale_bigan epochs 1-2": (2 * steps, 0), "train_whale_vae": (0, 0), "finetune_whale_bigan": (0, 0),
        "whale_generator_score": (0, 256 // 64), "whale_cf_score": (3 * cf_batches, 3 * cf_batches)}
    for label, (enc, dense) in expect.items():
        got = (launches["fused_encoder"][label], launches["fused_dense"][label])
        check(got == (enc, dense), f"W1: {label} launched (fused_encoder, fused_dense) {got}, not {(enc, dense)}")

    wcfg = whale_bigan_config(W_D)
    state, stats, _ = load_whale_bigan(os.path.join(whale, "whale-bigan.tar"), dev)
    model = bigan_from_state(state, wcfg, dev).eval()
    del state
    xv, calls, _ = collect_whale_arrays(data, "validation", device=dev)
    xb, ab = xv[:W_BATCH], {"call_type": torch.from_numpy(calls[:W_BATCH]).to(dev)}
    whale_line = trunk_at_training_shape(f"whale trunk at batch {W_BATCH}", model.encoder, xb, ab, wcfg.enc_plan,
                                         args.seed + 90, dev, peak, card, key="kernel_at_whale_shape")
    vae, _ = load_whale_vae(os.path.join(whale, "whale-vae.tar"), dev)
    # whale_cf_score's launches, each counted to the model whose first conv kernel it ran
    ft, _, _ = load_whale_bigan(os.path.join(whale, "whale-bigan-finetuned-mse.tar"), dev)
    trunks = {what: dict(e.trunk.named_parameters())["conv_0_kernel"].detach()
              for what, e in (("bigan", model.encoder), ("bigan_ft", bigan_from_state(ft, wcfg, dev).encoder),
                              ("vae", vae.encoder))}
    del ft
    by_trunk = dict.fromkeys(trunks, 0)
    for kernel in cf_firsts:
        hits = [what for what, w in trunks.items() if w.shape == kernel.shape and torch.equal(w, kernel)]
        check(len(hits) == 1, f"W1: a whale_cf_score launch ran the trunk of {hits or 'no saved model'}")
        by_trunk[hits[0]] += 1
    print(f"W1 whale_cf_score: fused_encoder launches by the trunk they ran {by_trunk}")
    check(by_trunk == dict.fromkeys(trunks, cf_batches), f"W1: whale_cf_score's trunks launched {by_trunk}")
    del cf_firsts, trunks
    vae_line = trunk_at_training_shape(f"whale VAE trunk at batch {W_BATCH}", vae.encoder, xb, ab,
                                       vae.cfg.enc_plan, args.seed + 91, dev, peak, card,
                                       key="kernel_at_whale_vae_shape")
    lines += [whale_line, vae_line]

    # ---------------------------------------- W2. the whale trunk against float64
    with torch.no_grad():
        feats = model.encoder.attr_channels(xb, ab).contiguous()
        trained = trunk_layers(model.encoder, feats, card)
        fan_in = Encoder(wcfg, dev)
        fan_in.trunk.load_state_dict(trunk_params(wcfg.enc_plan, args.seed + 92, dev, c_in=2, std=None))
        probe = torch.from_numpy(np.random.default_rng(args.seed + 93).normal(0, 1, tuple(feats.shape))
                                 .astype(np.float32)).to(dev)
        fanned = trunk_layers(fan_in, probe, card)
    for what, layers in (("trained", trained), ("fan-in", fanned)):
        whole = layers[-1]
        gate = GATE[F32] * max(1.0, whole["max_abs_plain"])
        print(f"W2 whale trunk ({what} weights) at B = {W_BATCH}: max|kernel - f64| = {whole['max_abs_err_f64']:.3e} "
              f"(bound {P1_GATE_SHARE * gate:.3e}, a quarter of the gate {gate:.3e}); layers' mean signed errors "
              f"{[f'{p['kernel_toward_zero']:.2e}' for p in layers[:-1]]}")
        check(whole["max_abs_err_f64"] <= P1_GATE_SHARE * gate, f"W2: the whale trunk ({what}) drifts from float64")
    lines.append({"precision": "W2", "trunk": "whale", "trained": trained, "fan_in": fanned, "card": card})
    del model, vae, fan_in, xv, feats, probe

    # ------------------------------------------------------- S1. the ESRF CLIs
    free_before = shutil.disk_usage(tmp).free
    edata = load_esrf_dataset(None, None, S_RECORDINGS)
    first = next(edata.stream(transform=False, batch_size=32, mode="train"))
    e_steps = len(first["has_boat"]) // S_BATCH
    check(e_steps >= 2, f"S1: the first batch of recordings holds {len(first['has_boat'])} windows")
    egan = ("--d", W_D, "--init-std", 0.01, "--batch-size", S_BATCH, "--max-batches", 1,
            "--synthetic-recordings", S_RECORDINGS)
    # the uninterrupted run first, its state held in host memory: one checkpoint on disk at a time
    with deterministic():
        cli("train_esrf_bigan epochs 1-2", "train_esrf_bigan", "--output-path", estraight, "--steps", 2, *egan)
        want, _ = load_train_state(os.path.join(estraight, "esrf-bigan.tar"), "cpu")
        shutil.rmtree(estraight)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        texts = [cli("train_esrf_bigan", "train_esrf_bigan", "--output-path", esrf, "--steps", 1, *egan)]
        train_peak = torch.cuda.max_memory_allocated(dev)
        saves = []
        with timing_saves(cli_common, saves):
            texts.append(cli("train_esrf_bigan --resume", "train_esrf_bigan", "--output-path", esrf, "--steps", 2,
                             "--resume", *egan))
    check(f"at epoch 1 (step {e_steps})" in texts[1], "S1: the ESRF --resume did not start at its step")
    # the trainers are gone: their parameters, Adam states and the packed hi/lo copies of E's weights
    # (remade after every step, when E changes) must have gone with them
    left = torch.cuda.memory_allocated(dev) - base
    check(left < 2 ** 30, f"S1: {left / 2**30:.2f} GiB of device memory outlived the ESRF runs")
    path = os.path.join(esrf, "esrf-bigan.tar")
    nbytes = os.path.getsize(path)
    rss_before, load_rss = host_rss(), [0]
    with sampling_rss(load_rss):
        t0 = time.perf_counter()
        got, meta = load_train_state(path, dev)
        sync(dev)
        load_s = time.perf_counter() - t0
    load_rss = load_rss[0]
    check(meta["epoch"] == 2 and got["trainer"]["step"] == 2 * e_steps, f"S1: the resumed ESRF run's meta {meta}")
    same_tree(got, to_device(want, dev), "S1 resumed ESRF state")
    print(f"S1 train_esrf_bigan --resume: epoch 2 ({e_steps} steps) equals the uninterrupted run's bit for bit")
    del want
    check(len(saves) == 1, f"S1: the resumed run saved {len(saves)} times")
    save_s = saves[0]
    n_params = {p: sum(v.numel() for v in got["trainer"][p].values()) for p in ("E", "G", "D")}
    del got
    ckpt = {"checkpoint": "S1 esrf-bigan.tar", "bytes": nbytes, "load_s": load_s, "save_s": save_s,
            "host_rss_before_loading": rss_before, "host_peak_rss_while_loading": load_rss,
            "disk_free_before": free_before,
            "device_peak_training": train_peak, "device_left_after_runs": left, "parameters": n_params,
            "card": card}
    print(f"S1 ESRF: device peak {train_peak / 2**30:.2f} GiB training at batch {S_BATCH} (remat); checkpoint "
          f"{nbytes / 2**30:.2f} GiB, save {save_s:.1f} s (in the resumed run), load {load_s:.1f} s; host "
          f"resident memory {rss_before / 2**30:.2f} GiB before the load, at most {load_rss / 2**30:.2f} GiB "
          f"while loading; disk free before S1 {free_before / 2**30:.1f} GiB; parameters {n_params}")
    check(load_rss - rss_before < nbytes / 2, "S1: loading the checkpoint held it in host memory")
    lines.append(ckpt)
    cli("finetune_esrf_bigan", "finetune_esrf_bigan", "--model-file", path, "--output-path", esrf,
        "--steps", 1, "--batch-size", S_BATCH, "--max-batches", 1, "--synthetic-recordings", S_RECORDINGS)
    payload, fmeta = load_train_state(os.path.join(esrf, "esrf-bigan-finetuned-ssim.tar"), "cpu")
    check(set(payload["trainer"]) == {"E", "G"} and fmeta["finetuned"] == "ssim",
          f"S1: the ESRF fine-tune saved {sorted(payload['trainer'])}")
    del payload
    text = cli("esrf_quality", "esrf_quality", "--model-dir", esrf, "--synthetic-recordings", S_RECORDINGS,
               "--batch-size", S_BATCH)
    quality = {k: float(v) for k, v in re.findall(r"(mse|ssim)=(-?[0-9.]+)", text)}
    check(set(quality) == {"mse", "ssim"} and all(np.isfinite(list(quality.values()))), f"S1: quality {quality}")
    n_qual = int(re.search(r"validation windows: (\d+)", text).group(1))
    q_batches = sum(1 for _ in edata.stream(transform=False, batch_size=S_BATCH, mode="validation", shuffle=False))
    expect = {"train_esrf_bigan": (e_steps, 0), "train_esrf_bigan --resume": (e_steps, 0),
              "train_esrf_bigan epochs 1-2": (2 * e_steps, 0), "finetune_esrf_bigan": (0, 0),
              "esrf_quality": (q_batches, 0)}
    for label, want_counts in expect.items():
        counts = (launches["fused_encoder"][label], launches["fused_dense"][label])
        check(counts == want_counts, f"S1: {label} launched {counts}, not {want_counts}")
    ecfg = esrf_bigan_config(W_D)
    state, stats, _ = load_whale_bigan(path, dev)
    model = bigan_from_state(state, ecfg, dev).eval()
    del state
    spects = next(edata.stream(batch_size=32, mode="train", device=dev))
    ex = stats.spect_to_img(spects["audio"][:S_BATCH])[..., None]
    ea = {"has_boat": torch.from_numpy(spects["has_boat"][:S_BATCH]).to(dev),
          "closest_boat": torch.from_numpy(spects["closest_boat"][:S_BATCH]).to(dev)}
    esrf_line = trunk_at_training_shape(f"ESRF trunk at batch {S_BATCH}", model.encoder, ex, ea, ecfg.enc_plan,
                                        args.seed + 94, dev, peak, card, key="kernel_at_esrf_shape")
    lines.append(esrf_line)
    del model, spects, ex

    # every shape the marine CLIs gave either kernel, on the inputs they gave it
    whale_seen = {k: v for k, v in seen.items() if k[0] == "fused_dense" or k[2][1:3] == (256, 256)}
    esrf_seen = {k: v for k, v in seen.items() if k[0] == "fused_encoder" and k[2][1:3] == (512, 512)}
    check(len(whale_seen) + len(esrf_seen) == len(seen), f"W/S: launches at {sorted(seen)}")
    checked = check_seen_launches(whale_seen, wcfg.enc_plan) + check_seen_launches(esrf_seen, ecfg.enc_plan)
    want = {("fused_encoder", W_BATCH, 256), ("fused_encoder", n_val % W_BATCH, 256),
            ("fused_encoder", S_BATCH, 512), ("fused_dense", W_BATCH, 4096), ("fused_dense", 64, 4096),
            ("fused_dense", n_val % W_BATCH, 4096)}
    got = {(k[0], k[2][0], k[2][1]) for k in seen}
    check(want <= got, f"W/S: no launch at {sorted(want - got)}")
    print(f"W/S: {len(checked)} launch shapes of the marine CLIs held against the plain versions")
    lines.append({"launch_shapes": "W/S", "checked": checked, "per_cli": shapes_of, "card": card})
    lines.append({"cli_seconds": secs, "phase": "W/S", "whale_generated_accuracy": gen_acc,
                  "whale_cf_accuracy": cf_acc, "esrf_quality": quality, "esrf_validation_windows": n_qual,
                  "steps_per_s": rates, "card": card})

    enc = launches["fused_encoder"]
    bigans = by_trunk["bigan"] + by_trunk["bigan_ft"]
    bigan_runs = {r: enc[r] for r in enc if "whale" in r and r not in ("whale_cf_score", "train_whale_vae")}
    rows = [
        trunk_row("fused_encoder:whale", whale_line, bigans, peak, card,
                  cli_launches={**bigan_runs, "whale_cf_score (the two BiGANs' share)": bigans},
                  train_launches=enc["train_whale_bigan"], train_steps=steps),
        trunk_row("fused_encoder:whale_vae", vae_line, by_trunk["vae"], peak, card,
                  cli_launches={"whale_cf_score (the VAE's share)": by_trunk["vae"],
                                "train_whale_vae": enc["train_whale_vae"]},
                  train_launches=enc["train_whale_vae"], train_steps=steps),
        trunk_row("fused_encoder:esrf", esrf_line, enc["esrf_quality"], peak, card,
                  cli_launches={r: enc[r] for r in enc if "esrf" in r}, train_launches=enc["train_esrf_bigan"],
                  train_steps=e_steps),
        dense_row("fused_dense:narw", seen[("fused_dense", "f32", (W_BATCH, 4096, 1024))],
                  launches["fused_dense"]["whale_cf_score"], peak, card,
                  cli_launches={r: n for r, n in launches["fused_dense"].items() if n},
                  train_launches=launches["fused_dense"]["train_whale_clf"], train_steps=steps),
    ]
    return launches, lines, rows


# ------------------------------------------------------------------ phase D
D_STEPS = 3  # steps of D1 and D2's compared runs
D_RATE_STEPS = 40  # steps of each timed run of D2
D_PROFILE_STEPS = 10  # steps of each profiled run of D2
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
            "GROUP_RANK", "ROLE_RANK", "TORCHELASTIC_RUN_ID")


def dp_trainer(dev, seed: int, mesh=None):
    """The main path's trainer: the full-width MNIST BiGAN, batch 64,
    ``d_updates_per_g_update=3``."""
    from imagecfgen_torch.models.bigan import BiGAN, mnist_bigan_config
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    return GANTrainer(BiGAN(mnist_bigan_config(), dev, seeded(seed)),
                      GANTrainConfig(batch_size=64, d_updates_per_g_update=3), dev, seed=seed, mesh=mesh)


def dp_steps(trainer, steps, dev):
    """``steps``: ``[(batch, z, masks)]``, global, numpy; each step run with
    that noise injected. Returns each step's metrics (this rank's shard's)."""
    def put(a):
        return torch.from_numpy(a).to(dev)

    out = []
    for batch, z, masks in steps:
        m = trainer.train_step({"image": put(batch["image"]), "attrs": {k: put(v) for k, v in batch["attrs"].items()}},
                               z=put(z), masks=[[put(k) for k in f] for f in masks])
        out.append({k: v.item() for k, v in m.items()})
    return out


def d1_rank(mesh, steps, seed: int, device: str):
    """D1 on one rank: :func:`dp_steps` on the rank's trainer; its metrics,
    E, G and D, and its ``fused_encoder`` launches."""
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    trainer = dp_trainer(dev, seed, mesh)
    fused_encoder_forward.launches = 0
    metrics = dp_steps(trainer, steps, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    state = trainer.state_dict()
    return {"metrics": metrics, "params": {f"{p}.{n}": v for p in "EGD" for n, v in state[p].items()},
            "launches": fused_encoder_forward.launches, "rng": trainer.rng.get_state()}


def dp_counts(what: str, got, want) -> dict:
    """How far the parameters and buffers ``got`` (a ``W``-rank run's, or
    a second process's) lie from ``want``'s: the elements beyond rtol 2e-3 /
    atol 2e-4, the largest difference of a parameter and of a batch-norm
    running statistic, and the tensors equal bit for bit; printed."""
    misses = size = equal = 0
    worst = {"parameter": 0.0, "buffer": 0.0}
    for name, w in want.items():
        g, w = np.asarray(got[name], np.float64), np.asarray(w, np.float64)
        err = np.abs(g - w)
        misses += int((err > 2e-4 + 2e-3 * np.abs(w)).sum())
        size += w.size
        equal += int(np.array_equal(g, w))
        kind = "buffer" if name.endswith((".mean", ".var")) else "parameter"
        worst[kind] = max(worst[kind], float(err.max()))
    print(f"{what}: {misses} of {size} elements beyond rtol 2e-3 / atol 2e-4, the largest difference "
          f"{worst['parameter']:.3e} (parameters), {worst['buffer']:.3e} (batch-norm statistics); "
          f"{equal} of {len(want)} tensors bit for bit")
    return {"elements_off": misses, "elements": size, "max_abs_diff": worst["parameter"],
            "max_abs_diff_bn_stats": worst["buffer"], "tensors_equal": equal, "tensors": len(want)}


# D3's entry point: the CLI module run as __main__ under cuDNN's deterministic
# algorithms, so that two processes can be compared bit for bit
D3_DRIVER = """import runpy, sys
import torch
torch.backends.cudnn.deterministic = True
torch.use_deterministic_algorithms(True, warn_only=True)
sys.argv[0] = "train_mnist_image_scm"
runpy.run_module("imagecfgen_torch.cli.train_mnist_image_scm", run_name="__main__", alter_sys=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def d2_phase(dev, seed: int, x, attrs, card) -> dict:
    """D2: the main path's trainer in an NCCL group of one, joined through
    ``init_from_env``, against no group: bit for bit after ``D_STEPS``
    steps, the collectives of three steps by kind, steps/s in turns, and
    both under torch.profiler (device time, NCCL's kernels, the host time
    of each collective op). Returns its line."""
    import torch.distributed as dist

    from imagecfgen_torch.parallel.launch import record_collectives
    from imagecfgen_torch.parallel.mesh import init_from_env

    saved = {k: os.environ.get(k) for k in DIST_ENV}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    try:
        mesh, mdev = init_from_env("cuda")
        check(mesh.group is not None and mesh.world == 1 and mdev == torch.device("cuda", 0),
              f"D2: init_from_env gave {mesh.world} ranks on {mdev}")
        backend = dist.get_backend(mesh.group)
        xd, ad = x.to(dev), {k: v.to(dev) for k, v in attrs.items()}
        batches = [{"image": xd[64 * i:64 * (i + 1)], "attrs": {k: v[64 * i:64 * (i + 1)] for k, v in ad.items()}}
                   for i in range(D_STEPS)]
        states = {}
        with deterministic():
            for label, m in (("no group", None), ("NCCL world 1", mesh)):
                tr = dp_trainer(dev, seed, m)
                for b in batches:
                    tr.train_step(b)
                torch.cuda.synchronize()
                states[label] = tr.state_dict()
        for part in ("E", "G", "D", "opt_eg", "opt_d", "step", "rng"):
            same_tree(states["NCCL world 1"][part], states["no group"][part], f"D2 {part}")
        print(f"D2: an NCCL group of one ({backend}) and no group: every parameter, buffer, Adam moment "
              f"and the generator bit for bit after {D_STEPS} steps")
        grouped = dp_trainer(dev, seed, mesh)
        grouped.train_step(batches[0])
        torch.cuda.synchronize()
        with record_collectives() as log:
            grouped.train_step(batches[0])  # step 1: no E+G update at d = 3
            grouped.train_step(batches[1])
            grouped.train_step(batches[2])  # step 3: E+G and two D updates
            torch.cuda.synchronize()
        print(f"D2: collectives of steps 1-3 by kind: {json.dumps(log)}")
        check(set(log) == {"all_reduce"}, f"D2: a collective other than the all-reduce: {sorted(log)}")
        rates = {}
        for label, m in (("no group", None), ("NCCL world 1", mesh), ("NCCL world 1", mesh), ("no group", None)):
            tr = dp_trainer(dev, seed, m)
            tr.train_step(batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(D_RATE_STEPS):
                tr.train_step(batches[i % D_STEPS])
            torch.cuda.synchronize()
            rates.setdefault(label, []).append(D_RATE_STEPS / (time.perf_counter() - t0))
        print(f"D2: steps/s, no group {rates['no group']}, NCCL world 1 {rates['NCCL world 1']} ({card})")
        profiles = {}
        for label, m in (("no group", None), ("NCCL world 1", mesh)):
            tr = dp_trainer(dev, seed, m)
            tr.train_step(batches[0])
            torch.cuda.synchronize()
            profiles[label] = profile_call(
                lambda: [tr.train_step(batches[i % D_STEPS]) for i in range(D_PROFILE_STEPS)],
                D_PROFILE_STEPS, f"D2 {label}, {D_PROFILE_STEPS} steps after one", dev, extra=collective_split)
            print(f"D2 profile, {label}: {json.dumps(profiles[label])} ({card})")
        return {"data_parallel": "D2", "backend": backend, "world": 1, "steps_compared": D_STEPS,
                "bit_for_bit": True, "collectives_steps_1_3": log, "steps_per_s": rates,
                "rate_steps": D_RATE_STEPS, "batch": 64, "profiles": profiles, "card": card}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def parallel_phases(args, dev, card, peak, tmp: str):
    """Phases D1-D3: data parallelism on the main path's trainer. Returns
    (lines, the ``fused_encoder:dp_rank`` row)."""
    import torch.distributed as dist

    from imagecfgen_torch.cli.common import load_bigan
    from imagecfgen_torch.models.bigan import mnist_bigan_config
    from imagecfgen_torch.ops.fused_encoder import fused_encoder_forward
    from imagecfgen_torch.parallel.launch import record_collectives, run_ranks
    from imagecfgen_torch.parallel.mesh import init_from_env

    lines, seed = [], args.seed + 90
    cfg = mnist_bigan_config()
    rng = np.random.default_rng(seed)
    x, attrs = gan_data(cfg, 64 * D_STEPS, rng, torch.device("cpu"))
    # --------------------------------- D1. two gloo ranks on the one card
    ref = dp_trainer(dev, seed)
    steps = []
    for i in range(D_STEPS):
        z, masks = ref.draw_noise(64)
        rows = slice(64 * i, 64 * (i + 1))
        steps.append(({"image": x[rows].numpy(), "attrs": {k: v[rows].numpy() for k, v in attrs.items()}},
                      z.cpu().numpy(), [[k.cpu().numpy() for k in f] for f in masks]))
    t0 = time.perf_counter()
    rank_device = "cuda:0" if dev.type == "cuda" else "cpu"  # the CPU: a rehearsal
    ranks = run_ranks(d1_rank, 2, steps, seed, rank_device, workdir=tmp, timeout=300)
    d1_secs = time.perf_counter() - t0
    ref = dp_trainer(torch.device(rank_device), seed)
    fused_encoder_forward.launches = 0
    ref_metrics = dp_steps(ref, steps, torch.device(rank_device))
    ref_launches = fused_encoder_forward.launches
    state = ref.state_dict()
    ref_params = {f"{p}.{n}": v.cpu().numpy() for p in "EGD" for n, v in state[p].items()}
    for name in ranks[0]["params"]:
        check(np.array_equal(ranks[0]["params"][name], ranks[1]["params"][name]), f"D1: the ranks' {name} differ")
    check(all(np.array_equal(r["rng"], state["rng"].cpu().numpy()) for r in ranks), "D1: a rank's generator drifted")
    for i, want in enumerate(ref_metrics):
        for k, v in want.items():
            got = np.mean([r["metrics"][i][k] for r in ranks])
            check(abs(got - v) <= 2e-4 + 2e-3 * abs(v), f"D1: step {i} {k}: 2 ranks {got}, 1 rank {v}")
    # the CPU tests' rule: Adam's update is lr g / |g|, so a gradient that is
    # rounding noise may take either sign; every parameter within 2 lr an
    # update, all but one element in a thousand within rtol 2e-3 / atol 2e-4
    d1 = dp_counts("D1 2 gloo ranks against 1 process", ranks[0]["params"], ref_params)
    check(d1["max_abs_diff"] <= 2 * ref.tcfg.learning_rate * ref.opt_d.count
          and d1["elements_off"] <= d1["elements"] / 1000, "D1: the ranks disagree with one process")
    launches = [r["launches"] for r in ranks]
    print(f"D1: fused_encoder launched {launches} times on the ranks in {D_STEPS} steps "
          f"(1 process: {ref_launches}); ranks on {rank_device}")
    if rank_device != "cpu":
        check(launches == [D_STEPS, D_STEPS], "D1: a rank did not launch fused_encoder once a step")
    line = trunk_at_training_shape("MNIST trunk at a rank's shard of 2", ref.model.encoder,
                                   x[:32].to(dev), {k: v[:32].to(dev) for k, v in attrs.items()},
                                   cfg.enc_plan, seed, dev, peak, card, key="kernel_at_rank_shape")
    check(line["shape"] == [32, 28, 28, 5], f"D1: the shard's trunk input is {line['shape']}")
    lines += [line, {"data_parallel": "D1", "ranks": 2, "backend": "gloo", "device": rank_device,
                     "steps": D_STEPS, "seconds": d1_secs, "fused_encoder_launches": launches, **d1,
                     "card": card}]
    dp_row = trunk_row("fused_encoder:dp_rank", line, sum(launches), peak, card, ranks=2, train_steps=D_STEPS)

    lines.append(d2_phase(dev, seed, x, attrs, card))

    # ------------------------------------- D3. the CLI under torchrun
    data = os.path.join(tmp, "data")  # C1's Morpho-MNIST-layout rows
    here = os.path.dirname(os.path.abspath(__file__))
    driver = os.path.join(tmp, "d3_train_mnist_image_scm.py")
    with open(driver, "w") as f:
        f.write(D3_DRIVER)
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(PYTHONPATH=os.pathsep.join(filter(None, (here, env.get("PYTHONPATH")))),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    cli = [driver, "--data-dir", data, "--steps", "1", "--save-images-every", "0", "--seed", str(seed),
           "--device", dev.type]
    runs = {"plain": [sys.executable, *cli],
            "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
                         *cli]}
    outs, secs = {}, {}
    for label, cmd in runs.items():
        outs[label] = os.path.join(tmp, "d3", label)
        t0 = time.perf_counter()
        done = subprocess.run([*cmd, "--output-path", outs[label]], env=env, cwd=here, capture_output=True,
                              text=True, timeout=600)
        secs[label] = time.perf_counter() - t0
        print(f"D3 {label}: exit {done.returncode} in {secs[label]:.1f} s; {done.stdout.strip()[-300:]}")
        check(done.returncode == 0, f"D3 {label} failed: {done.stderr[-2000:]}")
        secs[f"{label}_steps_per_s"] = steps_per_s(done.stdout)
    want, _, want_meta = load_bigan(os.path.join(outs["plain"], "mnist-bigan.tar"), "cpu")
    got, _, got_meta = load_bigan(os.path.join(outs["torchrun"], "mnist-bigan.tar"), "cpu")
    check(got["step"] == want["step"] == CLI_TRAIN // 64 and got_meta["epoch"] == want_meta["epoch"] == 1,
          f"D3: steps {got['step']} and {want['step']}")
    d3 = dp_counts("D3 torchrun against a plain run", {f"{p}.{n}": v.numpy() for p in "EGD" for n, v in got[p].items()},
                   {f"{p}.{n}": v.numpy() for p in "EGD" for n, v in want[p].items()})
    same_tree(got, want, "D3 the checkpoint")
    print("D3: torchrun's checkpoint is the plain run's bit for bit (E, G, D, both Adam states, the step, "
          "the generator)")
    lines.append({"data_parallel": "D3", "cli": "train_mnist_image_scm", "launcher": "torchrun --standalone "
                  "--nproc-per-node 1", "steps": want["step"], "bit_for_bit": True, "seconds": secs, **d3,
                  "card": card})
    return lines, dp_row


def quality_phase(args, dev, card, tmp: str):
    """Phase Q: the quality battery (``tools/quality_battery.py``) on M1's data (``tmp/morpho``)
    at one epoch. Returns ({kernel: {stage: launches}}, lines)."""
    import io

    from imagecfgen_torch.tools import quality_battery as qb

    mdata = os.path.join(tmp, "morpho")
    argv = [mdata, "--epochs", 1, "--train-glyphs", M_TRAIN, "--test-glyphs", M_TEST, "--finetune-steps", 1,
            "--scm-steps", 1, "--clf-epochs", 1, "--vae-steps", 1, "--device", dev.type]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = qb.main([str(v) for v in argv])
    secs = time.perf_counter() - t0
    print("".join(f"  quality_battery| {line}\n" for line in out.getvalue().splitlines()
                  if line.startswith(("===", "{"))), end="")
    check(code == 0, f"Q: quality_battery exited with {code}")
    record = qb.load_record(os.path.join(mdata, qb.RECORD))
    names = [s.name for s in qb.stages(qb.parser.parse_args([str(v) for v in argv]))]
    check(list(record["stages"]) == names, f"Q: the record's stages {list(record['stages'])}")
    ran = {k: v for k, v in record["stages"].items() if "skipped" not in v}
    check(set(names) - set(ran) == {"train_data", "test_data"}, f"Q: stages not run {set(names) - set(ran)}")
    for name, entry in ran.items():
        check({"cli", "argv", "seconds", "launches", "printed"} <= set(entry), f"Q: {name}'s entry {sorted(entry)}")
    missing = [k for k, v in record["scores"].items() if v is None]
    check(not missing and set(record["scores"]) >= set(qb.JAX_HARD), f"Q: scores missing {missing}")
    check(record["card"] == card, f"Q: the record's card {record['card']!r}")
    launches = {k: {f"Q {n}": e["launches"][k] for n, e in ran.items()} for k in ("fused_encoder", "fused_dense")}
    steps = ran["bigan"]["printed"]["epochs"][0]
    check(launches["fused_encoder"]["Q bigan"] == M_TRAIN // 64,
          f"Q: {launches['fused_encoder']['Q bigan']} fused_encoder launches in the BiGAN's {M_TRAIN // 64} steps")
    for name in qb.ENCODING_SCORES:
        check(launches["fused_encoder"][f"Q {name}"] > 0, f"Q: {name} did not reach the fused_encoder kernel")
    result = qb.compare(record)
    line = {"quality": "Q: quality_battery on M1's data, 1 epoch", "seconds": secs,
            "stage_seconds": {n: e["seconds"] for n, e in ran.items()}, "launches": launches,
            "bigan_epoch": steps, "scores": record["scores"], "bands_missed_at_one_epoch": len(result["missed"]),
            "card": card}
    print(f"Q quality_battery: {secs:.2f} s; fused_encoder launches "
          f"{ {n: launches['fused_encoder'][f'Q {n}'] for n in ('bigan', *qb.ENCODING_SCORES)} }")
    return launches, [line]


# QA's budgets, cut in depth (the digit classifier's val_acc is printed every fifth epoch), on AU's
# stand-in cut to its first QA_SUBJECTS subjects: 200 clips, 150 to train (one step an epoch at batch
# 128), 50 to validate (the whole stand-in read 37.8-42.7 s of QA, 10 subjects 28.4 s, over the 20 s)
QA_SCM_STEPS, QA_CLF_EPOCHS, QA_GEN_N, QA_SUBJECTS = 20, 5, 128, 5


def quality_audio_phase(args, dev, card, tmp: str):
    """Phase QA: the AudioMNIST battery (``tools/audio_battery.py``) through its ``main`` on AU's
    stand-in cut to ``QA_SUBJECTS`` subjects, in bf16 at one epoch, every stage and the identity
    stages at their smallest. Returns ({kernel: {stage: launches}}, lines)."""
    import io

    from imagecfgen_torch.tools import audio_battery as ab
    from imagecfgen_torch.tools import quality_battery as qb

    out_dir = os.path.join(tmp, "audio-battery")
    argv = [str(v) for v in (out_dir, "--dtype", "bfloat16", "--init-std", 0.01, "--epochs", 1, "--vae-epochs", 1,
                             "--scm-steps", QA_SCM_STEPS, "--clf-epochs", QA_CLF_EPOCHS, "--subject-clf-epochs", 1,
                             "--gen-n", QA_GEN_N, "--device", dev.type)]
    out = io.StringIO()
    t0 = time.perf_counter()
    with shared_stand_in(QA_SUBJECTS), contextlib.redirect_stdout(out):
        code = ab.main(argv)
    secs = time.perf_counter() - t0
    print("".join(f"  audio_battery| {line}\n" for line in out.getvalue().splitlines()
                  if line.startswith(("===", "{"))), end="")
    check(code == 0, f"QA: audio_battery exited with {code}")
    record = qb.load_record(os.path.join(out_dir, qb.RECORD))
    names = [s.name for s in ab.stages(ab.parser.parse_args(argv))]
    check(list(record["stages"]) == names and len(names) == 11, f"QA: the record's stages {list(record['stages'])}")
    for name, entry in record["stages"].items():
        check({"cli", "argv", "seconds", "launches", "printed", "run"} <= set(entry) and "skipped" not in entry,
              f"QA: {name}'s entry {sorted(entry)}")
    scores = record["scores"]
    missing = [k for k, v in scores.items() if v is None and k != "windows"]
    check(not missing, f"QA: scores missing {missing}")
    check(set(scores["subject_identity"]) == {"bigan", "vae", "bigan_int"}
          and set(scores["mean_ratio"]) == {"bigan", "vae", "bigan_int", "vae_int"}, "QA: the identity scores")
    check(record["card"] == card and record["dtype"] == "bfloat16", f"QA: the record's card {record['card']!r}")
    epochs = record["stages"]["bigan"]["printed"]["epochs"]
    check(len(epochs) == 1 and all(np.isfinite(epochs[0][1:3])), f"QA: the BiGAN's epoch {epochs}")
    with open(os.path.join(out_dir, "bigan.log")) as f:
        steps = int(re.findall(r"step (\d+)\)", f.read())[-1])
    launches = {k: {f"QA {n}": e["launches"][k] for n, e in record["stages"].items()}
                for k in ("fused_encoder", "fused_dense")}
    check(launches["fused_encoder"]["QA bigan"] == steps,
          f"QA: {launches['fused_encoder']['QA bigan']} fused_encoder launches in the bf16 BiGAN's {steps} steps")
    for name in ab.ENCODING_STAGES:
        check(launches["fused_encoder"][f"QA {name}"] > 0, f"QA: {name} did not reach the fused_encoder kernel")
    for name in ab.CLASSIFYING_STAGES:
        check(launches["fused_dense"][f"QA {name}"] > 0, f"QA: {name} did not reach the fused_dense kernel")
    result = ab.compare(record)
    line = {"quality": f"QA: audio_battery on AU's stand-in cut to {QA_SUBJECTS} subjects, bf16, 1 epoch",
            "seconds": secs,
            "stage_seconds": {n: e["seconds"] for n, e in record["stages"].items()}, "launches": launches,
            "bigan_epoch": epochs[0], "bigan_steps": steps, "scores": scores,
            "bands_missed_at_one_epoch": len(result["missed"]), "card": card}
    print(f"QA audio_battery: {secs:.2f} s; launches fused_encoder "
          f"{ {n: launches['fused_encoder'][f'QA {n}'] for n in ab.ENCODING_STAGES} }, fused_dense "
          f"{ {n: launches['fused_dense'][f'QA {n}'] for n in ab.CLASSIFYING_STAGES} }")
    return launches, [line]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--audio-batch", type=int, default=128,
                    help="batch of the AudioMNIST scoring path")
    ap.add_argument("--mc-rounds", type=int, default=4,
                    help="rounds of the AudioMNIST CF-effectiveness score")
    ap.add_argument("--profile", action="store_true",
                    help="also time each trunk layer alone beside its library conv, and write "
                         "torch.profiler tables of one MNIST counterfactual batch and one "
                         "AudioMNIST scoring round, in each type, and of five GAN training "
                         f"steps, to {PROFILE_DIR}/")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from imagecfgen_torch.cf.engine import CounterfactualEngine
    from imagecfgen_torch.core.attributes import MNIST_SPEC, AttributeScaler
    from imagecfgen_torch.models.bigan import BiGAN, mnist_bigan_config
    from imagecfgen_torch.ops import _build
    from imagecfgen_torch.ops.fused_encoder import (
        fused_encoder_forward,
        fused_encoder_reference,
        plan_conv_ops,
    )
    from imagecfgen_torch.scm.mnist import MNISTAttributeSCM, build_mnist_graph

    # ---------------------------------------------------------- 1. set-up
    started = time.perf_counter()

    def stamp(phase: str) -> None:
        print(f"[{time.perf_counter() - started:.1f} s] {phase}", flush=True)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    peak = peaks(name)
    t0 = time.perf_counter()
    _build.load_libraries("fused_encoder", "fused_dense")
    print(f"build: fused_encoder, fused_dense in {time.perf_counter() - t0:.2f} s")
    for lib, (secs, log) in _build.BUILD_LOG.items():
        print(f"nvcc {lib}: {secs:.2f} s")
        for line in kernel_lines(log):
            print(line)

    # ---------------------------------------------- 2. kernel against plain
    b = args.batch
    plan = mnist_bigan_config().enc_plan
    conv_ops = plan_conv_ops(plan)
    params = trunk_params(plan, args.seed, dev)
    rng = np.random.default_rng(args.seed + 1)
    feats = torch.from_numpy(rng.normal(0, 1, (b, 28, 28, 5)).astype(np.float32)).to(dev)
    trunk = {dtype: check_trunk("MNIST trunk", params, feats, plan, dtype, splits=(0, 2))
             for dtype in DTYPES}

    # ------------------------------------------------- 3. the main path
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    t = (rng.gamma(10, 1 / 5, b) + 0.5).astype(np.float32)
    i = (191 / (1 + np.exp(-(2 * t - 5))) + 64).astype(np.float32)
    s = (np.pi * rng.normal(0, 0.1, b)).astype(np.float32)
    digit = np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
    raw = {"digit": digit, "thickness": t, "intensity": i, "slant": s}
    scaler = AttributeScaler.fit(MNIST_SPEC, raw)
    graph = build_mnist_graph(i.min(), i.max(), s.min(), s.max())
    scm = MNISTAttributeSCM(graph, *graph.init(seeded(args.seed), dev))
    xd = torch.from_numpy(x).to(dev)
    attrs = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    do = {"thickness": torch.from_numpy(t + 2).reshape(-1, 1).to(dev)}

    kernels, engine_lines, x_cfs = [], [], {}
    for dtype in DTYPES:
        cfg = mnist_bigan_config(compute_dtype=dtype)
        # the same float32 parameters in both types: one seed
        engine = CounterfactualEngine(BiGAN(cfg, dev, seeded(args.seed + 1)), scm, scaler)
        fused_encoder_forward.launches = 0
        x_cf, cf_attrs = engine.counterfactual(xd, attrs, do)
        recon = engine.reconstruct(xd, attrs)
        torch.cuda.synchronize()
        launches = fused_encoder_forward.launches
        print(f"main path [{TAG[dtype]}]: fused_encoder launched {launches} times")
        check(launches > 0, f"the main path [{TAG[dtype]}] did not reach the fused_encoder kernel")
        x_cfs[dtype] = x_cf

        for img in (x_cf, recon):
            check(img.shape == (b, 28, 28, 1) and img.dtype == F32, f"image {tuple(img.shape)} {img.dtype}")
            check(torch.isfinite(img).all(), "non-finite image")
            check(img.abs().max().item() <= 1.0, "image outside [-1, 1]")
        check(sorted(cf_attrs) == sorted(raw), f"counterfactual attributes {sorted(cf_attrs)}")
        check(all(torch.isfinite(v).all() for v in cf_attrs.values()), "non-finite attribute")
        check(torch.equal(cf_attrs["thickness"], do["thickness"].reshape(-1)), "do(thickness) lost")
        check(torch.equal(cf_attrs["digit"], attrs["digit"]), "digit changed without an intervention")
        check((cf_attrs["intensity"] - attrs["intensity"]).abs().max().item() > 0, "intensity ignored its parent")

        with torch.no_grad():
            enc = engine.bigan.encoder
            scaled = scaler.scale(attrs)
            z = enc(xd, scaled).reshape(b, -1)
            ef = enc.attr_channels(xd, scaled)
            _, epairs = cast_pairs(dict(enc.trunk.named_parameters()), dtype)
            zp = fused_encoder_reference(ef, epairs, conv_ops).float()
        z_err = (z - zp).abs().max().item()
        z_tol = GATE[dtype] * max(1.0, zp.abs().max().item())
        print(f"engine z [{TAG[dtype]}]: max|kernel - plain| = {z_err:.3e} (tol {z_tol:.3e})")
        check(z_err <= z_tol, "the engine's encoder disagrees with the plain trunk")

        # ----------------------------------------------------- 4. times
        err, cast, pairs, tfeats, plain = trunk[dtype]
        with torch.no_grad():
            kernel_ms = time_ms(lambda: fused_encoder_forward(cast, tfeats, plan))
            plain_ms = time_ms(lambda: fused_encoder_reference(tfeats, pairs, conv_ops), reps=3, warmup=1)
            library_ms = time_ms(lambda: library_stack(tfeats, pairs, conv_ops))
            kernel_device_ms = device_ms(lambda: fused_encoder_forward(cast, tfeats, plan), reps=10)
            library_device_ms = device_ms(lambda: library_stack(tfeats, pairs, conv_ops), reps=10)
            lib_err = (library_stack(tfeats, pairs, conv_ops).float() - plain.float()).abs().max().item()
            # cuDNN's bf16 stack rounds at other places than the fused trunk: printed, gated in f32 only
            print(f"library stack MNIST trunk [{TAG[dtype]}]: max|library - plain| = {lib_err:.3e}")
            check(dtype != F32 or lib_err <= GATE[F32] * max(1.0, plain.float().abs().max().item()),
                  f"library stack disagrees with the plain version ({lib_err:.3e})")
            cf_ms = time_ms(lambda: engine.counterfactual(xd, attrs, do), reps=10, warmup=2)
            stages_ms = engine_stages_ms(engine, xd, attrs, do)
        flops, nbytes = trunk_cost(tuple(tfeats.shape), pairs, conv_ops, tfeats.element_size())
        kernels.append(row("fused_encoder", dtype, "imagecfgen_torch/csrc/fused_encoder.cu",
                           "imagecfgen_tpu/ops/pallas/fused_encoder.py:127", launches, err,
                           kernel_ms, plain_ms, library_ms, flops, nbytes, peak, card, batch=b,
                           device_ms=kernel_device_ms, library_device_ms=library_device_ms))
        engine_lines.append({
            "engine": "counterfactual do(thickness+2)",
            "compute_dtype": TAG[dtype],
            "batch": b,
            "ms_per_batch": cf_ms,
            "images_per_s": b / (cf_ms / 1e3),
            "stages_ms": stages_ms,
            "card": card,
        })
        if args.profile:
            layer_times("MNIST trunk", pairs, conv_ops, tfeats, dtype)
            profile_path(lambda: engine.counterfactual(xd, attrs, do), f"chip_smoke_profile_{TAG[dtype]}.txt")
        del engine
    diff = (x_cfs[BF16] - x_cfs[F32]).abs().max().item()
    print(f"main path: max|x_cf(bf16) - x_cf(f32)| = {diff:.3e} (printed, not gated)")
    del trunk, x_cfs

    # ------------------------------------------- A2-A4. the AudioMNIST path
    stamp("A2-A4")
    audio_rows, score_lines = audio_phases(args, dev, card, peak)
    kernels += audio_rows

    # ------------------------------------------------ T1-T6. training
    stamp("T1-T6")
    train_launches, train_lines = training_phases(args, dev, card, peak)
    for kernel in kernels:  # training is float32: the bf16 rows have no training launches
        count, steps = train_launches[kernel["name"]] if kernel["dtype"] == "f32" else (None, None)
        check(count is None or count > 0, f"the training path did not reach the {kernel['name']} kernel")
        kernel.update(train_launches=count, train_steps=steps)

    # ------- C1-C4, M1-M5, X1-X3. the MNIST CLIs, the comparison, the explainers
    with tempfile.TemporaryDirectory() as tmp:
        synthesis = start_synthesis(args, tmp)
        try:
            stamp("R")
            r_launches, r_lines = reference_phase(args, dev, card, tmp)
            stamp("C1-C4")
            cli_launches, cli_lines = cli_phases(args, dev, card, tmp)
        except BaseException:
            synthesis.kill()
            raise
        stamp("M1-M5")
        m_launches, m_lines = morpho_phases(args, dev, card, peak, tmp, synthesis)
        stamp("X1-X3")
        x_launches, x_lines, b1_row = explainer_phases(args, dev, card, peak, tmp)
        stamp("F1")
        f_launches, f_lines = figure_phases(args, dev, card, tmp)
        with shared_stand_in():
            stamp("AU1-AU5")
            au_launches, au_lines, au_rows = audio_cli_phases(args, dev, card, peak, tmp)
            stamp("AV1-AV2, G1")
            av_launches, av_lines, vae_row = audio_vae_gan_phases(args, dev, card, peak, tmp)
            stamp("P1")
            p_lines = precision_phase(args, dev, card, os.path.join(tmp, "audio"))
        stamp("W1-W2, S1")
        w_launches, w_lines, marine_rows = marine_phases(args, dev, card, peak, tmp)
        stamp("D1-D3")
        d_lines, dp_row = parallel_phases(args, dev, card, peak, tmp)
        stamp("Q")
        q_launches, q_lines = quality_phase(args, dev, card, tmp)
        stamp("QA")
        qa_launches, qa_lines = quality_audio_phase(args, dev, card, tmp)
        stamp("the end")
    for more in (r_launches, m_launches, x_launches, f_launches, q_launches):
        for k, runs in more.items():
            cli_launches[k].update(runs)
    cli_lines += (r_lines + m_lines + x_lines + au_lines + f_lines + av_lines + p_lines + w_lines + d_lines + q_lines
                  + qa_lines)
    for kernel in kernels:  # the MNIST CLIs run float32 MNIST models: the f32 MNIST rows
        kernel["cli_launches"] = (cli_launches[kernel["name"]] if kernel["name"] in cli_launches
                                  and kernel["dtype"] == "f32" else None)
        if kernel["name"] == "fused_encoder:audio_mnist":  # the float32 audio CLIs' trunk at any batch
            kernel["cli_launches"] = {r: n for r, n in au_launches["fused_encoder"].items()
                                      if "bf16" not in r and "bfloat16" not in r}
        elif kernel["name"] == "fused_dense":  # the audio classifier's head in every audio CLI
            kernel["cli_launches"] = {**kernel["cli_launches"], **au_launches["fused_dense"],
                                      **av_launches["fused_dense"], **qa_launches["fused_dense"]}
    check(sum(cli_launches["fused_encoder"].values()) > 0, "the CLIs did not reach the fused_encoder kernel")
    check(b1_row["launches"] > 0 and all(n > 0 for n in b1_row["cli_launches"].values()),
          "an explainer CLI did not reach the fused_encoder kernel")
    for k in ("fused_encoder", "fused_dense"):
        check(sum(au_launches[k].values()) > 0, f"the audio CLIs did not reach the {k} kernel")
    check(all(r["launches"] > 0 for r in (*au_rows, vae_row)), "an audio kernel row's path did not reach its kernel")
    for k in ("fused_encoder", "fused_dense"):
        check(sum(w_launches[k].values()) > 0, f"the marine CLIs did not reach the {k} kernel")
    check(all(r["launches"] > 0 for r in marine_rows), "a marine kernel row's path did not reach its kernel")
    kernels += [b1_row, *au_rows, vae_row, *marine_rows]
    check(dp_row["launches"] > 0, "the data-parallel path did not reach the fused_encoder kernel")
    kernels.append(dp_row)
    for line in engine_lines + score_lines + train_lines + cli_lines:
        print(json.dumps(line))
    print(json.dumps({"kernels": kernels}))

    # ---------------------------------------------------------- 5. the end
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
