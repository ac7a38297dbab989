#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root. Phases, each of which must pass:

1. build the Hopper kernels from the ``.cu`` sources in
   ``forwardtacotron_torch/ops/hopper`` with nvcc (one process per source,
   all started together);
2. float32: hold each slice-1 kernel against its plain-PyTorch twin on the
   card at the shapes the float32 path gives it, and time both (CUDA
   events, median of 20 runs after warm-up); Griffin-Lim also at R = n_fft
   / hop = 16 (2048 / 128), with 32 iterations of kernel and twin to the
   same spectral convergence, the profiler showing that an iteration is
   its two launches alone, and the time of copies of ``griffin_lim.cu``
   built to skip its A staging and/or its products (what each part adds);
3. the float32 path at full width: ``configs/singlespeaker.yaml`` with
   seeded random weights, 4 sentences of ``sentences.txt`` through
   ``TTSInference.generate_cropped`` and ``DSP.griffinlim``, with every
   kernel's launch count set to 0 just before and read just after, and the
   profiler showing which device kernels ran;
4. check its output: finite values of the expected lengths, and agreement
   with the plain path run on the CPU for one sentence; then where one
   ``DSP.griffinlim`` call of the longest request spends its time (NNLS,
   iterations, istft, the Griffin-Lim kernels' and the other device time,
   host time; ``--griffinlim-split`` runs this alone and stops);
5. bfloat16: hold every kernel of the serving and two-phase paths (and the
   bf16 entries of the slice-1 kernels) against its twin in bf16 on the
   card, at one serving call's shapes and at one request's (the length
   regulator's short request call also by its device time, as in phase
   12; ``pool_mask``'s in phase 9 the same), and time it
   beside its twin and a yardstick the port never calls: for the
   recurrences cuDNN's bidirectional ``nn.LSTM`` / ``nn.GRU``, for the
   highway stack the residual add and the ``nn.Linear`` chain, for the
   CBHG front the bank as one cuDNN K-tap convolution, ``pool_mask`` and
   cuDNN's proj1 convolution, for the multi-GRU (``gru_xp``, which takes
   the input projection precomputed) cuDNN's bi-GRU from an 8-wide input;
   the launch plans of the front, highway and step-major recurrent kernels
   are printed;
6. the bfloat16 serving path as ``bench.py`` shapes it: its 8 sentences
   tiled to batch 4096, 3 frames per token, ``max_len`` 256, routed to
   16-frame buckets, through ``TTSInference.generate_fused``: launch counts
   per call, the profiler, audio-s/s over trials, the device idle share and
   the roofline of the median rate (``utils/flops.py``: achieved TFLOP/s,
   mfu and hbm_util against the bf16 peak, arithmetic intensity, bound);
7. the bfloat16 two-phase path: the 4 requests through ``generate_cropped``
   and as one batch through ``generate_routed``, with launch counts;
8. a bfloat16 reference: one small batch through ``generate_fused`` on the
   card and on the CPU plain path;
9. the CBHG variants: ``highway_stack``, ``pool_proj1`` and ``pool_mask``
   against their twins (bf16 at one serving call's shapes, float32 at one
   request's, ``highway_stack`` also bf16 at one request's), timed beside
   the twin and the plain route the default path takes (with the bf16
   ``pool_proj1`` launch plans); ``CBHG._highways_fused`` against the layer chain; bf16
   ``generate_fused`` at the serving shape with the "pool_proj" and "pool"
   routes set on the model's CBHGs (exact launches per call, mel against
   the default route's, audio-s/s in turns with the default); the longest
   float32 request with each route against the CPU plain path; the K=16
   prenet front through ``cbhg_front.cu`` beside the plain and the
   ``pool_proj1`` routes;
10. the fused HiFi-GAN MRF level (``mrf.cu``) against its twin at each of
    v1's levels (C=256 and 128 in clusters of CTAs, 64, 32) and at levels
    of 10 kernel sizes and of 9 dilations: float32 at one
    request, bf16 at bench.py's vocoder shape (batch 128 x 256 frames), with
    each level's launch plan, timed beside the twin and the same level as
    18 cuDNN convolutions; then the phase-stacked tail's level
    (``ups_mrf``: leaky, upsample and MRF in one launch of ``mrf.cu``)
    against its twin at the same levels and shapes, timed beside the twin,
    beside the level as the fused-level route computes it (cuDNN's
    transposed convolution, bias, leaky, ``mrf.cu``) and beside the level
    per convolution; each level's weights are prepared (padded and packed
    into ring images, as the generator keeps them) once, and that work is
    timed on its own; then the cycle spans of both bf16 entries at those
    levels (a copy of ``mrf.cu`` built with ``-DMRF_CYCLES``: where one
    thread of one CTA spends its cycles);
11. the vocoder path: a seeded HiFi-GAN v1 checkpoint in jik876 format
    loaded by ``Vocoder.from_checkpoint`` with ``fuse_mrf_max_ch=64``, the
    4 requests through bf16 ``generate_routed(vocoder=)`` (2 ``mrf``
    launches per routed group), again with ``fuse_mrf_max_ch=256`` (every
    level fused: 4 ``mrf`` launches per group) and with
    ``fuse_ups_tail_max_ch=64`` (2 ``ups_mrf`` launches per routed group,
    no ``mrf``), one float32 request on the card against the CPU plain path
    on each route, vocoder audio-s/s at batch 128 x 256 frames in turns on
    the tail, the fused levels 2-3, every level fused and per convolution,
    the profiler and the idle share;
12. training kernels: the length regulator (row 8, ``lr.cu``'s tile
    kernel) at the train shape in float32 and bf16, at the bf16 step's 928
    frames and at one float32 request, exactly against its twin, with
    where a call's time goes (the kernel's device time per launch from the
    profiler, a CUDA graph of 20 calls, the CUDA-event pair around one
    call, the host's time per call), the same for a gather with
    precomputed indices (the yardstick); the bi-LSTM forward that keeps
    its cell states (at the train step's 928 frames), the three trainable
    GRUs' forward and the GRU / LSTM backward sweeps
    (incoming gradient at unit scale, each gate block held to its twin's
    in relative L2), each against its twin at full-width training shapes
    (batch 32, 160 tokens, 1024 frames), timed beside the twin and cuDNN's
    bidirectional ``nn.LSTM`` / ``nn.GRU`` (forward, or backward alone),
    with the launch plans (each sweep is two launches of ``rnn_bwd.cu``:
    the gate product, then the reverse walk); with ``--kernel-parts`` also
    the times of copies of ``rnn_bwd.cu`` built without the sweep's
    barrier wait or its products, of ``rnn.cu`` built without the step
    barrier's wait or the products (the LSTM forward here, the serving
    multi-GRU in phase 5) or with the LSTM's c through memory, and of
    ``pool.cu`` built without the pool or the weight copies (phase 9),
    which are wrong and timed only, for what each part adds;
13. the bf16 mixed-precision train step of ``configs/singlespeaker.yaml``
    at full width and batch 32 on 64 synthetic items written to a
    temporary directory: exact launch counts per step, the profiler,
    steps/s, mel frames/s, the idle share and the roofline over steps on
    one repeated batch (whose loss must fall), then
    ``ForwardTrainer.train`` to a checkpoint that ``gen_forward`` loads;
14. the float32 train step (the config's default), with the length
    regulator as its only kernel, and the eval step's kernels;
15. one train step on the card and on the CPU plain path (dropout off):
    loss and global gradient norm, float32 and bf16;
16. the multispeaker models at the full width of
    ``configs/multispeaker.yaml`` with seeded weights and 4 seeded speaker
    embeddings (256 wide, non-negative, unit norm): rows 6-10 at their new
    shapes against their twins (row 6 at 768 inputs at serving and at a
    request, row 7's predictor GRUs at H 128 / 256, row 8 at C 768 and
    512, rows 9-10's LSTM at I 768 and GRUs at H 128 / 256), timed beside
    the twin, cuDNN and the bound; MultiForwardTacotron's 4 requests in
    float32 and bf16 against the CPU path (exact launches, Griffin-Lim)
    and ``gen_forward --speaker`` on a reference-format checkpoint; its
    bf16 serving at bench.py's shape with the speakers cycling (exact
    launches of rows 5-7 a call, audio-s/s, idle share, a slice against
    the CPU); the bf16 train steps of MultiForwardTacotron, FastPitch
    (``configs/singlespeaker.yaml``) and MultiFastPitch at batch 32 (exact
    launches, steps/s, device busy; one float32 and one bf16 step of each
    against the CPU path, the pitch-condition CE and accuracy included);
    MultiFastPitch's float32 requests against the CPU and its bf16
    serving;
17. the Tacotron teacher at the full width of
    ``configs/singlespeaker.yaml``'s ``tacotron`` section with seeded
    weights: rows 1 and 2 at its four entries (the encoder's CBHG, K 16,
    C_in 128, C 128, P 128, at 8 x 180 tokens; the postnet's, K 8, C_in
    80, C 128, P 256, at the GTA export's 8 x 1,000 frames), float32 and
    bf16, against their twins, timed beside the twin, the yardstick and
    the bound; one teacher-forced eval forward at r = 1 on the card (2
    ``pre_highway_stack`` and 2 ``cbhg_front`` launches, nothing else)
    against the CPU plain path, and one of ``configs/multispeaker.yaml``'s
    teacher (4 seeded speakers, 400 frames); ``generate`` for the 4 sentences in
    float32 and bf16 (the same launches); float32 and bf16 train steps at
    r = 5 (batch 32) and r = 1 (batch 8) on synthetic items (no kernel
    launches, steps/s, a falling loss, a finite gradient for every
    parameter) and one step of each dtype
    against the CPU path; ``python -m forwardtacotron_torch.train_tacotron``
    through two short sessions and the extraction after them, a resume
    and ``--force_gta``;
18. the data pipeline on a seeded synthetic corpus at 22,050 Hz (96
    utterances, 32 each at 60, 120 and 180 tokens, ~5.5 frames a token,
    pre-phonemized text): rows 1 and 2 at one extraction batch (B 32,
    float32: the encoder's 180 tokens, the postnet's 1,000 frames) against
    their twins, timed beside the twin, the yardstick and the bound;
    ``python -m forwardtacotron_torch.preprocess`` with 4 workers (every
    mel (80, 1 + samples // hop), 4 within 1e-4 relative L2 of the CPU
    DSP, the splits and pickles; the VoiceEncoder with seeded weights in
    the published layout through ``$RESEMBLYZER_WEIGHTS``, 8 wavs card vs
    CPU within 1e-4); ``python -m forwardtacotron_torch.train_tacotron``
    training a few steps at r = 1 and then extracting (every ``alg/``
    sums to its mel, one finite pitch and energy a token, nonzero pitch
    z-normalised, ``duration_stats.pkl`` loads, ``get_forward_dataloaders``
    yields a batch); in this process, the extraction's launches (exactly 2
    ``pre_highway_stack`` and 2 ``cbhg_front`` a batch) and time, the
    postnet's share of a batch, one batch's attention card vs CPU within
    1e-3 (PreNet dropout off), the native DP (it must load) against the
    numpy DP on every item and Dijkstra on 4, the DP's time (native, a
    pool of 4, serial), the targets; then ``--force_align`` and
    ``--extract_pitch``, each rewriting its files;
19. data parallelism, on every card there is: ``TTSInference(mesh=)``
    over each card (the one card listed twice on a one-card machine, so
    that the pad, the split, each share's launches and the crop all run)
    with bf16 ``generate_fused`` at the serving batch and at an odd one
    (4093, which pads) and float32 ``generate`` on the 4 requests, each
    against one replica on the card (exact launches: every replica runs
    one replica's kernels; the launches of rows 4, 6 and 7 per card;
    mel_len exact, mel_post within 3e-2 / 1e-4 of the scale); then a world
    of ranks (NCCL with one rank a card; on one card, two gloo ranks
    sharing it) through ``tests/torch_parallel_worker.py``: 3 bf16
    ``ForwardTrainer`` steps and one float32 ``TacoTrainer`` step (r = 5)
    at TRAIN_BATCH rows a rank, each rank at its own padded shape, dropout
    off, against a world of 1 on NCCL taking them on the concatenated
    global batch (loss and gradient norm within the train steps'
    card-vs-CPU tolerance, every rank's parameters equal, rows 9-10's
    launches in each rank, each rank's step wall time); a failed or hung
    rank (300 s) fails the phase.

20. the remaining utils and entry points at full width: (a)
    ``python -m forwardtacotron_torch.train_forward --force_gta`` from a
    port checkpoint on 20 items of phase 13's kind (one (80, mel_len)
    file each), ``export_gta`` in this process (exactly 2
    ``pre_highway_stack``, 1 ``cbhg_front`` and 1 ``lr`` a batch, the
    time a batch), the validation batch's files against the CPU plain
    path; (b) ForwardTacotron, MultiForwardTacotron and the teacher written
    as the JAX package's native ``.ckpt`` with an Adam state and read
    back bit-equal, ``gen_forward`` from the ``.ckpt`` giving the ``.pt``'s
    mel, one bf16 train step resumed from a lone ``latest_model.ckpt``
    bit-equal to one from ``latest_model.pt``; (c) the ``plot_outputs``
    of ForwardTrainer, MultiForwardTrainer (configs/multispeaker.yaml, 3
    speakers) and TacoTrainer (r = 5) on the card against the CPU (mels
    within 1e-3, Griffin-Lim's spectral convergence within 1%, exact
    launches, the writer taken), then 2 bf16 steps with a plot after each
    bit-equal to 2 without; (d) ``utils.profiler.trace`` around one
    float32 request in an ``annotate`` span (the trace names the span and
    rows 1, 2 and 8) and ``device_memory_stats``; (e) the notebook
    ``Synthesizer`` on the ``.ckpt`` against the CPU, with Griffin-Lim and
    with phase 11's seeded HiFi-GAN v1 checkpoint.

``--multispeaker`` runs only the build and phase 16, ``--data-parallel``
only the build and phase 19, ``--entry-points`` only the build and phase
20, ``--teacher`` only
the build and phase 17 (there with the device busy and idle share of
every train step, which the default run does not profile), ``--pipeline``
only the build and phase 18,
``--griffinlim-split`` runs only phase 4's split, ``--lstm-times`` only
the LSTM entries' times (``LSTM_TIMES_SHAPES``, with ``--kernel-parts``
their parts) and ``--lr-mrf-times`` only row 8's phase (with a fill of
its output's bytes and the kernel's device time at several tiles of
frames) and the times of HiFi-GAN v1's MRF levels 2-3 (bf16, batch 128 x 256 frames, ``mrf`` and
``ups_mrf``); ``--mrf-gaps`` only builds ``mrf.cu`` and runs rows
14-15 at the shapes past their first limits (``mrf_gap_shapes_phase``:
the wide form past 256 channels, 33 kernel sizes, tail levels whose input
tile loads in chunks of input channels, each against its twin, with its
plan and bound); ``--host-times`` runs only the build and the
single-speaker f32 and bf16 requests and bf16 train step on the host
clock (``host_times_phase``); each stops after it and also runs copied
into an older checkout, to time two trees in one call.

Printed, in order: the card's name and power limit (nvidia-smi), the
card's peak figures (``chip spec: h100 for <device>``; any card but an H100
SXM fails the run), the build, one line per kernel comparison, the paths'
stages (with the ``serving roofline`` and ``bf16 train step roofline``
lines), then a JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.
Any failure exits non-zero without the last line, as does a machine without
a CUDA device or a directory without the repository. The profiler's kernel
tables go to ``chiprun_out/chip_smoke_profile.txt`` (float32 path),
``chiprun_out/chip_smoke_serving_profile.txt`` (serving path),
``chiprun_out/chip_smoke_vocoder_profile.txt`` (bf16 vocoder call, fused
levels 2-3), ``chiprun_out/chip_smoke_vocoder_all_profile.txt`` (every
level fused), ``chiprun_out/chip_smoke_vocoder_tail_profile.txt`` (the
tail) and ``chiprun_out/chip_smoke_train_profile.txt`` (bf16 train
step); phase 16 writes ``chip_smoke_multi_serving_profile.txt``,
``chip_smoke_multi_fast_pitch_profile.txt`` and
``chip_smoke_<family>_train_profile.txt`` beside them, phase 17
``chip_smoke_teacher_<precision>_r<r>_profile.txt``.
"""

import collections
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
if not (REPO / 'forwardtacotron_torch').is_dir():
    sys.exit(f'chip_smoke: FAIL: {REPO} does not hold the repository '
             '(forwardtacotron_torch/ is missing)')

from forwardtacotron_torch.utils.flops import (  # noqa: E402
    CHIP_SPECS, chip_spec, forward_tacotron_activation_bytes,
    forward_tacotron_generate_flops, forward_tacotron_param_bytes,
    forward_tacotron_train_flops, roofline_report)

SEED = 0
# every token lasts this many frames: the longest of the 4 requests is
# ~10 s of audio, and the postnet sees ~900 frames (above the TPU kernel's
# 512-frame block)
FRAMES_PER_TOKEN = 9
SENTENCES = 4
REPS = 20
# H100 SXM peaks (NVIDIA data sheet, utils/flops.py): float32 outside the
# tensor cores, device memory bandwidth; the kernels here are float32 FMA
# kernels
H100 = CHIP_SPECS['h100']
PEAK_F32_FLOPS = H100.flops_f32
PEAK_BYTES = H100.hbm_gbps
# kernel vs twin, float32 with different summation orders: max abs error
# over max(1, max |twin|) (a relative error at the output's scale)
KERNEL_TOL = 1e-4
# 32 Griffin-Lim iterations drift apart chaotically from float32 rounding;
# the kernel's spectral convergence must be within 1% of the twin's
SC_REL_TOL = 0.01
# full model on card vs CPU plain path, mel max abs error
E2E_MEL_ATOL = 1e-3
# TF32 tensor-core peak (dense), for the 3xTF32 bound of griffin_lim.cu
PEAK_TF32_FLOPS = H100.flops_tf32
# bf16 tensor-core peak (dense), for the bounds of the bf16 kernels
PEAK_BF16_FLOPS = H100.flops_bf16
# bf16 kernel vs twin: both round at the same points, but a float32 sum in
# another order can land on the neighbouring bf16 value (2^-8 relative) and
# a recurrence carries it on: max abs error over max(1, max |twin|); inside
# the JAX package's bf16 kernel tolerance of 5e-2
BF16_TOL = 3e-2
# the input width of cuDNN's bi-GRU beside gru_xp (which takes the input
# projection precomputed): no single call computes gru_from_xp, so cuDNN
# runs the recurrence from a narrow input (8, a whole 16-byte bf16 row)
CUDNN_XP_WIDTH = 8
# bf16 full model on the card vs the CPU plain path (both bf16, other sum
# orders in every kernel): mel max abs error over max(1, max |mel|)
E2E_BF16_TOL = 5e-2
# the trainable recurrences vs their twins, forward and backward sweeps, with
# the incoming gradient at unit scale: the relative L2 error of each gate
# block (||kernel - twin|| / ||twin|| over its columns). Rounding every
# dgate to bf16 moves the twin by 1.7e-3 of that against a float32 sweep; a
# sweep that drops the carried dgates @ Wh^T term, uses c_t for c_{t-1}, or
# leaves bh out of the GRU's dr is off by 0.19 or more
# (tests/test_torch_rnn_train.py::test_sweep_check_fails_faulty_sweeps)
SWEEP_TOL = 1e-2
# the serving path as bench.py shapes it (bench.py:20-30, 44-99)
BENCH_SENTENCES = [
    'ðə kwɪk bɹaʊn fɑks dʒʌmps oʊvɚ ðə leɪzi dɔɡ ænd ɹʌnz əweɪ ɪntʊ ðə fɔɹɪst.',
    'ɪn ə taʊn wɛɹ ðə ɹɪvɚ bɛndz, ðə laɪts ʃaɪn leɪt ɪntʊ ðə naɪt wɪθ ə wɔɹm gloʊ.',
    'sɪnθəsɪs ɑn ə tɛnsɚ pɹoʊsɛsɪŋ junɪt ɪz fæst wɛn ðə kɑmpaɪlɚ kæn taɪl ɛvɹi mætmʌl.',
    'ʃi soʊld siʃɛlz baɪ ðə siʃɔɹ waɪl ðə weɪvz keɪm ɪn wʌn æftɚ ənʌðɚ wɪðaʊt ɛnd.',
    'ə lɔŋ sɛntəns wɪθ mɛni fəʊnimz wɪl tɛst ðə lɛŋθ ɹɛgjəleɪtɚ ænd ðə dikoʊdɚ tugɛðɚ.',
    'tumɔɹoʊ mɔɹnɪŋ ðə tɹeɪn livz æt sɛvən θɝti fɹʌm plætfɔɹm naɪn ænd ə hæf.',
    'ɛvɹi gʊd bɔɪ dʌz faɪn ænd ɛvɹi gʊd gɝl dʌz bɛtɚ ðæn ɛvɚ bɪfɔɹ.',
    'ðɪs ɪz ðə faɪnəl sɛntəns ʌv ðə bɛntʃmɑɹk sɛt, ʃɔɹt ænd tu ðə pɔɪnt.',
]
SERVING_BATCH = 4096
# a first serving call longer than this drops the batch to 1024
SERVING_CALL_LIMIT_S = 10.0
SERVING_MAX_LEN = 256
SERVING_BUCKET = 16
# every sentence, padding tokens included, fits the 256-frame budget
SERVING_FRAMES_PER_TOKEN = 3
SERVING_ITERS, SERVING_TRIALS = 4, 3


def fail(msg: str) -> None:
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median over ``reps`` runs, each timed with a pair of CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


# profiled runs of a short call: after a run of several phases the profiler
# has recorded none, or only some, of a run's launches (on an H100, in
# runs of chip_smoke.py), so a run is repeated until it records each one
PROFILE_ATTEMPTS = 4


def profiled_ms(torch, fn, pattern: str, reps: int = REPS):
    """The device time per launch of the kernels whose name matches
    ``pattern`` (a regular expression), from the profiler's records of
    ``reps`` calls of ``fn`` (each one launch of them): the median of
    their launches' device times, and the launches recorded. The first of
    PROFILE_ATTEMPTS profiled runs that records all ``reps`` launches,
    else the last that records some; (None, 0) where none does."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = (None, 0)
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = per_launch_ms(prof.events(), pattern)
        if got[1] == reps:
            return got
        if got[1]:
            best = got
    return best


def per_launch_ms(events, pattern: str):
    """(the median device ms of a launch, launches) of the device events
    (profiler events: ``name``, ``device_type``, ``time_range`` in us)
    whose name matches ``pattern``; (None, 0) where none does. The median,
    as a launch recorded with a wrong time (one profiled run in a full
    chip_smoke.py run averaged half its kernel's time) moves it little."""
    from torch.autograd import DeviceType
    times = [e.time_range.elapsed_us() for e in events
             if e.device_type == DeviceType.CUDA and re.search(pattern, e.name)]
    if not times:
        return None, 0
    return statistics.median(times) / 1e3, len(times)


def graph_ms(torch, fn, reps: int = REPS):
    """One call's share of a CUDA graph of ``reps`` calls of ``fn``,
    replayed inside one pair of CUDA events (median of 5 replays): the
    launches back to back on the device, with no host work between them.
    None, with the reason logged, where the calls cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        del graph
        return statistics.median(times)
    except RuntimeError as e:
        log(f'    CUDA graph capture failed: {e}')
        torch.cuda.synchronize()
        return None


def device_times(torch, fn, pattern: str, reps: int = REPS) -> dict:
    """Where the time of a short call ``fn`` goes: ``event_ms``, the median
    CUDA-event pair around one call (``time_ms``: the host's dispatch of
    the call while the device waits, then the kernel); ``host_us``, the
    host's time per call over ``reps`` calls issued back to back without a
    synchronize; ``device_ms``, the kernel's own time per launch
    (``profiled_ms`` of the kernels matching ``pattern``); ``graph_ms``,
    one call's share of a CUDA graph of ``reps`` calls (``graph_ms``)."""
    out = {'event_ms': time_ms(torch, fn, reps)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out['host_us'] = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    out['device_ms'], out['launches_profiled'] = profiled_ms(
        torch, fn, pattern, reps)
    out['graph_ms'] = graph_ms(torch, fn, reps)
    return out


def fmt_ms(v) -> str:
    return 'not measured' if v is None else f'{v:.4f} ms'


def log_device_times(label: str, d: dict) -> None:
    log(f'    {label}: device {fmt_ms(d["device_ms"])} per launch '
        f'({d["launches_profiled"]} launches profiled), CUDA graph '
        f'{fmt_ms(d["graph_ms"])} per call, event pair '
        f'{d["event_ms"]:.4f} ms per call, host {d["host_us"]:.1f} us per '
        'call')


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of operations over the peak rate of
    their type (float32 by default) and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes \
        else 'bytes'


def roofline(name, flops, nbytes, seconds):
    """The roofline (utils/flops.py, against the H100's bf16 peak) of
    ``flops`` and ``nbytes`` of work done in ``seconds``, logged as one
    line with the card's name and power limit; returns the report with the
    work and the time beside it."""
    roof = roofline_report(flops, nbytes, seconds, H100, dtype='bf16')
    log(f'{name} roofline: achieved {roof["achieved_tflops"]:.2f} TFLOP/s, '
        f'mfu {roof["mfu"]:.4f}, hbm_util {roof["hbm_util"]:.4f}, '
        f'intensity {roof["arithmetic_intensity"]:.1f} FLOP/B (bf16 ridge '
        f'{roof["ridge_intensity"]:.1f}), bound {roof["bound"]} '
        f'({flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB in '
        f'{seconds * 1e3:.2f} ms); card: {nvidia_smi()}')
    return dict(roof, tflop=flops / 1e12, gb=nbytes / 1e9, ms=seconds * 1e3)


def compare(torch, name, got, want, tol=KERNEL_TOL):
    """Max abs error of kernel vs twin outputs; fails above tol * scale."""
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    ok = all(bool(torch.isfinite(g).all()) for g in got) \
        and err <= tol * scale
    log(f'  {name}: max_abs_err {err:.3e}, scale {scale:.3e}, '
        f'rel {err / scale:.3e} (tol {tol:g}) {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{name}: kernel disagrees with its twin')
    return err


def sweep_error(got, want, blocks: int):
    """(the largest relative L2 error of any gate block, the max abs error)
    of kernel outputs ``got`` against twin outputs ``want``, each split into
    ``blocks`` equal column blocks."""
    rel, err = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = max(err, float((g - w).abs().max()))
        for gk, wk in zip(g.chunk(blocks, -1), w.chunk(blocks, -1)):
            rel = max(rel, float((gk - wk).norm()
                                 / wk.norm().clamp_min(1e-30)))
    return rel, err


def compare_sweep(torch, name, got, want, blocks: int) -> float:
    """A trainable recurrence's kernel vs its twin: fails unless every
    output is finite, each gate block within SWEEP_TOL (relative L2) and the
    max abs error within BF16_TOL of max |twin| (no floor). Returns the max
    abs error."""
    rel, err = sweep_error(got, want, blocks)
    scale = max(float(w.float().abs().max()) for w in want)
    ok = (all(bool(torch.isfinite(g).all()) for g in got)
          and rel <= SWEEP_TOL and err <= BF16_TOL * scale)
    log(f'  {name}: gate-block rel L2 {rel:.3e} (tol {SWEEP_TOL:g}), '
        f'max_abs_err {err:.3e}, max |twin| {scale:.3e} (tol {BF16_TOL:g} '
        f'x max |twin|) {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{name}: kernel disagrees with its twin')
    return err


def nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def build_phase(build):
    nvcc = build.nvcc_path()
    version = subprocess.run([nvcc, '--version'], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    log(f'nvcc: {nvcc} ({version.splitlines()[-1]})')
    log(f'flags: {" ".join(build.NVCC_FLAGS)}')
    t0 = time.perf_counter()
    parts = [('rnn_bwd', BWD_PART_DEFINES), ('pool', POOL_PART_DEFINES),
             ('rnn', RNN_PART_DEFINES)]
    times = build.build(variants=[('mrf', MRF_CYCLES_DEFINES)] + [
        ('griffin_lim', d) for d in GL_PART_DEFINES.values()] + ([
            (name, d) for name, defs in parts for d in defs.values()]
            if '--kernel-parts' in sys.argv[1:] else []))
    log(f'build: {time.perf_counter() - t0:.1f} s wall, '
        + ', '.join(f'{k} {v:.1f} s' for k, v in times.items()))
    log(f'mrf build: {times.get("mrf", 0.0):.1f} s (0 where built before)')
    for name in build.SOURCES:
        logf = build.BUILD_DIR / f'{name}.log'
        if logf.is_file():
            for line in logf.read_text().splitlines():
                if 'registers' in line or 'spill' in line:
                    log(f'  ptxas {name}: {line.strip()}')


def request_tokens(config):
    from forwardtacotron_torch.text.cleaners import Cleaner
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    pre = config['preprocessing']
    # no espeak here: text goes in as graphemes, as gen_forward does
    cleaner = Cleaner(pre['cleaner_name'], use_phonemes=False,
                      lang=pre['language'])
    with open(REPO / 'sentences.txt', encoding='utf-8') as f:
        lines = [line.strip() for line in f if line.strip()][:SENTENCES]
    return [Tokenizer()(cleaner(s)) for s in lines]


def make_model(torch, config):
    """The config's model (ForwardTacotron in configs/singlespeaker.yaml)
    at full width with seeded random weights, random BN statistics, and a
    duration head that gives every token FRAMES_PER_TOKEN frames."""
    from forwardtacotron_torch.models.registry import init_tts_model
    torch.manual_seed(SEED)
    model = random_bn_stats(torch, init_tts_model(config))
    return set_frames_per_token(torch, model, FRAMES_PER_TOKEN)


def random_bn_stats(torch, model):
    """Seeded random BatchNorm running statistics (init leaves them at 0
    and 1)."""
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith('running_var'):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return model


def set_frames_per_token(torch, model, frames: int):
    """Make the duration head predict ``frames`` for every token."""
    with torch.no_grad():
        model.dur_pred.lin.weight.zero_()
        model.dur_pred.lin.bias.fill_(float(frames))
    return model


def reset_counts() -> None:
    from forwardtacotron_torch.ops.hopper import (cbhg, griffin_lim, highway,
                                                  lr, lr_bidir, mrf, rnn,
                                                  rnn_train, ups_mrf)
    highway.launches = cbhg.launches = griffin_lim.launches = 0
    lr_bidir.launches = lr.launches = mrf.launches = ups_mrf.launches = 0
    highway.stack_launches = cbhg.pool_proj1_launches = 0
    cbhg.pool_mask_launches = 0
    for counts in (rnn.launches, rnn_train.launches):
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    """Every kernel wrapper's launch count, one key per launch site."""
    from forwardtacotron_torch.ops.hopper import (cbhg, griffin_lim, highway,
                                                  lr, lr_bidir, mrf, rnn,
                                                  rnn_train, ups_mrf)
    return {'pre_highway_stack': highway.launches, 'cbhg_front': cbhg.launches,
            'griffin_lim_iter': griffin_lim.launches,
            'lr_bidir': lr_bidir.launches, 'lr': lr.launches,
            'mrf': mrf.launches, 'ups_mrf': ups_mrf.launches,
            'highway_stack': highway.stack_launches,
            'pool_proj1': cbhg.pool_proj1_launches,
            'pool_mask': cbhg.pool_mask_launches,
            **rnn.launches, **rnn_train.launches}


def expect_counts(label: str, launches: dict, **want) -> None:
    """Fail unless the counts are ``want`` and every other count is 0."""
    full = {k: want.get(k, 0) for k in launches}
    log(f'{label} launches: {launches}')
    if launches != full:
        fail(f'{label}: launch counts {launches}, expected {full}')


def kernel_phase(torch, model, config, n_tok, n_frames):
    """Each kernel against its twin at the main path's largest shapes."""
    from forwardtacotron_torch.models.synthesis import bucket_frames
    from forwardtacotron_torch.ops.hopper import cbhg, highway

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    results = {}
    max_len = bucket_frames(n_frames)

    # 1. pre_highway_stack: prenet (N = tokens, 256 -> 256), postnet
    #    (N = frames, 80 -> 256), the two launches of one request
    log(f'kernel pre_highway_stack (prenet N={n_tok} C_in=256, '
        f'postnet N={max_len} C_in=80; C=256, L=4)')
    ms = plain = err = 0.0
    bounds = []
    for cbhg_mod, n in ((model.prenet, n_tok), (model.postnet, max_len)):
        c_in = cbhg_mod.pre_highway.weight.shape[1]
        args = cbhg_mod.highway_args(randn(n, c_in), randn(n, c_in))
        err = max(err, compare(torch, f'N={n} C_in={c_in}',
                               highway.pre_highway_stack(*args),
                               highway.pre_highway_stack_plain(*args)))
        k_ms = time_ms(torch, lambda: highway.pre_highway_stack(*args))
        p_ms = time_ms(torch, lambda: highway.pre_highway_stack_plain(*args))
        c, layers = 256, len(cbhg_mod.highways)
        flops = 2 * n * c_in * c + layers * 2 * n * c * 2 * c + n * c_in
        nbytes = 4 * (2 * n * c_in + c_in * c + layers * 2 * c * (c + 1)
                      + n * c)
        b_ms, b_by = bound(flops, nbytes)
        log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, '
            f'bound {b_ms:.4f} ms ({b_by})')
        ms, plain = ms + k_ms, plain + p_ms
        bounds.append((b_ms, b_by))
    results['pre_highway_stack'] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=sum(b for b, _ in bounds), bound_by=max(bounds)[1],
        at=f'one request: prenet N={n_tok} + postnet N={max_len}')

    # 2. cbhg_front: the postnet front at the request's frame budget
    post = model.postnet
    t = max_len
    log(f'kernel cbhg_front (postnet B=1 T={t} C_in=80 K=8 C=P=256, '
        f'tail from frame {n_frames})')
    mask = (torch.arange(t, device=dev) < n_frames).float()[None]
    x = randn(1, t, 80) * mask[:, :, None]
    args = post.front_args(x, mask)
    err = compare(torch, f'T={t}', cbhg.bank_pool_proj(*args),
                  cbhg.bank_pool_proj_plain(*args))
    k_ms = time_ms(torch, lambda: cbhg.bank_pool_proj(*args))
    p_ms = time_ms(torch, lambda: cbhg.bank_pool_proj_plain(*args))
    k_max, c, p = post.K, 256, 256
    sum_k = k_max * (k_max + 1) // 2
    flops = 2 * t * (sum_k * 80 * c + 3 * k_max * c * p)
    nbytes = 4 * (t * 80 + t + sum_k * 80 * c + 2 * k_max * c
                  + 3 * k_max * c * p + 2 * p + t * p)
    b_ms, b_by = bound(flops, nbytes)
    log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, '
        f'bound {b_ms:.4f} ms ({b_by})')
    results['cbhg_front'] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 at=f'postnet B=1 T={t}')

    # 3. griffin_lim_iter: the longest request's frames (~10 s of audio),
    #    from a synthetic harmonic sweep at the config's STFT
    dsp = config['dsp']
    n_fft, hop, win = dsp['n_fft'], dsp['hop_length'], dsp['win_length']
    n_samples = hop * (n_frames - 1)
    tt = torch.arange(n_samples, device=dev) / dsp['sample_rate']
    sig = sum(0.2 / h * torch.sin(2 * torch.pi * h * (110 + 40 * tt) * tt)
              for h in range(1, 6)) + 0.01 * randn(n_samples)
    log(f'kernel griffin_lim_iter ({n_samples / dsp["sample_rate"]:.2f} s)')
    results['griffin_lim_iter'] = griffin_lim_check(
        torch, sig, n_fft, hop, win, twin_on_cpu=True)
    # R = n_fft / hop = 16 (n_fft 2048, hop 128: ~1700 frames of the same
    # signal), past the JAX package's fused gate (R <= 9)
    log('kernel griffin_lim_iter at R = 16 (n_fft 2048, hop 128, win 2048)')
    results['griffin_lim_iter']['r16'] = griffin_lim_check(
        torch, sig, 2048, 128, 2048, twin_on_cpu=False)
    return results


# griffin_lim.cu built without parts of its work, for the time each part
# adds (the outputs of these builds are wrong; nothing else calls them)
GL_PART_DEFINES = {'weights_and_epilogue': ('GL_SKIP_A', 'GL_SKIP_PRODUCTS'),
                   'without_products': ('GL_SKIP_PRODUCTS',),
                   'without_a_staging': ('GL_SKIP_A',)}


# copies of rnn_bwd.cu and pool.cu without one part of their work (their
# results are wrong, only their times are kept): where a sweep step and a
# pool_proj1 chunk spend their time; built and timed with --kernel-parts
BWD_PART_DEFINES = {'without_barrier_wait': ('RNN_BWD_SKIP_BARRIER',),
                    'without_products': ('RNN_BWD_SKIP_PRODUCTS',)}
POOL_PART_DEFINES = {'without_pool': ('POOL_SKIP_POOL',),
                     'without_weight_copies': ('POOL_SKIP_W',),
                     'products_only': ('POOL_SKIP_POOL', 'POOL_SKIP_W')}
# copies of rnn.cu: one step of the step-major recurrences without its
# barrier wait or its products (wrong sums, times only), and the LSTMs
# with c carried through memory at every shape (right sums)
RNN_PART_DEFINES = {'without_barrier_wait': ('RNN_SKIP_BARRIER',),
                    'without_products': ('RNN_SKIP_PRODUCTS',),
                    'c_through_memory': ('RNN_C_FROM_MEMORY',)}


def library_parts(torch, name: str, part_defines: dict, fn) -> dict:
    """CUDA-event times of ``fn`` with each copy of the library ``name``
    in ``part_defines`` loaded in the real one's place; nothing (no extra
    build) without ``--kernel-parts``."""
    from forwardtacotron_torch.ops.hopper import build
    if '--kernel-parts' not in sys.argv[1:]:
        return {}
    real = build.library
    parts = {}
    try:
        for label, defines in part_defines.items():
            build.library = lambda n, d=(), defines=defines: real(
                n, defines if n == name else d)
            parts[label] = time_ms(torch, fn)
    finally:
        build.library = real
    log('    parts (ms): ' + ', '.join(f'{k} {v:.4f}' for k, v in parts.items()))
    return parts


def griffin_lim_parts(torch, it_args):
    """CUDA-event times of one iteration with the copies of griffin_lim.cu
    that skip the A staging, the products or both, bound in the wrapper's
    place for this phase."""
    from forwardtacotron_torch.ops.hopper import build, griffin_lim
    real = griffin_lim._kernel
    parts = {}
    try:
        for label, defines in GL_PART_DEFINES.items():
            fn = build.library('griffin_lim', defines).gl_iter_f32
            fn.argtypes, fn.restype = real().argtypes, real().restype
            griffin_lim._kernel = lambda fn=fn: fn
            parts[label] = time_ms(
                torch, lambda: griffin_lim.griffin_lim_iter(*it_args))
    finally:
        griffin_lim._kernel = real
    log('    parts (ms per iteration): ' + ', '.join(
        f'{k} {v:.4f}' for k, v in parts.items()))
    return parts


def griffin_lim_check(torch, sig, n_fft, hop, win, twin_on_cpu):
    """One iteration of griffin_lim.cu against its twin from the signal's
    own magnitude and a seeded phase (random momentum terms), timed beside
    the twin, with both bounds: f32 FMA (held to) and the 3xTF32 tensor-core
    form; then 32 iterations of each from the same phase, whose spectral
    convergence must agree within SC_REL_TOL; then griffin_lim_fused
    profiled at 2 and at 4 iterations, GL_PROFILE_REPEATS times each, to
    show that the launches are the iteration's only device work (no
    edge_frames ops between them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.ops.hopper import griffin_lim
    from forwardtacotron_torch.ops.stft import (initial_phase, istft_pair,
                                                stft_pair)
    dev = sig.device
    gen = torch.Generator().manual_seed(SEED + n_fft)
    re, im = stft_pair(sig, n_fft, hop, win)
    mag = torch.sqrt(re * re + im * im)                  # [F, bins]
    f_true, bins = mag.shape
    r = n_fft // hop
    log(f'  F={f_true}, bins={bins}, n_fft={n_fft}, hop={hop}, R={r}')
    consts = griffin_lim.gl_constants(n_fft, hop, win, dev)
    winsq = griffin_lim.ola_normalizer(n_fft, hop, f_true, win, dev)
    phase = initial_phase((f_true, bins), SEED).to(dev)
    spec_re = (mag * torch.cos(phase))[None].contiguous()
    spec_im = (mag * torch.sin(phase))[None].contiguous()
    tp_re, tp_im = (torch.randn((1, f_true, bins), generator=gen).to(dev)
                    for _ in range(2))
    magb = mag[None].contiguous()
    it_args = (spec_re, spec_im, tp_re, tp_im, magb, winsq, consts, hop)
    err = compare(torch, 'one iteration',
                  griffin_lim.griffin_lim_iter(*it_args),
                  griffin_lim.griffin_lim_iter_plain(*it_args))
    k_ms = time_ms(torch, lambda: griffin_lim.griffin_lim_iter(*it_args))
    p_ms = time_ms(torch,
                   lambda: griffin_lim.griffin_lim_iter_plain(*it_args))
    gemm = 2 * f_true * (2 * bins) * n_fft * 2
    flops = gemm + f_true * n_fft * (2 * r - 1)
    nbytes = 4 * (5 * f_true * bins + (f_true - 1) * hop + n_fft
                  + 4 * bins * n_fft + 2 * n_fft + 4 * f_true * bins)
    b_ms, b_by = bound(flops, nbytes)
    tc_ms = max(3 * gemm / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound '
        f'{b_ms:.4f} ms ({b_by}, f32 FMA; 3xTF32 on tensor cores '
        f'{tc_ms:.4f} ms) per iteration')
    res = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
               bound_by=b_by, tc_bound_ms=tc_ms,
               parts_ms=griffin_lim_parts(torch, it_args),
               at=f'one iteration, F={f_true}, n_fft={n_fft}, hop={hop}')

    # 32 iterations end to end: spectral convergence of kernel vs twin
    def spectral_convergence(wav):
        r2, i2 = stft_pair(wav, n_fft, hop, win)
        m2 = torch.sqrt(r2 * r2 + i2 * i2)[:f_true]
        return float(torch.linalg.norm(m2 - mag) / torch.linalg.norm(mag))

    mag_t, ph_t = mag.T[None].contiguous(), phase.T[None].contiguous()
    wav_k = griffin_lim.griffin_lim_fused(mag_t, ph_t, n_fft, hop, win,
                                          n_iter=32)[0]
    if twin_on_cpu:  # the wrapper picks the twin for CPU tensors
        wav_p = griffin_lim.griffin_lim_fused(
            mag_t.cpu(), ph_t.cpu(), n_fft, hop, win, n_iter=32)[0].to(dev)
    else:  # the twin's iterations on the card (a CPU run takes minutes)
        state = (spec_re, spec_im, torch.zeros_like(magb),
                 torch.zeros_like(magb))
        for _ in range(32):
            state = griffin_lim.griffin_lim_iter_plain(*state, magb, winsq,
                                                       consts, hop)
        wav_p = istft_pair(state[0], state[1], n_fft, hop, win)[0]
    sc_k, sc_p = spectral_convergence(wav_k), spectral_convergence(wav_p)
    ok = abs(sc_k - sc_p) <= SC_REL_TOL * sc_p and sc_k < 1.0
    log(f'  32 iterations: spectral convergence kernel {sc_k:.5f}, '
        f'twin {sc_p:.5f} (|diff| <= {SC_REL_TOL:g} x twin) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'griffin_lim_iter (R={r}): 32-iteration spectral convergence')
    res.update(sc_kernel=sc_k, sc_twin=sc_p)

    # the device work of griffin_lim_fused at 2 and at 4 iterations, each
    # profiled GL_PROFILE_REPEATS times: every iteration adds its two
    # launches and nothing else
    counts = {}
    for n_iter in (2, 4):
        runs = []
        for _ in range(GL_PROFILE_REPEATS):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                griffin_lim.griffin_lim_fused(mag_t, ph_t, n_fft, hop, win,
                                              n_iter=n_iter)
                torch.cuda.synchronize()
            runs.append(collections.Counter(
                e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA))
        differ = {k: [c.get(k, 0) for c in runs]
                  for k in set().union(*runs)
                  if len({c.get(k, 0) for c in runs}) > 1}
        if differ:
            log(f'  profiler records differ between the {n_iter}-iteration '
                f'runs: {[sum(c.values()) for c in runs]} device events; '
                + '; '.join(f'{k[:60]}: {v}' for k, v in differ.items()))
        counts[n_iter] = typical_count(runs)
    log(f'  device events (gl_gemm_kernel, other) at 2 and 4 iterations: '
        + ', '.join(str((sum(v for k, v in c.items() if GL_KERNEL in k),
                         sum(v for k, v in c.items() if GL_KERNEL not in k)))
                    for c in counts.values()))
    if any(GL_KERNEL in k for c in counts.values() for k in c):
        extra = gl_iteration_extra_work(counts[2], counts[4])
        if extra:
            fail('griffin_lim_iter: an iteration runs device work besides '
                 f'its two launches: {"; ".join(extra)}')
    else:
        log('  profiler recorded no device kernels; the launch counts are '
            'the evidence')
    return res


# the Griffin-Lim kernels' name in the profiler, and how many times the
# iterations' device work is profiled at each iteration count
GL_KERNEL = 'gl_gemm_kernel'
GL_PROFILE_REPEATS = 5


def typical_count(runs) -> collections.Counter:
    """Per device-event name, the median count over profiled runs of the
    same work (the lower middle one; a run without the name counts 0). The
    profiler's records of one run can miss an event, and a record missed
    at the end of one run can come in the next run's (one run on the card
    counted one event fewer than the others, another one copy more), so
    neither the largest nor the smallest count is the work's; the work
    itself is the same in every run, so what a majority of the runs
    record is it, and work that every run does stays in the median."""
    names = set().union(*runs)
    return collections.Counter(
        {k: statistics.median_low(c.get(k, 0) for c in runs)
         for k in names})


def gl_iteration_extra_work(at_2, at_4) -> list:
    """What griffin_lim_fused at 4 iterations ran beyond its run at 2, per
    device-event name (kernels and copies; ``at_2`` / ``at_4`` map names to
    counts), besides the 4 gl_gemm_kernel launches of the 2 more
    iterations. Empty where the counts are exactly that."""
    gl = sum(v for k, v in at_4.items() if GL_KERNEL in k) \
        - sum(v for k, v in at_2.items() if GL_KERNEL in k)
    out = [] if gl == 4 else [f'{GL_KERNEL} launches +{gl}, expected +4']
    for name in sorted(set(at_2) | set(at_4)):
        if GL_KERNEL not in name and at_2.get(name, 0) != at_4.get(name, 0):
            out.append(f'{name}: {at_2.get(name, 0)} at 2 iterations, '
                       f'{at_4.get(name, 0)} at 4')
    return out


PRE_HIGHWAY_KERNEL = r'highway_kernel<[^>]*true>'
KERNEL_NAMES = {'pre_highway_stack': [PRE_HIGHWAY_KERNEL],
                'cbhg_front': ['cbhg_front_kernel'],
                'griffin_lim_iter': [r'gl_gemm_kernel<\d+, (\(int\))?0>',
                                     r'gl_gemm_kernel<\d+, (\(int\))?1>'],
                'lr': ['lr_tile_kernel']}


def device_profile(prof, label: str, table_file: str, kernel_names) -> float:
    """Device busy ms of a profiled run; logs its largest device kernels,
    writes the kernel table to chiprun_out/, and fails if the profiler
    recorded device time but no device kernel matches one of the
    ``kernel_names`` patterns (regular expressions)."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    # a profiler schedule's step annotations span the step on the device
    kernels_run = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith('ProfilerStep')]
    device_names = [e.key for e in kernels_run]
    busy_ms = sum(e.self_device_time_total for e in kernels_run) / 1e3
    log(f'profiled {label}: device busy {busy_ms:.1f} ms in '
        f'{sum(e.count for e in kernels_run)} device events')
    for e in sorted(kernels_run, key=lambda e: -e.self_device_time_total)[:8]:
        log(f'  device {e.self_device_time_total / 1e3:9.3f} ms '
            f'{e.count:6d} calls  {e.key[:70]}')
    out_dir = REPO / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    table = events.table(sort_by='device_time_total', row_limit=40)
    (out_dir / table_file).write_text(table)
    if device_names:
        for names in kernel_names.values():
            for n in names:
                if not any(re.search(n, d) for d in device_names):
                    fail(f'{label}: profiler shows no {n} on the device')
        log(f'profiler: all {sum(map(len, kernel_names.values()))} kernel '
            f'functions ran on the device ({len(device_names)} device '
            'event names recorded)')
    else:
        log('profiler: recorded no device time; the launch counts above '
            'are the evidence')
    return busy_ms


def main_path_phase(torch, model, config, tokens):
    """Text -> mel -> wav for every request, counts and profiler around it."""
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.synthesis import TTSInference

    inference = TTSInference(model, device='cuda')
    dsp = DSP.from_config(config, device='cuda')

    def run(toks):
        t0 = time.perf_counter()
        out = inference.generate_cropped(toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wav = dsp.griffinlim(out['mel_post'])
        torch.cuda.synchronize()
        return out, wav, t1 - t0, time.perf_counter() - t1

    run(tokens[0][:8])                        # warm-up: library loads
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [run(toks) for toks in tokens]
    launches = read_counts()

    # expected outputs: every token lasts FRAMES_PER_TOKEN frames
    hop = config['dsp']['hop_length']
    for i, (toks, (out, wav, _, _)) in enumerate(zip(tokens, outs)):
        frames = FRAMES_PER_TOKEN * len(toks)
        for key in ('mel', 'mel_post'):
            if out[key].shape != (config['dsp']['num_mels'], frames):
                fail(f'request {i}: {key} shape {out[key].shape}, '
                     f'expected (80, {frames})')
        if wav.shape != (hop * (frames - 1),):
            fail(f'request {i}: wav shape {wav.shape}')
        if not (np.isfinite(out['mel_post']).all()
                and np.isfinite(wav).all()):
            fail(f'request {i}: non-finite output')
    # float32 keeps the per-step recurrences: no recurrent kernel runs;
    # the frame trunk's length regulator is the lr kernel
    expect_counts('float32 path', launches,
                  pre_highway_stack=2 * len(tokens), cbhg_front=len(tokens),
                  griffin_lim_iter=32 * len(tokens), lr=len(tokens))

    busy_ms = device_profile(prof, 'main path', 'chip_smoke_profile.txt',
                             KERNEL_NAMES)

    # per-stage times, a second run without the profiler
    log('main path stages (host clock, synchronized):')
    wall = 0.0
    for i, toks in enumerate(tokens):
        out, wav, t_mel, t_wav = run(toks)
        wall += t_mel + t_wav
        frames = out['mel'].shape[1]
        log(f'  request {i}: {len(toks)} tokens -> {frames} frames '
            f'({frames * hop / config["dsp"]["sample_rate"]:.2f} s): '
            f'text->mel {t_mel * 1e3:.1f} ms, griffinlim {t_wav * 1e3:.1f} ms')
    log(f'main path: {wall * 1e3:.1f} ms wall for {len(tokens)} requests, '
        f'device busy {busy_ms:.1f} ms (profiled run): idle '
        f'{100 * (1 - busy_ms / (wall * 1e3)):.1f}%')
    return launches, outs


def griffinlim_split_phase(torch, model, config, tokens):
    """Where one ``DSP.griffinlim`` call of the longest float32 request
    spends its time: the call's wall time (synchronized, median of 5); the
    same for its parts called alone: the NNLS mel -> linear, the 32
    iterations with their final istft (``griffin_lim_fused``), that istft,
    and 32 calls of ``edge_frames`` (the torch ops an iteration ran between
    its launches before griffin_lim.cu built its edge frames); and, from
    the profiler over one call, the device time of the Griffin-Lim kernels,
    of everything else, and the host time no device work covers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.ops.hopper import griffin_lim
    from forwardtacotron_torch.ops.stft import initial_phase, istft_pair

    toks = max(tokens, key=len)
    mel = TTSInference(model, device='cuda').generate_cropped(
        toks)['mel_post']
    dsp = DSP.from_config(config, device='cuda')
    n_fft, hop, win = dsp.n_fft, dsp.hop_length, dsp.win_length

    def wall(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    mel_power = torch.exp(torch.tensor(mel, device='cuda'))
    linear = dsp._mel_to_stft(mel_power)
    phase = initial_phase(linear.shape, 0).to('cuda')
    spec = (linear.T * torch.cos(phase.T))[None].contiguous()
    consts = griffin_lim.gl_constants(n_fft, hop, win, spec.device)
    winsq = griffin_lim.ola_normalizer(n_fft, hop, linear.shape[1], win,
                                       spec.device)
    split = dict(
        frames=int(linear.shape[1]),
        total_ms=wall(lambda: dsp.griffinlim(mel)),
        nnls_ms=wall(lambda: dsp._mel_to_stft(mel_power)),
        iterations_and_istft_ms=wall(lambda: griffin_lim.griffin_lim_fused(
            linear[None], phase[None], n_fft, hop, win, n_iter=32)),
        istft_ms=wall(lambda: istft_pair(spec, spec, n_fft, hop, win)),
        edge_frames_x32_ms=wall(lambda: [
            griffin_lim.edge_frames(spec, spec, hop, consts, winsq)
            for _ in range(32)]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dsp.griffinlim(mel)
        torch.cuda.synchronize()
    gl = re.compile(r'gl_(gemm|idft|dft_update)_kernel')
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    gl_us = sum(e.self_device_time_total for e in kernels if gl.search(e.key))
    busy_us = sum(e.self_device_time_total for e in kernels)
    split.update(
        gl_kernels_device_ms=gl_us / 1e3,
        other_device_ms=(busy_us - gl_us) / 1e3,
        other_device_launches=sum(e.count for e in kernels
                                  if not gl.search(e.key)),
        host_not_covered_ms=split['total_ms'] - busy_us / 1e3)
    log(f'griffinlim split (longest request, {split["frames"]} frames, '
        f'{n_fft}/{hop}): ' + ', '.join(
            f'{k} {v:.3f}' if isinstance(v, float) else f'{k} {v}'
            for k, v in split.items()))
    return split


def reference_phase(torch, model, config, tokens, outs):
    """One request through the plain path on the CPU (twins, no kernels)
    against the card's result."""
    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.synthesis import TTSInference
    i = min(range(len(tokens)), key=lambda j: len(tokens[j]))
    cpu = TTSInference(copy.deepcopy(model).cpu(), device='cpu')
    ref = cpu.generate_cropped(tokens[i])
    got = outs[i][0]
    err = max(float(np.abs(got[k] - ref[k]).max())
              for k in ('mel', 'mel_post'))
    ok = err <= E2E_MEL_ATOL
    log(f'reference: request {i} on the card vs the CPU plain path, '
        f'mel/mel_post max abs err {err:.3e} (atol {E2E_MEL_ATOL:g}) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('main path disagrees with the CPU plain path')
    mel = ref['mel_post']
    phase = np.random.RandomState(SEED).uniform(
        0, 2 * np.pi, (config['dsp']['n_fft'] // 2 + 1, mel.shape[1]))
    wav_gpu = DSP.from_config(config, device='cuda').griffinlim(
        mel, n_iter=4, phase=phase)
    wav_cpu = DSP.from_config(config, device='cpu').griffinlim(
        mel, n_iter=4, phase=phase)
    err = float(np.abs(wav_gpu - wav_cpu).max())
    scale = max(1e-3, float(np.abs(wav_cpu).max()))
    ok = err <= KERNEL_TOL * 10 * scale
    log(f'reference: griffinlim (4 iterations, same phase) card vs CPU, '
        f'max abs err {err:.3e}, peak {scale:.3e} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('griffinlim disagrees with the CPU plain path')


# ------------------------------------------------------------- bfloat16

# the recurrent kernels' template instances by rnn.cu Mode value: the
# step-major rnn_step_kernel<mode, unit, mel columns> runs every mode,
# MODE_GRU_X (0), MODE_LSTM_X (1), MODE_GRU_XP (2), MODE_LSTM_MEL (3) and
# MODE_LSTM_TRAIN (4)
RNN_KERNELS = {'gru': r'rnn_step_kernel<(\(int\))?0,',
               'lstm': r'rnn_step_kernel<(\(int\))?1,',
               'gru_xp': r'rnn_step_kernel<(\(int\))?2,',
               'lstm_mel': r'rnn_step_kernel<(\(int\))?3,',
               'lstm_train': r'rnn_step_kernel<(\(int\))?4,'}
# the bf16 entries of rows 1 and 2 are their tensor-core kernels
SERVING_KERNEL_NAMES = {
    'pre_highway_stack': [r'highway_mma_kernel<[^>]*true>'],
    'cbhg_front': ['cbhg_front_mma_kernel'],
    'lr_bidir': ['lr_bidir_kernel'],
    **{k: [v] for k, v in RNN_KERNELS.items()
       if k in ('gru', 'gru_xp', 'lstm_mel')}}


def bf16_check(torch, name, kernel, plain, args, flops, nbytes,
               library=None, yardstick=None, sweep_blocks=None,
               plain_reps=REPS, tol=BF16_TOL, peak=PEAK_BF16_FLOPS):
    """Kernel vs twin on the same bf16 inputs (``compare`` at ``tol``, or
    ``compare_sweep`` with ``sweep_blocks`` gate blocks), then CUDA-event
    times of the kernel, the twin (``plain_reps`` runs) and (where one
    exists) one library call or, where no single call computes the
    function, a yardstick chain of calls; the bound at ``peak``. A float32
    entry passes KERNEL_TOL and PEAK_F32_FLOPS."""
    got, want = kernel(*args), plain(*args)
    if sweep_blocks is None:
        err = compare(torch, name, got.float(), want.float(), tol)
    else:
        got = got if isinstance(got, (tuple, list)) else [got]
        want = want if isinstance(want, (tuple, list)) else [want]
        err = compare_sweep(torch, name, got, want, sweep_blocks)
    del got, want
    k_ms = time_ms(torch, lambda: kernel(*args))
    p_ms = time_ms(torch, lambda: plain(*args), plain_reps,
                   min(3, plain_reps))
    l_ms = None if library is None else time_ms(torch, library)
    b_ms, b_by = bound(flops, nbytes, peak)
    res = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=b_ms, bound_by=b_by)
    extra = ''
    if yardstick is not None:
        res['yardstick_ms'] = time_ms(torch, yardstick)
        extra = f', yardstick {res["yardstick_ms"]:.4f} ms'
    log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library '
        f'{"-" if l_ms is None else f"{l_ms:.4f} ms"}{extra}, bound '
        f'{b_ms:.4f} ms ({b_by}); {flops / k_ms / 1e9:.1f} TFLOP/s')
    return res


def log_plan(rnn, mode: str, x2, hidden: int, n_mels: int = 0) -> None:
    """The launch plan the step-major kernel ``mode`` takes for x2."""
    t, _, b, i = x2.shape
    if mode == 'gru_xp':    # x2 is the projection: no x rows in the slice
        i = 0
    p = rnn.plan(mode, b, t, i, hidden, n_mels, *rnn.device_limits(x2.device))
    log(f'    plan: tile {p["tile"]} rows, {p["unit"]} units x '
        f'{p["ctas_per_direction"]} CTAs per direction, {p["groups"]} groups '
        f'of <= {p["tiles_per_group"]} tiles, {p["warpgroups"]} consumer '
        f'warpgroups, ring {p["stages"]} x {p["chunk"]}, cluster '
        f'{p["cluster"]}, {p["rounds"]} rounds, {p["smem"]} B shared')


def log_bwd_plan(rnn, rnn_train, cell: str, x2, hidden: int) -> None:
    """The launch plans of rnn_bwd.cu's gate product and sweep for x2."""
    t, _, b, i = x2.shape
    p = rnn_train.plan(cell, b, t, i, hidden,
                       *rnn.device_limits(x2.device))
    g, s = p['gates'], p['sweep']
    log(f'    plan: gates {g["rows"]} rows x {g["steps"]} steps per tile, '
        f'{g["m_tiles"]} x {g["n_tiles"]} tiles per direction, K {g["k"]}, '
        f'ring {g["stages"]}, {g["grid"]} CTAs, {g["smem"]} B shared; sweep '
        f'{s["unit"]} units x {s["ctas_per_direction"]} CTAs per direction, '
        f'{s["groups"]} groups of <= {s["tiles_per_group"]} tiles, '
        f'{s["chunks"]} K chunks, rings 2 x {s["stages"]}, {s["rounds"]} '
        f'rounds, {s["smem"]} B shared')


def log_pool_plan(cbhg, b: int, t: int, kc: int, p: int) -> None:
    """The launch plan of pool.cu's bf16 pool_proj1 for [b, t, kc] -> p."""
    q = cbhg.pool_proj1_plan(b, t, kc, p)
    log(f'    plan: {q["virtual_frames"]} frames with gaps in {q["tiles"]} '
        f'tiles of {q["tile"]}, {q["n_blocks"]} column block(s) of '
        f'{q["n_cols"]}, {q["chunks"]} K chunks of {q["chunk"]}, ring '
        f'{q["stages"]} + x ring {q["x_stages"]}, '
        f'{q["grid"]} CTAs, {q["smem"]} B shared')


def cudnn_rnn(torch, cell: str, in_dim: int, hidden: int, x2):
    """One call of cuDNN's bidirectional nn.LSTM / nn.GRU in bf16 on
    direction 0 of x2 [T, 2, B, I]: the yardstick of the recurrent rows."""
    cls = torch.nn.LSTM if cell == 'lstm' else torch.nn.GRU
    # built on the card in bf16, so its weights are one flat cuDNN buffer
    mod = cls(in_dim, hidden, bidirectional=True, device='cuda',
              dtype=torch.bfloat16)
    x = x2[:, 0].contiguous()
    return lambda: mod(x)


def bf16_kernel_phase(torch, model, label, batch, n_tok, frames, t_budget,
                      two_phase):
    """Every bf16 kernel against its twin at one shape set: ``batch``
    items of ``n_tok`` tokens, ``frames`` valid frames each, a decode
    budget of ``t_budget`` frames. ``two_phase`` adds the recurrences only
    the two-phase path runs (prenet and pitch GRUs) and the LSTM body,
    which serves ``BiLSTM.forward`` in bf16 where the fused trunk's gate
    fails (no path of the full-width model reaches it)."""
    from forwardtacotron_torch.models import layers
    from forwardtacotron_torch.ops.hopper import cbhg, highway, lr_bidir, rnn

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    log(f'bf16 kernels, {label}: B={batch}, {n_tok} tokens, {frames} '
        f'frames, budget {t_budget}')
    res = {}
    b, n, t = batch, n_tok, t_budget
    t_run = -(-t // lr_bidir.T_TILE) * lr_bidir.T_TILE

    # pre_highway_stack: prenet (N = tokens, 256 -> 256) and postnet
    # (N = frames, 80 -> 256), the two launches of one call; yardstick the
    # residual add and the nn.Linear chain (pre_highway, the highways)
    parts = []
    for mod, rows in ((model.prenet, b * n), (model.postnet, b * t)):
        c_in, c = mod.pre_highway.weight.shape[1], mod.channels
        log(f'  pre_highway_stack bf16 N={rows} C_in={c_in} (yardstick: '
            'residual add + nn.Linear chain)')
        log(f'    plan: {highway.plan(c_in, c)}')
        layers_n = len(mod.highways)
        flops = 2 * rows * c_in * c + layers_n * 2 * rows * c * 2 * c
        nbytes = 2 * (2 * rows * c_in + c_in * c + layers_n * 2 * c * c
                      + rows * c) + 4 * layers_n * 2 * c
        a, r = randn(rows, c_in), randn(rows, c_in)

        def chain(mod=mod, a=a, r=r):
            y = mod.pre_highway(a + r)
            for hw in mod.highways:
                y = hw(y)
            return y
        parts.append(bf16_check(
            torch, f'N={rows}', highway.pre_highway_stack,
            highway.pre_highway_stack_plain, mod.highway_args(a, r),
            flops, nbytes, yardstick=chain))
        del a, r
    res['pre_highway_stack'] = {
        k: (max(p[k] for p in parts) if k == 'max_abs_err'
            else parts[0][k] if k == 'bound_by'
            else None if k == 'library_ms' else sum(p[k] for p in parts))
        for k in parts[0]}

    # cbhg_front: the postnet front at the decode budget, tail masked;
    # yardstick the bank as one cuDNN K-tap conv1d (+ ReLU, BN), pool_mask,
    # then cuDNN's proj1 conv1d (+ ReLU, BN)
    post = model.postnet
    log(f'  cbhg_front bf16 B={b} T={t} (valid {frames}; yardstick: fused '
        'cuDNN bank, pool_mask, cuDNN proj1)')
    mask = (torch.arange(t, device=dev) < frames).float().expand(
        b, t).contiguous()
    x = randn(b, t, 80) * mask[:, :, None].to(bf)
    k_max, c, p = post.K, post.channels, 256
    log(f'    plan: {cbhg.plan(bf, k_max, 80, c, p)}')
    sum_k = k_max * (k_max + 1) // 2
    res['cbhg_front'] = bf16_check(
        torch, f'B={b} T={t}', cbhg.bank_pool_proj, cbhg.bank_pool_proj_plain,
        post.front_args(x, mask),
        2 * b * t * (sum_k * 80 * c + 3 * k_max * c * p),
        2 * (b * t * 80 + sum_k * 80 * c + 3 * k_max * c * p + b * t * p)
        + 4 * (b * t + 2 * k_max * c + 2 * p),
        yardstick=lambda: post.conv_project1(cbhg.pool_mask(
            post._bank_fused(x).contiguous(), mask)))
    del x

    # gru_from_xp: the four token GRUs as one block-diagonal H=512 GRU
    rnns = [model.dur_pred.rnn, model.pitch_pred.rnn, model.energy_pred.rnn,
            model.prenet.rnn]
    wh, bh = layers.multi_gru_weights(rnns)
    h = wh.shape[1]
    log(f'  gru_from_xp T={n} B={b} H={h} (yardstick: cuDNN bi-GRU H={h} '
        f'from an input of width {CUDNN_XP_WIDTH}, which also projects it)')
    xp2 = randn(n, 2, b, 3 * h, scale=0.5)
    res['gru_from_xp'] = bf16_check(
        torch, f'T={n} B={b}', rnn.gru_xp, rnn.gru_xp_plain, (xp2, wh, bh),
        n * 2 * b * 2 * h * 3 * h,
        2 * (n * 2 * b * 3 * h + 2 * h * 3 * h + 2 * 3 * h + n * 2 * b * h),
        yardstick=cudnn_rnn(torch, 'gru', CUDNN_XP_WIDTH, h,
                            randn(n, 1, b, CUDNN_XP_WIDTH)))
    log_plan(rnn, 'gru_xp', xp2, h)
    if not two_phase:   # row 4's serving step split (--kernel-parts)
        res['gru_from_xp']['parts_ms'] = library_parts(
            torch, 'rnn', {k: v for k, v in RNN_PART_DEFINES.items()
                           if k != 'c_through_memory'},
            lambda: rnn.gru_xp(xp2, wh, bh))
    del xp2

    # lr_bidir: tokens of C=512 -> [t_run, 2, B, 512], frames/n per token
    c_tok = 2 * model.prenet.channels
    reps = torch.full((b, n), frames // n, dtype=torch.int32, device=dev)
    ends = torch.cumsum(reps, dim=1, dtype=torch.int32)
    log(f'  lr_bidir B={b} N={n} C={c_tok} T_run={t_run}')
    args = (randn(b, n, c_tok), ends, t_run)
    res['lr_bidir'] = bf16_check(
        torch, f'T_run={t_run}', lr_bidir.length_regulator_bidir,
        lr_bidir.length_regulator_bidir_plain, args, 0,
        2 * b * n * c_tok + 4 * b * n + 2 * t_run * 2 * b * c_tok)
    if b == 1:   # a request: where the short call's time goes
        res['lr_bidir'].update(device_times(
            torch, lambda: lr_bidir.length_regulator_bidir(*args),
            'lr_bidir_kernel'))
        log_device_times('kernel', res['lr_bidir'])
    del args

    # lstm_lr_mel: the bi-LSTM H=512 over t_run frames, mel stage M=80
    wi, wh, bi, bh = model.lstm.stacked_params()
    wm = layers.mel_weights(model.lstm, model.lin)
    i_dim, h = wi.shape[1], wh.shape[1]
    m = wm.shape[-1]
    x2 = randn(t_run, 2, b, i_dim, scale=0.5)
    log(f'  lstm_lr_mel T_run={t_run} B={b} I={i_dim} H={h} M={m} '
        '(library: cuDNN bi-LSTM, without the mel stage)')
    res['lstm_lr_mel'] = bf16_check(
        torch, f'T_run={t_run} B={b}', rnn.lstm_mel, rnn.lstm_mel_plain,
        (x2, wi, wh, bi + bh, wm),
        t_run * 2 * b * 2 * ((i_dim + h) * 4 * h + h * m),
        2 * (t_run * 2 * b * i_dim + 2 * (i_dim + h) * 4 * h + 2 * 4 * h
             + 2 * h * m + t_run * 2 * b * m),
        cudnn_rnn(torch, 'lstm', i_dim, h, x2))
    log_plan(rnn, 'lstm_mel', x2, h, m)

    # bidir_rnn, GRU body: the postnet GRU over the decode budget
    def bidir(name, mod, steps, cell):
        wi, wh, bi, bh = mod.stacked_params()
        i_dim, h = wi.shape[1], wh.shape[1]
        g = wi.shape[2]
        x2 = randn(steps, 2, b, i_dim, scale=0.5)
        log(f'  bidir_rnn {name} T={steps} B={b} I={i_dim} H={h} '
            f'(library: cuDNN bi-{cell.upper()})')
        if cell == 'gru':
            kernel, plain, args = rnn.gru, rnn.gru_plain, (x2, wi, wh, bi, bh)
        else:
            kernel, plain, args = rnn.lstm, rnn.lstm_plain, (x2, wi, wh,
                                                             bi + bh)
        res = bf16_check(
            torch, f'{name} T={steps}', kernel, plain, args,
            steps * 2 * b * 2 * (i_dim + h) * g,
            2 * (steps * 2 * b * i_dim + 2 * (i_dim + h) * g + 4 * g
                 + steps * 2 * b * h),
            cudnn_rnn(torch, cell, i_dim, h, x2))
        log_plan(rnn, cell, x2, h)
        return res

    res['bidir_rnn'] = bidir('postnet GRU', model.postnet.rnn, t, 'gru')
    if two_phase:
        bidir('prenet GRU', model.prenet.rnn, n, 'gru')
        bidir('pitch GRU', model.pitch_pred.rnn, n, 'gru')
        res['lstm_body'] = bidir('LSTM body', model.lstm, t, 'lstm')
    for r in res.values():
        r['at'] = label
    return res


def serving_requests(torch, batch: int):
    """bench.py's 8 sentences tiled to ``batch`` rows, zero-padded to the
    longest, on the card."""
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    token_lists = [Tokenizer()(s) for s in BENCH_SENTENCES]
    x = np.zeros((batch, max(map(len, token_lists))), np.int64)
    for i in range(batch):
        toks = token_lists[i % len(token_lists)]
        x[i, :len(toks)] = toks
    return torch.as_tensor(x, device='cuda')


def serving_phase(torch, model, config):
    """generate_fused as bench.py drives it: one profiling call at the full
    budget, requests routed to 16-frame buckets, every group warmed, then
    SERVING_TRIALS trials of SERVING_ITERS iterations over all groups."""
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.text.tokenizer import Tokenizer

    hop, sr = config['dsp']['hop_length'], config['dsp']['sample_rate']
    n_tok = max(len(Tokenizer()(s)) for s in BENCH_SENTENCES)
    inference = TTSInference(set_frames_per_token(
        torch, model, SERVING_FRAMES_PER_TOKEN), dtype='bfloat16',
        device='cuda')

    def requests(batch):
        return serving_requests(torch, batch)

    def timed_call(xd, max_len):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inference.generate_fused(xd, max_len=max_len)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    batch = SERVING_BATCH
    xd = requests(batch)
    timed_call(xd[:8], SERVING_MAX_LEN)       # warm-up: library loads
    out, first_s = timed_call(xd, SERVING_MAX_LEN)
    log(f'serving: first generate_fused call, batch {batch}, max_len '
        f'{SERVING_MAX_LEN}: {first_s:.3f} s')
    if first_s > SERVING_CALL_LIMIT_S:
        batch = 1024
        log(f'serving: over {SERVING_CALL_LIMIT_S:g} s, batch dropped to '
            f'{batch}')
        xd = requests(batch)
        out, first_s = timed_call(xd, SERVING_MAX_LEN)
    mel_lens = np.minimum(out['mel_len'].cpu().numpy(), SERVING_MAX_LEN)
    if not (mel_lens == SERVING_FRAMES_PER_TOKEN * n_tok).all():
        fail(f'serving: mel_len {np.unique(mel_lens)}, expected '
             f'{SERVING_FRAMES_PER_TOKEN * n_tok} for every request')
    buckets = np.minimum(-(-np.maximum(mel_lens, 1) // SERVING_BUCKET)
                         * SERVING_BUCKET, SERVING_MAX_LEN)
    groups = []
    for bucket in np.unique(buckets):
        idx = np.nonzero(buckets == bucket)[0]
        groups.append((xd[torch.as_tensor(idx, device='cuda')], int(bucket),
                       int(np.minimum(mel_lens[idx], bucket).sum())))
    frames_per_iter = sum(g[2] for g in groups)
    log(f'serving: {len(groups)} bucket group(s) '
        f'{[(len(g[0]), g[1]) for g in groups]} (batch, frames)')

    def iteration():
        return [inference.generate_fused(xg, max_len=bk)
                for xg, bk, _ in groups]

    iteration()
    torch.cuda.synchronize()
    reset_counts()
    outs = iteration()
    torch.cuda.synchronize()
    n_calls = len(groups)
    # one call: the 4 token GRUs as one gru_xp, LR + LSTM-mel, the
    # postnet GRU, both highway stacks, the postnet front
    expect_counts('serving path', read_counts(), gru_xp=n_calls,
                  lr_bidir=n_calls, lstm_mel=n_calls, gru=n_calls,
                  pre_highway_stack=2 * n_calls, cbhg_front=n_calls)
    launches = read_counts()
    n_mels = config['dsp']['num_mels']
    for (xg, bk, _), o in zip(groups, outs):
        if o['mel_post'].shape != (len(xg), bk, n_mels) \
                or not bool(torch.isfinite(o['mel_post']).all()):
            fail(f'serving: bad mel_post {tuple(o["mel_post"].shape)}')

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        iteration()
        torch.cuda.synchronize()
    busy_ms = device_profile(prof, 'serving iteration',
                             'chip_smoke_serving_profile.txt',
                             SERVING_KERNEL_NAMES)

    rates, walls = [], []
    for _ in range(SERVING_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_ITERS):
            iteration()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        walls.append(elapsed / SERVING_ITERS)
        rates.append(SERVING_ITERS * frames_per_iter * hop / sr / elapsed)
    wall_ms = statistics.median(walls) * 1e3
    stats = dict(batch=batch, groups=[(len(g[0]), g[1]) for g in groups],
                 audio_s_per_iter=frames_per_iter * hop / sr,
                 audio_s_per_s=sorted(rates), iteration_ms=wall_ms,
                 device_busy_ms=busy_ms, idle=1 - busy_ms / wall_ms)
    log(f'serving: {frames_per_iter} frames = '
        f'{stats["audio_s_per_iter"]:.1f} audio-s per iteration; '
        f'{SERVING_TRIALS} trials x {SERVING_ITERS} iterations: audio-s/s '
        f'min {min(rates):.1f} median {statistics.median(rates):.1f} max '
        f'{max(rates):.1f}; iteration {wall_ms:.2f} ms wall (median), '
        f'device busy {busy_ms:.2f} ms (profiled iteration): idle '
        f'{100 * stats["idle"]:.1f}%')
    # as bench.py counts it: each group decodes its padded bucket of frames
    # from the padded token width; the weights are read once per call
    iter_flops = sum(forward_tacotron_generate_flops(
        config, len(xg), xg.shape[1], bk) for xg, bk, _ in groups)
    iter_bytes = sum(forward_tacotron_activation_bytes(
        config, len(xg), xg.shape[1], bk, dtype_bytes=2)
        + forward_tacotron_param_bytes(config, dtype_bytes=2)
        for xg, bk, _ in groups)
    stats['roofline'] = roofline(
        'serving', iter_flops, iter_bytes,
        stats['audio_s_per_iter'] / statistics.median(rates))
    return launches, stats


def two_phase_bf16_phase(torch, model, tokens):
    """The 4 requests, bf16, through generate_cropped one at a time and
    through generate_routed as one batch."""
    from forwardtacotron_torch.models.synthesis import TTSInference
    inference = TTSInference(set_frames_per_token(torch, model,
                                                  FRAMES_PER_TOKEN),
                             dtype='bfloat16', device='cuda')
    inference.generate_cropped(tokens[0][:8])
    torch.cuda.synchronize()
    reset_counts()
    for i, toks in enumerate(tokens):
        t0 = time.perf_counter()
        out = inference.generate_cropped(toks)
        torch.cuda.synchronize()
        frames = FRAMES_PER_TOKEN * len(toks)
        if out['mel_post'].shape != (80, frames) \
                or not np.isfinite(out['mel_post']).all():
            fail(f'bf16 request {i}: mel_post {out["mel_post"].shape}')
        log(f'  bf16 request {i}: {len(toks)} tokens -> {frames} frames: '
            f'text->mel {(time.perf_counter() - t0) * 1e3:.1f} ms')
    n = len(tokens)
    # per request: prenet, postnet and pitch GRUs (the H=64 predictor GRUs
    # stay loops), LR + LSTM-mel, both highway stacks, the postnet front
    expect_counts('bf16 generate', read_counts(), gru=3 * n, lr_bidir=n,
                  lstm_mel=n, pre_highway_stack=2 * n, cbhg_front=n)

    x = np.zeros((n, max(map(len, tokens))), np.int64)
    for i, toks in enumerate(tokens):
        x[i, :len(toks)] = toks
    reset_counts()
    t0 = time.perf_counter()
    out = inference.generate_routed(x, frame_bucket=SERVING_BUCKET)
    torch.cuda.synchronize()
    lens = out['mel_len'].cpu().numpy()
    groups = len(np.unique(-(-lens // SERVING_BUCKET)))
    log(f'  bf16 generate_routed, {n} requests: {groups} group(s), '
        f'{(time.perf_counter() - t0) * 1e3:.1f} ms')
    if not bool(torch.isfinite(out['mel_post']).all()):
        fail('bf16 generate_routed: non-finite mel_post')
    expect_counts('bf16 generate_routed', read_counts(), gru=1 + 2 * groups,
                  lr_bidir=groups, lstm_mel=groups,
                  pre_highway_stack=2 * groups, cbhg_front=groups)


def bf16_reference_phase(torch, model):
    """Two bench sentences through generate_fused on the card and on the
    CPU plain path, both bf16 (the model's duration head as left by the
    serving phase)."""
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    toks = [Tokenizer()(s) for s in BENCH_SENTENCES[6:]]
    x = np.zeros((len(toks), max(map(len, toks))), np.int64)
    for i, t in enumerate(toks):
        x[i, :len(t)] = t
    gpu = TTSInference(model, dtype='bfloat16', device='cuda')
    got = gpu.generate_fused(x, max_len=SERVING_MAX_LEN)
    cpu = TTSInference(copy.deepcopy(model).cpu(), dtype='bfloat16',
                       device='cpu')
    ref = cpu.generate_fused(x, max_len=SERVING_MAX_LEN)
    if not torch.equal(got['mel_len'].cpu(), ref['mel_len']):
        fail('bf16 reference: mel_len differs between card and CPU')
    err, scale = 0.0, 1.0
    for key in ('mel', 'mel_post'):
        for i, n in enumerate(ref['mel_len'].tolist()):
            g = got[key][i, :n].float().cpu()
            r = ref[key][i, :n].float()
            err = max(err, float((g - r).abs().max()))
            scale = max(scale, float(r.abs().max()))
    ok = err <= E2E_BF16_TOL * scale
    log(f'bf16 reference: generate_fused of {len(toks)} sentences on the '
        f'card vs the CPU plain path, mel/mel_post max abs err {err:.3e}, '
        f'scale {scale:.3e} (tol {E2E_BF16_TOL:g} x scale) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('bf16 serving path disagrees with the CPU plain path')
    return err


# --------------------------------------------------------- CBHG variants

# the CBHG variants' serving routes beside the default: the fields set on
# the model's (prenet, postnet), and each route's launches per
# generate_fused call that differ from the default's
VARIANT_ROUTES = {
    'pool_proj': (dict(fuse_pool_proj=True),
                  dict(fuse_front=False, fuse_pool_proj=True),
                  dict(cbhg_front=0, pool_proj1=2)),
    'pool': (dict(fuse_pool=True), dict(fuse_front=False, fuse_pool=True),
             dict(cbhg_front=0, pool_mask=2))}
VARIANT_ITERS, VARIANT_TRIALS = 2, 3
# the K=16 prenet front through cbhg_front.cu takes ~1/3 s a call
PRENET_FRONT_REPS = 5


def set_cbhg_route(model, route) -> None:
    """Set the CBHG fields of ``route`` (a key of VARIANT_ROUTES, or None
    for the JAX defaults) on the model's prenet and postnet."""
    import inspect

    from forwardtacotron_torch.models.layers import CBHG
    params = inspect.signature(CBHG).parameters
    defaults = {k: params[k].default for k in params if k.startswith(
        ('fuse_', 'stream_'))}
    fields = VARIANT_ROUTES[route][:2] if route else ({}, {})
    for mod, change in zip((model.prenet, model.postnet), fields):
        for name, value in {**defaults, **change}.items():
            setattr(mod, name, value)


def variant_kernel_phase(torch, model, model16, n_tok, n_frames, batch,
                         serving_tok, serving_frames):
    """Rows 11-13 (``highway_stack``, ``pool_proj1``, ``pool_mask``) against
    their twins at full width: bf16 at one serving call's shapes, float32
    at one request's. Each is timed beside its twin and beside a yardstick,
    the plain route the default path takes for the same work (no single
    PyTorch call computes these functions: ``library_ms`` is null)."""
    from forwardtacotron_torch.models.layers import conv1d, maxpool_time
    from forwardtacotron_torch.models.synthesis import bucket_frames
    from forwardtacotron_torch.ops.hopper import cbhg, highway

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def masked(b, t, valid):
        return (torch.arange(t, device=dev) < valid).float().expand(
            b, t).contiguous()

    def check(name, kernel, plain, yardstick, args, flops, nbytes, dtype):
        f32 = dtype == torch.float32
        err = compare(torch, name, kernel(*args).float(),
                      plain(*args).float(), KERNEL_TOL if f32 else BF16_TOL)
        k_ms = time_ms(torch, lambda: kernel(*args))
        parts = {}
        if kernel is cbhg.pool_proj1 and not f32:
            parts = library_parts(torch, 'pool', POOL_PART_DEFINES,
                                  lambda: kernel(*args))
        p_ms = time_ms(torch, lambda: plain(*args))
        y_ms = time_ms(torch, yardstick)
        b_ms, b_by = bound(flops, nbytes,
                           PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
        log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, yardstick '
            f'{y_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); '
            f'{flops / k_ms / 1e9:.1f} TFLOP/s, '
            f'{nbytes / k_ms / 1e9:.1f} TB/s')
        return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                    yardstick_ms=y_ms, bound_ms=b_ms, bound_by=b_by,
                    **({'parts_ms': parts} if parts else {}))

    res = {}
    t_req = bucket_frames(n_frames)
    for name, dtype, b, t, valid in (
            ('pool_mask_bf16', torch.bfloat16, batch, SERVING_MAX_LEN,
             serving_frames),
            ('pool_mask', torch.float32, 1, t_req, n_frames)):
        post = (model16 if dtype == torch.bfloat16 else model).postnet
        kc, p = post.K * post.channels, post.proj1_weight().shape[-1]
        log(f'kernel {name}: postnet concat B={b} T={t} KC={kc} (valid '
            f'{valid}); yardstick maxpool_time + masked_fill')
        x, mask = randn((b, t, kc), dtype), masked(b, t, valid)
        tail = (mask == 0)[:, :, None]
        elt = x.element_size()
        res[name] = check(
            name, cbhg.pool_mask, cbhg.pool_mask_plain,
            lambda: maxpool_time(x).masked_fill(tail, 0.0), (x, mask),
            2 * b * t * kc, 2 * elt * b * t * kc + 4 * b * t, dtype)
        res[name]['at'] = f'postnet concat B={b} T={t} KC={kc}'
        if dtype == torch.float32:
            res[name].update(device_times(
                torch, lambda: cbhg.pool_mask(x, mask), 'pool_mask_kernel'))
            log_device_times('kernel', res[name])
        if dtype == torch.bfloat16:
            # row 12 at the postnet on the same concat
            log(f'kernel pool_proj1_bf16: postnet B={b} T={t} KC={kc} P={p}; '
                'yardstick maxpool_time + masked_fill + cuDNN conv1d')
            log_pool_plan(cbhg, b, t, kc, p)
            parts = [check(
                'postnet', cbhg.pool_proj1, cbhg.pool_proj1_plain,
                lambda: conv1d(maxpool_time(x).masked_fill(tail, 0.0),
                               post.conv_project1.conv),
                (x, mask, post.proj1_weight()), 2 * b * t * 3 * kc * p,
                elt * (b * t * kc + 3 * kc * p + b * t * p) + 4 * b * t,
                dtype)]
        del x, mask, tail

    # row 12: the prenet's concat (no lengths: every frame valid), bf16 at
    # the serving batch, f32 at one request
    for name, dtype, b, t in (('pool_proj1_bf16', torch.bfloat16, batch,
                               serving_tok),
                              ('pool_proj1', torch.float32, 1, n_tok)):
        pre = (model16 if dtype == torch.bfloat16 else model).prenet
        kc, p = pre.K * pre.channels, pre.proj1_weight().shape[-1]
        log(f'kernel {name}: prenet B={b} T={t} KC={kc} P={p}')
        if dtype == torch.bfloat16:
            log_pool_plan(cbhg, b, t, kc, p)
        x, mask = randn((b, t, kc), dtype), masked(b, t, t)
        elt = x.element_size()
        part = check(
            'prenet', cbhg.pool_proj1, cbhg.pool_proj1_plain,
            lambda: conv1d(maxpool_time(x), pre.conv_project1.conv),
            (x, mask, pre.proj1_weight()), 2 * b * t * 3 * kc * p,
            elt * (b * t * kc + 3 * kc * p + b * t * p) + 4 * b * t, dtype)
        if dtype == torch.bfloat16:
            post_parts, pre_parts = (q.pop('parts_ms', {})
                                     for q in (parts[0], part))
            res[name] = sum_levels(parts + [part])
            res[name].update(postnet_ms=parts[0]['ms'], prenet_ms=part['ms'],
                             parts_ms={**{f'postnet_{k}': v
                                          for k, v in post_parts.items()},
                                       **{f'prenet_{k}': v
                                          for k, v in pre_parts.items()}},
                             at=f'one serving call: postnet B={batch} '
                                f'T={SERVING_MAX_LEN} + prenet T={t}')
        else:
            res[name] = dict(part, at=f'one request: prenet T={t}')
        del x, mask

    # row 11: the postnet's rows, bf16 at the serving shape and at one
    # request's budget, f32 at the request's; yardstick the HighwayNetwork
    # chain (nn.Linear)
    for name, dtype, n in (('highway_stack_bf16', torch.bfloat16,
                            batch * SERVING_MAX_LEN),
                           ('highway_stack_bf16_request', torch.bfloat16,
                            t_req),
                           ('highway_stack', torch.float32, t_req)):
        post = (model16 if dtype == torch.bfloat16 else model).postnet
        c, layers_n = post.channels, len(post.highways)
        log(f'kernel {name}: postnet rows N={n} C={c} L={layers_n}; '
            'yardstick the nn.Linear chain')
        x = randn((n, c), dtype)
        w, bias = post.highway_weights()

        def chain():
            y = x
            for hw in post.highways:
                y = hw(y)
            return y
        elt = x.element_size()
        res[name] = check(
            name, highway.highway_stack, highway.highway_stack_plain, chain,
            (x, w, bias), layers_n * 2 * n * c * 2 * c,
            elt * (2 * n * c + layers_n * 2 * c * c) + 4 * layers_n * 2 * c,
            dtype)
        res[name]['at'] = f'postnet rows N={n}'
        del x
    request = res.pop('highway_stack_bf16_request')
    res['highway_stack_bf16'].update(
        {f'request_{k}': request[k]
         for k in ('ms', 'plain_ms', 'bound_ms', 'yardstick_ms')})
    for r in res.values():
        r['library_ms'] = None
    return res


def highways_fused_phase(torch, model, model16, batch, serving_frames,
                         n_frames):
    """``CBHG._highways_fused`` (no caller in ``pre_rnn``, as in JAX) on the
    postnet's post-projection activation, pre_highway(proj2 + residual) of
    a masked mel batch: bf16 at the serving shape, float32 at one request's
    budget; one ``highway_stack`` launch each (counts set to 0 just before,
    read just after) against the plain layer chain. Returns the launches
    per dtype."""
    from forwardtacotron_torch.models.synthesis import bucket_frames
    from forwardtacotron_torch.ops.hopper import cbhg

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    counts = {}
    for dtype, b, t, valid in ((torch.bfloat16, batch, SERVING_MAX_LEN,
                                serving_frames),
                               (torch.float32, 1, bucket_frames(n_frames),
                                n_frames)):
        post = (model16 if dtype == torch.bfloat16 else model).postnet
        mask = (torch.arange(t, device=dev) < valid).float().expand(
            b, t).contiguous()
        tail = (mask == 0)[:, :, None]
        mel = (torch.randn(b, t, 80, generator=gen, device=dev)
               * mask[:, :, None]).to(dtype)
        front = cbhg.bank_pool_proj(*post.front_args(mel, mask))
        h = post.pre_highway(post.conv_project2(front.masked_fill(tail, 0.0))
                             + mel)
        del front
        torch.cuda.synchronize()
        reset_counts()
        got = post._highways_fused(h)
        torch.cuda.synchronize()
        launches = read_counts()
        label = f'_highways_fused {str(dtype)[6:]} B={b} T={t}'
        expect_counts(label, launches, highway_stack=1)
        want = h
        for hw in post.highways:
            want = hw(want)
        f32 = dtype == torch.float32
        compare(torch, f'{label} vs the layer chain', got.float(),
                want.float(), KERNEL_TOL if f32 else E2E_BF16_TOL)
        counts['f32' if f32 else 'bf16'] = launches['highway_stack']
        del h, got, want
    return counts


def variant_serving_phase(torch, model16, config, serving):
    """generate_fused at the serving phase's batch and budget with the CBHG
    variants set on the model's prenet and postnet ("pool_proj": row 12 in
    both, the postnet's front off; "pool": row 13 in both), each with its
    exact launches per call (counts set to 0 just before, read just after)
    and its mel against the default route's, then audio-s/s over
    VARIANT_TRIALS trials of VARIANT_ITERS calls, the routes in turns.
    Restores the defaults. Returns (launches per route, stats)."""
    from forwardtacotron_torch.models.synthesis import TTSInference

    hop, sr = config['dsp']['hop_length'], config['dsp']['sample_rate']
    batch = serving['batch']
    budget = serving['groups'][-1][1]
    inference = TTSInference(model16, dtype='bfloat16', device='cuda')
    xd = serving_requests(torch, batch)
    base = dict(gru_xp=1, lr_bidir=1, lstm_mel=1, gru=1, pre_highway_stack=2,
                cbhg_front=1)
    routes = (None, *VARIANT_ROUTES)
    outs, launches = {}, {}
    for route in routes:
        set_cbhg_route(model16, route)
        inference.generate_fused(xd, max_len=budget)      # warm-up
        torch.cuda.synchronize()
        reset_counts()
        out = inference.generate_fused(xd, max_len=budget)
        torch.cuda.synchronize()
        counts = read_counts()
        name = route or 'default'
        expect_counts(f'serving route {name}', counts,
                      **{**base, **(VARIANT_ROUTES[route][2] if route
                                    else {})})
        launches[name] = counts
        outs[name] = out
    lens = np.minimum(outs['default']['mel_len'].cpu().numpy(), budget)
    frames = int(lens.sum())
    n = int(lens.max())
    if not (lens == n).all():
        fail(f'serving routes: mel_len {np.unique(lens)}, expected one')
    want = outs['default']['mel_post'][:, :n].float()
    scale = max(1.0, float(want.abs().max()))
    errs = {}
    for name in VARIANT_ROUTES:
        got = outs[name]['mel_post'][:, :n].float()
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= E2E_BF16_TOL * scale
        log(f'serving route {name} vs default: mel_post max abs err '
            f'{err:.3e}, scale {scale:.3e} (tol {E2E_BF16_TOL:g} x scale) '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'serving route {name} disagrees with the default route')
        errs[name] = err
    del outs
    rates = {route or 'default': [] for route in routes}
    for _ in range(VARIANT_TRIALS):
        for route in routes:
            set_cbhg_route(model16, route)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(VARIANT_ITERS):
                inference.generate_fused(xd, max_len=budget)
            torch.cuda.synchronize()
            rates[route or 'default'].append(
                VARIANT_ITERS * frames * hop / sr
                / (time.perf_counter() - t0))
    set_cbhg_route(model16, None)
    stats = {name: dict(audio_s_per_s=sorted(r), max_abs_err=errs.get(name))
             for name, r in rates.items()}
    for name, r in rates.items():
        log(f'serving route {name}: audio-s/s min {min(r):.1f} median '
            f'{statistics.median(r):.1f} max {max(r):.1f} '
            f'({VARIANT_TRIALS} trials x {VARIANT_ITERS} calls, batch '
            f'{batch}, budget {budget})')
    return launches, stats


def variant_request_phase(torch, model, tokens):
    """The longest request in float32 through generate_cropped on the card
    with each variant route (counts set to 0 just before, read just after)
    against the same route on the CPU plain path. With "pool_proj" the
    prenet takes row 12 and the postnet, over 512 frames, the plain route,
    as the JAX gate sends it; with "pool" both take row 13. Restores the
    defaults. Returns the launches per route."""
    from forwardtacotron_torch.models.synthesis import TTSInference

    i = max(range(len(tokens)), key=lambda j: len(tokens[j]))
    gpu = TTSInference(model, device='cuda')
    launches = {}
    for route, counts in (('pool_proj', dict(pool_proj1=1)),
                          ('pool', dict(pool_mask=2))):
        set_cbhg_route(model, route)
        gpu.generate_cropped(tokens[i][:8])
        torch.cuda.synchronize()
        reset_counts()
        got = gpu.generate_cropped(tokens[i])
        torch.cuda.synchronize()
        launches[route] = read_counts()
        expect_counts(f'float32 request, route {route}', launches[route],
                      pre_highway_stack=2, lr=1, **counts)
        cpu = TTSInference(copy.deepcopy(model).cpu(), device='cpu')
        ref = cpu.generate_cropped(tokens[i])
        err = max(float(np.abs(got[k] - ref[k]).max())
                  for k in ('mel', 'mel_post'))
        ok = err <= E2E_MEL_ATOL
        log(f'float32 request {i} ({len(tokens[i])} tokens, '
            f'{got["mel"].shape[1]} frames), route {route}: card vs the CPU '
            f'plain path, mel/mel_post max abs err {err:.3e} '
            f'(atol {E2E_MEL_ATOL:g}) {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'float32 route {route} disagrees with the CPU plain path')
    set_cbhg_route(model, None)
    return launches


def prenet_front_phase(torch, model16, batch, serving_tok):
    """The K=16 prenet front at the serving shape through ``cbhg_front.cu``
    (its ``shape_error`` admits it; the JAX weight budget routes it to
    plain convolutions, and so does the port) against the plain route
    (cuDNN bank, pool, mask, cuDNN proj1) and the row 12 route (cuDNN
    bank, ``pool_proj1``): outputs within the bf16 model tolerance, and
    times. The routing stays as it is."""
    from forwardtacotron_torch.models.layers import maxpool_time
    from forwardtacotron_torch.ops.hopper import cbhg

    pre = model16.prenet
    c_in = pre.conv1d_bank[0].conv.in_channels
    p = pre.proj1_weight().shape[-1]
    err = cbhg.shape_error(pre.K, c_in, pre.channels, p)
    if err:
        fail(f'prenet front: cbhg_front.cu refuses it ({err})')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randn(batch, serving_tok, c_in, generator=gen,
                    device=dev).to(torch.bfloat16)
    mask = torch.ones(batch, serving_tok, device=dev)
    routes = {
        'cbhg_front': lambda: cbhg.bank_pool_proj(*pre.front_args(x, mask)),
        'plain': lambda: pre.conv_project1(maxpool_time(pre._bank(x))),
        'pool_proj1': lambda: pre._pool_proj1_fused(pre._bank(x), None)}
    log(f'prenet front K={pre.K} C_in={c_in} C={pre.channels} P={p}, '
        f'B={batch} T={serving_tok}, bf16')
    want = routes['plain']().float()
    res = {}
    for name, fn in routes.items():
        if name != 'plain':
            compare(torch, f'{name} route vs plain route', fn().float(),
                    want, E2E_BF16_TOL)
        res[f'{name}_ms'] = time_ms(torch, fn, reps=PRENET_FRONT_REPS)
    log('prenet front: ' + ', '.join(f'{k} {v:.3f} ms'
                                     for k, v in res.items()))
    return res


# ------------------------------------------------------------- vocoder

# HiFi-GAN v1 at full width (the generator's defaults: 512 initial
# channels, levels of 256, 128, 64 and 32 channels, kernel sizes 3/7/11,
# dilations 1/3/5) with seeded weights; levels of at most this many channels
# (2 and 3) take the fused MRF kernel on the "fused" route, every level
# (fuse_mrf_max_ch=256) on the "fused_all" route
VOCODER_FUSE_MAX_CH = 64
VOCODER_FUSE_ALL_CH = 256
VOCODER_LEVELS = (2, 3)
VOCODER_ALL_LEVELS = (0, 1, 2, 3)
# bench.py's vocoder shape (bench.py:127-150): batch x frames of random
# normal mels, bf16
VOCODER_BATCH, VOCODER_FRAMES = 128, 256
VOCODER_CALLS, VOCODER_TRIALS = 4, 3
# one f32 request vocoded on the card (fused levels, f32 kernel) vs the CPU
# plain path (per-convolution): max abs error over max(1e-3, max |wav|)
E2E_WAV_TOL = 1e-3
VOCODER_KERNEL_NAMES = {
    'mrf': [r'level_kernel<(__nv_bfloat16|float), false']}
# the phase-stacked tail: from the first level of at most this many output
# channels (level 2 of v1), each level is one ups_mrf launch
VOCODER_TAIL_MAX_CH = 64
VOCODER_TAIL_KERNEL_NAMES = {
    'ups_mrf': [r'level_kernel<(__nv_bfloat16|float), true']}
# the channels-major tail: from the first level of at most this many output
# channels (level 2 of v1), each level is a polyphase GEMM (_up_cm) and one
# mrf launch
VOCODER_CM_TAIL_MAX_CH = 64
# the vocoder's routes, timed in turns: (fuse_ups_tail_max_ch,
# fuse_mrf_max_ch, fuse_tail_max_ch)
VOCODER_ROUTES = {'tail': (VOCODER_TAIL_MAX_CH, VOCODER_FUSE_MAX_CH, 0),
                  'cm_tail': (0, 0, VOCODER_CM_TAIL_MAX_CH),
                  'fused': (0, VOCODER_FUSE_MAX_CH, 0),
                  'fused_all': (0, VOCODER_FUSE_ALL_CH, 0),
                  'per_conv': (0, 0, 0)}
# mrf launches per vocoder call on each fused route
VOCODER_MRF_LAUNCHES = {'fused': 2, 'fused_all': 4, 'cm_tail': 2}
# the channels-major tail's bf16 batch against the per-convolution route:
# max abs error over max(1, max |wav|)
CM_TAIL_BF16_TOL = 3e-2
# a GEMM kernel's name in the profiler (cuBLAS's sm90 / nvjet kernels,
# CUTLASS)
GEMM_KERNEL = r'gemm|xmma|nvjet|cutlass'



def seeded_hifigan(torch):
    """A HiFi-GAN v1 generator with weights drawn from SEED (PyTorch's
    default initializers), on the CPU."""
    from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
    torch.manual_seed(SEED)
    return HiFiGANGenerator()


def write_hifigan_checkpoint(torch, path: Path):
    """The seeded v1 generator saved as jik876/hifigan saves it: every conv
    weight-normed (weight_g / weight_v), the state dict under
    'generator'."""
    gen = seeded_hifigan(torch)
    for m in gen.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.utils.weight_norm(m)
    torch.save({'generator': gen.state_dict()}, str(path))


def vocoder_kernel_phase(torch, n_frames):
    """The fused MRF level against its twin on the card at each of v1's
    levels, 0 (C=256, clusters of CTAs), 1 (C=128), 2 (C=64) and 3 (C=32):
    float32 at one request of ``n_frames`` frames, bf16 at bench.py's
    vocoder batch; timed beside the twin and beside the same level as the
    generator's per-convolution path (18 cuDNN convolutions, the route the
    JAX package's default takes), a yardstick the fused path does not call.
    The row's numbers sum levels 2 + 3 (the "fused" route's levels, as in
    earlier readings); every level's are kept under ``levels``. The twin's
    comparison and timing run with cudnn.benchmark on: without it cuDNN
    picks a float32 algorithm for the C=32 dilated convolutions that takes
    seconds per level."""
    from forwardtacotron_torch.ops.hopper import mrf

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    model = seeded_hifigan(torch).to(dev)
    krs = model.resblock_kernel_sizes
    dils = model.resblock_dilation_sizes[0]
    hop_at = {0: 8, 1: 64, 2: 128, 3: 256}  # samples per frame at the level
    res = {}
    for dtype, batch, frames in ((torch.float32, 1, n_frames),
                                 (torch.bfloat16, VOCODER_BATCH,
                                  VOCODER_FRAMES)):
        name = 'mrf' if dtype == torch.float32 else 'mrf_bf16'
        tol = KERNEL_TOL if dtype == torch.float32 else BF16_TOL
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        model.to(dtype)
        parts, levels = [], {}
        for level in VOCODER_ALL_LEVELS:
            c = model.ups[level].out_channels
            t = frames * hop_at[level]
            x = torch.randn(batch, c, t, generator=gen, device=dev).to(dtype)
            weights = model.mrf_weights(level, dtype)
            prep = mrf.prepare(weights, krs, dils)
            args = (x, weights, krs, dils)
            pl = mrf.plan(dtype, c, krs, dils)
            log(f'  {name} level {level}: B={batch} C={c} T={t}')
            log(f'    plan: {pl["cluster"]} CTA(s) of {pl["cs"]} channels '
                f'per tile of {pl["t_tile"]} samples, {pl["stages"]} ring '
                f'stages, {pl["smem"]} bytes of shared memory, '
                f'{pl["threads"]} threads')
            got = mrf.mrf(*args, prepared=prep)
            torch.backends.cudnn.benchmark = True
            err = compare(torch, f'level {level}', got.float(),
                          mrf.mrf_plain(*args).float(), tol)
            p_ms = time_ms(torch, lambda: mrf.mrf_plain(*args), reps=3)
            torch.backends.cudnn.benchmark = False
            k_ms = time_ms(torch, lambda: mrf.mrf(*args, prepared=prep))
            w_ms = time_ms(torch, lambda: mrf.prepare(weights, krs, dils),
                           reps=5)
            blocks = model.resblocks[3 * level:3 * level + 3]
            y_ms = time_ms(torch, lambda: (blocks[0](x) + blocks[1](x)
                                           + blocks[2](x)) / 3)
            elt = x.element_size()
            flops = 2 * c * c * 2 * len(dils) * sum(krs) * t * batch
            nbytes = elt * (2 * batch * c * t
                            + sum(w.numel() for w in weights))
            b_ms, b_by = bound(flops, nbytes, peak)
            log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, 18 cuDNN '
                f'convolutions {y_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); '
                f'{flops / k_ms / 1e9:.1f} TFLOP/s; preparing the weights '
                f'{w_ms:.4f} ms')
            part = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                        cudnn_level_ms=y_ms, bound_ms=b_ms, bound_by=b_by,
                        prepare_ms=w_ms)
            levels[f'level{level}_C{c}'] = dict(part, t_tile=pl['t_tile'],
                                                cluster=pl['cluster'])
            if level in VOCODER_LEVELS:
                parts.append(part)
        res[name] = sum_levels(parts)
        res[name].update(library_ms=None, levels=levels, at=(
            f'HiFi-GAN v1 levels 2 + 3 (C=64, 32), B={batch}, {frames} '
            'frames, summed; every level under levels'))
    return res


# levels past HiFi-GAN's three kernel sizes and three dilations, within the
# halo: (label, C, kernel sizes, dilations); bf16 at MRF_LONG_BATCH items
# of v1 level 2's samples, float32 at one request's
MRF_LONG_LISTS = (('10 kernel sizes', 64, tuple(range(2, 12)), (1, 3, 5)),
                  ('9 dilations', 32, (3, 5), (1, 2) * 4 + (1,)))
MRF_LONG_BATCH = 16


def mrf_long_lists_phase(torch, n_frames) -> dict:
    """The fused MRF level against its twin at MRF_LONG_LISTS (more kernel
    sizes or dilations than v1's), float32 at one request of ``n_frames``
    frames and bf16 at MRF_LONG_BATCH x VOCODER_FRAMES frames (v1 level
    2's 128 samples a frame), timed beside the twin (with
    cudnn.benchmark); returns per dtype name ('mrf', 'mrf_bf16') the
    results per label."""
    from forwardtacotron_torch.ops.hopper import mrf
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    res = {'mrf': {}, 'mrf_bf16': {}}
    for label, c, krs, dils in MRF_LONG_LISTS:
        for dtype, batch, frames in ((torch.float32, 1, n_frames),
                                     (torch.bfloat16, MRF_LONG_BATCH,
                                      VOCODER_FRAMES)):
            name = 'mrf' if dtype == torch.float32 else 'mrf_bf16'
            f32 = dtype == torch.float32
            t = frames * 128

            def randn(shape, scale=1.0):
                return (torch.randn(shape, generator=gen, device=dev)
                        * scale).to(dtype)
            x = randn((batch, c, t))
            weights = tuple(
                w for kr in krs for _ in range(2)
                for w in (randn((len(dils), c, kr * c), (kr * c) ** -0.5),
                          randn((len(dils), c, 1), 0.1)))
            prep = mrf.prepare(weights, krs, dils)
            pl = mrf.plan(dtype, c, krs, dils)
            log(f'  {name} {label}: B={batch} C={c} T={t} kernel sizes '
                f'{krs} dilations {dils}; plan: {pl["cluster"]} CTA(s) of '
                f'{pl["cs"]} channels per tile of {pl["t_tile"]} samples, '
                f'{pl["stages"]} ring stages, {pl["smem"]} bytes of shared '
                'memory')
            before = mrf.launches
            got = mrf.mrf(x, weights, krs, dils, prepared=prep)
            if mrf.launches != before + 1:
                fail(f'{name} {label}: no mrf launch')
            torch.backends.cudnn.benchmark = True
            err = compare(torch, f'{label}', got.float(),
                          mrf.mrf_plain(x, weights, krs, dils).float(),
                          KERNEL_TOL if f32 else BF16_TOL)
            p_ms = time_ms(torch, lambda: mrf.mrf_plain(x, weights, krs,
                                                        dils), reps=3)
            torch.backends.cudnn.benchmark = False
            k_ms = time_ms(torch, lambda: mrf.mrf(x, weights, krs, dils,
                                                  prepared=prep))
            flops = 2 * c * c * 2 * len(dils) * sum(krs) * t * batch
            b_ms, b_by = bound(flops, x.element_size() * (
                2 * batch * c * t + sum(w.numel() for w in weights)),
                PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
            log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound '
                f'{b_ms:.4f} ms ({b_by}); {flops / k_ms / 1e9:.1f} TFLOP/s')
            res[name][label] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    at=f'B={batch} C={c} T={t} krs={krs} '
                                    f'dils={dils}')
            del x, got
    return res


# shapes the JAX generator sends to its Pallas kernels past the kernels'
# first limits (Queue 3, settled in tests/test_torch_mrf_gaps.py), each
# with its dtypes: a level of 1-tap convolutions with 40 dilations; levels
# past 256 channels within the Pallas kernel's VMEM (the wide form: C 512
# of (3,) x (1, 3, 5) in bf16, a cluster of 8; C 1,024 of 1-tap
# convolutions, 16; C 1,061 in bf16, 9 CTAs of 128 channels); 33 kernel
# sizes; tail levels whose upsamplers reach past IN_HALO input rows (34 and
# 66 taps), one of C_in = 2 C + 1, and those whose input tile loads in
# chunks of input channels (C 256 behind 513 in f32; C 512 behind 1,024 in
# the wide form)
BOTH = ('float32', 'bfloat16')
KRS_V1, DILS_V1 = (3, 7, 11), (1, 3, 5)
MRF_GAP_LEVELS = (('one-tap level, 40 dilations', 32, (1,),
                   tuple(range(1, 41)), BOTH),
                  ('C 512, (3,) x 3', 512, (3,), DILS_V1, ('bfloat16',)),
                  ('C 1,024, 1-tap', 1024, (1,), (1,), BOTH),
                  ('C 1,061, (3,) x 1', 1061, (3,), (1,), ('bfloat16',)),
                  ('33 kernel sizes', 64,
                   tuple((3, 5, 1, 7)[i % 4] for i in range(33)), (1, 2),
                   BOTH))
UPS_GAP_LEVELS = (('34 taps', 1, 2, 34, 64, 32, KRS_V1, DILS_V1, BOTH),
                  ('66 taps', 2, 2, 66, 64, 32, KRS_V1, DILS_V1, BOTH),
                  ('C_in = 2 C + 1', 1, 2, 4, 65, 32, KRS_V1, DILS_V1, BOTH),
                  ('C 256 behind 513', 1, 2, 4, 513, 256, (3,), DILS_V1,
                   BOTH),
                  ('C 512 behind 1,024', 1, 2, 4, 1024, 512, (3,), DILS_V1,
                   ('bfloat16',)))
GAP_BATCH, GAP_SAMPLES = 8, 16384


def mrf_gap_shapes_phase(torch) -> dict:
    """``mrf`` and ``ups_mrf`` against their twins at MRF_GAP_LEVELS and
    UPS_GAP_LEVELS, GAP_BATCH items of GAP_SAMPLES output samples, one
    launch each, each timed beside its twin and logged with its plan and
    bound; then a level past the Pallas kernel's VMEM (v1's branch set at
    512 channels) must raise before any launch. Returns {'mrf': {label:
    {dtype: result}}, 'ups_mrf': {...}}."""
    from forwardtacotron_torch.ops.hopper import mrf, ups_mrf
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    res = {'mrf': {}, 'ups_mrf': {}}

    def randn(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def branch_weights(c, krs, n_units, dtype, bias_dtype):
        return tuple(w for kr in krs for _ in range(2)
                     for w in (randn((n_units, c, kr * c), (kr * c) ** -0.5,
                                     dtype),
                               randn((n_units, c, 1), 0.1, bias_dtype)))

    def check(kind, label, dtype, run, plain, counter, at, pl, flops,
              nbytes):
        name = str(dtype).replace('torch.', '')
        log(f'  {kind} {label} ({name}): {at}; plan: {pl["cluster"]} CTA(s) '
            f'of {pl["cs"]} channels ({"wide" if pl["wide"] else "narrow"}),'
            f' tile {pl["t_tile"]}, {pl["stages"]} ring stages, input tile '
            f'in {pl["groups"]} chunk(s), {pl["smem"]} bytes')
        before = counter()
        got = run()
        if counter() != before + 1:
            fail(f'{kind} {label}: no launch')
        err = compare(torch, f'{kind} {label} ({name})', got.float(),
                      plain().float(),
                      KERNEL_TOL if dtype == torch.float32 else BF16_TOL)
        k_ms, p_ms = time_ms(torch, run), time_ms(torch, plain, reps=3)
        b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS
                           if dtype == torch.float32 else PEAK_BF16_FLOPS)
        log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound '
            f'{b_ms:.4f} ms ({b_by}); {flops / k_ms / 1e9:.1f} TFLOP/s')
        res[kind].setdefault(label, {})[name] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, at=at, plan=dict(
                cs=pl['cs'], cluster=pl['cluster'], t_tile=pl['t_tile'],
                stages=pl['stages'], wide=pl['wide'], groups=pl['groups'],
                smem=pl['smem']))

    t0 = time.perf_counter()
    for label, c, krs, dils, dtypes in MRF_GAP_LEVELS:
        for dtype in (getattr(torch, d) for d in dtypes):
            x = randn((GAP_BATCH, c, GAP_SAMPLES), 1.0, dtype)
            weights = branch_weights(c, krs, len(dils), dtype, dtype)
            prep = mrf.prepare(weights, krs, dils)
            flops = (2 * c * c * 2 * len(dils) * sum(krs) * GAP_SAMPLES
                     * GAP_BATCH)
            nbytes = x.element_size() * (2 * x.numel() + sum(
                w.numel() for w in weights))
            check('mrf', label, dtype,
                  lambda: mrf.mrf(x, weights, krs, dils, prepared=prep),
                  lambda: mrf.mrf_plain(x, weights, krs, dils),
                  lambda: mrf.launches,
                  f'B={GAP_BATCH} C={c} T={GAP_SAMPLES} {len(krs)} kernel '
                  f'sizes {krs[:4]}, {len(dils)} dilations',
                  mrf.plan(dtype, c, krs, dils), flops, nbytes)
            del x, weights, prep
    for label, s_in, s_up, k, c_in, c, krs, dils, dtypes in UPS_GAP_LEVELS:
        for dtype in (getattr(torch, d) for d in dtypes):
            t_ps = GAP_SAMPLES // (s_in * s_up)
            x = randn((GAP_BATCH, s_in * c_in, t_ps), 1.0, dtype)
            up_w = randn((k, c, c_in), (k * c_in / s_up) ** -0.5, dtype)
            up_b = randn((c,), 0.1, torch.float32)
            weights = branch_weights(c, krs, len(dils), dtype,
                                     torch.float32)
            args = (x, up_w, up_b, weights, s_in, s_up, krs, dils, t_ps - 5)
            prep = ups_mrf.prepare(*args[1:8])
            flops = GAP_BATCH * GAP_SAMPLES * (
                2 * c * c * 2 * len(dils) * sum(krs) + 2 * c_in * c * k
                // s_up)
            nbytes = (x.element_size() * (
                x.numel() + GAP_BATCH * s_in * s_up * c * t_ps
                + up_w.numel() + sum(w.numel() for w in weights[0::2]))
                + 4 * (up_b.numel() + sum(w.numel() for w in weights[1::2])))
            check('ups_mrf', label, dtype,
                  lambda: ups_mrf.ups_mrf(*args, prepared=prep),
                  lambda: ups_mrf.ups_mrf_plain(*args),
                  lambda: ups_mrf.launches,
                  f'B={GAP_BATCH} s_in={s_in} s_up={s_up} k_up={k} '
                  f'C_in={c_in} C={c} T_ps={t_ps} kernel sizes {krs}',
                  ups_mrf.plan(dtype, s_in, s_up, c_in, c, k, krs, dils),
                  flops, nbytes)
            del x, weights, prep, args
    # past the count: raised before any launch, never plain operations
    x = randn((1, 512, 64), 1.0, torch.bfloat16)
    weights = branch_weights(512, KRS_V1, 3, torch.bfloat16, torch.bfloat16)
    before = mrf.launches
    try:
        mrf.mrf(x, weights, KRS_V1, DILS_V1)
        fail('mrf: a v1 level of 512 channels launched past the Pallas count')
    except ValueError as e:
        if 'Pallas' not in str(e) or mrf.launches != before:
            fail(f'mrf: a v1 level of 512 channels: {e}')
        log(f'  past the count, raised before any launch: {str(e)[:160]}')
    log(f'  shapes past the first limits: '
        f'{time.perf_counter() - t0:.1f} s')
    return res


def sum_levels(parts):
    """Per-level results summed over the levels: the largest error, the
    first level's bound_by, every time summed."""
    return {k: (max(p[k] for p in parts) if k == 'max_abs_err'
                else parts[0][k] if k == 'bound_by'
                else sum(p[k] for p in parts)) for k in parts[0]}


def ups_kernel_phase(torch, n_frames):
    """The phase-stacked tail's level (``ups_mrf``: leaky, upsample by 2,
    MRF) against its twin on the card at v1's levels 2 (s_in 1, C_in 128 ->
    C 64) and 3 (s_in 2, C_in 64 -> C 32): float32 at one request of
    ``n_frames`` frames, bf16 at bench.py's vocoder batch; timed beside the
    twin (with cudnn.benchmark, as above), beside the same level on the
    fused-level route (cuDNN's transposed convolution and bias, leaky,
    ``mrf.cu``: the yardstick) and beside the level per convolution, both
    from the sample-ordered input."""
    from forwardtacotron_torch.models.vocoder import leaky_relu
    from forwardtacotron_torch.ops.hopper import mrf, ups_mrf

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    model = seeded_hifigan(torch).to(dev)
    krs = model.resblock_kernel_sizes
    dils = model.resblock_dilation_sizes[0]
    res = {}
    for dtype, batch, frames in ((torch.float32, 1, n_frames),
                                 (torch.bfloat16, VOCODER_BATCH,
                                  VOCODER_FRAMES)):
        name = 'ups_mrf' if dtype == torch.float32 else 'ups_mrf_bf16'
        tol = KERNEL_TOL if dtype == torch.float32 else BF16_TOL
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        model.to(dtype)
        t_ps = frames * 64            # lanes: samples per frame at level 2
        parts, s_in = [], 1
        for level in VOCODER_LEVELS:
            up = model.ups[level]
            c_in, c, k_up = up.in_channels, up.out_channels, up.kernel_size[0]
            s_up = model.upsample_rates[level]
            x = torch.randn(batch, s_in * c_in, t_ps, generator=gen,
                            device=dev).to(dtype)
            up_w, up_b, *weights = model.ups_mrf_weights(level, dtype)
            args = (x, up_w, up_b, tuple(weights), s_in, s_up, krs, dils,
                    t_ps)
            prep = ups_mrf.prepare(*args[1:8])
            log(f'  {name} level {level}: B={batch} s_in={s_in} C_in={c_in} '
                f'C={c} T_ps={t_ps}')
            got = ups_mrf.ups_mrf(*args, prepared=prep)
            torch.backends.cudnn.benchmark = True
            err = compare(torch, f'level {level}', got.float(),
                          ups_mrf.ups_mrf_plain(*args).float(), tol)
            p_ms = time_ms(torch, lambda: ups_mrf.ups_mrf_plain(*args),
                           reps=3)
            torch.backends.cudnn.benchmark = False
            k_ms = time_ms(torch, lambda: ups_mrf.ups_mrf(*args,
                                                          prepared=prep))
            w_ms = time_ms(torch, lambda: ups_mrf.prepare(*args[1:8]),
                           reps=5)
            x_nat = ups_mrf.phase_unstack(x, s_in).contiguous()
            mrf_w = model.mrf_weights(level, dtype)
            mrf_prep = mrf.prepare(mrf_w, krs, dils)
            blocks = model.resblocks[3 * level:3 * level + 3]

            def fused_level():
                return mrf.mrf(up(leaky_relu(x_nat, 0.1)), mrf_w, krs, dils,
                               prepared=mrf_prep)

            def per_conv_level():
                u = up(leaky_relu(x_nat, 0.1))
                return (blocks[0](u) + blocks[1](u) + blocks[2](u)) / 3

            f_ms = time_ms(torch, fused_level)
            y_ms = time_ms(torch, per_conv_level)
            t_out = s_in * s_up * t_ps
            flops = batch * t_out * (2 * c * c * 2 * len(dils) * sum(krs)
                                     + 2 * c_in * c * k_up // s_up)
            nbytes = (x.element_size() * (
                batch * (s_in * c_in + s_in * s_up * c) * t_ps
                + up_w.numel() + sum(w.numel() for w in weights[0::2]))
                + 4 * (up_b.numel() + sum(w.numel() for w in weights[1::2])))
            b_ms, b_by = bound(flops, nbytes, peak)
            log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, fused-level '
                f'route {f_ms:.4f} ms, per convolution {y_ms:.4f} ms, bound '
                f'{b_ms:.4f} ms ({b_by}); {flops / k_ms / 1e9:.1f} TFLOP/s; '
                f'preparing the weights {w_ms:.4f} ms')
            parts.append(dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              fused_level_ms=f_ms, cudnn_level_ms=y_ms,
                              bound_ms=b_ms, bound_by=b_by, prepare_ms=w_ms))
            s_in *= s_up
        res[name] = sum_levels(parts)
        res[name].update(library_ms=None, at=(
            f'HiFi-GAN v1 levels 2 + 3 (C_in 128 -> C 64, s_in 1; C_in 64 -> '
            f'C 32, s_in 2), B={batch}, {frames} frames, summed'))
    return res


# the cycle spans of mrf.cu's bf16 entries (mrf.cu CycleSpan order)
MRF_CYCLES_DEFINES = ('MRF_CYCLES',)
MRF_CYCLE_SPANS = ('ring_wait', 'products', 'epilogues', 'cluster_sync',
                   'branch_start', 'kernel_to_output', 'producer_empty_wait',
                   'producer_cluster_wait')


def mrf_cycles_phase(torch):
    """Where one CTA of ``mrf.cu``'s bf16 entries spends its cycles: the
    copy of the library built with ``-DMRF_CYCLES`` runs the MRF level at
    each of v1's levels and the tail's level at levels 2-3, bf16 batch
    VOCODER_BATCH x VOCODER_FRAMES frames (seeded random weights, prepared
    once), through the wrappers with that library's entries bound in their
    place for this phase. Thread 0 of CTA (0, 0) sums its clock64() cycles
    per span: waiting for a ring stage, the products (ring waits included),
    the epilogues, the barriers after each convolution, the branch starts,
    the whole kernel up to its output, and the producer warp's waits for a
    free slot and for the barrier before the next product. The epilogue
    span bounds what overlapping the epilogues with the products could
    save."""
    import ctypes

    from forwardtacotron_torch.ops.hopper import build, mrf, ups_mrf

    lib = build.library('mrf', MRF_CYCLES_DEFINES)
    lib.mrf_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.mrf_cycles.restype = ctypes.c_int
    bound = {}
    for mod, entry in ((mrf, 'mrf_bf16'), (ups_mrf, 'ups_mrf_bf16')):
        fn, real = getattr(lib, entry), mod._kernel(torch.bfloat16)
        fn.argtypes, fn.restype = real.argtypes, real.restype
        bound[mod] = fn
    dev = torch.device('cuda')
    dev_index = torch.cuda.current_device()
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    model = seeded_hifigan(torch).to(dev).to(torch.bfloat16)
    krs = model.resblock_kernel_sizes
    dils = model.resblock_dilation_sizes[0]
    frames, batch = VOCODER_FRAMES, VOCODER_BATCH
    h = (ctypes.c_ulonglong * len(MRF_CYCLE_SPANS))()

    def spans(label, fn):
        fn()
        torch.cuda.synchronize()
        build.check(lib.mrf_cycles(h, 1, dev_index), 'mrf_cycles')
        fn()
        torch.cuda.synchronize()
        build.check(lib.mrf_cycles(h, 0, dev_index), 'mrf_cycles')
        total = h[MRF_CYCLE_SPANS.index('kernel_to_output')]
        out = {n: int(h[i]) for i, n in enumerate(MRF_CYCLE_SPANS)}
        log(f'  {label}: ' + ', '.join(
            f'{n} {v} ({100 * v / max(total, 1):.1f}%)'
            for n, v in out.items()))
        return out

    res = {}
    saved = mrf._kernel, ups_mrf._kernel
    mrf._kernel = lambda dtype: bound[mrf]
    ups_mrf._kernel = lambda dtype: bound[ups_mrf]
    try:
        for level, hop in ((0, 8), (1, 64), (2, 128), (3, 256)):
            c = model.ups[level].out_channels
            x = torch.randn(batch, c, frames * hop, generator=g,
                            device=dev).to(torch.bfloat16)
            w = model.mrf_weights(level, torch.bfloat16)
            prep = mrf.prepare(w, krs, dils)
            res[f'mrf_C{c}'] = spans(
                f'mrf C={c} T={frames * hop}',
                lambda: mrf.mrf(x, w, krs, dils, prepared=prep))
        s_in, t_ps = 1, frames * 64
        for level in VOCODER_LEVELS:
            up = model.ups[level]
            c_in, c = up.in_channels, up.out_channels
            s_up = model.upsample_rates[level]
            x = torch.randn(batch, s_in * c_in, t_ps, generator=g,
                            device=dev).to(torch.bfloat16)
            up_w, up_b, *w = model.ups_mrf_weights(level, torch.bfloat16)
            args = (up_w, up_b, tuple(w), s_in, s_up, krs, dils)
            prep = ups_mrf.prepare(*args)
            res[f'ups_mrf_C{c}'] = spans(
                f'ups_mrf C={c} s_in={s_in} T_ps={t_ps}',
                lambda: ups_mrf.ups_mrf(x, *args, t_ps, prepared=prep))
            s_in *= s_up
    finally:
        mrf._kernel, ups_mrf._kernel = saved
    return res


def set_route(model, route: str) -> None:
    (model.fuse_ups_tail_max_ch, model.fuse_mrf_max_ch,
     model.fuse_tail_max_ch) = VOCODER_ROUTES[route]


def vocoder_path_phase(torch, model16, config, tokens, root: Path):
    """The vocoder path through its entry points: a jik876-format v1
    checkpoint loaded by ``Vocoder.from_checkpoint``, bf16
    ``generate_routed(vocoder=)`` on the 4 requests with the fused levels 2-3
    (2 mrf launches per routed group), with every level fused
    (``fuse_mrf_max_ch=256``: 4 mrf launches per group) and with the tail
    (2 ups_mrf launches per group, no mrf), one f32 request on the card vs
    the CPU plain path on each, then vocoder throughput at bench.py's shape
    on the four routes (and per convolution) in turns, the profiler and the
    idle share."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from forwardtacotron_torch.models.synthesis import TTSInference, Vocoder

    path = root / 'g_02500000'
    write_hifigan_checkpoint(torch, path)
    hop, sr = 256, config['dsp']['sample_rate']
    voc = Vocoder.from_checkpoint(str(path), dtype='bfloat16', device='cuda')
    inference = TTSInference(set_frames_per_token(torch, model16,
                                                  FRAMES_PER_TOKEN),
                             dtype='bfloat16', device='cuda')
    n = len(tokens)
    x = np.zeros((n, max(map(len, tokens))), np.int64)
    for i, toks in enumerate(tokens):
        x[i, :len(toks)] = toks
    routed, wavs = {}, {}
    fused_routes = (('fused', 'mrf'), ('fused_all', 'mrf'), ('tail', 'ups_mrf'),
                    ('cm_tail', 'mrf'))
    for route, kernel in fused_routes:
        set_route(voc.model, route)
        inference.generate_routed(x, vocoder=voc)     # warm-up, same shapes
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = inference.generate_routed(x, vocoder=voc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        lens = out['mel_len'].cpu().numpy()
        groups = len(np.unique(-(-lens // 128)))
        per_call = VOCODER_MRF_LAUNCHES.get(route, 2)
        expect_counts(f'bf16 generate_routed + vocoder ({route})', launches,
                      gru=1 + 2 * groups, lr_bidir=groups, lstm_mel=groups,
                      pre_highway_stack=2 * groups, cbhg_front=groups,
                      **{kernel: per_call * groups})
        wav, wav_len = out['wav'], out['wav_len'].cpu().numpy()
        if not (np.array_equal(wav_len, lens * hop)
                and wav.shape[1] == -(-int(lens.max()) // 128) * 128 * hop
                and bool(torch.isfinite(wav).all())):
            fail(f'vocoder path ({route}): wav {tuple(wav.shape)}, wav_len '
                 f'{wav_len}, mel_len {lens}')
        log(f'vocoder path ({route}): {n} requests, {groups} routed '
            f'group(s), text -> wav {wall * 1e3:.1f} ms, '
            f'{int(wav_len.sum()) / sr:.2f} s of audio')
        routed[route], wavs[route] = launches[kernel], wav.float()
    for route in ('tail', 'fused_all', 'cm_tail'):
        log(f'vocoder path: bf16 wav, {route} vs fused levels, max abs diff '
            f'{float((wavs[route] - wavs["fused"]).abs().max()):.3e}')

    # one f32 request: card (fused levels or tail, f32 kernels) vs the CPU
    # plain path (per convolution)
    i = int(np.argmin(lens))
    mel = out['mel_post'][i:i + 1, :int(lens[i])].float()
    ref = Vocoder.from_checkpoint(str(path), dtype='float32',
                                  device='cpu')(mel.cpu())
    scale = max(1e-3, float(ref.abs().max()))
    voc32 = Vocoder.from_checkpoint(str(path), dtype='float32',
                                    device='cuda')
    request, errs = {}, {}
    for route, kernel in fused_routes:
        set_route(voc32.model, route)
        reset_counts()
        got = voc32(mel)
        torch.cuda.synchronize()
        launches32 = read_counts()
        expect_counts(f'f32 vocoder request ({route})', launches32,
                      **{kernel: VOCODER_MRF_LAUNCHES.get(route, 2)})
        err = float((got.cpu() - ref).abs().max())
        ok = err <= E2E_WAV_TOL * scale and got.shape == (1,
                                                          int(lens[i]) * hop)
        log(f'vocoder reference ({route}): f32 request {i} ({int(lens[i])} '
            f'frames) on the card vs the CPU plain path, max abs err '
            f'{err:.3e}, peak {scale:.3e} (tol {E2E_WAV_TOL:g} x peak) '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'f32 vocoder ({route}) disagrees with the CPU plain path')
        request[route], errs[route] = launches32[kernel], err

    # throughput at bench.py's shape, the routes in turns
    mel = torch.randn(VOCODER_BATCH, VOCODER_FRAMES, config['dsp']['num_mels'],
                      generator=torch.Generator().manual_seed(SEED)).cuda()
    audio_s = VOCODER_BATCH * VOCODER_FRAMES * hop / sr
    rates = {route: [] for route in VOCODER_ROUTES}
    for route in rates:
        set_route(voc.model, route)
        voc(mel)
    torch.cuda.synchronize()
    # the channels-major tail's batch against the per-convolution route:
    # 2 mrf launches a call, no ups_mrf
    set_route(voc.model, 'per_conv')
    want = voc(mel).float()
    set_route(voc.model, 'cm_tail')
    reset_counts()
    got = voc(mel).float()
    torch.cuda.synchronize()
    expect_counts('bf16 vocoder call (cm_tail)', read_counts(),
                  mrf=VOCODER_MRF_LAUNCHES['cm_tail'])
    cm_err = float((got - want).abs().max())
    cm_scale = max(1.0, float(want.abs().max()))
    ok = bool(torch.isfinite(got).all()) \
        and cm_err <= CM_TAIL_BF16_TOL * cm_scale
    log(f'vocoder cm_tail: bf16 batch {VOCODER_BATCH} x {VOCODER_FRAMES} vs '
        f'the per-convolution route, max abs err {cm_err:.3e}, scale '
        f'{cm_scale:.3e} (tol {CM_TAIL_BF16_TOL:g} x scale) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('the channels-major tail disagrees with the per-convolution '
             'route')
    del want, got
    with torch.inference_mode():
        up_cm = up_cm_times(torch, voc.model, mel)
    for _ in range(VOCODER_TRIALS):
        for route in rates:
            set_route(voc.model, route)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(VOCODER_CALLS):
                voc(mel)
                torch.cuda.synchronize()
            rates[route].append(VOCODER_CALLS * audio_s
                                / (time.perf_counter() - t0))
    stats = {'batch': VOCODER_BATCH, 'frames': VOCODER_FRAMES,
             'audio_s_per_call': audio_s}
    for route, table, names in (
            ('fused', 'chip_smoke_vocoder_profile.txt', VOCODER_KERNEL_NAMES),
            ('fused_all', 'chip_smoke_vocoder_all_profile.txt',
             VOCODER_KERNEL_NAMES),
            ('tail', 'chip_smoke_vocoder_tail_profile.txt',
             VOCODER_TAIL_KERNEL_NAMES),
            ('cm_tail', 'chip_smoke_vocoder_cm_tail_profile.txt',
             VOCODER_KERNEL_NAMES)):
        set_route(voc.model, route)
        # the first call is the profiler's warm-up, not recorded: a trace
        # of a lone call lost its first ~40 ms on the every-level route (a
        # few of the warm-up's kernels may still land in the trace)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                voc(mel)
                torch.cuda.synchronize()
                prof.step()
        busy_ms = device_profile(prof, f'bf16 vocoder call ({route})', table,
                                 names)
        recorded = sum(e.count for e in prof.key_averages()
                       if any(re.search(n, e.key)
                              for ns in names.values() for n in ns))
        expected = VOCODER_MRF_LAUNCHES.get(route, 2)
        call_ms = audio_s / statistics.median(rates[route]) * 1e3
        idle = 1 - busy_ms / call_ms if recorded == expected else None
        # the fused route keeps the key names of the earlier readings
        sfx = '' if route == 'fused' else f'_{route}'
        stats.update({f'call_ms_{route}': call_ms,
                      f'device_busy_ms{sfx}': busy_ms, f'idle{sfx}': idle})
        log(f'vocoder {route}: {call_ms:.2f} ms per call (median), device '
            f'busy {busy_ms:.2f} ms (profiled call, {recorded} of '
            f'{expected} MRF launches recorded): idle '
            + (f'{100 * idle:.1f}%' if idle is not None
               else 'not measured (the trace is incomplete)'))
    for route, label in (('tail', 'phase-stacked tail, levels 2-3'),
                         ('cm_tail', 'channels-major tail, levels 2-3'),
                         ('fused', 'fused levels 2-3'),
                         ('fused_all', 'fused at every level'),
                         ('per_conv', 'per-convolution')):
        r = rates[route]
        stats[f'audio_s_per_s_{route}'] = sorted(r)
        log(f'vocoder {label}: batch {VOCODER_BATCH} x {VOCODER_FRAMES} '
            f'frames bf16, {VOCODER_TRIALS} trials x {VOCODER_CALLS} calls: '
            f'audio-s/s min {min(r):.1f} median {statistics.median(r):.1f} '
            f'max {max(r):.1f}')
    stats.update(card_vs_cpu_err=errs['fused'],
                 card_vs_cpu_err_tail=errs['tail'],
                 card_vs_cpu_err_fused_all=errs['fused_all'],
                 card_vs_cpu_err_cm_tail=errs['cm_tail'],
                 cm_tail_vs_per_conv_bf16_err=cm_err, up_cm=up_cm)
    return routed, request, stats


def up_cm_times(torch, model, mel) -> dict:
    """The channels-major tail's upsamplers (``_up_cm``: shifted copies,
    one GEMM, the phase interleave) at the tail's levels of a bf16 call at
    ``mel``'s shape: per level the CUDA-event time (median of REPS), and
    from the profiler the device time of all its kernels and of its GEMM
    alone, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.models.vocoder import leaky_relu

    out = {}
    x = model.conv_pre(mel.to(torch.bfloat16).transpose(1, 2))
    for i in range(len(model.ups)):
        if i >= 2:        # v1's levels 2-3, the tail of fuse_tail_max_ch 64
            def call(x=x, i=i):
                return model._up_cm(leaky_relu(x, 0.1), i)
            r = {'ms': time_ms(torch, call, reps=5)}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
            dev_events = [e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA]
            r['device_ms'] = sum(e.self_device_time_total
                                 for e in dev_events) / 3e3
            r['gemm_device_ms'] = sum(
                e.self_device_time_total for e in dev_events
                if re.search(GEMM_KERNEL, e.key)) / 3e3
            r['shape'] = list(x.shape)
            out[f'level {i}'] = r
            log(f'  _up_cm level {i}: input {list(x.shape)} bf16: '
                f'{r["ms"]:.3f} ms (events), device {r["device_ms"]:.3f} ms, '
                f'of which the GEMM {r["gemm_device_ms"]:.3f} ms')
        x = model.ups[i](leaky_relu(x, 0.1))
    return out


# ------------------------------------------------------------ FastPitch

# the long request: 256 tokens of 17 frames (4,352 frames), past the
# blockwise attention's default threshold (2048 frames)
FP_LONG_TOKENS, FP_LONG_FRAMES = 256, 17
# a threshold no request reaches: the full attention path
FP_FULL_ATTENTION_T = 100000
# the long request's blockwise attention against its full path (float32):
# max abs error over max(1, max |mel|)
FP_BLOCKWISE_TOL = 1e-4
# the bf16 serving call's slice held against the CPU path
FP_CHECK_BATCH = 8
# row 8 at FastPitch's width (d_model 256): (label, B, N, T, dtype, frames
# a token). In bfloat16 the JAX package's FastPitch (so the port's) expands
# float32 tokens: its positional table is a float32 constant that promotes
# the transformer's activations; the bf16 shape is timed for the plan.
FP_LR_C = 256
FP_LR_SHAPES = (('FastPitch serving f32', SERVING_BATCH, 81, 256, 'float32',
                 SERVING_FRAMES_PER_TOKEN),
                ('FastPitch serving bf16', SERVING_BATCH, 81, 256,
                 'bfloat16', SERVING_FRAMES_PER_TOKEN),
                ('FastPitch request f32', 1, 92, 896, 'float32',
                 FRAMES_PER_TOKEN))


def fast_pitch_config(config):
    cfg = copy.deepcopy(config)
    cfg['tts_model'] = 'fast_pitch'
    return cfg


def make_fast_pitch(torch, config):
    """FastPitch at the full width of ``configs/singlespeaker.yaml``'s
    fast_pitch section (d_model 256, 4 + 4 FFT blocks of 1024, predictors
    of 128), seeded weights (PyTorch's initializers), on the CPU, with a
    duration head that gives every token FRAMES_PER_TOKEN frames."""
    from forwardtacotron_torch.models.registry import init_tts_model
    torch.manual_seed(SEED)
    model = init_tts_model(fast_pitch_config(config))
    return set_frames_per_token(torch, model, FRAMES_PER_TOKEN)


def fast_pitch_request_phase(torch, model, config, tokens):
    """The 4 requests, float32, one at a time through
    ``TTSInference.generate_cropped`` on the card (one ``lr`` launch each,
    text -> mel latency), each against the CPU path."""
    from forwardtacotron_torch.models.synthesis import TTSInference
    cpu = TTSInference(copy.deepcopy(model), device='cpu')
    inference = TTSInference(copy.deepcopy(model), device='cuda')
    inference.generate_cropped(tokens[0][:8])          # warm-up
    torch.cuda.synchronize()
    outs, lat, errs = [], [], []
    n_mels = config['dsp']['num_mels']
    for i, toks in enumerate(tokens):
        reset_counts()
        t0 = time.perf_counter()
        out = inference.generate_cropped(toks)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        expect_counts(f'FastPitch f32 request {i}', read_counts(), lr=1)
        frames = FRAMES_PER_TOKEN * len(toks)
        if out['mel_post'].shape != (n_mels, frames) \
                or not np.isfinite(out['mel_post']).all():
            fail(f'FastPitch request {i}: mel_post {out["mel_post"].shape}')
        ref = cpu.generate_cropped(toks)
        err = max(float(np.abs(out[k] - ref[k]).max())
                  for k in ('mel', 'dur', 'pitch', 'energy'))
        ok = err <= E2E_MEL_ATOL
        log(f'  FastPitch f32 request {i}: {len(toks)} tokens -> {frames} '
            f'frames: text->mel {lat[-1]:.1f} ms; vs the CPU path max abs '
            f'err {err:.3e} (atol {E2E_MEL_ATOL:g}) {"ok" if ok else "FAIL"}')
        if not ok:
            fail('FastPitch float32 request disagrees with the CPU path')
        outs.append(out)
        errs.append(err)
    return outs, {'request_ms': lat, 'card_vs_cpu_err': max(errs),
                  'lr_launches_per_request': 1}


def fast_pitch_long_phase(torch, model):
    """One float32 request of FP_LONG_TOKENS tokens x FP_LONG_FRAMES frames
    through ``TTSInference.generate``: the post-regulator attention on the
    blockwise schedule (the default threshold) against the full path
    (threshold forced high), each call's time and peak device memory."""
    import os

    from forwardtacotron_torch.models.synthesis import TTSInference
    model = set_frames_per_token(torch, copy.deepcopy(model), FP_LONG_FRAMES)
    inference = TTSInference(model, device='cuda')
    x = np.random.RandomState(SEED + 15).randint(
        1, model.embedding.num_embeddings, (1, FP_LONG_TOKENS))
    frames = FP_LONG_TOKENS * FP_LONG_FRAMES
    res, mels = {}, {}
    saved = os.environ.pop('FTT_ATTN_BLOCK_T', None)
    try:
        for path, threshold in (('blockwise', None),
                                ('full', FP_FULL_ATTENTION_T)):
            if threshold is not None:
                os.environ['FTT_ATTN_BLOCK_T'] = str(threshold)
            inference.generate(x)                       # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            out = inference.generate(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            expect_counts(f'FastPitch long request ({path})', read_counts(),
                          lr=1)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            if int(out['mel_len'][0]) != frames \
                    or not bool(torch.isfinite(out['mel']).all()):
                fail(f'FastPitch long request ({path}): mel_len '
                     f'{out["mel_len"].tolist()}')
            mels[path] = out['mel'][0, :frames].float()
            res[path] = {'ms': ms, 'peak_mib': peak}
            log(f'  FastPitch long request ({path} attention): '
                f'{FP_LONG_TOKENS} tokens -> {frames} frames, {ms:.1f} ms, '
                f'peak device memory {peak:.1f} MiB above the weights')
    finally:
        os.environ.pop('FTT_ATTN_BLOCK_T', None)
        if saved is not None:
            os.environ['FTT_ATTN_BLOCK_T'] = saved
    err = float((mels['blockwise'] - mels['full']).abs().max())
    scale = max(1.0, float(mels['full'].abs().max()))
    ok = err <= FP_BLOCKWISE_TOL * scale
    log(f'  FastPitch long request: blockwise vs full attention, max abs err '
        f'{err:.3e}, scale {scale:.3e} (tol {FP_BLOCKWISE_TOL:g} x scale) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('FastPitch blockwise attention disagrees with the full path')
    res.update(frames=frames, blockwise_vs_full_err=err)
    return res


def fast_pitch_serving_phase(torch, model, config):
    """bf16 ``generate_fused`` (FastPitch: ``predict_series`` then
    ``generate`` at the budget) at the ForwardTacotron serving shape: batch
    SERVING_BATCH of bench.py's sentences, SERVING_FRAMES_PER_TOKEN frames
    a token, ``max_len`` SERVING_MAX_LEN; one ``lr`` launch a call,
    audio-s/s over trials, the profiler (device time by op, idle share),
    and a slice against the CPU path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.text.tokenizer import Tokenizer

    hop, sr = config['dsp']['hop_length'], config['dsp']['sample_rate']
    model = set_frames_per_token(torch, copy.deepcopy(model),
                                 SERVING_FRAMES_PER_TOKEN)
    cpu = TTSInference(copy.deepcopy(model), dtype='bfloat16', device='cpu')
    inference = TTSInference(model, dtype='bfloat16', device='cuda')
    n_tok = max(len(Tokenizer()(s)) for s in BENCH_SENTENCES)

    def timed_call(xd):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inference.generate_fused(xd, max_len=SERVING_MAX_LEN)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    batch = SERVING_BATCH
    xd = serving_requests(torch, batch)
    timed_call(xd[:FP_CHECK_BATCH])
    out, first_s = timed_call(xd)
    log(f'FastPitch serving: first generate_fused call, batch {batch}, '
        f'max_len {SERVING_MAX_LEN}: {first_s:.3f} s')
    if first_s > SERVING_CALL_LIMIT_S:
        batch = 1024
        log(f'FastPitch serving: over {SERVING_CALL_LIMIT_S:g} s, batch '
            f'dropped to {batch}')
        xd = xd[:batch]
        out, first_s = timed_call(xd)
    mel_lens = np.minimum(out['mel_len'].cpu().numpy(), SERVING_MAX_LEN)
    if not (mel_lens == SERVING_FRAMES_PER_TOKEN * n_tok).all():
        fail(f'FastPitch serving: mel_len {np.unique(mel_lens)}, expected '
             f'{SERVING_FRAMES_PER_TOKEN * n_tok} for every request')
    del out
    reset_counts()
    out, _ = timed_call(xd)
    expect_counts('FastPitch serving call', read_counts(), lr=1)
    if out['mel_post'].shape != (batch, SERVING_MAX_LEN,
                                 config['dsp']['num_mels']) \
            or not bool(torch.isfinite(out['mel_post']).all()):
        fail(f'FastPitch serving: bad mel_post {tuple(out["mel_post"].shape)}')
    del out

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed_call(xd)
    busy_ms = device_profile(prof, 'FastPitch serving call',
                             'chip_smoke_fast_pitch_serving_profile.txt',
                             {'lr': [LR_KERNEL]})
    by_op = sorted(((e.key, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda kv: -kv[1])[:12]

    audio_s = int(mel_lens.sum()) * hop / sr
    rates, walls = [], []
    for _ in range(SERVING_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_ITERS):
            inference.generate_fused(xd, max_len=SERVING_MAX_LEN)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        walls.append(elapsed / SERVING_ITERS)
        rates.append(SERVING_ITERS * audio_s / elapsed)
    wall_ms = statistics.median(walls) * 1e3
    stats = dict(batch=batch, audio_s_per_call=audio_s,
                 audio_s_per_s=sorted(rates), call_ms=wall_ms,
                 device_busy_ms=busy_ms, idle=1 - busy_ms / wall_ms,
                 device_ms_by_op=by_op)
    log(f'FastPitch serving: {audio_s:.1f} audio-s per call; '
        f'{SERVING_TRIALS} trials x {SERVING_ITERS} calls: audio-s/s min '
        f'{min(rates):.1f} median {statistics.median(rates):.1f} max '
        f'{max(rates):.1f}; call {wall_ms:.2f} ms wall (median), device '
        f'busy {busy_ms:.2f} ms (profiled call): idle '
        f'{100 * stats["idle"]:.1f}%')

    x8 = xd[:FP_CHECK_BATCH]
    got = inference.generate_fused(x8, max_len=SERVING_MAX_LEN)
    ref = cpu.generate_fused(x8.cpu(), max_len=SERVING_MAX_LEN)
    if not torch.equal(got['mel_len'].cpu(), ref['mel_len']):
        fail('FastPitch bf16: mel_len differs between card and CPU')
    n = int(ref['mel_len'].min())
    err = float((got['mel'][:, :n].float().cpu()
                 - ref['mel'][:, :n].float()).abs().max())
    scale = max(1.0, float(ref['mel'][:, :n].float().abs().max()))
    ok = err <= E2E_BF16_TOL * scale
    log(f'FastPitch bf16 reference: generate_fused of {FP_CHECK_BATCH} '
        f'requests on the card vs the CPU path, mel max abs err {err:.3e}, '
        f'scale {scale:.3e} (tol {E2E_BF16_TOL:g} x scale) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('FastPitch bf16 serving disagrees with the CPU path')
    stats['card_vs_cpu_err'] = err
    return stats


def fast_pitch_lr_phase(torch) -> dict:
    """Row 8 at FastPitch's width (``lr_shape_times`` at FP_LR_SHAPES)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 16)
    return {label: lr_shape_times(torch, gen, label, b, n, t, FP_LR_C,
                                  dt_name, per_token)
            for label, b, n, t, dt_name, per_token in FP_LR_SHAPES}


# --------------------------------------------------------------- MelGAN

# seungwonpark/melgan's published generator: 512 base channels, rates
# 8-8-2-2 (hop 256), 80 mels
MELGAN_HOP = 256


def write_melgan_checkpoint(torch, path: Path, n_mels: int):
    """A MelGAN generator with weights drawn from SEED (PyTorch's default
    initializers) saved as seungwonpark/melgan saves it: every conv
    weight-normed (weight_g / weight_v), the keys its ``nn.Sequential``'s
    (``generator.{i}...``), the state dict under 'model_g'."""
    from forwardtacotron_torch.models.vocoder import MelGANGenerator
    torch.manual_seed(SEED)
    gen = MelGANGenerator(mel_channels=n_mels)
    for m in gen.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.utils.weight_norm(m)
    names = {'conv_pre': '1', 'conv_post': '16'}
    for j in range(4):
        seq = 3 + 3 * j
        names[f'ups.{j}'] = str(seq)
        for u in range(3):
            names[f'res.{j}.blocks_conv1.{u}'] = f'{seq + 1}.blocks.{u}.2'
            names[f'res.{j}.blocks_conv2.{u}'] = f'{seq + 1}.blocks.{u}.4'
            names[f'res.{j}.shortcuts.{u}'] = f'{seq + 1}.shortcuts.{u}'
    sd = {}
    for k, v in gen.state_dict().items():
        module, leaf = k.rsplit('.', 1)
        sd[f'generator.{names[module]}.{leaf}'] = v
    torch.save({'model_g': sd}, str(path))


def melgan_phase(torch, config, fp_model, fp_outs, tokens, root: Path):
    """MelGAN through its entry points: a seeded published-format
    checkpoint loaded by ``Vocoder.from_checkpoint(vocoder_type='melgan')``;
    one float32 request (FastPitch's longest mel) on the card against the
    CPU; bf16 audio-s/s at bench.py's vocoder shape, with the profiler;
    FastPitch + MelGAN through bf16 ``generate_routed(vocoder=)``; and
    ``python -m forwardtacotron_torch.gen_forward melgan
    --vocoder_checkpoint`` on a seeded FastPitch checkpoint, writing
    .wav files."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from forwardtacotron_torch.models.synthesis import TTSInference, Vocoder
    from forwardtacotron_torch.utils.checkpoints import save_checkpoint

    n_mels, sr = config['dsp']['num_mels'], config['dsp']['sample_rate']
    path = root / 'nvidia_tacotron2_LJ11_epoch6400.pt'
    write_melgan_checkpoint(torch, path, n_mels)
    stats = {}

    # one f32 request: the longest FastPitch mel
    i = max(range(len(fp_outs)), key=lambda j: fp_outs[j]['mel_post'].shape[1])
    mel = torch.from_numpy(np.ascontiguousarray(fp_outs[i]['mel_post'].T))[None]
    frames = mel.shape[1]
    voc32 = Vocoder.from_checkpoint(str(path), vocoder_type='melgan',
                                    dtype='float32', device='cuda')
    voc32(mel[:, :8])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = voc32(mel)
    torch.cuda.synchronize()
    stats['f32_request_ms'] = (time.perf_counter() - t0) * 1e3
    expect_counts('MelGAN f32 request', read_counts())
    ref = Vocoder.from_checkpoint(str(path), vocoder_type='melgan',
                                  dtype='float32', device='cpu')(mel)
    err = float((got.cpu() - ref).abs().max())
    scale = max(1e-3, float(ref.abs().max()))
    ok = got.shape == (1, frames * MELGAN_HOP) and err <= E2E_WAV_TOL * scale
    log(f'MelGAN: f32 request ({frames} frames) on the card '
        f'{stats["f32_request_ms"]:.1f} ms; vs the CPU path max abs err '
        f'{err:.3e}, peak {scale:.3e} (tol {E2E_WAV_TOL:g} x peak) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('MelGAN float32 request disagrees with the CPU path')
    stats['card_vs_cpu_err'] = err
    del voc32

    # bf16 throughput at bench.py's vocoder shape
    voc = Vocoder.from_checkpoint(str(path), vocoder_type='melgan',
                                  dtype='bfloat16', device='cuda')
    mel = torch.randn(VOCODER_BATCH, VOCODER_FRAMES, n_mels,
                      generator=torch.Generator().manual_seed(SEED)).cuda()
    audio_s = VOCODER_BATCH * VOCODER_FRAMES * MELGAN_HOP / sr
    wav = voc(mel)
    torch.cuda.synchronize()
    if wav.shape != (VOCODER_BATCH, VOCODER_FRAMES * MELGAN_HOP) \
            or not bool(torch.isfinite(wav).all()):
        fail(f'MelGAN bf16: wav {tuple(wav.shape)}')
    del wav
    rates = []
    for _ in range(VOCODER_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VOCODER_CALLS):
            voc(mel)
            torch.cuda.synchronize()
        rates.append(VOCODER_CALLS * audio_s / (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            voc(mel)
            torch.cuda.synchronize()
            prof.step()
    busy_ms = device_profile(prof, 'MelGAN bf16 call',
                             'chip_smoke_melgan_profile.txt', {})
    call_ms = audio_s / statistics.median(rates) * 1e3
    stats.update(batch=VOCODER_BATCH, frames=VOCODER_FRAMES,
                 audio_s_per_call=audio_s, audio_s_per_s=sorted(rates),
                 call_ms=call_ms, device_busy_ms=busy_ms,
                 idle=1 - busy_ms / call_ms)
    log(f'MelGAN bf16: batch {VOCODER_BATCH} x {VOCODER_FRAMES} frames, '
        f'{VOCODER_TRIALS} trials x {VOCODER_CALLS} calls: audio-s/s min '
        f'{min(rates):.1f} median {statistics.median(rates):.1f} max '
        f'{max(rates):.1f}; {call_ms:.2f} ms a call, device busy '
        f'{busy_ms:.2f} ms: idle {100 * stats["idle"]:.1f}%')

    # FastPitch + MelGAN, bf16, routed
    inference = TTSInference(copy.deepcopy(fp_model), dtype='bfloat16',
                             device='cuda')
    x = np.zeros((len(tokens), max(map(len, tokens))), np.int64)
    for j, toks in enumerate(tokens):
        x[j, :len(toks)] = toks
    inference.generate_routed(x, vocoder=voc)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = inference.generate_routed(x, vocoder=voc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lens = out['mel_len'].cpu().numpy()
    groups = len(np.unique(-(-lens // 128)))
    expect_counts('FastPitch + MelGAN generate_routed', read_counts(),
                  lr=groups)
    wav, wav_len = out['wav'], out['wav_len'].cpu().numpy()
    if not (np.array_equal(wav_len, lens * MELGAN_HOP)
            and bool(torch.isfinite(wav).all())):
        fail(f'FastPitch + MelGAN: wav {tuple(wav.shape)}, wav_len '
             f'{wav_len}, mel_len {lens}')
    stats['routed_ms'] = wall * 1e3
    log(f'FastPitch + MelGAN generate_routed: {len(tokens)} requests, '
        f'{groups} routed group(s), text -> wav {wall * 1e3:.1f} ms, '
        f'{int(wav_len.sum()) / sr:.2f} s of audio')

    # the CLI, on a seeded FastPitch checkpoint
    ckpt = root / 'fast_pitch.pt'
    save_checkpoint(ckpt, copy.deepcopy(fp_model).cpu(),
                    fast_pitch_config(config), step=0)
    with open(REPO / 'sentences.txt', encoding='utf-8') as f:
        lines = [line.strip() for line in f if line.strip()][:2]
    text = root / 'text.txt'
    text.write_text('\n'.join(lines) + '\n', encoding='utf-8')
    out_dir = root / 'melgan_wavs'
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'forwardtacotron_torch.gen_forward',
         '--checkpoint', str(ckpt), '--text_file', str(text), '--output',
         str(out_dir), '--vocoder_checkpoint', str(path), 'melgan'],
        cwd=str(REPO), capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f'gen_forward melgan failed:\n{proc.stderr[-3000:]}')
    from scipy.io import wavfile
    wavs = sorted(out_dir.glob('*.wav'))
    if len(wavs) != len(lines):
        fail(f'gen_forward melgan wrote {wavs}')
    for w, toks in zip(wavs, tokens):
        n = len(wavfile.read(str(w))[1])
        if n != FRAMES_PER_TOKEN * len(toks) * MELGAN_HOP:
            fail(f'gen_forward melgan: {w.name} has {n} samples')
    stats['cli_s'] = time.perf_counter() - t0
    log(f'gen_forward melgan --vocoder_checkpoint: {len(wavs)} .wav files '
        f'from a FastPitch checkpoint, {stats["cli_s"]:.1f} s')
    return stats


# ------------------------------------------------------------- training

# full-width training shapes of the kernel phase: batch, tokens, frames
TRAIN_KERNEL_SHAPE = (32, 160, 1024)
# the frames the bf16 train step's batch is padded to (its data below):
# lstm_train is held to its twin and timed there
TRAIN_STEP_FRAMES = 928
# the synthetic dataset: items, of which the last few are validation ones,
# tokens per item and frames per token
TRAIN_ITEMS, TRAIN_VAL_ITEMS = 64, 8
TRAIN_TOKENS = (80, 160)
TRAIN_FRAMES = (2, 9)
TRAIN_BATCH = 32
TRAIN_LR = 1e-3
# bf16 steps on one repeated batch: warm-up, counted, profiled, then timed;
# the loss must fall over all of them
TRAIN_TIMED_STEPS = 10
F32_TRAIN_STEPS = 2
# card vs CPU: one step at a small batch, loss and global gradient norm
CHECK_BATCH = 4
E2E_TRAIN_TOL = {'float32': 1e-3, 'bfloat16': 5e-2}
# LR kernel vs twin: a copy, so exact
LR_TOL = 0.0
LR_KERNEL = 'lr_tile_kernel'
TRAIN_KERNEL_NAMES = {'lr': [LR_KERNEL], 'gru': [RNN_KERNELS['gru']],
                      'lstm_train': [RNN_KERNELS['lstm_train']],
                      'gru_bwd': [r'bwd_gates_kernel<false>',
                                  r'bwd_sweep_kernel<false>'],
                      'lstm_bwd': [r'bwd_gates_kernel<true>',
                                   r'bwd_sweep_kernel<true>']}


# row 8 (lr.cu) at the shapes its callers give it: (label, B, N, T, dtype,
# frames per token; None: 2-9 drawn from the seed, as the train step's
# synthetic items): the kernel phase's train shape in both dtypes, the bf16
# step's 928 frames, and one float32 request (92 tokens of 9 frames in the
# 896-frame budget)
LR_C = 512
LR_SHAPES = (('train f32', 32, 160, 1024, 'float32', None),
             ('train bf16', 32, 160, 1024, 'bfloat16', None),
             ('step bf16', 32, 160, TRAIN_STEP_FRAMES, 'bfloat16', None),
             ('request f32', 1, 92, 896, 'float32', FRAMES_PER_TOKEN))
# with --lr-mrf-times, the kernel's device time at each of these tiles
# (frames per CTA), beside the one lr.plan takes
LR_TILE_SWEEP = (2, 4, 8, 16, 32, 64, 128)
# the name of the kernel in this tree and in a checkout before the tile
# kernel
LR_ANY_KERNEL = r'lr_(tile_)?kernel'


def lr_phase(torch, sweep: bool = False) -> dict:
    """Row 8 against its twin, exactly, at LR_SHAPES (``lr_shape_times``).
    'lr' and 'lr_f32' are the train shape's rows, every shape's numbers
    under their 'shapes'."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    shapes = {label: lr_shape_times(torch, gen, label, b, n, t, LR_C,
                                    dt_name, per_token, sweep)
              for label, b, n, t, dt_name, per_token in LR_SHAPES}
    return {'lr_f32': dict(shapes['train f32']),
            'lr': dict(shapes['train bf16'], shapes=shapes)}


def lr_shape_times(torch, gen, label, b, n, t, c, dt_name, per_token,
                   sweep=False) -> dict:
    """Row 8 against its twin, exactly, at one shape ([b, n, c] tokens to t
    frames, ``per_token`` frames a token or TRAIN_FRAMES at random): where
    its time goes (``device_times``: the kernel's device time, the CUDA
    graph's, the event pair around a call, the host's time per call),
    beside the plain twin and the yardstick (``torch.gather`` from the
    tokens with a zero row appended, with precomputed indices: the copy
    without the search); with ``sweep``, also a fill of the output's bytes
    (the write floor) and the kernel at each tile of LR_TILE_SWEEP, each
    held exactly to the twin. In a checkout before the tile kernel (no
    ``lr.plan``) no plan and no sweep."""
    from forwardtacotron_torch.ops.hopper import lr

    dev = torch.device('cuda')
    tiled = hasattr(lr, 'plan')
    dtype = getattr(torch, dt_name)
    if per_token:
        reps = torch.full((b, n), per_token, device=dev)
    else:
        reps = torch.randint(TRAIN_FRAMES[0], TRAIN_FRAMES[1] + 1, (b, n),
                             generator=gen, device=dev)
    ends = torch.cumsum(reps, dim=1).to(torch.int32)
    x = torch.randn(b, n, c, generator=gen, device=dev).to(dtype)
    over = int((ends[:, -1] > t).sum())
    size = x.element_size()
    log(f'  lr {label}: B={b} N={n} C={c} T={t} ({over} items over '
        f'the budget; {int(ends[:, -1].clamp(max=t).sum())} of {b * t} '
        'frames copy a token)')

    def call():
        return lr.length_regulator_expand(x, ends, t)
    want = lr.length_regulator_plain(x, ends, t)
    err = compare(torch, f'lr {label}', call().float(), want.float(),
                  LR_TOL)
    r = dict(max_abs_err=err, **device_times(torch, call, LR_ANY_KERNEL))
    r['ms'] = r['event_ms']
    r['plain_ms'] = time_ms(torch, lambda: lr.length_regulator_plain(
        x, ends, t))
    # the yardstick: the same output by one gather, indices made here
    x0 = torch.cat([x, x.new_zeros(b, 1, c)], 1)
    frames = torch.arange(t, device=dev, dtype=torch.int32)
    idx = torch.searchsorted(ends, frames.expand(b, t).contiguous(),
                             right=True)
    idx = torch.where(frames < ends[:, -1:], idx.clamp(max=n - 1), n)
    idx = idx[:, :, None].expand(b, t, c)
    if not torch.equal(torch.gather(x0, 1, idx), want):
        fail(f'lr {label}: the gather yardstick disagrees with the twin')
    y = device_times(torch, lambda: torch.gather(x0, 1, idx), 'gather')
    r.update(yardstick_ms=y['event_ms'], yardstick_device_ms=y['device_ms'])
    if sweep:   # the write floor: a fill of the output's bytes
        r['fill_device_ms'] = profiled_ms(torch, lambda: want.fill_(0),
                                          'Fill')[0]
        want = lr.length_regulator_plain(x, ends, t)
    r['bound_ms'], r['bound_by'] = bound(
        0, size * (b * n * c + b * t * c) + 4 * b * n)
    r['library_ms'] = None
    r['at'] = f'{label}: B={b} N={n} C={c} T={t}'
    log_device_times('kernel', r)
    log(f'    plain {r["plain_ms"]:.4f} ms; yardstick (gather) device '
        f'{fmt_ms(y["device_ms"])}, event pair {y["event_ms"]:.4f} ms; '
        + (f'fill of the output\'s bytes {fmt_ms(r["fill_device_ms"])}; '
           if sweep else '')
        + f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]})'
        + ('' if r['device_ms'] is None else
           f': the kernel at {100 * r["bound_ms"] / r["device_ms"]:.0f}% '
           'of its bound'))
    if tiled:
        pl = lr.plan(b, n, t, c, dtype)
        r['plan'] = pl._asdict()
        tiles = -(-t // pl.tile)
        log(f'    plan: {b * tiles} CTAs of {pl.tile} frames '
            f'({tiles} an item), rows of {pl.row_vecs} 16-byte words')
    if tiled and sweep:
        out = torch.empty_like(want)
        by_tile = {}
        for tile in LR_TILE_SWEEP:
            q = pl._replace(tile=tile)
            out.fill_(float('nan'))
            lr.launch(x, ends, out, q)
            if not torch.equal(out, want):
                fail(f'lr {label}: the kernel at {tile}-frame tiles '
                     'disagrees with the twin')
            by_tile[tile] = profiled_ms(
                torch, lambda: lr.launch(x, ends, out, q), LR_KERNEL)[0]
        r['tile_sweep_device_ms'] = by_tile
        log('    device ms per launch by tile: ' + ', '.join(
            f'{k} {fmt_ms(v)}' for k, v in by_tile.items()))
    return r


def train_config(config, root, precision, max_step, dropout=True):
    """``config`` at full width (the section of its ``tts_model``) with
    the data under ``root``, a schedule of ``max_step`` steps at
    TRAIN_BATCH and no checkpoints between epochs; without ``dropout``
    every dropout rate is 0 (for comparisons across devices)."""
    cfg = copy.deepcopy(config)
    cfg['data_path'] = str(root / 'data')
    cfg['checkpoint_path'] = str(root / 'ckpt')
    section = cfg[cfg.get('tts_model', 'forward_tacotron')]
    section['training'].update(
        precision=precision, checkpoint_every=10 ** 9,
        schedule=[f'{TRAIN_LR}, {max_step}, {TRAIN_BATCH}'])
    if not dropout:
        model = section['model']
        for key in model:
            if key.endswith('_dropout'):
                model[key] = 0.0
    return cfg


def write_train_data(cfg, n_items=TRAIN_ITEMS, n_val=TRAIN_VAL_ITEMS,
                     tokens=TRAIN_TOKENS):
    """``n_items`` synthetic items (the last ``n_val`` for validation) made
    from SEED with numpy: ``tokens`` (80-160) phonemes, 2-9 frames each,
    random log-mel-like spectrograms, pitch and energy, duration
    statistics that pass the config's filter."""
    from forwardtacotron_torch.data.dataset import DurationStats
    from forwardtacotron_torch.text.symbols import phonemes
    from forwardtacotron_torch.utils.files import pickle_binary
    from forwardtacotron_torch.utils.paths import Paths

    paths = Paths.from_config(cfg)
    rs = np.random.RandomState(SEED)
    n_mels = cfg['dsp']['num_mels']
    symbols = phonemes[20:60]
    text, stats, items = {}, {}, []
    for i in range(n_items):
        item_id = f'item{i:03d}'
        n_tok = rs.randint(tokens[0], tokens[1] + 1)
        text[item_id] = ''.join(rs.choice(list(symbols), n_tok))
        dur = rs.randint(TRAIN_FRAMES[0], TRAIN_FRAMES[1] + 1,
                         n_tok).astype(np.float32)
        frames = int(dur.sum())
        np.save(paths.mel / f'{item_id}.npy',
                (rs.randn(n_mels, frames) - 5.0).astype(np.float32))
        np.save(paths.alg / f'{item_id}.npy', dur)
        np.save(paths.phon_pitch / f'{item_id}.npy',
                rs.randn(n_tok).astype(np.float32))
        np.save(paths.phon_energy / f'{item_id}.npy',
                rs.rand(n_tok).astype(np.float32))
        np.save(paths.speaker_emb / f'{item_id}.npy',
                np.zeros(256, np.float32))
        stats[item_id] = DurationStats(0.9, 0.99, 2, int(dur.max()))
        items.append((item_id, frames))
    split = n_items - n_val
    for obj, path in ((text, paths.text_dict), (stats, paths.duration_stats),
                      ({k: 'speaker' for k in text}, paths.speaker_dict),
                      (items[:split], paths.train_dataset),
                      (items[split:], paths.val_dataset)):
        pickle_binary(obj, path)
    return paths


def with_targets(batch):
    batch = dict(batch)
    batch['pitch_target'] = batch['pitch'].copy()
    batch['energy_target'] = batch['energy'].copy()
    return batch


HOST_TIME_ROUNDS = 3


def host_times_phase(torch, config, tokens, root):
    """The single-speaker host-clock numbers alone, for a comparison of two
    checkouts in one call (``--host-times``): each f32 and bf16 request's
    text->mel (generate_cropped, synchronized; the median of
    HOST_TIME_ROUNDS rounds over the 4 requests) and the bf16 train step
    (the mean of TRAIN_TIMED_STEPS steps on one batch after 2 warm-up
    steps, in each of HOST_TIME_ROUNDS rounds)."""
    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
    from forwardtacotron_torch.train.state import create_train_state

    out = {}
    model = make_model(torch, config)
    for dtype in ('float32', 'bfloat16'):
        inference = TTSInference(copy.deepcopy(model), dtype=dtype,
                                 device='cuda')
        inference.generate_cropped(tokens[0][:8])
        runs = []
        for _ in range(HOST_TIME_ROUNDS):
            for toks in tokens:
                t0 = time.perf_counter()
                inference.generate_cropped(toks)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
        per_request = np.median(np.reshape(runs, (HOST_TIME_ROUNDS, -1)),
                                axis=0)
        out[f'{dtype}_request_ms'] = [float(v) for v in per_request]
        log(f'{dtype} requests, text->mel ms (median of '
            f'{HOST_TIME_ROUNDS}): '
            + ', '.join(f'{v:.1f}' for v in per_request))
    del model, inference
    torch.cuda.empty_cache()

    cfg = train_config(config, root, 'bfloat16', 10 ** 6)
    paths = write_train_data(cfg)
    torch.manual_seed(SEED)
    model = init_tts_model(cfg).cuda()
    trainer = ForwardTrainer(paths, None, cfg, device='cuda')
    state = create_train_state(model, trainer.tx)
    train_cfg = cfg['forward_tacotron']['training']
    train_set, _ = get_forward_dataloaders(
        paths, TRAIN_BATCH, bucket_multiple=train_cfg['bucket_multiple'],
        seed=SEED, **train_cfg['filter'])
    batch = trainer.device_batch(with_targets(next(iter(train_set))))
    for _ in range(2):
        trainer.train_step(state, batch)
    step_ms = []
    for _ in range(HOST_TIME_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_TIMED_STEPS):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / TRAIN_TIMED_STEPS * 1e3)
    out['bf16_step_ms'] = step_ms
    log('bf16 train step ms (each the mean of '
        f'{TRAIN_TIMED_STEPS} steps): ' + ', '.join(f'{v:.1f}'
                                                   for v in step_ms))
    return out


def cudnn_train(torch, cell, in_dim, hidden, x2, backward):
    """cuDNN's bidirectional nn.LSTM / nn.GRU in bf16 on direction 0 of x2
    [T, 2, B, I]: the forward with autograd on, or (``backward``) the
    backward alone of one forward kept for it. A yardstick the port never
    calls."""
    cls = torch.nn.LSTM if cell == 'lstm' else torch.nn.GRU
    mod = cls(in_dim, hidden, bidirectional=True, device='cuda',
              dtype=torch.bfloat16)
    x = x2[:, 0].contiguous().requires_grad_()
    if not backward:
        return lambda: mod(x)
    out, _ = mod(x)
    g = torch.randn_like(out)
    inputs = [x, *mod.parameters()]
    return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)


def train_kernel_phase(torch, model16):
    """Every kernel of the training step against its twin at full-width
    training shapes, bf16 (the LR in float32 too), timed beside its twin
    and cuDNN's recurrences."""
    from forwardtacotron_torch.ops.hopper import rnn, rnn_train

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bf = torch.bfloat16
    b, n, t = TRAIN_KERNEL_SHAPE
    at = f'training B={b} N={n} T={t}'

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    log(f'training kernels, {at}')
    res = {}

    # lr: tokens of C=512 (the prenet's 2 x 256) -> frames, at the train
    # shapes in float32 and bf16, the bf16 step's and one request's
    res.update(lr_phase(torch))

    # lstm_train: the bi-LSTM forward that keeps its cell states (weights
    # detached: the twins run outside autograd, as the kernels do), at the
    # bf16 train step's frames (its first TRAIN_STEP_FRAMES of x2) and,
    # timed only, at the kernel phase's T
    with torch.no_grad():
        wi, wh, bi, bh = model16.lstm.stacked_params()
    i_dim, h = wi.shape[1], wh.shape[1]
    x2 = randn(t, 2, b, i_dim, scale=0.5)
    ts = TRAIN_STEP_FRAMES
    xs = x2[:ts]
    log(f'  lstm_train T={ts} B={b} I={i_dim} H={h} (library: cuDNN bi-LSTM '
        'forward with autograd)')
    err = compare_sweep(torch, 'lstm_train hs, cs',
                        rnn.lstm_train(xs, wi, wh, bi + bh),
                        rnn.lstm_train_plain(xs, wi, wh, bi + bh), 1)
    k_ms = time_ms(torch, lambda: rnn.lstm_train(xs, wi, wh, bi + bh))
    p_ms = time_ms(torch, lambda: rnn.lstm_train_plain(xs, wi, wh, bi + bh))
    l_ms = time_ms(torch, cudnn_train(torch, 'lstm', i_dim, h, xs, False))
    b_ms, b_by = bound(ts * 2 * b * 2 * (i_dim + h) * 4 * h,
                       2 * (ts * 2 * b * (i_dim + 2 * h)
                            + 2 * (i_dim + h) * 4 * h + 2 * 4 * h),
                       PEAK_BF16_FLOPS)
    t_ms = time_ms(torch, lambda: rnn.lstm_train(x2, wi, wh, bi + bh))
    log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library '
        f'{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); kernel at T={t} '
        f'{t_ms:.4f} ms')
    log_plan(rnn, 'lstm_train', xs, h)
    parts = library_parts(torch, 'rnn', RNN_PART_DEFINES,
                          lambda: rnn.lstm_train(xs, wi, wh, bi + bh))
    res['lstm_train'] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                             at=f'training B={b} T={ts}', ms_at_t=t_ms,
                             parts_ms=parts)

    # lstm_bwd: its reverse-time sweep, from the kernel's saved states,
    # with an incoming gradient at unit scale
    hs, cs = rnn.lstm_train(x2, wi, wh, bi + bh)
    args = (randn(t, 2, b, h), hs, cs, x2, wi, wh, bi + bh)
    log(f'  lstm_bwd T={t} B={b} I={i_dim} H={h} (library: cuDNN bi-LSTM '
        'backward)')
    err = compare_sweep(torch, 'lstm_bwd dgates', [rnn_train.lstm_bwd(*args)],
                        [rnn_train.lstm_bwd_plain(*args)], 4)
    k_ms = time_ms(torch, lambda: rnn_train.lstm_bwd(*args))
    p_ms = time_ms(torch, lambda: rnn_train.lstm_bwd_plain(*args))
    l_ms = time_ms(torch, cudnn_train(torch, 'lstm', i_dim, h, x2, True))
    g = 4 * h
    b_ms, b_by = bound(t * 2 * b * 2 * ((i_dim + h) * g + g * h),
                       2 * (t * 2 * b * (3 * h + i_dim + g)
                            + 2 * (i_dim + h) * g + 2 * g), PEAK_BF16_FLOPS)
    log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library '
        f'{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})')
    log_bwd_plan(rnn, rnn_train, 'lstm', x2, h)
    parts = library_parts(torch, 'rnn_bwd', BWD_PART_DEFINES,
                          lambda: rnn_train.lstm_bwd(*args))
    res['lstm_bwd'] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                           library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                           at=at, parts_ms=parts)

    # the three trainable GRUs of one step (pitch and prenet over the
    # tokens, postnet over the frames): their forward (row 7's kernel) and
    # gru_bwd, whose numbers are summed
    parts, fwd = [], {}
    for name, mod, steps in (('pitch', model16.pitch_pred.rnn, n),
                             ('prenet', model16.prenet.rnn, n),
                             ('postnet', model16.postnet.rnn, t)):
        with torch.no_grad():
            wi, wh, bi, bh = mod.stacked_params()
        i_dim, h = wi.shape[1], wh.shape[1]
        g = 3 * h
        x2 = randn(steps, 2, b, i_dim, scale=0.5)
        hs = rnn.gru(x2, wi, wh, bi, bh)
        log(f'  gru {name} forward T={steps} B={b} I={i_dim} H={h}')
        f_err = compare_sweep(torch, f'gru {name} hs', [hs],
                              [rnn.gru_plain(x2, wi, wh, bi, bh)], 1)
        f_ms = time_ms(torch, lambda: rnn.gru(x2, wi, wh, bi, bh))
        f_plain = time_ms(torch, lambda: rnn.gru_plain(x2, wi, wh, bi, bh))
        f_lib = time_ms(torch, cudnn_train(torch, 'gru', i_dim, h, x2, False))
        f_bound, f_by = bound(steps * 2 * b * 2 * (i_dim + h) * g,
                              2 * (steps * 2 * b * (i_dim + h)
                                   + 2 * (i_dim + h) * g + 4 * g),
                              PEAK_BF16_FLOPS)
        log(f'    kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, library '
            f'{f_lib:.4f} ms (cuDNN bi-GRU forward with autograd), bound '
            f'{f_bound:.4f} ms ({f_by})')
        log_plan(rnn, 'gru', x2, h)
        fwd[name] = dict(max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
                         library_ms=f_lib, bound_ms=f_bound, bound_by=f_by)
        args = (randn(steps, 2, b, h), hs, x2, wi, wh, bi, bh)
        log(f'  gru_bwd {name} T={steps} B={b} I={i_dim} H={h} (library: '
            'cuDNN bi-GRU backward)')
        err = compare_sweep(torch, f'gru_bwd {name} dgx, dgh',
                            rnn_train.gru_bwd(*args),
                            rnn_train.gru_bwd_plain(*args), 3)
        k_ms = time_ms(torch, lambda: rnn_train.gru_bwd(*args))
        p_ms = time_ms(torch, lambda: rnn_train.gru_bwd_plain(*args))
        l_ms = time_ms(torch, cudnn_train(torch, 'gru', i_dim, h, x2, True))
        b_ms, b_by = bound(steps * 2 * b * 2 * ((i_dim + h) * g + g * h),
                           2 * (steps * 2 * b * (2 * h + i_dim + 2 * g)
                                + 2 * (i_dim + h) * g + 4 * g),
                           PEAK_BF16_FLOPS)
        log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library '
            f'{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})')
        log_bwd_plan(rnn, rnn_train, 'gru', x2, h)
        parts.append(dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                          library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
        if name == 'postnet':
            postnet_parts = library_parts(torch, 'rnn_bwd', BWD_PART_DEFINES,
                                          lambda: rnn_train.gru_bwd(*args))
    res['gru_bwd'] = {k: (max(p[k] for p in parts) if k == 'max_abs_err'
                          else parts[-1][k] if k == 'bound_by'
                          else sum(p[k] for p in parts)) for k in parts[0]}
    res['gru_bwd']['at'] = (f'{at}: pitch (T={n}, H=128) + prenet (T={n}) + '
                            f'postnet (T={t}) GRUs, summed')
    res['gru_bwd']['parts_ms'] = {f'postnet_{k}': v
                                  for k, v in postnet_parts.items()}
    res['gru_train_fwd'] = fwd
    return res


def train_bf16_phase(torch, config, root):
    """The bf16 mixed-precision train step at full width on the synthetic
    data: exact launch counts, the profiler over one step, steps/s and mel
    frames/s over TRAIN_TIMED_STEPS steps on one repeated batch (whose loss
    must fall), then ForwardTrainer.train (with its eval) to a checkpoint
    that the port's gen_forward loads and speaks from."""
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch import gen_forward
    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
    from forwardtacotron_torch.train.state import create_train_state
    from forwardtacotron_torch.utils.checkpoints import (checkpoint_step,
                                                         restore_checkpoint)

    n_steps = 3 + TRAIN_TIMED_STEPS
    cfg = train_config(config, root, 'bfloat16', n_steps + 2)
    paths = write_train_data(cfg)
    torch.manual_seed(SEED)
    model = init_tts_model(cfg).cuda()
    trainer = ForwardTrainer(paths, None, cfg, device='cuda')
    state = create_train_state(model, trainer.tx)
    train_cfg = cfg['forward_tacotron']['training']
    train_set, _ = get_forward_dataloaders(
        paths, TRAIN_BATCH, bucket_multiple=train_cfg['bucket_multiple'],
        seed=SEED, **train_cfg['filter'])
    host = with_targets(next(iter(train_set)))
    batch = trainer.device_batch(host)
    frames = int(host['mel_len'].sum())
    log(f'bf16 train step: batch {len(host["x_len"])}, tokens padded to '
        f'{host["x"].shape[1]}, frames padded to {host["mel"].shape[1]} '
        f'({frames} valid mel frames)')
    if host['mel'].shape[1] != TRAIN_STEP_FRAMES:
        fail(f'the bf16 train step runs {host["mel"].shape[1]} frames; the '
             f'kernel phase held lstm_train at TRAIN_STEP_FRAMES = '
             f'{TRAIN_STEP_FRAMES}')

    losses = []

    def step():
        m = trainer.train_step(state, batch)
        losses.append(m['loss'])
        return m

    step()                                     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    step()
    torch.cuda.synchronize()
    launches = read_counts()
    # one step: the LR, the pitch / prenet / postnet GRUs forward and
    # backward, the bi-LSTM forward (with cells) and backward; each
    # backward sweep is two launches (the gate product, then the sweep)
    expect_counts('bf16 train step', launches, lr=1, gru=3, lstm_train=1,
                  gru_bwd=6, lstm_bwd=2)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    busy_ms = device_profile(prof, 'bf16 train step',
                             'chip_smoke_train_profile.txt',
                             TRAIN_KERNEL_NAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS * 1e3
    losses = [float(v) for v in losses]
    stats = dict(step_ms=step_ms, steps_per_s=1e3 / step_ms,
                 mel_frames_per_s=frames * 1e3 / step_ms,
                 device_busy_ms=busy_ms, idle=1 - busy_ms / step_ms,
                 peak_memory_gb=peak_gb, losses=losses)
    log(f'bf16 train step: {step_ms:.1f} ms per step over '
        f'{TRAIN_TIMED_STEPS} steps: {stats["steps_per_s"]:.3f} steps/s, '
        f'{stats["mel_frames_per_s"]:.0f} mel frames/s; device busy '
        f'{busy_ms:.1f} ms (profiled step): idle {100 * stats["idle"]:.1f}%; '
        f'peak memory {peak_gb:.2f} GiB')
    # as scripts/bench_train.py counts it: the forward and backward
    # activations ~3x one pass, f32 weights read and gradients written once
    n_tok, n_frames = host['x'].shape[1], host['mel'].shape[1]
    stats['roofline'] = roofline(
        'bf16 train step',
        forward_tacotron_train_flops(cfg, len(host['x_len']), n_tok,
                                     n_frames),
        3 * forward_tacotron_activation_bytes(
            cfg, len(host['x_len']), n_tok, n_frames, dtype_bytes=2)
        + 2 * forward_tacotron_param_bytes(cfg, dtype_bytes=4),
        step_ms / 1e3)
    log(f'bf16 train losses on one repeated batch: '
        f'{", ".join(f"{v:.4f}" for v in losses)}')
    if not (np.isfinite(losses).all()
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        fail('bf16 train step: the loss is not finite or does not fall')

    # ForwardTrainer.train: two more steps, eval, latest_model.pt
    t0 = time.perf_counter()
    state = trainer.train(model, state=state, seed=SEED)
    log(f'ForwardTrainer.train to step {state.step}, eval and checkpoint: '
        f'{time.perf_counter() - t0:.1f} s')
    ckpt = restore_checkpoint(paths.forward_checkpoints)
    if ckpt is None or checkpoint_step(ckpt) != state.step:
        fail('bf16 training: no latest_model.pt at the final step')
    out = root / 'wavs'
    gen_forward.main(['--checkpoint',
                      str(paths.forward_checkpoints / 'latest_model.pt'),
                      '--input_text', 'ðə kwɪk bɹaʊn fɑks.',
                      '--output', str(out), '--device', 'cuda'])
    wavs = sorted(out.glob('*.wav'))
    if len(wavs) != 1 or wavs[0].stat().st_size < 1000:
        fail(f'gen_forward from the trained checkpoint wrote {wavs}')
    log(f'gen_forward loaded the step-{state.step} checkpoint and wrote '
        f'{wavs[0].name} ({wavs[0].stat().st_size} bytes)')
    return launches, stats


def train_f32_phase(torch, config, root):
    """The float32 train step (the config's default): F32_TRAIN_STEPS steps
    with the lr kernel as the only kernel (the recurrences are per-step
    loops), then the eval step's kernels."""
    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
    from forwardtacotron_torch.train.state import create_train_state
    from forwardtacotron_torch.utils.paths import Paths

    cfg = train_config(config, root, 'float32', F32_TRAIN_STEPS)
    paths = Paths.from_config(cfg)
    torch.manual_seed(SEED)
    model = init_tts_model(cfg).cuda()
    trainer = ForwardTrainer(paths, None, cfg, device='cuda')
    state = create_train_state(model, trainer.tx)
    train_cfg = cfg['forward_tacotron']['training']
    train_set, _ = get_forward_dataloaders(
        paths, TRAIN_BATCH, bucket_multiple=train_cfg['bucket_multiple'],
        seed=SEED, **train_cfg['filter'])
    batch = trainer.device_batch(with_targets(next(iter(train_set))))
    torch.cuda.synchronize()
    reset_counts()
    times, losses = [], []
    for _ in range(F32_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(state, batch)['loss']))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    expect_counts('float32 train steps', read_counts(), lr=F32_TRAIN_STEPS)
    log(f'float32 train steps: {", ".join(f"{v:.0f}" for v in times)} ms, '
        f'losses {", ".join(f"{v:.4f}" for v in losses)}')
    if not np.isfinite(losses).all():
        fail('float32 train step: non-finite loss')
    reset_counts()
    t0 = time.perf_counter()
    metrics = trainer.eval_step(model, batch)
    torch.cuda.synchronize()
    expect_counts('float32 eval step', read_counts(), pre_highway_stack=2,
                  cbhg_front=1, lr=1)
    log(f'float32 eval step: {(time.perf_counter() - t0) * 1e3:.0f} ms, '
        f'{ {k: round(float(v), 4) for k, v in metrics.items()} }')
    return times


def check_batch(n_mels):
    """CHECK_BATCH collated items of 30-50 phonemes, 2-5 frames each (at
    most 250 frames), made from SEED with numpy."""
    rs = np.random.RandomState(SEED + 4)
    x_len = rs.randint(30, 51, CHECK_BATCH)
    n = int(x_len.max())
    x = np.zeros((CHECK_BATCH, n), np.int64)
    dur, pitch, energy = (np.zeros((CHECK_BATCH, n), np.float32)
                          for _ in range(3))
    for i, ln in enumerate(x_len):
        x[i, :ln] = rs.randint(20, 60, ln)
        dur[i, :ln] = rs.randint(2, 6, ln)
        pitch[i, :ln] = rs.randn(ln)
        energy[i, :ln] = rs.rand(ln)
    mel_len = dur.sum(1).astype(np.int64)
    mel = np.full((CHECK_BATCH, int(mel_len.max()) + 1, n_mels), -11.5129,
                  np.float32)
    for i, ln in enumerate(mel_len):
        mel[i, :ln] = rs.randn(ln, n_mels) - 5.0
    return with_targets({'x': x, 'dur': dur, 'mel_len': mel_len,
                         'x_len': x_len, 'pitch': pitch, 'energy': energy,
                         'mel': mel})


def train_reference_phase(torch, config, root):
    """One train step on the card and on the CPU plain path (twins, no
    kernels), dropout off, same weights and batch: the loss and the global
    gradient norm, float32 and bf16."""
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
    from forwardtacotron_torch.train.state import create_train_state
    from forwardtacotron_torch.utils.paths import Paths

    errs = {}
    host = check_batch(config['dsp']['num_mels'])
    for precision, tol in E2E_TRAIN_TOL.items():
        cfg = train_config(config, root, precision, 1, dropout=False)
        paths = Paths.from_config(cfg)
        torch.manual_seed(SEED)
        model = init_tts_model(cfg)
        got = {}
        for device in ('cpu', 'cuda'):
            trainer = ForwardTrainer(paths, None, cfg, device=device)
            copy_ = copy.deepcopy(model).to(device)
            m = trainer.train_step(create_train_state(copy_, trainer.tx),
                                   trainer.device_batch(host))
            got[device] = (float(m['loss']), float(m['grad_norm']))
            if m['loss'].device.type != device:
                fail(f'train reference: the step ran on {m["loss"].device}')
        rel = max(abs(g - c) / abs(c) for g, c in zip(got['cuda'], got['cpu']))
        ok = rel <= tol
        log(f'train reference {precision}: B={CHECK_BATCH}, '
            f'{host["mel"].shape[1]} frames: loss / grad norm card '
            f'{got["cuda"][0]:.6f} / {got["cuda"][1]:.6f}, CPU '
            f'{got["cpu"][0]:.6f} / {got["cpu"][1]:.6f}: rel {rel:.3e} '
            f'(tol {tol:g}) {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'{precision} train step disagrees with the CPU plain path')
        errs[precision] = rel
    return errs


# --lstm-times: (wrapper, B, T, I, H) of the LSTM entries at the bf16 train
# step's shape and the kernel phase's, and with narrower inputs (fewer x
# chunks per step), row 7's LSTM body at a request, and two kernels no
# LSTM change touches, whose times show the spread between two checkouts:
# the train step's postnet GRU forward and row 4's serving multi-GRU (from
# its projection, batch 4096, 81 tokens)
LSTM_TIMES_SHAPES = [('lstm_train', 32, TRAIN_STEP_FRAMES, 512, 512),
                     ('lstm_train', 32, TRAIN_STEP_FRAMES, 256, 512),
                     ('lstm_train', 32, TRAIN_STEP_FRAMES, 64, 512),
                     ('lstm_train', 32, 1024, 512, 512),
                     ('lstm', 1, 896, 512, 512), ('gru', 32, 1024, 256, 256),
                     ('gru_xp', 4096, 81, 0, 512)]


def lstm_times_phase(torch) -> dict:
    """CUDA-event times (median of REPS) of the recurrent wrappers at
    LSTM_TIMES_SHAPES on seeded inputs, with only rnn.cu built; runs as it
    is in an older checkout too (the wrappers' signatures are unchanged),
    to compare two trees in one call. With --kernel-parts also the times
    of the LSTM entries and of gru_xp with the copies of RNN_PART_DEFINES
    in rnn.cu's place."""
    from forwardtacotron_torch.ops.hopper import build, rnn
    t0 = time.perf_counter()
    build.build(['rnn'])
    log(f'build rnn: {time.perf_counter() - t0:.1f} s')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen, device='cuda')
                * scale).to(torch.bfloat16)
    out = {}
    for name, b, t, i, h in LSTM_TIMES_SHAPES:
        g = 4 if name.startswith('lstm') else 3
        wh = randn(2, h, g * h, scale=h ** -0.5)
        if name == 'gru_xp':
            args = (randn(t, 2, b, 3 * h, scale=0.5), wh,
                    randn(2, 3 * h, scale=0.1))
        else:
            args = (randn(t, 2, b, i, scale=0.5),
                    randn(2, i, g * h, scale=i ** -0.5), wh,
                    *[randn(2, g * h, scale=0.1) for _ in range(5 - g)])
        fn = getattr(rnn, name)
        key = f'{name} B={b} T={t} I={i} H={h}'
        out[key] = time_ms(torch, lambda: fn(*args))
        log(f'  {key}: {out[key]:.4f} ms ({1e3 * out[key] / t:.2f} us a step)')
        if (name, b, t, i) in (('lstm_train', 32, TRAIN_STEP_FRAMES, 512),
                               ('lstm', 1, 896, 512), ('gru_xp', 4096, 81, 0)):
            defines = RNN_PART_DEFINES if g == 4 else {
                k: v for k, v in RNN_PART_DEFINES.items()
                if k != 'c_through_memory'}
            parts = library_parts(torch, 'rnn', defines, lambda: fn(*args))
            if parts:
                out[f'{key} parts'] = parts
        del args
    return out


def mrf_times_phase(torch) -> dict:
    """CUDA-event times (median of REPS) of HiFi-GAN v1's levels 2 and 3 in
    bf16 at bench.py's vocoder batch, as the fused level (``mrf``) and as
    the tail's level (``ups_mrf``), with prepared weights, on seeded
    inputs; runs as it is in an older checkout too, to compare two trees
    in one call."""
    from forwardtacotron_torch.ops.hopper import mrf, ups_mrf
    bf = torch.bfloat16
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
    model = seeded_hifigan(torch).cuda().to(bf)
    krs = model.resblock_kernel_sizes
    dils = model.resblock_dilation_sizes[0]
    out, s_in = {}, 1
    for level, hop in ((2, 128), (3, 256)):
        up = model.ups[level]
        c = up.out_channels
        x = torch.randn(VOCODER_BATCH, c, VOCODER_FRAMES * hop, generator=gen,
                        device='cuda').to(bf)
        weights = model.mrf_weights(level, bf)
        prep = mrf.prepare(weights, krs, dils)
        key = f'mrf level {level}'
        out[key] = time_ms(torch, lambda: mrf.mrf(x, weights, krs, dils,
                                                  prepared=prep))
        del x
        s_up, t_ps = model.upsample_rates[level], VOCODER_FRAMES * 64
        x = torch.randn(VOCODER_BATCH, s_in * up.in_channels, t_ps,
                        generator=gen, device='cuda').to(bf)
        up_w, up_b, *weights = model.ups_mrf_weights(level, bf)
        args = (x, up_w, up_b, tuple(weights), s_in, s_up, krs, dils, t_ps)
        prep = ups_mrf.prepare(*args[1:8])
        out[f'ups_mrf level {level}'] = time_ms(
            torch, lambda: ups_mrf.ups_mrf(*args, prepared=prep))
        del x, args
        s_in *= s_up
    for k, v in out.items():
        log(f'  {k}: {v:.4f} ms')
    return out


# --------------------------------------------------------- multispeaker

# configs/multispeaker.yaml at full width: MultiForwardTacotron (predictor
# GRUs of 128 / 256 / 128 / 64 over 256-wide convolutions, a trunk LSTM of
# 2 x 256 + 256 = 768 inputs) and MultiFastPitch (transformers of 256 +
# 256 = 512 channels, predictors of 384 and 392). Speaker embeddings as
# resemblyzer's are: 256 wide, non-negative, of unit norm; MULTI_SPEAKERS
# of them, drawn from SEED.
MULTI_SPEAKERS = 4
MULTI_EMB_DIMS = 256
# a plain twin per-step loop at these shapes takes 0.1-0.7 s a call: time
# it over fewer runs than a kernel
PLAIN_REPS = 3
# row 8 at the multispeaker widths: (label, B, N, T, dtype, frames a token
# or None: 2-9 drawn as the train step's items): C 768 in
# MultiForwardTacotron's f32 requests and training trunk, C 512 in
# MultiFastPitch's decode (float32: its transformers compute in float32)
MULTI_LR_SHAPES = {768: (('multi request f32', 1, 92, 896, 'float32',
                          FRAMES_PER_TOKEN),
                         ('multi step bf16', 32, 160, TRAIN_STEP_FRAMES,
                          'bfloat16', None),
                         ('multi train f32', 32, 160, 1024, 'float32',
                          None)),
                   512: (('MultiFastPitch serving f32', SERVING_BATCH, 81,
                          256, 'float32', SERVING_FRAMES_PER_TOKEN),
                         ('MultiFastPitch request f32', 1, 92, 896,
                          'float32', FRAMES_PER_TOKEN))}
# the predictor GRUs of the multispeaker serving call that take row 7
# (H % 128 == 0; energy's H = 64 stays a per-step loop), with the
# prenet's and postnet's GRUs: 5 launches a call, or a request
MULTI_GRUS_PER_CALL = 5
MULTI_TRAIN_STEPS = 10
# FastPitch and MultiFastPitch: synchronized train steps at TRAIN_BATCH
FP_TRAIN_STEPS = 2
# MultiFastPitch bf16 serving: calls timed (one trial)
MFP_SERVING_CALLS = 2


def speaker_table(torch, n=MULTI_SPEAKERS, dims=MULTI_EMB_DIMS):
    """``n`` speaker embeddings [n, dims] float32 on the CPU, non-negative
    and of unit norm, from SEED."""
    e = np.abs(np.random.RandomState(SEED + 20).randn(n, dims))
    return torch.as_tensor(e / np.linalg.norm(e, axis=1, keepdims=True),
                           dtype=torch.float32)


def multi_config(config, family):
    cfg = copy.deepcopy(config)
    cfg['tts_model'] = family
    return cfg


def multi_kernel_phase(torch, mft16) -> dict:
    """Rows 6-10 at the multispeaker shapes, each against its twin: row 6
    at I 768 (serving and a request), row 7's predictor GRUs (H 128 and
    256 from I 256 at the serving shape), row 8 at C 768 and 512, row 9's
    LSTM at I 768 and its GRUs at H 128 / 256, row 10 at the same shapes;
    timed beside the twin, cuDNN's bi-LSTM / bi-GRU and the bound."""
    from forwardtacotron_torch.models import layers
    from forwardtacotron_torch.ops.hopper import lr_bidir, rnn, rnn_train

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def check(*args, **kw):
        return bf16_check(*args, plain_reps=PLAIN_REPS, **kw)

    res = {}
    wi, wh, bi, bh = mft16.lstm.stacked_params()
    wm = layers.mel_weights(mft16.lstm, mft16.lin)
    i_dim, h, m = wi.shape[1], wh.shape[1], wm.shape[-1]
    for label, b, t in (('serving', SERVING_BATCH, SERVING_MAX_LEN),
                        ('request', 1, 896)):
        t_run = -(-t // lr_bidir.T_TILE) * lr_bidir.T_TILE
        x2 = randn(t_run, 2, b, i_dim, scale=0.5)
        log(f'  lstm_lr_mel {label} T_run={t_run} B={b} I={i_dim} H={h} '
            f'M={m} (library: cuDNN bi-LSTM at I={i_dim}, without the mel '
            'stage)')
        res[f'lstm_lr_mel_{label}'] = dict(check(
            torch, f'lstm_lr_mel I={i_dim} {label}', rnn.lstm_mel,
            rnn.lstm_mel_plain, (x2, wi, wh, bi + bh, wm),
            t_run * 2 * b * 2 * ((i_dim + h) * 4 * h + h * m),
            2 * (t_run * 2 * b * i_dim + 2 * (i_dim + h) * 4 * h + 2 * 4 * h
                 + 2 * h * m + t_run * 2 * b * m),
            cudnn_rnn(torch, 'lstm', i_dim, h, x2)),
            at=f'{label}: B={b} T_run={t_run} I={i_dim}')
        log_plan(rnn, 'lstm_mel', x2, h, m)
        res[f'lstm_lr_mel_{label}']['plan'] = rnn.plan(
            'lstm_mel', b, t_run, i_dim, h, m, *rnn.device_limits(dev))
        del x2

    b, n = SERVING_BATCH, 81
    for name, mod in (('dur_pred', mft16.dur_pred.rnn),
                      ('pitch_cond_pred', mft16.pitch_cond_pred.rnn),
                      ('pitch_pred', mft16.pitch_pred.rnn)):
        wi, wh, bi, bh = mod.stacked_params()
        i_dim, h = wi.shape[1], wh.shape[1]
        g = 3 * h
        x2 = randn(n, 2, b, i_dim, scale=0.5)
        log(f'  bidir_rnn {name} GRU T={n} B={b} I={i_dim} H={h} (library: '
            'cuDNN bi-GRU)')
        res[f'gru_{name}'] = dict(check(
            torch, f'{name} GRU H={h}', rnn.gru, rnn.gru_plain,
            (x2, wi, wh, bi, bh), n * 2 * b * 2 * (i_dim + h) * g,
            2 * (n * 2 * b * i_dim + 2 * (i_dim + h) * g + 4 * g
                 + n * 2 * b * h), cudnn_rnn(torch, 'gru', i_dim, h, x2)),
            at=f'serving: B={b} T={n} I={i_dim} H={h}')
        log_plan(rnn, 'gru', x2, h)
        del x2

    lr_gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    for c, shapes in MULTI_LR_SHAPES.items():
        for label, b, n, t, dt_name, per_token in shapes:
            res[f'lr {label}'] = lr_shape_times(torch, lr_gen, label, b, n,
                                                t, c, dt_name, per_token)

    b, n, t = TRAIN_BATCH, 160, TRAIN_STEP_FRAMES
    with torch.no_grad():
        wi, wh, bi, bh = mft16.lstm.stacked_params()
    i_dim, h = wi.shape[1], wh.shape[1]
    x2 = randn(t, 2, b, i_dim, scale=0.5)
    log(f'  lstm_train T={t} B={b} I={i_dim} H={h} (library: cuDNN bi-LSTM '
        'forward with autograd)')
    res['lstm_train'] = dict(check(
        torch, f'lstm_train I={i_dim} hs, cs', rnn.lstm_train,
        rnn.lstm_train_plain, (x2, wi, wh, bi + bh),
        t * 2 * b * 2 * (i_dim + h) * 4 * h,
        2 * (t * 2 * b * (i_dim + 2 * h) + 2 * (i_dim + h) * 4 * h
             + 2 * 4 * h), cudnn_train(torch, 'lstm', i_dim, h, x2, False),
        sweep_blocks=1),
        at=f'training: B={b} T={t} I={i_dim}')
    log_plan(rnn, 'lstm_train', x2, h)
    hs, cs = rnn.lstm_train(x2, wi, wh, bi + bh)
    g = 4 * h
    log(f'  lstm_bwd T={t} B={b} I={i_dim} H={h} (library: cuDNN bi-LSTM '
        'backward)')
    res['lstm_bwd'] = dict(check(
        torch, f'lstm_bwd I={i_dim} dgates', rnn_train.lstm_bwd,
        rnn_train.lstm_bwd_plain,
        (randn(t, 2, b, h), hs, cs, x2, wi, wh, bi + bh),
        t * 2 * b * 2 * ((i_dim + h) * g + g * h),
        2 * (t * 2 * b * (3 * h + i_dim + g) + 2 * (i_dim + h) * g + 2 * g),
        cudnn_train(torch, 'lstm', i_dim, h, x2, True),
        sweep_blocks=4), at=f'training: B={b} T={t} I={i_dim}')
    log_bwd_plan(rnn, rnn_train, 'lstm', x2, h)
    del x2, hs, cs

    for name, mod in (('dur_pred', mft16.dur_pred.rnn),
                      ('pitch_pred', mft16.pitch_pred.rnn)):
        with torch.no_grad():
            wi, wh, bi, bh = mod.stacked_params()
        i_dim, h = wi.shape[1], wh.shape[1]
        g = 3 * h
        x2 = randn(n, 2, b, i_dim, scale=0.5)
        log(f'  gru {name} forward T={n} B={b} I={i_dim} H={h}')
        res[f'gru_train_fwd_{name}'] = dict(check(
            torch, f'gru {name} H={h} hs', rnn.gru, rnn.gru_plain,
            (x2, wi, wh, bi, bh), n * 2 * b * 2 * (i_dim + h) * g,
            2 * (n * 2 * b * (i_dim + h) + 2 * (i_dim + h) * g + 4 * g),
            cudnn_train(torch, 'gru', i_dim, h, x2, False),
            sweep_blocks=1), at=f'training: B={b} T={n} I={i_dim} H={h}')
        hs = rnn.gru(x2, wi, wh, bi, bh)
        log(f'  gru_bwd {name} T={n} B={b} I={i_dim} H={h} (library: cuDNN '
            'bi-GRU backward)')
        res[f'gru_bwd_{name}'] = dict(check(
            torch, f'gru_bwd {name} H={h} dgx, dgh', rnn_train.gru_bwd,
            rnn_train.gru_bwd_plain,
            (randn(n, 2, b, h), hs, x2, wi, wh, bi, bh),
            n * 2 * b * 2 * ((i_dim + h) * g + g * h),
            2 * (n * 2 * b * (2 * h + i_dim + 2 * g) + 2 * (i_dim + h) * g
                 + 4 * g), cudnn_train(torch, 'gru', i_dim, h, x2, True),
            sweep_blocks=3),
            at=f'training: B={b} T={n} I={i_dim} H={h}')
        log_bwd_plan(rnn, rnn_train, 'gru', x2, h)
        del x2, hs
    return res


def multi_request_phase(torch, model, config, tokens, table, root: Path):
    """The 4 requests in float32 and bf16 through ``generate_cropped`` with
    speaker i % MULTI_SPEAKERS, each against the CPU path (the model gates),
    exact launches per request, Griffin-Lim on the float32 mels; then
    ``gen_forward --speaker`` on a reference-format checkpoint."""
    from forwardtacotron_torch import gen_forward
    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.synthesis import TTSInference

    dsp = DSP.from_config(config, device='cuda')
    n_mels, hop = config['dsp']['num_mels'], config['dsp']['hop_length']
    res = {}
    for dtype, tol in (('float32', E2E_MEL_ATOL), ('bfloat16', E2E_BF16_TOL)):
        cpu = TTSInference(copy.deepcopy(model), dtype=dtype, device='cpu')
        card = TTSInference(copy.deepcopy(model), dtype=dtype, device='cuda')
        card.generate_cropped(tokens[0][:8], speaker_emb=table[0])
        torch.cuda.synchronize()
        lat, errs, cpu_s = [], [], 0.0
        for i, toks in enumerate(tokens):
            semb = table[i % len(table)]
            reset_counts()
            t0 = time.perf_counter()
            out = card.generate_cropped(toks, speaker_emb=semb)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            if dtype == 'float32':
                # the trunk's LR is row 8 at C 768, the recurrences loops
                expect_counts(f'multispeaker f32 request {i}', read_counts(),
                              lr=1, pre_highway_stack=2, cbhg_front=1)
            else:
                expect_counts(f'multispeaker bf16 request {i}',
                              read_counts(), gru=MULTI_GRUS_PER_CALL,
                              lr_bidir=1, lstm_mel=1, pre_highway_stack=2,
                              cbhg_front=1)
            frames = FRAMES_PER_TOKEN * len(toks)
            if out['mel_post'].shape != (n_mels, frames) \
                    or not np.isfinite(out['mel_post']).all():
                fail(f'multispeaker {dtype} request {i}: mel_post '
                     f'{out["mel_post"].shape}')
            t0 = time.perf_counter()
            ref = cpu.generate_cropped(toks, speaker_emb=semb)
            cpu_s += time.perf_counter() - t0
            err = max(float(np.abs(out[k] - ref[k]).max())
                      for k in ('mel', 'mel_post'))
            scale = 1.0 if dtype == 'float32' else max(
                1.0, float(np.abs(ref['mel_post']).max()))
            ok = err <= tol * scale
            log(f'  multispeaker {dtype} request {i} (speaker '
                f'{i % len(table)}): {len(toks)} tokens -> {frames} frames, '
                f'text->mel {lat[-1]:.1f} ms; vs the CPU path mel/mel_post '
                f'max abs err {err:.3e} (tol {tol:g} x {scale:.3g}) '
                f'{"ok" if ok else "FAIL"}')
            if not ok:
                fail(f'multispeaker {dtype} request disagrees with the CPU '
                     'path')
            errs.append(err)
            if dtype == 'float32':
                reset_counts()
                t0 = time.perf_counter()
                wav = dsp.griffinlim(out['mel_post'])
                torch.cuda.synchronize()
                expect_counts(f'multispeaker griffinlim {i}', read_counts(),
                              griffin_lim_iter=32)
                if wav.shape != (hop * (frames - 1),) \
                        or not np.isfinite(wav).all():
                    fail(f'multispeaker request {i}: wav {wav.shape}')
                log(f'    griffinlim {(time.perf_counter() - t0) * 1e3:.1f} '
                    'ms')
        res[dtype] = dict(request_ms=lat, card_vs_cpu_err=max(errs),
                          cpu_s=cpu_s)

    # gen_forward --speaker on a reference-format checkpoint: the exported
    # mel is the card's generate_cropped with that speaker's embedding
    names = [f'speaker{i}' for i in range(len(table))]
    path = root / 'multi_forward_tacotron.pt'
    torch.save({'model': model.state_dict(),
                'config': multi_config(config, 'multi_forward_tacotron'),
                'speaker_embeddings': {k: e.numpy()
                                       for k, e in zip(names, table)}},
               str(path))
    text = 'ðə kwɪk bɹaʊn fɑks.'
    gen_forward.main(['--checkpoint', str(path), '--input_text', text,
                      '--output', str(root / 'mels'), '--speaker', names[2],
                      '--device', 'cuda', 'hifigan'])
    got = np.load(str(next((root / 'mels').glob('*.npy'))))
    # the tokens as gen_forward makes them (no espeak: graphemes)
    from forwardtacotron_torch.text.cleaners import Cleaner
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    pre = config['preprocessing']
    toks = Tokenizer()(Cleaner(pre['cleaner_name'], use_phonemes=False,
                               lang=pre['language'])(text))
    card = TTSInference(copy.deepcopy(model), device='cuda')
    want = card.generate_cropped(toks, speaker_emb=table[2])
    other = card.generate_cropped(toks, speaker_emb=table[3])
    err = float(np.abs(got - want['mel_post']).max())
    moved = float(np.abs(other['mel_post'] - want['mel_post']).max())
    ok = err <= 1e-5 and moved > 1e-5
    log(f'  gen_forward --speaker {names[2]}: mel {got.shape}, vs '
        f'generate_cropped with its embedding max abs err {err:.3e}; '
        f'another speaker moves it by {moved:.3e} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('gen_forward --speaker did not speak as the chosen speaker')
    res['gen_forward_speaker_err'] = err
    return res


def multi_serving_phase(torch, model, config, table):
    """bf16 ``generate_fused`` of MultiForwardTacotron at the serving shape
    (bench.py's sentences at batch SERVING_BATCH, speakers cycling over the
    batch, SERVING_FRAMES_PER_TOKEN frames a token, ``max_len``
    SERVING_MAX_LEN): exact launches per call, the profiler, audio-s/s over
    SERVING_TRIALS trials of SERVING_ITERS calls, the idle share, and a
    slice against the CPU path."""
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.text.tokenizer import Tokenizer

    hop, sr = config['dsp']['hop_length'], config['dsp']['sample_rate']
    model = set_frames_per_token(torch, copy.deepcopy(model),
                                 SERVING_FRAMES_PER_TOKEN)
    cpu = TTSInference(copy.deepcopy(model), dtype='bfloat16', device='cpu')
    inference = TTSInference(model, dtype='bfloat16', device='cuda')
    n_tok = max(len(Tokenizer()(s)) for s in BENCH_SENTENCES)
    batch = SERVING_BATCH
    xd = serving_requests(torch, batch)
    semb = table[torch.arange(batch) % len(table)].cuda()

    def call(xs=xd, ss=semb):
        return inference.generate_fused(xs, max_len=SERVING_MAX_LEN,
                                        speaker_emb=ss)

    call(xd[:8], semb[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    log(f'multispeaker serving: first generate_fused call, batch {batch}, '
        f'max_len {SERVING_MAX_LEN}: {time.perf_counter() - t0:.3f} s')
    mel_lens = np.minimum(out['mel_len'].cpu().numpy(), SERVING_MAX_LEN)
    if not (mel_lens == SERVING_FRAMES_PER_TOKEN * n_tok).all():
        fail(f'multispeaker serving: mel_len {np.unique(mel_lens)}, '
             f'expected {SERVING_FRAMES_PER_TOKEN * n_tok}')
    del out
    reset_counts()
    out = call()
    torch.cuda.synchronize()
    # one call: the pitch-condition, duration and pitch GRUs (H 128, 128,
    # 256; energy's H 64 is a loop), the prenet and postnet GRUs, LR + LSTM
    # mel at I 768, both highway stacks, the postnet front
    expect_counts('multispeaker serving call', read_counts(),
                  gru=MULTI_GRUS_PER_CALL, lr_bidir=1, lstm_mel=1,
                  pre_highway_stack=2, cbhg_front=1)
    launches = read_counts()
    if out['mel_post'].shape != (batch, SERVING_MAX_LEN,
                                 config['dsp']['num_mels']) \
            or not bool(torch.isfinite(out['mel_post']).all()):
        fail(f'multispeaker serving: bad mel_post '
             f'{tuple(out["mel_post"].shape)}')
    del out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    busy_ms = device_profile(
        prof, 'multispeaker serving call',
        'chip_smoke_multi_serving_profile.txt',
        {k: v for k, v in SERVING_KERNEL_NAMES.items() if k != 'gru_xp'})
    audio_s = int(mel_lens.sum()) * hop / sr
    rates, walls = [], []
    for _ in range(SERVING_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_ITERS):
            call()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        walls.append(elapsed / SERVING_ITERS)
        rates.append(SERVING_ITERS * audio_s / elapsed)
    wall_ms = statistics.median(walls) * 1e3
    stats = dict(batch=batch, speakers=len(table), audio_s_per_call=audio_s,
                 audio_s_per_s=sorted(rates), call_ms=wall_ms,
                 device_busy_ms=busy_ms, idle=1 - busy_ms / wall_ms)
    log(f'multispeaker serving: {audio_s:.1f} audio-s per call; '
        f'{SERVING_TRIALS} trials x {SERVING_ITERS} calls: audio-s/s min '
        f'{min(rates):.1f} median {statistics.median(rates):.1f} max '
        f'{max(rates):.1f}; call {wall_ms:.2f} ms wall (median), device '
        f'busy {busy_ms:.2f} ms (profiled call): idle '
        f'{100 * stats["idle"]:.1f}%')

    x8, s8 = xd[:FP_CHECK_BATCH], semb[:FP_CHECK_BATCH]
    got = call(x8, s8)
    ref = cpu.generate_fused(x8.cpu(), max_len=SERVING_MAX_LEN,
                             speaker_emb=s8.cpu())
    if not torch.equal(got['mel_len'].cpu(), ref['mel_len']):
        fail('multispeaker bf16: mel_len differs between card and CPU')
    n = int(ref['mel_len'].min())
    err = max(float((got[k][:, :n].float().cpu() - ref[k][:, :n].float())
                    .abs().max()) for k in ('mel', 'mel_post'))
    scale = max(1.0, float(ref['mel_post'][:, :n].float().abs().max()))
    ok = err <= E2E_BF16_TOL * scale
    log(f'multispeaker bf16 reference: generate_fused of {FP_CHECK_BATCH} '
        f'requests (4 speakers) on the card vs the CPU path, mel/mel_post '
        f'max abs err {err:.3e}, scale {scale:.3e} (tol {E2E_BF16_TOL:g} x '
        f'scale) {"ok" if ok else "FAIL"}')
    if not ok:
        fail('multispeaker bf16 serving disagrees with the CPU path')
    stats['card_vs_cpu_err'] = err
    return launches, stats


def multi_fast_pitch_phase(torch, model, config, tokens, table):
    """MultiFastPitch: the 4 requests in float32 on the card against the
    CPU path (one ``lr`` launch at C 512 each), then bf16
    ``generate_fused`` at the serving shape (MFP_SERVING_CALLS calls timed,
    one ``lr`` launch a call)."""
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.models.synthesis import TTSInference

    hop, sr = config['dsp']['hop_length'], config['dsp']['sample_rate']
    cpu = TTSInference(copy.deepcopy(model), device='cpu')
    card = TTSInference(copy.deepcopy(model), device='cuda')
    card.generate_cropped(tokens[0][:8], speaker_emb=table[0])
    lat, errs = [], []
    for i, toks in enumerate(tokens):
        semb = table[i % len(table)]
        reset_counts()
        t0 = time.perf_counter()
        out = card.generate_cropped(toks, speaker_emb=semb)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        expect_counts(f'MultiFastPitch f32 request {i}', read_counts(), lr=1)
        frames = FRAMES_PER_TOKEN * len(toks)
        if out['mel_post'].shape != (config['dsp']['num_mels'], frames) \
                or not np.isfinite(out['mel_post']).all():
            fail(f'MultiFastPitch request {i}: {out["mel_post"].shape}')
        ref = cpu.generate_cropped(toks, speaker_emb=semb)
        err = max(float(np.abs(out[k] - ref[k]).max())
                  for k in ('mel', 'dur', 'pitch', 'energy'))
        ok = err <= E2E_MEL_ATOL
        log(f'  MultiFastPitch f32 request {i}: {len(toks)} tokens -> '
            f'{frames} frames, text->mel {lat[-1]:.1f} ms; vs the CPU path '
            f'max abs err {err:.3e} (atol {E2E_MEL_ATOL:g}) '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            fail('MultiFastPitch float32 request disagrees with the CPU path')
        errs.append(err)
    res = {'request_ms': lat, 'card_vs_cpu_err': max(errs)}

    model = set_frames_per_token(torch, copy.deepcopy(model),
                                 SERVING_FRAMES_PER_TOKEN)
    inference = TTSInference(model, dtype='bfloat16', device='cuda')
    xd = serving_requests(torch, SERVING_BATCH)
    semb = table[torch.arange(SERVING_BATCH) % len(table)].cuda()

    def call():
        return inference.generate_fused(xd, max_len=SERVING_MAX_LEN,
                                        speaker_emb=semb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_counts()
    out = call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    expect_counts('MultiFastPitch serving call', read_counts(), lr=1)
    mel_lens = np.minimum(out['mel_len'].cpu().numpy(), SERVING_MAX_LEN)
    if out['mel_post'].shape != (SERVING_BATCH, SERVING_MAX_LEN,
                                 config['dsp']['num_mels']) \
            or not bool(torch.isfinite(out['mel_post']).all()):
        fail('MultiFastPitch serving: bad mel_post')
    del out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    busy_ms = device_profile(prof, 'MultiFastPitch serving call',
                             'chip_smoke_multi_fast_pitch_profile.txt',
                             {'lr': [LR_KERNEL]})
    audio_s = int(mel_lens.sum()) * hop / sr
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MFP_SERVING_CALLS):
        call()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / MFP_SERVING_CALLS * 1e3
    res['serving'] = dict(batch=SERVING_BATCH, first_call_s=first_s,
                          call_ms=call_ms,
                          audio_s_per_s=audio_s * 1e3 / call_ms,
                          device_busy_ms=busy_ms,
                          idle=1 - busy_ms / call_ms)
    log(f'MultiFastPitch serving: {audio_s:.1f} audio-s per call, '
        f'{MFP_SERVING_CALLS} calls: {call_ms:.1f} ms a call, '
        f'{res["serving"]["audio_s_per_s"]:.1f} audio-s/s; device busy '
        f'{busy_ms:.1f} ms: idle {100 * res["serving"]["idle"]:.1f}%')
    return res


def write_multi_train_data(cfg, table, **items):
    """``write_train_data`` (of ``items``) with speakers: item i speaks as
    speaker i % len(table) (its embedding the table's row), each
    speaker's mean embedding, and about a third of the tokens unvoiced
    (pitch 0, the pitch condition's class 1)."""
    from forwardtacotron_torch.utils.files import pickle_binary
    paths = write_train_data(cfg, **items)
    rs = np.random.RandomState(SEED + 23)
    names = [f'speaker{i}' for i in range(len(table))]
    speakers = {}
    for i, path in enumerate(sorted(paths.alg.glob('*.npy'))):
        item_id = path.stem
        speakers[item_id] = names[i % len(names)]
        np.save(paths.speaker_emb / f'{item_id}.npy',
                table[i % len(names)].numpy())
        pitch = np.load(paths.phon_pitch / f'{item_id}.npy')
        pitch[rs.rand(len(pitch)) < 0.3] = 0.0
        np.save(paths.phon_pitch / f'{item_id}.npy', pitch)
    for name, emb in zip(names, table):
        np.save(paths.mean_speaker_emb / f'{name}.npy', emb.numpy())
    pickle_binary(speakers, paths.speaker_dict)
    return paths


def family_train_phase(torch, config, family, root, table, steps, want):
    """``family``'s bf16 train step at TRAIN_BATCH on the synthetic
    (multispeaker) data: exact launch counts ``want`` per step, the
    profiler, ``steps`` synchronized steps (steps/s, mel frames/s, the idle
    share), then one float32 and one bf16 step at CHECK_BATCH on the card
    against the CPU path (loss, global gradient norm, and for a
    multispeaker model the pitch-condition CE and accuracy)."""
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.models.registry import (init_tts_model,
                                                       is_multispeaker)
    from forwardtacotron_torch.train.forward_trainer import (
        ForwardTrainer, MultiForwardTrainer)
    from forwardtacotron_torch.train.state import create_train_state

    cfg = train_config(multi_config(config, family), root, 'bfloat16', 100)
    paths = write_multi_train_data(cfg, table)
    trainer_cls = MultiForwardTrainer if is_multispeaker(cfg) \
        else ForwardTrainer
    torch.manual_seed(SEED)
    model = init_tts_model(cfg).cuda()
    trainer = trainer_cls(paths, None, cfg, device='cuda')
    state = create_train_state(model, trainer.tx)
    train_cfg = cfg[family]['training']
    train_set, _ = get_forward_dataloaders(
        paths, TRAIN_BATCH, bucket_multiple=train_cfg['bucket_multiple'],
        seed=SEED, **train_cfg['filter'])
    host = with_targets(next(iter(train_set)))
    batch = trainer.device_batch(host)
    frames = int(host['mel_len'].sum())
    log(f'{family} bf16 train step: batch {len(host["x_len"])}, tokens '
        f'padded to {host["x"].shape[1]}, frames padded to '
        f'{host["mel"].shape[1]} ({frames} valid mel frames)')
    losses = []

    def step():
        m = trainer.train_step(state, batch)
        losses.append(m['loss'])
        return m

    step()
    torch.cuda.synchronize()
    reset_counts()
    m = step()
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts(f'{family} bf16 train step', launches, **want)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy_ms = device_profile(
        prof, f'{family} bf16 train step',
        f'chip_smoke_{family}_train_profile.txt',
        {k: v for k, v in TRAIN_KERNEL_NAMES.items() if want.get(k)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        fail(f'{family} bf16 train step: non-finite loss')
    stats = dict(step_ms=step_ms, steps_per_s=1e3 / step_ms,
                 mel_frames_per_s=frames * 1e3 / step_ms,
                 device_busy_ms=busy_ms, idle=1 - busy_ms / step_ms,
                 losses=losses)
    if 'pitch_cond_loss' in m:
        stats.update(pitch_cond_loss=float(m['pitch_cond_loss']),
                     pitch_cond_acc=float(m['pitch_cond_acc']))
    log(f'{family} bf16 train step: {step_ms:.1f} ms per step over {steps} '
        f'steps: {stats["steps_per_s"]:.3f} steps/s, '
        f'{stats["mel_frames_per_s"]:.0f} mel frames/s; device busy '
        f'{busy_ms:.1f} ms (profiled step): idle {100 * stats["idle"]:.1f}%; '
        f'losses {", ".join(f"{v:.4f}" for v in losses)}')
    del state, trainer, model, batch
    torch.cuda.empty_cache()

    # card vs CPU: one step at CHECK_BATCH, dropout off, f32 and bf16
    host = check_batch(cfg['dsp']['num_mels'])
    if is_multispeaker(cfg):
        host['speaker_emb'] = table[np.arange(CHECK_BATCH)
                                    % len(table)].numpy()
        valid = np.arange(host['x'].shape[1])[None] < host['x_len'][:, None]
        host['pitch'][:, ::3] = 0.0
        host['pitch_target'] = host['pitch'].copy()
        host['pitch_cond'] = np.where(
            valid, np.where(host['pitch'] == 0, 1, 2), 0).astype(np.int64)
    stats['card_vs_cpu_rel'] = {}
    keys = ['loss', 'grad_norm'] + (['pitch_cond_loss', 'pitch_cond_acc']
                                    if is_multispeaker(cfg) else [])
    for precision, tol in E2E_TRAIN_TOL.items():
        cfg_p = train_config(multi_config(config, family), root, precision,
                             1, dropout=False)
        torch.manual_seed(SEED)
        model = init_tts_model(cfg_p)
        got = {}
        for device in ('cpu', 'cuda'):
            trainer = trainer_cls(paths, None, cfg_p, device=device)
            m = trainer.train_step(
                create_train_state(copy.deepcopy(model).to(device),
                                   trainer.tx), trainer.device_batch(host))
            got[device] = [float(m[k]) for k in keys]
        rel = max(abs(g - c) / max(abs(c), 1e-6)
                  for g, c in zip(got['cuda'], got['cpu']))
        ok = rel <= tol
        log(f'{family} train reference {precision}: B={CHECK_BATCH}: '
            f'{", ".join(keys)} card {got["cuda"]}, CPU {got["cpu"]}: rel '
            f'{rel:.3e} (tol {tol:g}) {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'{family} {precision} train step disagrees with the CPU '
                 'path')
        stats['card_vs_cpu_rel'][precision] = rel
    return launches, stats


def multispeaker_phases(torch, config, tokens) -> dict:
    """Every multispeaker phase (configs/multispeaker.yaml at full width,
    MULTI_SPEAKERS seeded speakers): rows 6-10 at the new shapes,
    MultiForwardTacotron's requests, serving and training, FastPitch's
    training (configs/singlespeaker.yaml), MultiFastPitch's requests,
    serving and training."""
    from forwardtacotron_torch.utils.files import read_config
    t_all = time.perf_counter()
    mconfig = read_config(REPO / 'configs' / 'multispeaker.yaml')
    table = speaker_table(torch)
    out = {}
    mft = make_model(torch, multi_config(mconfig,
                                          'multi_forward_tacotron'))
    # autograd stays on for cuDNN's training yardsticks; the weights need
    # no gradient
    mft16 = copy.deepcopy(mft).cuda().to(torch.bfloat16).requires_grad_(
        False)
    t0 = time.perf_counter()
    log('multispeaker kernels at the new shapes:')
    out['kernels'] = multi_kernel_phase(torch, mft16)
    del mft16
    torch.cuda.empty_cache()
    out['kernels_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log('multispeaker requests (host clock, synchronized):')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_multi_') as tmp:
        out['requests'] = multi_request_phase(torch, mft, mconfig, tokens,
                                              table, Path(tmp))
    out['requests_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['serving_launches'], out['serving'] = multi_serving_phase(
        torch, mft, mconfig, table)
    torch.cuda.empty_cache()
    out['serving_s'] = time.perf_counter() - t0
    del mft
    trains = {'multi_forward_tacotron': (mconfig, MULTI_TRAIN_STEPS, dict(
        lr=1, gru=MULTI_GRUS_PER_CALL, lstm_train=1,
        gru_bwd=2 * MULTI_GRUS_PER_CALL, lstm_bwd=2)),
        'fast_pitch': (config, FP_TRAIN_STEPS, dict(lr=1)),
        'multi_fast_pitch': (mconfig, FP_TRAIN_STEPS, dict(lr=1))}
    out['training'] = {}
    for family, (cfg, steps, want) in trains.items():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix='chip_smoke_mtrain_') as tmp:
            launches, stats = family_train_phase(torch, cfg, family,
                                                 Path(tmp), table, steps,
                                                 want)
        stats['launches'] = launches
        stats['phase_s'] = time.perf_counter() - t0
        out['training'][family] = stats
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mfp = make_model(torch, multi_config(mconfig, 'multi_fast_pitch'))
    log('MultiFastPitch (host clock, synchronized):')
    out['multi_fast_pitch'] = multi_fast_pitch_phase(torch, mfp, mconfig,
                                                     tokens, table)
    del mfp
    torch.cuda.empty_cache()
    out['multi_fast_pitch_s'] = time.perf_counter() - t0
    out['phases_s'] = time.perf_counter() - t_all
    log(f'multispeaker phases: {out["phases_s"]:.1f} s')
    return out


# the Tacotron teacher (configs/singlespeaker.yaml's tacotron section):
# rows 1-2 at the GTA export's batch and at the encoder's tokens
TEACHER_BATCH, TEACHER_FRAMES, TEACHER_TOKENS = 8, 1000, 180
# train steps: (r, batch) as the schedule's first and last sessions; timed
# steps of each after the counted one (and, with --teacher, the profiled
# one)
TEACHER_TRAIN = ((5, 32), (1, 8))
TEACHER_TIMED_STEPS = {5: 1, 1: 1}
# card vs CPU: the shortest items at r = 5
TEACHER_CHECK_BATCH, TEACHER_CHECK_R = 4, 5
TEACHER_GEN_STEPS = 2000
# the train_tacotron CLI: items of 20-40 phonemes, two short sessions
# (r, lr, steps, batch)
TEACHER_CLI_ITEMS, TEACHER_CLI_VAL, TEACHER_CLI_TOKENS = 16, 4, (20, 40)
TEACHER_CLI_SCHEDULE = ['5, 1e-3, 2, 8', '2, 1e-4, 4, 4']
# teacher-forced eval forward, card vs CPU (float32, 1000 decoder steps);
# the multispeaker teacher's at fewer frames
TEACHER_EVAL_TOL = 1e-4
TEACHER_MULTI_FRAMES = 400


def teacher_model(torch, config):
    """The teacher at full width from SEED, random BN statistics, eval."""
    from forwardtacotron_torch.models.tacotron import Tacotron
    torch.manual_seed(SEED)
    return random_bn_stats(torch, Tacotron.from_config(config)).eval()


def teacher_no_dropout(torch, model):
    """The teacher's dropout and zoneout off (card vs CPU steps)."""
    from forwardtacotron_torch.models.tacotron import PreNet
    for m in model.modules():
        if isinstance(m, PreNet):
            m.dropout = 0.0
        elif isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    model.decoder.zoneout = 0.0
    return model


def teacher_kernel_phase(torch, model, b=TEACHER_BATCH, tokens=TEACHER_TOKENS,
                         frames=TEACHER_FRAMES, dtypes=('f32', 'bf16'),
                         equal_tokens=False) -> dict:
    """Rows 1 and 2 at the teacher's four entries (the encoder's CBHG at
    ``b`` x ``tokens``, the postnet's at ``b`` x ``frames``, items ragged;
    with ``equal_tokens`` every item has ``tokens``, as in an extraction
    batch), in ``dtypes``, each against its twin and timed beside the
    twin, its yardstick (the residual add and the ``nn.Linear`` chain; the
    fused cuDNN bank, ``pool_mask`` and cuDNN's proj1) and its bound."""
    from forwardtacotron_torch.ops.hopper import cbhg, highway

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    res = {}
    for name in dtypes:
        dt = {'f32': torch.float32, 'bf16': torch.bfloat16}[name]
        m = copy.deepcopy(model).to(dev, dt).requires_grad_(False)
        f32 = dt == torch.float32
        kw = dict(tol=KERNEL_TOL, peak=PEAK_F32_FLOPS) if f32 else {}
        isz = 4 if f32 else 2
        for entry, mod, t in (('encoder', m.encoder.cbhg, tokens),
                              ('postnet', m.postnet, frames)):
            c_in = mod.conv1d_bank[0].conv.in_channels
            k_max, c = mod.K, mod.channels
            p = mod.conv_project1.conv.out_channels
            lens = torch.tensor([t if equal_tokens and entry == 'encoder'
                                 else t - i * (t // (2 * b))
                                 for i in range(b)], device=dev)
            mask = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
            x = (torch.randn(b, t, c_in, generator=gen, device=dev)
                 * mask[:, :, None]).to(dt)
            log(f'  teacher {entry} cbhg_front {name} B={b} T={t} '
                f'C_in={c_in} K={k_max} C={c} P={p} (yardstick: fused '
                'cuDNN bank, pool_mask, cuDNN proj1)')
            log(f'    plan: {cbhg.plan(dt, k_max, c_in, c, p)}')
            sum_k = k_max * (k_max + 1) // 2
            res[f'cbhg_front_{entry}_{name}'] = bf16_check(
                torch, f'B={b} T={t}', cbhg.bank_pool_proj,
                cbhg.bank_pool_proj_plain, mod.front_args(x, mask),
                2 * b * t * (sum_k * c_in * c + 3 * k_max * c * p),
                isz * (b * t * c_in + sum_k * c_in * c + 3 * k_max * c * p
                       + b * t * p) + 4 * (b * t + 2 * k_max * c + 2 * p),
                yardstick=lambda: mod.conv_project1(cbhg.pool_mask(
                    mod._bank_fused(x).contiguous(), mask)), **kw)
            rows, layers_n = b * t, len(mod.highways)
            log(f'  teacher {entry} pre_highway_stack {name} N={rows} '
                f'C_in={c_in} C={c} L={layers_n} (yardstick: residual add '
                '+ nn.Linear chain)')
            log(f'    plan: {highway.plan(c_in, c)}')
            a = torch.randn(rows, c_in, generator=gen, device=dev).to(dt)
            r = torch.randn(rows, c_in, generator=gen, device=dev).to(dt)

            def chain(mod=mod, a=a, r=r):
                y = mod.pre_highway(a + r)
                for hw in mod.highways:
                    y = hw(y)
                return y
            res[f'pre_highway_stack_{entry}_{name}'] = bf16_check(
                torch, f'N={rows}', highway.pre_highway_stack,
                highway.pre_highway_stack_plain, mod.highway_args(a, r),
                2 * rows * c_in * c + layers_n * 2 * rows * c * 2 * c,
                isz * (2 * rows * c_in + c_in * c + layers_n * 2 * c * c
                       + rows * c) + 4 * layers_n * 2 * c,
                yardstick=chain, **kw)
        del m
        torch.cuda.empty_cache()
    return res


def teacher_eval_phase(torch, model, label, b, n, t,
                       speaker_emb=None) -> dict:
    """One teacher-forced eval forward at r = 1 on the card (exactly 2
    ``pre_highway_stack`` and 2 ``cbhg_front`` launches, no other kernel)
    and on the CPU plain path, ``b`` items of ``t`` frames and ragged
    tokens (at most ``n``), with ``speaker_emb`` [b, dims] for a
    multispeaker teacher: mel, postnet mel and attention within
    TEACHER_EVAL_TOL of each one's scale."""
    from forwardtacotron_torch.text.symbols import phonemes
    rs = np.random.RandomState(SEED + 32)
    x_lens = np.array([n - i * (n // (2 * b)) for i in range(b)])
    x = np.zeros((b, n), np.int64)
    for i, ln in enumerate(x_lens):
        x[i, :ln] = rs.randint(1, len(phonemes), ln)
    mel = (rs.randn(b, t, model.n_mels) - 5.0).astype(np.float32)
    host = {'x': torch.from_numpy(x), 'mel': torch.from_numpy(mel)}
    if speaker_emb is not None:
        host['speaker_emb'] = speaker_emb
    card = copy.deepcopy(model).cuda().eval()
    batch = {k: v.cuda() for k, v in host.items()}
    lens = torch.from_numpy(x_lens)
    with torch.inference_mode():
        card(batch, r=1, x_lens=lens.cuda())
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = card(batch, r=1, x_lens=lens.cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        expect_counts(label, launches, pre_highway_stack=2, cbhg_front=2)
        t0 = time.perf_counter()
        want = copy.deepcopy(model).eval()(host, r=1, x_lens=lens)
        cpu_s = time.perf_counter() - t0
    rel = {}
    for name, g, w in zip(('mel', 'linear', 'attention'), got, want):
        err = float((g.cpu() - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        rel[name] = err / scale
        ok = bool(torch.isfinite(g).all()) and err <= TEACHER_EVAL_TOL * scale
        log(f'{label} {name}: max_abs_err {err:.3e}, scale {scale:.3e} '
            f'(tol {TEACHER_EVAL_TOL:g}) {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'{label} {name} disagrees with the CPU path')
    log(f'{label}, B={b} T={t}, {n} tokens: {ms:.1f} ms on the card (host '
        f'clock, synchronized), {cpu_s:.1f} s on the CPU')
    return dict(ms=ms, launches=launches, card_vs_cpu_rel=rel,
                cpu_s=cpu_s)


def teacher_generate_phase(torch, model, tokens) -> dict:
    """``generate`` for the 4 sentences (one batch, padded), float32 and
    bf16: exactly 2 ``pre_highway_stack`` and 2 ``cbhg_front`` launches a
    call, finite outputs of the step budget's length, the steps each item
    ran (``n_valid``), the call's time (host clock, synchronized)."""
    n = max(len(tk) for tk in tokens)
    x = torch.zeros(len(tokens), n, dtype=torch.long)
    for i, tk in enumerate(tokens):
        x[i, :len(tk)] = torch.as_tensor(tk)
    x = x.cuda()
    out = {}
    for name, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        card = copy.deepcopy(model).to('cuda', dt).eval()
        with torch.inference_mode():
            card.generate(x, steps=64)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            mel, linear, attn, n_valid = card.generate(
                x, steps=TEACHER_GEN_STEPS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        expect_counts(f'teacher generate {name}', launches,
                      pre_highway_stack=2, cbhg_front=2)
        want = (len(tokens), TEACHER_GEN_STEPS, model.n_mels)
        if (tuple(mel.shape) != want or tuple(linear.shape) != want
                or not all(bool(torch.isfinite(a).all())
                           for a in (mel, linear, attn))):
            fail(f'teacher generate {name}: outputs {tuple(mel.shape)}, '
                 f'expected finite {want}')
        out[name] = dict(ms=ms, n_valid=n_valid.tolist(),
                         launches=launches)
        log(f'teacher generate {name}: {len(tokens)} sentences, {n} tokens, '
            f'{TEACHER_GEN_STEPS} steps budget, n_valid {n_valid.tolist()}: '
            f'{ms:.1f} ms')
        del card
    return out


def teacher_train_config(config, root, precision, schedule):
    """``config`` with the data and checkpoints under ``root`` and the
    teacher's ``precision`` and ``schedule`` rows."""
    cfg = copy.deepcopy(config)
    cfg['data_path'] = str(root / 'data')
    cfg['checkpoint_path'] = str(root / 'ckpt')
    cfg['tacotron']['training'].update(precision=precision,
                                       schedule=schedule)
    return cfg


def teacher_train_phase(torch, config, root, profiled) -> dict:
    """f32 and bf16 train steps at r = 5 (batch 32) and r = 1 (batch 8) on
    the synthetic items of ``write_train_data``, one repeated batch each:
    no kernel launches, the profiler's device busy and the idle share for
    each (precision, r) of ``profiled`` (a profiled step of 10^5 device
    events takes 20-60 s), steps/s over TEACHER_TIMED_STEPS synchronized steps, a falling
    loss, a finite gradient for every parameter (at r = 5); then one step
    of each
    dtype on the card against the CPU path (dropout and zoneout off):
    loss and global gradient norm within E2E_TRAIN_TOL."""
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.data.dataset import (TacoCollator,
                                                    TacoDataset,
                                                    get_taco_dataloaders)
    from forwardtacotron_torch.models.tacotron import Tacotron
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    from forwardtacotron_torch.train.state import create_train_state
    from forwardtacotron_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_torch.utils.files import unpickle_binary

    paths = write_train_data(teacher_train_config(
        config, root, 'float32', [f'5, {TRAIN_LR}, 100, 32']))
    filt = config['tacotron']['training']['filter']
    out = {}
    for precision in ('float32', 'bfloat16'):
        cfg = teacher_train_config(config, root, precision,
                                   [f'5, {TRAIN_LR}, 100, 32'])
        for r, bs in TEACHER_TRAIN:
            label = f'teacher {precision} train step r={r}'
            torch.manual_seed(SEED)
            model = Tacotron.from_config(cfg).cuda()
            trainer = TacoTrainer(paths, None, cfg, device='cuda')
            state = create_train_state(model, trainer.tx)
            train_set, _ = get_taco_dataloaders(paths, bs, r,
                                                bucket_multiple=r,
                                                seed=SEED, **filt)
            host = next(iter(train_set))
            batch = trainer.device_batch(host)
            gen = torch.Generator(device='cuda').manual_seed(SEED)
            frames = int(host['mel_len'].sum())
            log(f'{label}: batch {bs}, tokens padded to {host["x"].shape[1]}, '
                f'frames padded to {host["mel"].shape[1]} ({frames} valid, '
                f'{host["mel"].shape[1] // r} decoder steps)')
            losses = []

            def step():
                m, _ = trainer.train_step(state, batch, r, gen)
                losses.append(m['loss'])

            reset_counts()
            step()
            torch.cuda.synchronize()
            launches = read_counts()
            expect_counts(label, launches)
            busy_ms = profile_s = None
            if (precision, r) in profiled:
                # device events only: a step is 10^5 of them
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    step()
                    torch.cuda.synchronize()
                busy_ms = device_profile(
                    prof, label,
                    f'chip_smoke_teacher_{precision}_r{r}_profile.txt', {})
                profile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(TEACHER_TIMED_STEPS[r]):
                step()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / TEACHER_TIMED_STEPS[r] * 1e3
            losses = [float(v) for v in losses]
            if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
                fail(f'{label}: losses {losses} do not fall')
            if r == TEACHER_TRAIN[0][0]:
                params = state.params()
                loss = trainer.loss_fn(model.train(), params, batch, r,
                                       gen)[0]
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True)
                bad = [k for k, g in zip(params, grads)
                       if g is None or not bool(torch.isfinite(g).all())]
                if bad:
                    fail(f'{label}: no finite gradient for {bad[:5]}')
                log(f'{label}: every parameter has a finite gradient')
                del params, loss, grads
            stats = dict(batch=bs, frames_padded=int(host['mel'].shape[1]),
                         step_ms=step_ms, steps_per_s=1e3 / step_ms,
                         mel_frames_per_s=frames * 1e3 / step_ms,
                         device_busy_ms=busy_ms,
                         idle=None if busy_ms is None else 1 - busy_ms / step_ms,
                         profile_s=profile_s, losses=losses)
            busy = ('device busy not measured' if busy_ms is None else
                    f'device busy {busy_ms:.1f} ms (profiled step, '
                    f'{profile_s:.1f} s with the profiler): idle '
                    f'{100 * stats["idle"]:.1f}%')
            log(f'{label}: {step_ms:.1f} ms per step over '
                f'{TEACHER_TIMED_STEPS[r]} steps: {stats["steps_per_s"]:.3f} '
                f'steps/s, {stats["mel_frames_per_s"]:.0f} mel frames/s; '
                f'{busy}; losses {", ".join(f"{v:.4f}" for v in losses)}')
            out[f'{precision}_r{r}'] = stats
            del state, trainer, model, batch
            torch.cuda.empty_cache()

    # card vs CPU: the shortest train items at r = 5, dropout off
    train_items = sorted(unpickle_binary(paths.train_dataset),
                         key=lambda it: it[1])[:TEACHER_CHECK_BATCH]
    dataset = TacoDataset(paths, [i for i, _ in train_items],
                          unpickle_binary(paths.text_dict),
                          unpickle_binary(paths.speaker_dict), Tokenizer())
    host = TacoCollator(r=TEACHER_CHECK_R)(
        [dataset[i] for i in range(len(dataset))])
    out['card_vs_cpu_rel'] = {}
    for precision, tol in E2E_TRAIN_TOL.items():
        cfg = teacher_train_config(config, root, precision,
                                   [f'5, {TRAIN_LR}, 1, 4'])
        torch.manual_seed(SEED)
        model = teacher_no_dropout(torch, Tacotron.from_config(cfg))
        got = {}
        for device in ('cpu', 'cuda'):
            trainer = TacoTrainer(paths, None, cfg, device=device)
            m, _ = trainer.train_step(
                create_train_state(copy.deepcopy(model).to(device),
                                   trainer.tx), trainer.device_batch(host),
                TEACHER_CHECK_R)
            got[device] = [float(m['loss']), float(m['grad_norm'])]
        rel = max(abs(g - c) / max(abs(c), 1e-6)
                  for g, c in zip(got['cuda'], got['cpu']))
        ok = rel <= tol
        log(f'teacher train reference {precision}: B={TEACHER_CHECK_BATCH}, '
            f'{host["mel"].shape[1]} frames at r={TEACHER_CHECK_R}: loss, '
            f'grad_norm card {got["cuda"]}, CPU {got["cpu"]}: rel {rel:.3e} '
            f'(tol {tol:g}) {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'teacher {precision} train step disagrees with the CPU '
                 'path')
        out['card_vs_cpu_rel'][precision] = rel
    return out


def teacher_cli_phase(torch, config, root) -> dict:
    """``python -m forwardtacotron_torch.train_tacotron`` on the card:
    two short sessions to a checkpoint and the extraction after them (an
    ``alg/`` file summing to its mel and a pitch target for every item,
    from seeded raw pitch), a resume that restores the step and the
    optimizer and extracts again,
    and ``--force_gta`` writing one finite [n_mels, mel_len] .npy per
    item. Phase 18 runs the whole pipeline."""
    import yaml

    from forwardtacotron_torch.utils.checkpoints import (checkpoint_step,
                                                         restore_checkpoint)
    from forwardtacotron_torch.utils.files import unpickle_binary

    cfg = teacher_train_config(config, root / 'cli', 'float32',
                               TEACHER_CLI_SCHEDULE)
    cfg['tacotron']['training']['checkpoint_every'] = 2
    cfg['duration_extraction']['num_workers'] = 0
    paths = write_train_data(cfg, TEACHER_CLI_ITEMS, TEACHER_CLI_VAL,
                             TEACHER_CLI_TOKENS)
    cfg_path = root / 'cli_config.yaml'
    cfg_path.write_text(yaml.dump(cfg))
    last_step = int(TEACHER_CLI_SCHEDULE[-1].split(',')[2])
    items = dict(unpickle_binary(paths.train_dataset)
                 + unpickle_binary(paths.val_dataset))
    rs = np.random.RandomState(SEED + 42)
    for item_id, mel_len in items.items():
        np.save(paths.raw_pitch / f'{item_id}.npy',
                rs.uniform(80, 300, mel_len).astype(np.float32))
    out = {}
    for run, extra in (('train', []), ('resume', []),
                       ('force_gta', ['--force_gta'])):
        for f in [*paths.alg.glob('*.npy'), *paths.phon_pitch.glob('*.npy')]:
            f.unlink()
        out[f'{run}_s'], stdout = run_cli(
            f'train_tacotron {run}', 'forwardtacotron_torch.train_tacotron',
            ['--config', str(cfg_path), *extra])
        if run == 'force_gta':
            continue
        if run == 'resume' and \
                f'Restored checkpoint at step {last_step}' not in stdout:
            fail('train_tacotron did not resume from its checkpoint')
        ckpt = restore_checkpoint(paths.taco_checkpoints)
        if (ckpt is None or checkpoint_step(ckpt) != last_step
                or int(ckpt['optim']['count']) != last_step):
            fail(f'train_tacotron {run}: no checkpoint at step {last_step}')
        for item_id, mel_len in items.items():
            alg = paths.alg / f'{item_id}.npy'
            if not alg.is_file() or int(np.load(alg).sum()) != mel_len or \
                    not (paths.phon_pitch / f'{item_id}.npy').is_file():
                fail(f'train_tacotron {run}: no alg/{item_id}.npy summing '
                     f'to {mel_len}, or no pitch target')
    for item_id, mel_len in items.items():
        gta = np.load(paths.gta / f'{item_id}.npy')
        if gta.shape != (cfg['dsp']['num_mels'], mel_len) or \
                not np.isfinite(gta).all():
            fail(f'--force_gta: {item_id} has {gta.shape}, expected finite '
                 f'({cfg["dsp"]["num_mels"]}, {mel_len})')
    out['gta_files'] = len(items)
    log(f'train_tacotron: two sessions to step {last_step} and the '
        f'extraction, a resume, {len(items)} GTA mels')
    return out


def teacher_phases(torch, config, tokens,
                   profiled=()) -> dict:
    """Every teacher phase, each one's seconds beside it: rows 1-2 at its
    shapes, the eval forward card vs CPU, ``generate``, the train steps
    (the profiler at the (precision, r) pairs of ``profiled``) and the
    CLI."""
    from forwardtacotron_torch.utils.files import read_config
    t_all = time.perf_counter()
    model = teacher_model(torch, config)
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        out[f'{name}_s'] = time.perf_counter() - t0
        torch.cuda.empty_cache()

    log('teacher kernels (rows 1-2 at the teacher\'s shapes):')
    with torch.inference_mode():
        timed('kernels', lambda: teacher_kernel_phase(torch, model))
    timed('eval', lambda: teacher_eval_phase(
        torch, model, 'teacher eval forward', TEACHER_BATCH, TEACHER_TOKENS,
        TEACHER_FRAMES))
    # configs/multispeaker.yaml's teacher: a 256-wide speaker embedding
    # tiled onto the tokens, MULTI_SPEAKERS items
    mconfig = read_config(REPO / 'configs' / 'multispeaker.yaml')
    timed('multispeaker_eval', lambda: teacher_eval_phase(
        torch, teacher_model(torch, mconfig),
        'multispeaker teacher eval forward', MULTI_SPEAKERS, TEACHER_TOKENS,
        TEACHER_MULTI_FRAMES, speaker_table(torch)))
    timed('generate', lambda: teacher_generate_phase(torch, model, tokens))
    with tempfile.TemporaryDirectory(prefix='chip_smoke_teacher_') as tmp:
        timed('training', lambda: teacher_train_phase(
            torch, config, Path(tmp), profiled))
        timed('cli', lambda: teacher_cli_phase(torch, config, Path(tmp)))
    out['phases_s'] = time.perf_counter() - t_all
    log('teacher phases: ' + ', '.join(
        f'{k[:-2]} {v:.1f} s' for k, v in out.items() if k.endswith('_s')))
    return out


# the data pipeline (phase 18): a seeded synthetic corpus at 22,050 Hz,
# PIPE_PER_LEN utterances at each token count (one extraction batch of 32
# per bin), ~5.5 frames a token (LJSpeech's 1.5-11.5 s)
PIPE_TOKENS = (60, 120, 180)
PIPE_PER_LEN = 32
PIPE_FRAMES_PER_TOKEN = 5.5
PIPE_WORKERS = 4
PIPE_SPEAKERS = ('spk0', 'spk1', 'spk2')


def write_corpus(root: Path, token_lens, per_len: int, sample_rate: int,
                 hop: int, frames_per_token: float = PIPE_FRAMES_PER_TOKEN,
                 speakers=None, seed: int = SEED) -> Path:
    """A seeded synthetic corpus in LJSpeech's layout under ``root``
    (``wavs/<id>.wav``, 16-bit, and ``metadata.csv``; with ``speakers``,
    ``ljspeech_multi``'s ``id|speaker|text``, the speakers cycling):
    ``per_len`` utterances at each token count of ``token_lens``,
    pre-phonemized text (words of 2-7 phonemes, a full stop), and
    ``frames_per_token`` hops of audio a token: voiced stretches at
    100-250 Hz (three harmonics, a slow vibrato), pauses of noise between
    them, quiet noise before and after (which the start/end trim cuts)."""
    from scipy.io import wavfile

    from forwardtacotron_torch.text.symbols import phonemes

    rs = np.random.RandomState(seed)
    letters = [p for p in phonemes[12:82] if p.strip()]
    wavs = root / 'wavs'
    wavs.mkdir(parents=True, exist_ok=True)
    lines = []
    for n_tok in token_lens:
        for _ in range(per_len):
            item_id = f'utt{len(lines):03d}'
            chars = list(rs.choice(letters, n_tok - 1))
            pos = int(rs.randint(2, 8))
            while pos < n_tok - 3:               # word breaks
                chars[pos] = ' '
                pos += int(rs.randint(3, 9))
            text = ''.join(chars) + '.'
            n = int(frames_per_token * n_tok * hop)
            t = np.arange(n) / sample_rate
            f0 = rs.uniform(100, 250) * (
                1 + 0.05 * np.sin(2 * np.pi * rs.uniform(2, 6) * t))
            phase = 2 * np.pi * np.cumsum(f0) / sample_rate
            voice = (np.sin(phase) + 0.5 * np.sin(2 * phase)
                     + 0.25 * np.sin(3 * phase))
            gate, pos = np.zeros(n), 0
            while pos < n:
                on = int(rs.uniform(0.15, 0.6) * sample_rate)
                gate[pos:pos + on] = rs.uniform(0.15, 0.35)
                pos += on + int(rs.uniform(0.04, 0.2) * sample_rate)
            y = voice * gate + 0.003 * rs.randn(n)
            pad = [1e-4 * rs.randn(int(rs.uniform(0.1, 0.3) * sample_rate))
                   for _ in range(2)]
            y = np.concatenate([pad[0], y, pad[1]])
            wavfile.write(str(wavs / f'{item_id}.wav'), sample_rate,
                          (np.clip(y, -1, 1) * 32767).astype(np.int16))
            speaker = ('' if speakers is None else
                       f'{speakers[len(lines) % len(speakers)]}|')
            lines.append(f'{item_id}|{speaker}{text}')
    (root / 'metadata.csv').write_text('\n'.join(lines) + '\n',
                                       encoding='utf-8')
    return root


PIPE_VAL = 8
# the default mode's training: a few steps at r = 1 (r, lr, steps, batch)
PIPE_SCHEDULE = ['1, 1e-3, 2, 8']
PIPE_MEL_CHECKS, PIPE_DIJKSTRA_ITEMS, PIPE_EMBED_ITEMS = 4, 4, 8
PIPE_MEL_TOL = 1e-4          # relative L2, card mel vs the CPU DSP
PIPE_ATTN_TOL = 1e-3         # one batch's attention, card vs CPU
PIPE_EMB_TOL = 1e-4          # speaker embedding, card vs CPU


def write_voice_encoder_weights(torch, path: Path) -> Path:
    """Seeded VoiceEncoder weights in the published ``pretrained.pt``
    layout (the state_dict under 'model_state', with its extra keys)."""
    from forwardtacotron_torch.models.speaker_encoder import \
        init_voice_encoder_params
    state = {k: torch.from_numpy(v)
             for k, v in init_voice_encoder_params(SEED + 41).items()}
    state.update(similarity_weight=torch.tensor([10.0]),
                 similarity_bias=torch.tensor([-5.0]))
    torch.save({'model_state': state, 'step': 0}, path)
    return path


def run_cli(label: str, module: str, args, env=None):
    """``python -m <module> <args>`` from the repository root; fails on a
    non-zero exit. Returns (its wall seconds, its standard output)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=env)
    sec = time.perf_counter() - t0
    log(f'{label}: exit {proc.returncode} in {sec:.1f} s; '
        f'{proc.stdout.strip()[-300:]!r}')
    if proc.returncode != 0:
        fail(f'{label} failed:\n{proc.stderr[-3000:]}')
    return sec, proc.stdout


def pipeline_preprocess_checks(torch, cfg, root, weights) -> dict:
    """After ``python -m forwardtacotron_torch.preprocess``: every mel
    (n_mels, 1 + samples // hop) of its trimmed wav, PIPE_MEL_CHECKS of
    them within PIPE_MEL_TOL (relative L2) of the CPU DSP, the splits,
    pickles and embeddings written; the VoiceEncoder (``weights`` through
    ``$RESEMBLYZER_WEIGHTS`` and ``make_speaker_encoder``) on the card
    against the CPU on PIPE_EMBED_ITEMS wavs."""
    import os

    from forwardtacotron_torch.data.preprocess import (
        HostPreprocessor, MelStatsSpeakerEncoder, make_speaker_encoder)
    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.utils.files import unpickle_binary
    from forwardtacotron_torch.utils.paths import Paths

    paths = Paths.from_config(cfg)
    cpu = DSP.from_config(cfg, device='cpu')
    host = HostPreprocessor(paths, cfg, {})
    items = dict(unpickle_binary(paths.train_dataset)
                 + unpickle_binary(paths.val_dataset))
    n_all = len(PIPE_TOKENS) * PIPE_PER_LEN
    speakers = unpickle_binary(paths.speaker_dict)
    if (len(items) != n_all or len(unpickle_binary(paths.val_dataset))
            != PIPE_VAL or sorted(unpickle_binary(paths.text_dict))
            != sorted(items) or sorted(speakers) != sorted(items)):
        fail(f'preprocess: {len(items)} items in the splits, expected '
             f'{n_all} with {PIPE_VAL} in val, and matching dicts')
    wavs = root / 'corpus' / 'wavs'
    rel = []
    for k, (item_id, mel_len) in enumerate(sorted(items.items())):
        y = host.load_trimmed(wavs / f'{item_id}.wav')
        mel = np.load(paths.mel / f'{item_id}.npy')
        emb = np.load(paths.speaker_emb / f'{item_id}.npy')
        want = (cfg['dsp']['num_mels'], 1 + len(y) // cfg['dsp']['hop_length'])
        if mel.shape != want or mel_len != want[1] or \
                not np.isfinite(mel).all() or emb.shape != (256,):
            fail(f'preprocess: {item_id} mel {mel.shape}, expected {want}')
        if k < PIPE_MEL_CHECKS:
            ref = cpu.wav_to_mel(y)
            rel.append(float(np.linalg.norm(mel - ref) / np.linalg.norm(ref)))
    ok = max(rel) <= PIPE_MEL_TOL
    log(f'preprocess: {n_all} mels of (80, 1 + samples // hop), '
        f'{len(items)} in the splits; {PIPE_MEL_CHECKS} mels vs the CPU DSP: '
        f'rel L2 {max(rel):.3e} (tol {PIPE_MEL_TOL:g}) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('preprocess: card mels disagree with the CPU DSP')
    for speaker in set(speakers.values()):
        mean = np.load(paths.mean_speaker_emb / f'{speaker}.npy')
        if abs(float(np.linalg.norm(mean)) - 1.0) > 1e-5:
            fail(f'preprocess: mean embedding of {speaker} is not unit')

    old = os.environ.get('RESEMBLYZER_WEIGHTS')
    os.environ['RESEMBLYZER_WEIGHTS'] = str(weights)
    try:
        encoders = {d: make_speaker_encoder(cfg['dsp']['num_mels'], d)
                    for d in ('cpu', 'cuda')}
    finally:
        if old is None:
            del os.environ['RESEMBLYZER_WEIGHTS']
        else:
            os.environ['RESEMBLYZER_WEIGHTS'] = old
    if any(isinstance(e, MelStatsSpeakerEncoder) for e in encoders.values()):
        fail('make_speaker_encoder did not take the VoiceEncoder')
    err, card_s = 0.0, 0.0
    sr = cfg['dsp']['sample_rate']
    ids = sorted(items)[::len(items) // PIPE_EMBED_ITEMS][:PIPE_EMBED_ITEMS]
    encoders['cuda'].embed(None, wav=host.load_trimmed(
        wavs / f'{ids[0]}.wav'), sample_rate=sr)          # warm-up
    torch.cuda.synchronize()
    for item_id in ids:
        y = host.load_trimmed(wavs / f'{item_id}.wav')
        t0 = time.perf_counter()
        got = encoders['cuda'].embed(None, wav=y, sample_rate=sr)
        card_s += time.perf_counter() - t0
        want = encoders['cpu'].embed(None, wav=y, sample_rate=sr)
        err = max(err, float(np.abs(got - want).max()))
        # the CLI embedded with the same weights on the card
        err = max(err, float(np.abs(np.load(
            paths.speaker_emb / f'{item_id}.npy') - want).max()))
    ok = err <= PIPE_EMB_TOL
    log(f'speaker encoder (seeded published-layout weights): '
        f'{PIPE_EMBED_ITEMS} wavs card vs CPU max_abs_err {err:.3e} (tol '
        f'{PIPE_EMB_TOL:g}) {"ok" if ok else "FAIL"}; '
        f'{card_s / PIPE_EMBED_ITEMS * 1e3:.1f} ms an utterance with the card '
        '(its host preprocessing included)')
    if not ok:
        fail('speaker encoder: card disagrees with the CPU')
    return dict(items=len(items), mel_rel_l2=max(rel), emb_max_abs_err=err,
                emb_ms_per_item=card_s / PIPE_EMBED_ITEMS * 1e3)


def pipeline_extraction_phase(torch, cfg) -> dict:
    """In this process, from the checkpoint the default mode trained: the
    extraction's launches (exactly 2 ``pre_highway_stack`` and 2
    ``cbhg_front`` a batch, nothing else) and its time per batch and item,
    the postnet's share of a batch, one batch's attention on the card
    against the CPU (PreNet dropout off on both), the native DP against
    the numpy DP on every item and Dijkstra on PIPE_DIJKSTRA_ITEMS, the
    DP's time per item (native; the pool of PIPE_WORKERS; serial), the
    targets' time."""
    from forwardtacotron_torch.data.dataset import get_binned_taco_dataloader
    from forwardtacotron_torch.duration import extractor as ext
    from forwardtacotron_torch.duration.pipeline import \
        DurationExtractionPipeline
    from forwardtacotron_torch.duration.targets import extract_pitch_energy
    from forwardtacotron_torch.models.tacotron import Tacotron
    from forwardtacotron_torch.native import load_library
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    from forwardtacotron_torch.utils.checkpoints import restore_checkpoint
    from forwardtacotron_torch.utils.files import unpickle_binary
    from forwardtacotron_torch.utils.paths import Paths

    paths = Paths.from_config(cfg)
    model = Tacotron.from_config(cfg)
    model.load_state_dict(restore_checkpoint(paths.taco_checkpoints)['model'])
    dcfg = cfg['duration_extraction']
    extractor = ext.DurationExtractor(dcfg['silence_threshold'],
                                      dcfg['silence_prob_shift'])
    pipe = DurationExtractionPipeline(paths, cfg, extractor)
    n_batches = len(get_binned_taco_dataloader(paths,
                                               dcfg['max_batch_size']))
    n_items = len(PIPE_TOKENS) * PIPE_PER_LEN
    out = {'batches': n_batches}
    pipe.extract_attentions(model, dcfg['max_batch_size'],
                            device='cuda')  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    score = pipe.extract_attentions(model, dcfg['max_batch_size'],
                                    device='cuda')
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    expect_counts('extraction', counts,
                  pre_highway_stack=2 * n_batches, cbhg_front=2 * n_batches)
    out.update(sharpness=score, s=sec, ms_per_batch=sec / n_batches * 1e3,
               ms_per_item=sec / n_items * 1e3,
               launches_per_batch={row: counts[row] / n_batches for row in
                                   ('pre_highway_stack', 'cbhg_front')})
    log(f'extraction: {n_batches} batches of <= {dcfg["max_batch_size"]}, '
        f'{sec:.2f} s: {out["ms_per_batch"]:.1f} ms a batch, '
        f'{out["ms_per_item"]:.1f} ms an item, {n_items / sec:.1f} items/s, '
        f'sharpness {score:.4f}')

    # the postnet's share of the longest batch, and card vs CPU on the
    # shortest, PreNet dropout off on both sides
    batches = list(get_binned_taco_dataloader(paths, dcfg['max_batch_size']))
    longest = max(batches, key=lambda b: b['mel'].shape[1])
    shortest = min(batches, key=lambda b: b['mel'].shape[1])
    quiet = teacher_no_dropout(torch, copy.deepcopy(model)).eval()
    with torch.inference_mode():
        dev_in = {k: torch.as_tensor(longest[k], device='cuda')
                  for k in ('x', 'mel', 'speaker_emb')}
        fwd_ms = time_ms(torch, lambda: quiet(dev_in, r=1), reps=3, warmup=1)
        mel = quiet(dev_in, r=1)[0]
        post_ms = time_ms(torch, lambda: quiet._post(mel), reps=10)
        out.update(forward_ms=fwd_ms, postnet_ms=post_ms,
                   postnet_share=post_ms / fwd_ms,
                   longest=list(longest['mel'].shape[:2]))
        log(f'extraction batch {tuple(longest["mel"].shape[:2])}: forward '
            f'{fwd_ms:.1f} ms, postnet {post_ms:.2f} ms '
            f'({100 * post_ms / fwd_ms:.2f}%, which a jit that returns only '
            'the attention drops)')
        host = {k: torch.as_tensor(shortest[k])
                for k in ('x', 'mel', 'speaker_emb')}
        got = quiet({k: v.cuda() for k, v in host.items()}, r=1)[2]
        t0 = time.perf_counter()
        want = copy.deepcopy(quiet).cpu()(host, r=1)[2]
        cpu_s = time.perf_counter() - t0
    err = float((got.cpu() - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= PIPE_ATTN_TOL
    log(f'extraction attention card vs CPU, batch '
        f'{tuple(shortest["mel"].shape[:2])}: max_abs_err {err:.3e} (tol '
        f'{PIPE_ATTN_TOL:g}) {"ok" if ok else "FAIL"}; CPU {cpu_s:.1f} s')
    if not ok:
        fail('extraction attention disagrees with the CPU path')
    out['attention_card_vs_cpu'] = err

    # the DP: native library, node for node against numpy; Dijkstra on a few
    if load_library('duration_dp') is None:
        fail('the native duration DP did not build or load')
    texts, tok = unpickle_binary(paths.text_dict), Tokenizer()
    native_s, numpy_s, checked = 0.0, 0.0, 0
    for k, item_id in enumerate(sorted(texts)):
        x = np.asarray(tok(texts[item_id]))
        att, _ = extractor.shifted_attention(
            x, np.load(paths.mel / f'{item_id}.npy'),
            np.load(paths.att_pred / f'{item_id}.npy'))
        w = 1.0 - att
        t0 = time.perf_counter()
        native = ext._shortest_monotonic_path_native(w)
        native_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = ext._shortest_monotonic_path_dp(w)
        numpy_s += time.perf_counter() - t0
        if native != plain:
            fail(f'native DP differs from the numpy DP on {item_id}')
        if k < PIPE_DIJKSTRA_ITEMS and \
                ext._shortest_monotonic_path_dijkstra(w) != plain:
            fail(f'Dijkstra differs from the DP on {item_id}')
        checked += 1
    out.update(dp_native_ms_per_item=native_s / checked * 1e3,
               dp_numpy_ms_per_item=numpy_s / checked * 1e3)
    for workers in (PIPE_WORKERS, 0):
        t0 = time.perf_counter()
        pipe.extract_durations(num_workers=workers)
        out[f'durations_{workers}_workers_ms_per_item'] = \
            (time.perf_counter() - t0) / n_items * 1e3
    t0 = time.perf_counter()
    extract_pitch_energy(paths, cfg['preprocessing']['pitch_min_freq'],
                         cfg['preprocessing']['pitch_max_freq'])
    out['targets_s'] = time.perf_counter() - t0
    log(f'durations: {checked} items native == numpy DP, '
        f'{PIPE_DIJKSTRA_ITEMS} == Dijkstra; native '
        f'{out["dp_native_ms_per_item"]:.2f} ms an item, numpy '
        f'{out["dp_numpy_ms_per_item"]:.1f}; extract_durations '
        f'{out[f"durations_{PIPE_WORKERS}_workers_ms_per_item"]:.2f} ms an '
        f'item with {PIPE_WORKERS} workers, '
        f'{out["durations_0_workers_ms_per_item"]:.2f} serial; targets '
        f'{out["targets_s"]:.2f} s')
    return out


def pipeline_target_checks(cfg) -> dict:
    """The extracted files: every ``alg/<id>.npy`` sums to its mel length;
    ``phon_pitch`` / ``phon_energy`` one finite value a token, nonzero
    pitch z-normalised; ``duration_stats.pkl`` loads;
    ``get_forward_dataloaders`` yields a batch."""
    from forwardtacotron_torch.data.dataset import (get_forward_dataloaders,
                                                    load_duration_stats)
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    from forwardtacotron_torch.utils.files import unpickle_binary
    from forwardtacotron_torch.utils.paths import Paths

    paths = Paths.from_config(cfg)
    items = dict(unpickle_binary(paths.train_dataset)
                 + unpickle_binary(paths.val_dataset))
    texts, tok = unpickle_binary(paths.text_dict), Tokenizer()
    pitches = []
    for item_id, mel_len in items.items():
        n_tok = len(tok(texts[item_id]))
        alg = np.load(paths.alg / f'{item_id}.npy')
        pitch = np.load(paths.phon_pitch / f'{item_id}.npy')
        energy = np.load(paths.phon_energy / f'{item_id}.npy')
        if alg.shape != (n_tok,) or int(alg.sum()) != mel_len:
            fail(f'alg/{item_id}: {alg.shape} summing to {alg.sum()}, '
                 f'expected ({n_tok},) summing to {mel_len}')
        if pitch.shape != (n_tok,) or energy.shape != (n_tok,) or \
                not (np.isfinite(pitch).all() and np.isfinite(energy).all()):
            fail(f'{item_id}: pitch {pitch.shape}, energy {energy.shape}, '
                 f'expected finite ({n_tok},)')
        pitches.append(pitch[pitch != 0])
    nz = np.concatenate(pitches)
    if abs(float(nz.mean())) > 1e-3 or abs(float(nz.std()) - 1.0) > 1e-3:
        fail(f'nonzero pitch not z-normalised: mean {nz.mean()}, std '
             f'{nz.std()}')
    stats = load_duration_stats(paths.duration_stats)
    if sorted(stats) != sorted(items):
        fail('duration_stats.pkl does not cover every item')
    filt = dict(cfg['tacotron']['training']['filter'],
                filter_duration_stats=False)
    train_set, _ = get_forward_dataloaders(paths, 8, seed=SEED, **filt)
    batch = next(iter(train_set))
    if batch['dur'].shape != batch['x'].shape or \
            not np.isfinite(batch['pitch']).all():
        fail('get_forward_dataloaders: no batch from the extracted files')
    log(f'targets: {len(items)} alg files sum to their mels; pitch and '
        f'energy a token, nonzero pitch mean {nz.mean():.2e} std '
        f'{nz.std():.6f}; duration_stats {len(stats)} items; a forward '
        f'batch {tuple(batch["x"].shape)}')
    return {'nonzero_pitch_mean': float(nz.mean()),
            'nonzero_pitch_std': float(nz.std())}


def pipeline_phase(torch, config) -> dict:
    """Phase 18: the data pipeline on a seeded synthetic corpus, from wavs
    to the forward models' targets, through the CLIs a user runs, with
    rows 1-2 at one extraction batch of 32."""
    import os

    import yaml

    t_all = time.perf_counter()
    log('rows 1-2 at one extraction batch (B 32, f32; the encoder\'s tokens '
        'of equal length):')
    with torch.inference_mode():
        out = {'kernels': teacher_kernel_phase(
            torch, teacher_model(torch, config), b=32,
            tokens=max(PIPE_TOKENS), frames=TEACHER_FRAMES, dtypes=('f32',),
            equal_tokens=True)}
    out['kernels_s'] = time.perf_counter() - t_all
    with tempfile.TemporaryDirectory(prefix='chip_smoke_pipeline_') as tmp:
        root = Path(tmp)
        cfg = copy.deepcopy(config)
        cfg.update(data_path=str(root / 'data'),
                   checkpoint_path=str(root / 'ckpt'))
        cfg['preprocessing'].update(use_phonemes=False,
                                    cleaner_name='no_cleaners', n_val=PIPE_VAL)
        cfg['duration_extraction']['num_workers'] = PIPE_WORKERS
        cfg['tacotron']['training'].update(schedule=PIPE_SCHEDULE,
                                           checkpoint_every=2)
        cfg_path = root / 'config.yaml'
        cfg_path.write_text(yaml.dump(cfg))
        t0 = time.perf_counter()
        write_corpus(root / 'corpus', PIPE_TOKENS, PIPE_PER_LEN,
                     cfg['dsp']['sample_rate'], cfg['dsp']['hop_length'])
        out['corpus_s'] = time.perf_counter() - t0
        weights = write_voice_encoder_weights(torch, root / 'pretrained.pt')
        env = dict(os.environ, RESEMBLYZER_WEIGHTS=str(weights))
        n_items = len(PIPE_TOKENS) * PIPE_PER_LEN
        base = ['--config', str(cfg_path)]
        out['preprocess_s'], _ = run_cli(
            'preprocess', 'forwardtacotron_torch.preprocess',
            ['--path', str(root / 'corpus'), '--num_workers',
             str(PIPE_WORKERS), *base], env)
        out['preprocess_ms_per_item'] = out['preprocess_s'] / n_items * 1e3
        out['preprocess'] = pipeline_preprocess_checks(torch, cfg, root,
                                                       weights)
        out['train_and_extract_s'], _ = run_cli(
            'train_tacotron (train, then extract)',
            'forwardtacotron_torch.train_tacotron', base)
        out['targets'] = pipeline_target_checks(cfg)
        out['extraction'] = pipeline_extraction_phase(torch, cfg)
        torch.cuda.empty_cache()
        for flag in ('--force_align', '--extract_pitch'):
            subs = ('alg', 'phon_pitch', 'phon_energy') \
                if flag == '--force_align' else ('phon_pitch', 'phon_energy')
            for sub in subs:
                for f in (root / 'data' / sub).glob('*.npy'):
                    f.unlink()
            if flag == '--force_align':
                (root / 'data' / 'duration_stats.pkl').unlink()
            out[f'{flag[2:]}_s'], _ = run_cli(
                f'train_tacotron {flag}',
                'forwardtacotron_torch.train_tacotron', [*base, flag])
            pipeline_target_checks(cfg)
    out['phase_s'] = time.perf_counter() - t_all
    log('pipeline phase: ' + ', '.join(
        f'{k[:-2]} {v:.1f} s' for k, v in out.items() if k.endswith('_s')))
    return out


# phase 19: data parallelism. Serving: bf16 generate_fused at the serving
# batch and at an odd one (which pads), f32 generate on the requests, each
# over a mesh of every card (the one card twice on a one-card machine)
# against one replica. Training: a world of ranks (NCCL, one a card; on one
# card two gloo ranks sharing it) takes DP_TRAIN_STEPS bf16 ForwardTrainer
# steps and one f32 TacoTrainer step at TRAIN_BATCH rows a rank, against a
# world of 1 on NCCL taking them on the concatenated global batch
DP_SERVING_BATCHES = (SERVING_BATCH, SERVING_BATCH - 3)
DP_TRAIN_STEPS = 3
DP_TEACHER_R = 5
DP_TIMEOUT_S = 300
# same card, same kernels; a share is another batch size, so a kernel plan
# or a cuBLAS product may sum in another order, land on the neighbouring
# bf16 value and carry it through a recurrence: the bf16 kernel tolerance.
# float32 requests: the kernel-vs-twin tolerance
DP_SERVING_TOL = {'bfloat16': 3e-2, 'float32': KERNEL_TOL}
# rows 9-10 (and row 7's GRU forward) per bf16 train step, per rank
DP_STEP_LAUNCHES = {'gru': 3, 'lstm_train': 1, 'gru_bwd': 6, 'lstm_bwd': 2}


def dp_worker():
    """tests/torch_parallel_worker.py, the rank program of the
    data-parallel runs (it imports the port only)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'torch_parallel_worker', REPO / 'tests' / 'torch_parallel_worker.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def spy_card_launches(rnn):
    """Attribute each rnn.cu launch (rows 4, 6, 7, 9) to its card: a
    Counter of (mode, card index) filled around ``rnn._launch``, whose own
    counts stay as they are; returns (counter, undo)."""
    per_card = collections.Counter()
    real = rnn._launch

    def spy(name, entry, ptrs, ints, x2, *args, **kwargs):
        before = rnn.launches[name]
        out = real(name, entry, ptrs, ints, x2, *args, **kwargs)
        per_card[(name, x2.device.index)] += rnn.launches[name] - before
        return out
    rnn._launch = spy
    return per_card, lambda: setattr(rnn, '_launch', real)


def dp_compare(torch, label, got, want, tol, lengths):
    """mel_len exactly, mel_post on valid frames within ``tol`` of the
    scale; returns (max abs error, rows exactly equal)."""
    if got['mel_post'].shape != want['mel_post'].shape:
        fail(f'{label}: mel_post {tuple(got["mel_post"].shape)}, one '
             f'replica {tuple(want["mel_post"].shape)}')
    if not torch.equal(got['mel_len'], want['mel_len']):
        fail(f'{label}: mel_len differs from one replica')
    g, w = got['mel_post'].float(), want['mel_post'].float()
    frames = torch.arange(g.shape[1], device=g.device)[None, :]
    valid = (frames < torch.as_tensor(lengths, device=g.device)[:, None])
    diff = ((g - w).abs() * valid[:, :, None]).amax(dim=(1, 2))
    err = float(diff.max())
    scale = max(1.0, float((w.abs() * valid[:, :, None]).max()))
    same = int((diff == 0).sum())
    ok = bool(torch.isfinite(g).all()) and err <= tol * scale
    log(f'{label}: max abs {err:.3e} of scale {scale:.2f} (tol {tol:g}), '
        f'{same} of {len(diff)} rows equal {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{label}: the mesh disagrees with one replica')
    return err, same


def dp_serving(torch, model, tokens, devices):
    """The bf16 serving calls and the f32 requests over the mesh against
    one replica, with the launches of rows 4, 6 and 7 per card."""
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.ops.hopper import rnn
    from forwardtacotron_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=devices)
    n = len(mesh)
    model16 = set_frames_per_token(
        torch, copy.deepcopy(model).to(torch.bfloat16),
        SERVING_FRAMES_PER_TOKEN)
    out = {'mesh': [str(d) for d in mesh]}
    per_card, undo = spy_card_launches(rnn)
    try:
        for dtype, m in (('bfloat16', model16), ('float32', model)):
            one = TTSInference(copy.deepcopy(m), dtype=dtype, device='cuda')
            dp = TTSInference(copy.deepcopy(m), dtype=dtype, mesh=mesh)
            if dtype == 'bfloat16':
                calls = [(f'bf16 generate_fused, batch {b}',
                          serving_requests(torch, b)) for b in
                         DP_SERVING_BATCHES]
            else:
                x = np.zeros((len(tokens), max(map(len, tokens))), np.int64)
                for i, t in enumerate(tokens):
                    x[i, :len(t)] = t
                calls = [(f'f32 generate, {len(tokens)} requests',
                          torch.as_tensor(x, device='cuda'))]
            for label, x in calls:
                def run(inf):
                    if dtype == 'bfloat16':
                        return inf.generate_fused(x, max_len=SERVING_MAX_LEN)
                    return inf.generate(x)
                run(dp), run(one)          # warm-up on every card
                torch.cuda.synchronize()
                times = {}
                for name, inf in (('one', one), ('mesh', dp)):
                    reset_counts()
                    per_card.clear()
                    t0 = time.perf_counter()
                    res = run(inf)
                    torch.cuda.synchronize()
                    times[name] = (time.perf_counter() - t0) * 1e3
                    counts, cards = read_counts(), dict(per_card)
                    if name == 'one':
                        want, one_counts = res, counts
                if res['mel_post'].shape[0] != len(x):
                    fail(f'{label}: {res["mel_post"].shape[0]} rows, '
                         f'{len(x)} requests')
                # every replica runs the one-replica call's kernels
                expect_counts(f'{label} over {n} replicas', counts,
                              **{k: n * v for k, v in one_counts.items()})
                lengths = np.minimum(want['mel_len'].cpu().numpy(),
                                     want['mel_post'].shape[1])
                err, same = dp_compare(torch, label, res, want,
                                       DP_SERVING_TOL[dtype], lengths)
                by_card = collections.defaultdict(dict)
                for (mode, card), c in cards.items():
                    if c:
                        by_card[f'cuda:{card}'][mode] = c
                log(f'{label}: one replica {times["one"]:.1f} ms, mesh '
                    f'{times["mesh"]:.1f} ms (host clock, synchronized); '
                    f'rnn.cu launches per card {dict(by_card)}')
                out[label] = dict(one_ms=times['one'], mesh_ms=times['mesh'],
                                  max_abs_err=err, rows_equal=same,
                                  rows=len(x), launches=counts,
                                  rnn_launches_per_card=dict(by_card))
            del one, dp
            torch.cuda.empty_cache()
    finally:
        undo()
    return out


def dp_jobs(torch, config, world, root):
    """The bf16 ForwardTrainer job and the f32 TacoTrainer job for a
    ``world`` of ranks (TRAIN_BATCH rows each, dropout off; their paths
    under ``root``) and the same jobs on the concatenated global batch."""
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.models.tacotron import Tacotron

    worker = dp_worker()
    n_mels = config['dsp']['num_mels']
    out, ref = [], []
    for kind in ('forward', 'taco'):
        if kind == 'forward':
            cfg = train_config(config, root / kind, 'bfloat16',
                               DP_TRAIN_STEPS, dropout=False)
            torch.manual_seed(SEED)
            model = init_tts_model(cfg)
            multiple, steps = 32, DP_TRAIN_STEPS
        else:
            cfg = teacher_train_config(
                config, root / kind, 'float32',
                [f'{DP_TEACHER_R}, {TRAIN_LR}, 1, {TRAIN_BATCH}'])
            torch.manual_seed(SEED)
            model = Tacotron.from_config(cfg)
            multiple, steps = 8 * DP_TEACHER_R, 2
        items = worker.make_items(world * TRAIN_BATCH, SEED + world, n_mels,
                                  tokens=TRAIN_TOKENS, frames=TRAIN_FRAMES)
        batches, global_batch = worker.rank_batches(items, world, multiple)
        job = {'trainer': kind, 'config': cfg, 'r': DP_TEACHER_R,
               'steps': steps, 'state_dict': model.state_dict()}
        out.append(dict(job, batches=batches))
        ref.append(dict(job, batches=[global_batch]))
    return out, ref


def dp_step_check(worker, label, got, want, tol, mp):
    """One rank's first step against the global batch's: loss and gradient
    norm within ``tol`` relative, the BatchNorm statistics within ``tol``
    of the scale, the parameters as the CPU tests hold a step
    (``worker.step_difference``: bf16 a mean difference of at most LR /
    10, float32 at most 0.5% of the elements 1e-5 relative + LR / 100
    apart and none 2 LR)."""
    rel = max(abs(got['metrics'][k] - want['metrics'][k])
              / abs(want['metrics'][k]) for k in ('loss', 'grad_norm'))
    stat_err, param = worker.step_difference(got['state'], want['state'],
                                             TRAIN_LR, mp)
    ok = rel <= tol and stat_err <= tol and param <= (0.1 if mp else 5e-3)
    log(f'{label}: loss / grad norm {got["metrics"]["loss"]:.6f} / '
        f'{got["metrics"]["grad_norm"]:.6f}, global batch '
        f'{want["metrics"]["loss"]:.6f} / {want["metrics"]["grad_norm"]:.6f}:'
        f' rel {rel:.3e}; BN statistics {stat_err:.3e} (tol {tol:g}); '
        + (f'mean parameter difference {param:.3f} LR (tol 0.1)' if mp else
           f'{param:.2e} of the parameters apart (tol 5e-3)')
        + f' {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{label}: the ranks\' step disagrees with the global batch\'s')
    return dict(rel=rel, bn_stat_err=stat_err, param_diff=param)


def dp_training(torch, config, card):
    """The ranks' steps against the global batch's, rows 9-10 per rank."""
    n_cards = torch.cuda.device_count()
    worker = dp_worker()
    if n_cards > 1:
        world, form = n_cards, f'NCCL, one rank on each of {n_cards} cards'
        job = {'backend': 'cuda', 'device': 'cuda'}
    else:
        world, form = 2, 'gloo, two ranks sharing cuda:0'
        job = {'backend': 'cpu', 'device': 'cuda:0'}
    log(f'data-parallel training: {form}, against a world of 1 on NCCL')
    out = {'form': form, 'world': world}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dp_') as tmp:
        jobs, refs = dp_jobs(torch, config, world, Path(tmp))
        runs = {}
        for name, spec in (('ranks', dict(job, jobs=jobs)),
                           ('global', {'backend': 'cuda', 'device': 'cuda',
                                       'jobs': refs})):
            sub = Path(tmp) / name
            sub.mkdir()
            t0 = time.perf_counter()
            runs[name] = worker.launch(spec, sub, timeout=DP_TIMEOUT_S)
            out[f'{name}_run_s'] = time.perf_counter() - t0
    for i, (kind, precision) in enumerate((('forward', 'bfloat16'),
                                           ('taco', 'float32'))):
        label = f'{kind} {precision}'
        ranks = [r[i] for r in runs['ranks']]
        want = runs['global'][0][i]
        for r, res in enumerate(ranks[1:], 1):
            for key, value in ranks[0]['state'].items():
                if not torch.equal(res['state'][key], value):
                    fail(f'{label}: rank {r} holds another {key} than '
                         'rank 0 after the step')
        check = dp_step_check(
            worker, f'{label}, {world} ranks vs global batch', ranks[0],
            want, E2E_TRAIN_TOL[precision], precision == 'bfloat16')
        steps = len(ranks[0]['times'])
        expect = ({k: v * steps for k, v in DP_STEP_LAUNCHES.items()}
                  if kind == 'forward' else {})
        for r, res in enumerate(ranks):
            expect_counts(f'{label} rank {r} ({res["device"]})',
                          res['launches'], **expect)
        for r, res in enumerate(ranks + [want]):
            who = f'rank {r}' if r < world else 'global batch, 1 rank'
            log(f'{label} {who}: step wall ms '
                + ', '.join(f'{t * 1e3:.1f}' for t in res['times'])
                + f' ({card})')
        out[label] = dict(
            check, steps=steps, launches_per_rank=[r['launches'] for r in
                                                   ranks],
            step_ms_per_rank=[[t * 1e3 for t in r['times']] for r in ranks],
            global_step_ms=[t * 1e3 for t in want['times']],
            shapes=[[list(s) for s in r['shape']] for r in ranks])
    return out


def dp_launches(dp: dict, modes) -> dict:
    """The launches of ``modes`` in phase 19: per card for each bf16
    serving call, per rank for the bf16 train steps."""
    out = {}
    for label, res in dp['serving'].items():
        if label.startswith('bf16'):
            out[label + ', per card'] = {
                card: {m: c[m] for m in modes if m in c}
                for card, c in res['rnn_launches_per_card'].items()}
    train = dp['training']['forward bfloat16']
    out[f'{train["steps"]} bf16 train steps, per rank'] = [
        {m: r[m] for m in modes} for r in train['launches_per_rank']]
    return out


def data_parallel_phase(torch, model, config, tokens, card) -> dict:
    """Phase 19 (``--data-parallel`` alone)."""
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    devices = ([f'cuda:{i}' for i in range(n_cards)] if n_cards > 1
               else ['cuda:0', 'cuda:0'])
    log(f'data parallel: {n_cards} card(s) visible; serving mesh {devices}'
        + ('' if n_cards > 1 else ' (the one card twice)'))
    out = {'cards': n_cards, 'serving': dp_serving(torch, model.cuda(),
                                                   tokens, devices)}
    torch.cuda.empty_cache()
    out['training'] = dp_training(torch, config, card)
    out['phase_s'] = time.perf_counter() - t0
    log(f'data-parallel phase: {out["phase_s"]:.1f} s')
    return out


# ------------------------------------------------------------ entry points
#
# phase 20: the remaining utils and entry points. The GTA
# export runs on items of the training phase's kind (80-160 tokens, 2-9
# frames each), cut to ENTRY_ITEMS of which ENTRY_VAL_ITEMS validate: 3
# batches (8, 8, 4)
ENTRY_ITEMS, ENTRY_VAL_ITEMS = 20, 4
GTA_BATCH = 8
# the plots (each of the first validation item): timed on items of the
# training phase's kind, what a trainer plots every plot_every steps, and
# held against the CPU on items of PLOT_TOKENS phonemes (the CPU reference
# of the three trainers at the training phase's lengths takes ~40 s);
# PLOT_SPEAKERS speakers for MultiForwardTrainer, the teacher at its
# schedule's first r; PLOT_STEPS bf16 steps at PLOT_BATCH with a plot
# after each against the same steps without, on the short items
PLOT_ITEMS, PLOT_VAL_ITEMS, PLOT_TOKENS = 16, 4, (12, 24)
PLOT_SPEAKERS = 3
PLOT_STEPS, PLOT_BATCH = 2, 8
# the sentence of the checkpoint and Synthesizer checks (pre-phonemized)
ENTRY_TEXT = 'ðə kwɪk bɹaʊn fɑks dʒʌmps oʊvɚ ðə leɪzi dɑɡ.'
# what the trace of one float32 request must name: an annotate span and
# the kernels of rows 1, 2 and 8
TRACE_SPAN = 'chip_smoke_request'
TRACE_KERNELS = ('highway_kernel', 'cbhg_front_kernel', LR_KERNEL)


def entry_config(config, root, family=None):
    """``config`` (or configs/multispeaker.yaml's ``family``) at full width
    with its data and checkpoints under ``root``, bf16 training at
    PLOT_BATCH, one schedule row of PLOT_STEPS steps, no plots or
    checkpoints between epochs."""
    from forwardtacotron_torch.utils.files import read_config
    if family is not None:
        config = multi_config(
            read_config(REPO / 'configs' / 'multispeaker.yaml'), family)
    cfg = train_config(config, root, 'bfloat16', PLOT_STEPS)
    section = cfg[cfg.get('tts_model', 'forward_tacotron')]['training']
    section.update(plot_every=10 ** 9,
                   schedule=[f'{TRAIN_LR}, {PLOT_STEPS}, {PLOT_BATCH}'])
    return cfg


def gta_export_phase(torch, config, root) -> dict:
    """(a) ``train_forward --force_gta`` from a port checkpoint: one
    (n_mels, mel_len) file per item; in this process ``export_gta``'s
    launches (2 ``pre_highway_stack``, 1 ``cbhg_front``, 1 ``lr`` a batch,
    nothing else) and time; the first validation batch's files against
    the CPU plain path."""
    import yaml

    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.train_forward import export_gta
    from forwardtacotron_torch.utils.checkpoints import save_checkpoint
    from forwardtacotron_torch.utils.files import unpickle_binary

    cfg = entry_config(config, root)
    paths = write_train_data(cfg, ENTRY_ITEMS, ENTRY_VAL_ITEMS)
    model = make_model(torch, cfg)
    save_checkpoint(paths.forward_checkpoints / 'latest_model.pt', model,
                    cfg, step=0)
    cfg_path = root / 'gta_config.yaml'
    cfg_path.write_text(yaml.dump(cfg))
    out = {}
    out['cli_s'], _ = run_cli('train_forward --force_gta',
                              'forwardtacotron_torch.train_forward',
                              ['--config', str(cfg_path), '--force_gta'])
    items = dict(unpickle_binary(paths.train_dataset)
                 + unpickle_binary(paths.val_dataset))
    n_mels = cfg['dsp']['num_mels']
    files = {p.stem: np.load(p) for p in paths.gta.glob('*.npy')}
    bad = [k for k, n in items.items()
           if k not in files or files[k].shape != (n_mels, n)
           or not np.isfinite(files[k]).all()]
    log(f'train_forward --force_gta: {len(files)} files for {len(items)} '
        f'items{"" if not bad else f"; wrong: {bad}"}')
    if bad or len(files) != len(items):
        fail('train_forward --force_gta: a file is missing or wrong')

    n_batches = sum(-(-n // GTA_BATCH) for n in (
        ENTRY_ITEMS - ENTRY_VAL_ITEMS, ENTRY_VAL_ITEMS))
    model.cuda()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    written = export_gta(model, paths, cfg, 'cuda')
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    expect_counts(f'export_gta, {n_batches} batches', counts,
                  pre_highway_stack=2 * n_batches, cbhg_front=n_batches,
                  lr=n_batches)
    if written != len(items):
        fail(f'export_gta wrote {written} of {len(items)} items')
    out.update(batches=n_batches, ms_per_batch=sec * 1e3 / n_batches,
               launches_per_batch={k: v / n_batches
                                   for k, v in counts.items() if v})
    log(f'export_gta: {out["ms_per_batch"]:.1f} ms a batch (host clock, '
        f'synchronized; the first call in this process)')

    filters = cfg['forward_tacotron']['training']['filter']
    _, val_set = get_forward_dataloaders(paths, GTA_BATCH, **filters)
    batch = next(iter(val_set))
    cpu = copy.deepcopy(model).cpu().eval()
    with torch.inference_mode():
        ref = cpu({k: torch.as_tensor(v) for k, v in batch.items()
                   if isinstance(v, np.ndarray)})['mel_post'].numpy()
    errs = []
    for j, item_id in enumerate(batch['item_id']):
        want = ref[j, :int(batch['mel_len'][j])].T
        errs.append(float(np.abs(files[item_id] - want).max())
                    / max(1.0, float(np.abs(want).max())))
    out['cpu_rel_err'] = max(errs)
    ok = out['cpu_rel_err'] <= E2E_MEL_ATOL
    log(f'GTA files of a validation batch vs the CPU plain path: max err '
        f'{out["cpu_rel_err"]:.3e} of the scale (<= {E2E_MEL_ATOL:g}) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('the GTA export disagrees with the CPU plain path')
    return out


def seeded_opt_state(torch, model, cfg_section, step):
    """A train state of ``model`` at ``step`` whose Adam moments hold one
    update on seeded gradients (what a checkpoint carries)."""
    from forwardtacotron_torch.train.state import (create_train_state,
                                                   make_optimizer)
    tx = make_optimizer(TRAIN_LR,
                        cfg_section['training'].get('clip_grad_norm', 1.0))
    state = create_train_state(model, tx, step=step)
    gen = torch.Generator().manual_seed(SEED + 5)
    params = state.params()
    tx.step(params, {k: torch.randn(p.shape, generator=gen).to(p.device)
                     for k, p in params.items()}, state.opt_state)
    return state


def same_tree(torch, a, b) -> bool:
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and \
            a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            same_tree(torch, a[k], b[k]) for k in a)
    return bool(np.array_equal(a, b))


def native_checkpoint_phase(torch, config, root) -> dict:
    """(b) ForwardTacotron, MultiForwardTacotron and the teacher written as
    the JAX package's ``.ckpt`` and read back: state and optimizer state
    bit-equal (the teacher's r from its schedule row); ``gen_forward``'s
    mel from the ``.ckpt`` equal to the ``.pt``'s; one bf16 train step
    resumed from a lone ``latest_model.ckpt`` bit-equal to one resumed
    from ``latest_model.pt``."""
    from forwardtacotron_torch import gen_forward
    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
    from forwardtacotron_torch.train.state import state_from_checkpoint
    from forwardtacotron_torch.utils.checkpoints import (
        load_checkpoint, restore_checkpoint, save_checkpoint,
        save_native_checkpoint)
    from forwardtacotron_torch.utils.files import read_config
    from forwardtacotron_torch.utils.paths import Paths

    step = 5
    multi = multi_config(read_config(REPO / 'configs' / 'multispeaker.yaml'),
                         'multi_forward_tacotron')
    table = speaker_table(torch, PLOT_SPEAKERS)
    cases = (('forward_tacotron', config, make_model(torch, config), None),
             ('multi_forward_tacotron', multi, random_bn_stats(
                 torch, init_tts_model(multi)),
              {'speaker_embeddings': {f'speaker{i}': e.numpy()
                                      for i, e in enumerate(table)}}),
             ('tacotron', config, teacher_model(torch, config), None))
    out, states = {}, {}
    for name, cfg, model, meta in cases:
        section = cfg['tacotron' if name == 'tacotron' else name]
        state = seeded_opt_state(torch, model, section, step)
        with torch.no_grad():
            model.step.fill_(step)
            if name == 'tacotron':      # the schedule's row at this step
                model.decoder.r.fill_(int(
                    section['training']['schedule'][0].split(',')[0]))
        path = root / f'{name}.ckpt'
        t0 = time.perf_counter()
        save_native_checkpoint(path, model, cfg, step=step,
                               opt_state=state.opt_state, meta=meta)
        t1 = time.perf_counter()
        ckpt = load_checkpoint(path)
        t2 = time.perf_counter()
        ok = (same_tree(torch, ckpt['model'], model.state_dict())
              and same_tree(torch, ckpt['optim'], state.opt_state)
              and ckpt['config'] == cfg
              and (meta is None or same_tree(
                  torch, ckpt['speaker_embeddings'],
                  meta['speaker_embeddings'])))
        out[name] = dict(mb=path.stat().st_size / 2 ** 20,
                         save_s=t1 - t0, load_s=t2 - t1)
        log(f'{name}: .ckpt of {out[name]["mb"]:.1f} MiB written in '
            f'{t1 - t0:.2f} s, read in {t2 - t1:.2f} s; state and optimizer '
            f'state bit-equal: {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'{name}: the .ckpt does not read back what was written')
        states[name] = (model, state)

    # gen_forward from the .pt and from the .ckpt of the same model
    model, state = states['forward_tacotron']
    save_checkpoint(root / 'forward_tacotron.pt', model, config, step=step,
                    opt_state=state.opt_state)
    mels = {}
    for suffix in ('pt', 'ckpt'):
        gen_forward.main(['--checkpoint', str(root / f'forward_tacotron.'
                                              f'{suffix}'),
                          '--input_text', ENTRY_TEXT, '--output',
                          str(root / f'mels_{suffix}'), '--device', 'cuda',
                          'hifigan'])
        files = sorted((root / f'mels_{suffix}').glob('*.npy'))
        mels[suffix] = np.load(files[0]) if len(files) == 1 else None
    ok = mels['pt'] is not None and mels['ckpt'] is not None and \
        np.array_equal(mels['pt'], mels['ckpt'])
    log(f'gen_forward: the .ckpt\'s mel {"equals" if ok else "differs from"} '
        f'the .pt\'s ({None if mels["pt"] is None else mels["pt"].shape})')
    if not ok:
        fail('gen_forward: a .ckpt and a .pt of one model give other mels')

    # one bf16 train step resumed from a lone .ckpt and from the .pt (the
    # files above, of this model at this step with this optimizer state)
    cfg = entry_config(config, root / 'resume')
    paths = write_train_data(cfg, PLOT_ITEMS, PLOT_VAL_ITEMS, PLOT_TOKENS)
    for kind in ('pt', 'ckpt'):
        Path(cfg['checkpoint_path'], kind).mkdir(parents=True)
        os.link(root / f'forward_tacotron.{kind}',
                Path(cfg['checkpoint_path'], kind, f'latest_model.{kind}'))
    train_cfg = cfg['forward_tacotron']['training']
    train_set, _ = get_forward_dataloaders(
        paths, PLOT_BATCH, bucket_multiple=train_cfg['bucket_multiple'],
        seed=SEED, **train_cfg['filter'])
    host = with_targets(next(iter(train_set)))
    after = {}
    deterministic = torch.backends.cudnn.deterministic
    # cuDNN's deterministic algorithms: two runs can be bit-equal at all
    torch.backends.cudnn.deterministic = True
    # one model for both: each resume loads every parameter and buffer
    fresh = init_tts_model(cfg).cuda()
    for kind in ('pt', 'ckpt'):
        ckpt = restore_checkpoint(Path(cfg['checkpoint_path'], kind))
        trainer = ForwardTrainer(Paths.from_config(cfg), None, cfg,
                                 device='cuda')
        resumed = state_from_checkpoint(fresh, trainer.tx, ckpt)
        torch.manual_seed(SEED)
        trainer.train_step(resumed, trainer.device_batch(host))
        after[kind] = ({k: v.detach().cpu() for k, v in
                        fresh.state_dict().items()}, resumed.opt_state,
                       resumed.step)
    torch.backends.cudnn.deterministic = deterministic
    ok = after['pt'][2] == after['ckpt'][2] == step + 1 and all(
        same_tree(torch, a, b) for a, b in zip(after['pt'][:2],
                                               after['ckpt'][:2]))
    log(f'one bf16 train step resumed from latest_model.ckpt vs from '
        f'latest_model.pt: parameters, statistics and optimizer state '
        f'bit-equal: {"ok" if ok else "FAIL"}')
    if not ok:
        fail('a step resumed from the .ckpt differs from one from the .pt')
    return out


def spectral_convergence(torch, dsp, mel, wav) -> float:
    """||STFT magnitude of wav - the magnitude Griffin-Lim targets|| over
    the target's norm (float64 on the CPU)."""
    from forwardtacotron_torch.ops.stft import stft_pair
    target = dsp._mel_to_stft(torch.exp(torch.as_tensor(
        mel, dtype=torch.float32, device=dsp.device))).cpu().double()
    re_, im_ = stft_pair(torch.as_tensor(wav, dtype=torch.float32),
                         dsp.n_fft, dsp.hop_length, dsp.win_length)
    mag = torch.sqrt(re_ * re_ + im_ * im_).double()[:target.shape[1]].T
    return float(torch.linalg.norm(mag - target) / torch.linalg.norm(target))


def audio_sources(torch, name, arrays, cpu_trainer) -> dict:
    """The mel each plot's Griffin-Lim audio was made from, on the CPU:
    the forward trainers' plotted mels; the teacher's postnet output (its
    eval forward again, not a plot)."""
    if name != 'teacher':
        return {'Ground_Truth_Aligned/audio':
                arrays['mel']['Ground_Truth_Aligned/generated'],
                'Generated/audio': arrays['mel']['Generated/mel']}
    trainer, state, session, _ = cpu_trainer
    sample = {k: v[:1] if isinstance(v, np.ndarray) else v
              for k, v in session.val_sample.items()}
    with torch.no_grad():
        _, linear, _ = state.model.eval()(trainer.device_batch(sample),
                                          session.r)
    mel_len = int(sample['mel_len'][0])
    return {'Generated/teacher_forced_audio':
            linear[0, :mel_len].T.float().numpy()}


def plot_trainers(torch, config, root, device, models=None):
    """The three trainers of the plots on ``device``, each with its session
    of the first schedule row: on seeded weights, or on copies of
    ``models`` (name -> model)."""
    from forwardtacotron_torch.data.dataset import (get_forward_dataloaders,
                                                    get_taco_dataloaders)
    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.train.common import TTSSession
    from forwardtacotron_torch.train.forward_trainer import (
        ForwardTrainer, MultiForwardTrainer)
    from forwardtacotron_torch.train.state import create_train_state
    from forwardtacotron_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_torch.utils.paths import Paths

    out = {}
    for name, family in (('forward', None),
                         ('multi', 'multi_forward_tacotron'),
                         ('teacher', None)):
        cfg = entry_config(config, root / name, family)
        paths = Paths.from_config(cfg)
        torch.manual_seed(SEED)
        dsp = DSP.from_config(cfg, device=device)
        if models is not None:     # the models, or copies on another device
            model = models[name]
            if next(model.parameters()).device.type != \
                    torch.device(device).type:
                model = copy.deepcopy(model)
        elif name == 'teacher':
            model = teacher_model(torch, cfg)
        else:
            model = set_frames_per_token(torch, random_bn_stats(
                torch, init_tts_model(cfg)), FRAMES_PER_TOKEN)
        model = model.to(device)
        if name == 'teacher':
            trainer = TacoTrainer(paths, dsp, cfg, device=device)
            r = int(cfg['tacotron']['training']['schedule'][0].split(',')[0])
            train_set, val_set = get_taco_dataloaders(
                paths, PLOT_BATCH, r=r, **cfg['tacotron']['training'][
                    'filter'])
        else:
            cls = MultiForwardTrainer if family else ForwardTrainer
            trainer = cls(paths, dsp, cfg, device=device)
            r = 1
            train_set, val_set = get_forward_dataloaders(
                paths, PLOT_BATCH, seed=SEED,
                **cfg[cfg.get('tts_model', 'forward_tacotron')]['training'][
                    'filter'])
        session = TTSSession(1, r, TRAIN_LR, PLOT_STEPS, PLOT_BATCH,
                             train_set, val_set)
        out[name] = (trainer, create_train_state(model.train(), trainer.tx),
                     session, dsp)
    return out


def plots_phase(torch, config, root) -> dict:
    """(c) The three trainers' ``plot_outputs`` on the card: timed at the
    training phase's lengths, and against the CPU at PLOT_TOKENS (mels
    within E2E_MEL_ATOL of the scale, Griffin-Lim's spectral convergence
    within SC_REL_TOL), exact launches in both, the writer taken; then
    PLOT_STEPS bf16 ForwardTrainer steps with a plot after each against
    the same steps without plots, bit-equal."""
    from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
    from forwardtacotron_torch.train.state import create_train_state

    table = speaker_table(torch, PLOT_SPEAKERS)
    for sub, tokens in (('short', PLOT_TOKENS), ('long', TRAIN_TOKENS)):
        write_train_data(entry_config(config, root / sub / 'forward'),
                         PLOT_ITEMS, PLOT_VAL_ITEMS, tokens)
        write_multi_train_data(
            entry_config(config, root / sub / 'multi',
                         'multi_forward_tacotron'),
            table, n_items=PLOT_ITEMS, n_val=PLOT_VAL_ITEMS, tokens=tokens)
        write_train_data(entry_config(config, root / sub / 'teacher'),
                         PLOT_ITEMS, PLOT_VAL_ITEMS, tokens)
    card = plot_trainers(torch, config, root / 'short', 'cuda')
    models = {name: run[1].model for name, run in card.items()}
    cpu = plot_trainers(torch, config, root / 'short', 'cpu', models)
    timed = plot_trainers(torch, config, root / 'long', 'cuda', models)
    # plot_outputs' launches: the GTA eval forward and each generation 2
    # pre_highway_stack, 1 cbhg_front, 1 lr; the teacher's forward 2 and 2;
    # 32 griffin_lim_iter per Griffin-Lim call
    want = {'forward': dict(pre_highway_stack=4, cbhg_front=2, lr=2,
                            griffin_lim_iter=64),
            'multi': dict(pre_highway_stack=4 + 2 * PLOT_SPEAKERS,
                          cbhg_front=2 + PLOT_SPEAKERS,
                          lr=2 + PLOT_SPEAKERS, griffin_lim_iter=64),
            'teacher': dict(pre_highway_stack=2, cbhg_front=2,
                            griffin_lim_iter=32)}
    out = {}
    for name, (trainer, state, session, dsp) in card.items():
        # the short plot is also the timed plot's warm-up
        reset_counts()
        got = trainer.plot_outputs(state, session)
        expect_counts(f'{name} plot_outputs at {PLOT_TOKENS} tokens',
                      read_counts(), **want[name])
        t_trainer, t_state, t_session, _ = timed[name]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        t_trainer.plot_outputs(t_state, t_session)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        frames = int(t_session.val_sample['mel_len'][0])
        expect_counts(f'{name} plot_outputs of {frames} frames', counts,
                      **want[name])
        c_trainer, c_state, c_session, c_dsp = cpu[name]
        ref = c_trainer.plot_outputs(c_state, c_session)
        mel_err, sc = 0.0, {}
        for kind in ('mel', 'pitch', 'attention'):
            if sorted(got.get(kind, {})) != sorted(ref.get(kind, {})):
                fail(f'{name} plots: card and CPU give other {kind} tags')
            for tag, arr in ref.get(kind, {}).items():
                if got[kind][tag].shape != arr.shape:
                    fail(f'{name} plot {tag}: shape {got[kind][tag].shape} '
                         f'on the card, {arr.shape} on the CPU')
                mel_err = max(mel_err, float(np.abs(got[kind][tag] - arr).max())
                              / max(1.0, float(np.abs(arr).max())))
        for tag, mel in audio_sources(torch, name, ref, cpu[name]).items():
            sc[tag] = (spectral_convergence(torch, c_dsp, mel,
                                            got['audio'][tag]),
                       spectral_convergence(torch, c_dsp, mel,
                                            ref['audio'][tag]))
        ok = mel_err <= E2E_MEL_ATOL and sorted(sc) == sorted(
            ref['audio']) and all(abs(v[0] - v[1]) <= SC_REL_TOL * v[1]
                                  for v in sc.values()) and all(
            got['audio'][t].shape == ref['audio'][t].shape
            and np.isfinite(got['audio'][t]).all() for t in ref['audio'])
        out[name] = dict(ms=ms, frames=frames,
                         compared_frames=int(session.val_sample['mel_len'][0]),
                         mel_rel_err=mel_err,
                         launches={k: v for k, v in counts.items() if v},
                         spectral_convergence=sc,
                         writer=type(trainer.writer).__name__)
        log(f'{name} plot_outputs: {ms:.1f} ms on the card at {frames} '
            f'frames; at {out[name]["compared_frames"]} frames, arrays vs '
            f'the CPU: max err {mel_err:.3e} of the scale; Griffin-Lim '
            f'spectral convergence (card, CPU) {sc}; writer '
            f'{out[name]["writer"]} {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'{name} plots disagree with the CPU plain path')

    # PLOT_STEPS bf16 steps with a plot after each vs without plots (the
    # short items), each run from the same weights and the same batches,
    # on cuDNN's deterministic algorithms (two runs can be bit-equal at all)
    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.train.common import TTSSession
    trainer, _, _, dsp = card['forward']
    cfg = trainer.config
    train_cfg = cfg['forward_tacotron']['training']
    after = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for plot_every in (10 ** 9, 1):
        train_cfg['plot_every'] = plot_every
        model = make_model(torch, cfg).cuda()
        run = ForwardTrainer(trainer.paths, dsp, cfg, device='cuda')
        state = create_train_state(model, run.tx)
        session = TTSSession(1, 1, TRAIN_LR, PLOT_STEPS, PLOT_BATCH,
                             *get_forward_dataloaders(
                                 trainer.paths, PLOT_BATCH, seed=SEED,
                                 **train_cfg['filter']))
        t0 = time.perf_counter()
        run.train_session(state, session, seed=SEED)
        torch.cuda.synchronize()
        after[plot_every] = ({k: v.detach().cpu() for k, v in
                              model.state_dict().items()}, state.opt_state,
                             state.step, time.perf_counter() - t0)
    torch.backends.cudnn.deterministic = deterministic
    ok = after[1][2] == after[10 ** 9][2] == PLOT_STEPS and all(
        same_tree(torch, a, b) for a, b in zip(after[1][:2],
                                               after[10 ** 9][:2]))
    out['plot_every_1_s'], out['no_plots_s'] = after[1][3], after[10 ** 9][3]
    log(f'{PLOT_STEPS} bf16 steps with a plot after each '
        f'({after[1][3]:.1f} s) vs without ({after[10 ** 9][3]:.1f} s): '
        f'parameters, statistics and optimizer state bit-equal: '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('plots changed training')
    return out


def profiler_phase(torch, config, root) -> dict:
    """(d) ``utils.profiler.trace`` around one float32 request in an
    ``annotate`` span: the trace file must name the span and the kernels
    of rows 1, 2 and 8 (the run is repeated up to PROFILE_ATTEMPTS times,
    as the profiler can drop records late in a run);
    ``device_memory_stats`` gives the three keys, peak >= in use > 0."""
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    from forwardtacotron_torch.utils.profiler import (annotate,
                                                      device_memory_stats,
                                                      trace)

    inference = TTSInference(make_model(torch, config), device='cuda')
    tokens = Tokenizer()(ENTRY_TEXT)
    inference.generate_cropped(tokens)
    torch.cuda.synchronize()
    out = {}
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        log_dir = root / f'trace{attempt}'
        with trace(log_dir):
            with annotate(TRACE_SPAN):
                inference.generate_cropped(tokens)
            torch.cuda.synchronize()
        files = list(log_dir.glob('*.pt.trace.json'))
        if len(files) != 1:
            fail(f'profiler trace: {len(files)} trace files in {log_dir}')
        names = {e.get('name', '') for e in
                 json.loads(files[0].read_text()).get('traceEvents', [])}
        missing = [k for k in (TRACE_SPAN,) + TRACE_KERNELS
                   if not any(k in n for n in names)]
        out.update(trace_mb=files[0].stat().st_size / 2 ** 20,
                   attempts=attempt, events=len(names))
        if not missing:
            break
    log(f'profiler trace of one f32 request: {out["trace_mb"]:.2f} MiB, '
        f'{out["events"]} event names, attempt {out["attempts"]}; missing '
        f'{missing or "none"}')
    if missing:
        fail(f'the profiler trace does not name {missing}')
    stats = device_memory_stats()
    out['memory'] = stats
    ok = stats is not None and sorted(stats) == [
        'bytes_in_use', 'bytes_limit', 'peak_bytes_in_use'] and \
        stats['peak_bytes_in_use'] >= stats['bytes_in_use'] > 0 and \
        device_memory_stats('cpu') is None
    log(f'device_memory_stats: {stats} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('device_memory_stats')
    return out


def synthesizer_phase(torch, config, root) -> dict:
    """(e) ``Synthesizer`` on a ``.ckpt`` (written in (b)) on the card: the
    mel against the CPU's, the Griffin-Lim wav finite and (frames - 1) x
    hop samples long; again with phase 11's seeded HiFi-GAN v1 checkpoint
    as ``vocoder_checkpoint``, frames x hop samples."""
    from forwardtacotron_torch.notebook_utils.synthesize import Synthesizer

    ckpt = str(root / 'forward_tacotron.ckpt')
    hop = config['dsp']['hop_length']
    synth = Synthesizer(ckpt, device='cuda')
    mel = synth.synthesize_mel(ENTRY_TEXT)
    ref = Synthesizer(ckpt, device='cpu').synthesize_mel(ENTRY_TEXT)
    err = float(np.abs(mel - ref).max()) / max(1.0, float(np.abs(ref).max()))
    t0 = time.perf_counter()
    wav = synth(ENTRY_TEXT)
    torch.cuda.synchronize()
    gl_ms = (time.perf_counter() - t0) * 1e3
    write_hifigan_checkpoint(torch, root / 'g_00000000')
    neural = Synthesizer(ckpt, vocoder_checkpoint=str(root / 'g_00000000'),
                         device='cuda')
    t0 = time.perf_counter()
    wav_v = neural(ENTRY_TEXT)
    torch.cuda.synchronize()
    voc_ms = (time.perf_counter() - t0) * 1e3
    # HiFi-GAN gives a hop per frame, Griffin-Lim's inverse STFT a hop
    # per frame after the first
    n = mel.shape[1] * hop
    ok = (err <= E2E_MEL_ATOL and mel.shape == ref.shape
          and wav.shape == (n - hop,) and wav_v.shape == (n,)
          and np.isfinite(wav).all() and np.isfinite(wav_v).all())
    out = dict(frames=mel.shape[1], mel_rel_err=err, griffinlim_ms=gl_ms,
               hifigan_ms=voc_ms)
    log(f'Synthesizer: {mel.shape[1]} frames, mel vs the CPU max err '
        f'{err:.3e} of the scale; text -> wav {gl_ms:.1f} ms Griffin-Lim, '
        f'{voc_ms:.1f} ms HiFi-GAN v1 (f32), {wav.shape[0]} and '
        f'{wav_v.shape[0]} samples {"ok" if ok else "FAIL"}')
    if not ok:
        fail('Synthesizer')
    return out


def entry_points_phase(torch, config) -> dict:
    """Phase 20 (``--entry-points`` alone)."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_entry_') as tmp:
        root = Path(tmp)
        for name, fn, sub in (
                ('gta', gta_export_phase, 'gta'),
                ('checkpoints', native_checkpoint_phase, 'ckpt'),
                ('plots', plots_phase, 'plots'),
                ('profiler', profiler_phase, 'profile'),
                ('synthesizer', synthesizer_phase, 'ckpt')):
            log(f'({name}):')
            (root / sub).mkdir(exist_ok=True)
            t1 = time.perf_counter()
            out[name] = fn(torch, config, root / sub)
            out[name]['phase_s'] = time.perf_counter() - t1
    out['phase_s'] = time.perf_counter() - t0
    log(f'entry-points phase: {out["phase_s"]:.1f} s')
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail('PyTorch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device: this script measures the port on a GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from forwardtacotron_torch.ops.hopper import build
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    from forwardtacotron_torch.utils.files import read_config

    card = nvidia_smi()
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'device {torch.cuda.get_device_name(0)}')
    try:
        spec = chip_spec(torch.device('cuda'))
    except ValueError as e:
        fail(str(e))
    log(f'chip spec: {spec.name} for {torch.cuda.get_device_name(0)}')
    if '--lstm-times' in sys.argv[1:]:
        # the LSTM entries' times alone, e.g. beside a parent checkout's
        with torch.inference_mode():
            log(f'lstm times: {json.dumps(lstm_times_phase(torch))}')
        log(f'card: {card}')
        return
    if '--mrf-gaps' in sys.argv[1:]:
        # rows 14-15 at the shapes past their first limits alone
        t0 = time.perf_counter()
        build.build(['mrf'])
        log(f'build mrf: {time.perf_counter() - t0:.1f} s')
        with torch.inference_mode():
            gaps = mrf_gap_shapes_phase(torch)
        log(f'mrf gap shapes: {json.dumps(gaps)}')
        log(f'card: {card}')
        return
    if '--lr-mrf-times' in sys.argv[1:]:
        # row 8 (with its tile sweep) and v1's MRF levels 2-3 alone, e.g.
        # beside a parent checkout's
        t0 = time.perf_counter()
        build.build(['lr', 'mrf'])
        log(f'build lr, mrf: {time.perf_counter() - t0:.1f} s')
        lr_res = lr_phase(torch, sweep=True)['lr']['shapes']
        with torch.inference_mode():
            mrf_res = mrf_times_phase(torch)
        log(f'lr times: {json.dumps(lr_res)}')
        log(f'mrf times: {json.dumps(mrf_res)}')
        log(f'card: {card}')
        return
    build_phase(build)

    config = read_config(REPO / 'configs' / 'singlespeaker.yaml')
    tokens = request_tokens(config)
    if '--host-times' in sys.argv[1:]:
        # the single-speaker requests and train step on the host clock,
        # e.g. beside a parent checkout's in one call
        with tempfile.TemporaryDirectory(prefix='chip_smoke_host_') as tmp:
            times = host_times_phase(torch, config, tokens, Path(tmp))
        log(f'host times: {json.dumps(times)}')
        log(f'card: {card}')
        return
    if '--teacher' in sys.argv[1:]:
        # the teacher's phases alone, every train step profiled
        teacher = teacher_phases(torch, config, tokens, profiled=tuple(
            (p, r) for p in ('float32', 'bfloat16') for r, _ in TEACHER_TRAIN))
        log(f'teacher: {json.dumps(teacher)}')
        log(f'card: {card}')
        return
    if '--pipeline' in sys.argv[1:]:
        # the data pipeline's phase alone
        pipeline = pipeline_phase(torch, config)
        log(f'pipeline: {json.dumps(pipeline)}')
        log(f'card: {card}')
        return
    if '--data-parallel' in sys.argv[1:]:
        # the data-parallel phase alone
        dp = data_parallel_phase(torch, make_model(torch, config), config,
                                 tokens, card)
        log(f'data parallel: {json.dumps(dp)}')
        log(f'card: {card}')
        return
    if '--entry-points' in sys.argv[1:]:
        # the utils and entry points' phase alone
        entry = entry_points_phase(torch, config)
        log(f'entry points: {json.dumps(entry)}')
        log(f'card: {card}')
        return
    if '--multispeaker' in sys.argv[1:]:
        # the multispeaker phases alone
        multi = multispeaker_phases(torch, config, tokens)
        log(f'multispeaker: {json.dumps(multi)}')
        log(f'card: {card}')
        return
    model = make_model(torch, config)
    if '--griffinlim-split' in sys.argv[1:]:
        # the split alone, e.g. beside a parent checkout's in one call
        split = griffinlim_split_phase(torch, model.cuda(), config, tokens)
        log(f'griffinlim split: {json.dumps(split)}')
        log(f'card: {card}')
        return
    n_tok = max(len(t) for t in tokens)
    n_frames = FRAMES_PER_TOKEN * n_tok
    with torch.inference_mode():
        results = kernel_phase(torch, model.cuda(), config, n_tok, n_frames)
    launches, outs = main_path_phase(torch, model, config, tokens)
    reference_phase(torch, model, config, tokens, outs)
    gl_split = griffinlim_split_phase(torch, model, config, tokens)

    # bfloat16: a copy of the same weights, cast as TTSInference casts them
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    serving_tok = max(len(Tokenizer()(s)) for s in BENCH_SENTENCES)
    serving_frames = SERVING_FRAMES_PER_TOKEN * serving_tok
    with torch.inference_mode():
        request16 = bf16_kernel_phase(torch, model16, 'one request', 1,
                                      n_tok, n_frames,
                                      -(-n_frames // 128) * 128,
                                      two_phase=True)
    serving_launches, serving = serving_phase(torch, model16, config)
    with torch.inference_mode():
        results16 = bf16_kernel_phase(
            torch, model16, f'one serving call, batch {serving["batch"]}',
            serving['batch'], serving_tok, serving_frames,
            serving['groups'][-1][1], two_phase=False)
    log('bf16 two-phase path (host clock, synchronized):')
    two_phase_bf16_phase(torch, model16, tokens)
    with torch.inference_mode():
        set_frames_per_token(torch, model16, SERVING_FRAMES_PER_TOKEN)
    bf16_reference_phase(torch, model16)

    # the CBHG variants: rows 11-13 against their twins, _highways_fused,
    # the variant serving routes, f32 requests with them, and the K=16
    # prenet front through cbhg_front.cu
    t_var = time.perf_counter()
    with torch.inference_mode():
        results_var = variant_kernel_phase(
            torch, model, model16, n_tok, n_frames, serving['batch'],
            serving_tok, serving_frames)
        highway_launches = highways_fused_phase(
            torch, model, model16, serving['batch'], serving_frames,
            n_frames)
    var_launches, variants = variant_serving_phase(torch, model16, config,
                                                   serving)
    req_launches = variant_request_phase(torch, model, tokens)
    with torch.inference_mode():
        variants['prenet_front'] = prenet_front_phase(
            torch, model16, serving['batch'], serving_tok)
    variants['phases_s'] = time.perf_counter() - t_var
    log(f'cbhg variant phases: {variants["phases_s"]:.1f} s')

    # the vocoder: the fused MRF level and the tail's level against their
    # twins at v1's shapes, then the bf16 text -> wav path, a f32 request
    # and throughput, with either
    with torch.inference_mode():
        results_voc = vocoder_kernel_phase(torch, n_frames)
        results_voc.update(ups_kernel_phase(torch, n_frames))
        for name, r in mrf_long_lists_phase(torch, n_frames).items():
            results_voc[name]['long_lists'] = r
        log('mrf and ups_mrf at the shapes past their first limits:')
        for name, r in mrf_gap_shapes_phase(torch).items():
            results_voc[name]['gap_shapes'] = r
        log('mrf cycle spans (bf16, thread 0 of CTA (0, 0), one launch):')
        mrf_cycles = mrf_cycles_phase(torch)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_vocoder_') as tmp:
        voc_routed, voc_request, vocoder = vocoder_path_phase(
            torch, model16, config, tokens, Path(tmp))

    # FastPitch at full width: f32 requests, the long request (blockwise
    # against full attention), bf16 serving, row 8 at its width; MelGAN
    t_fp = time.perf_counter()
    fp_model = make_fast_pitch(torch, config)
    log('FastPitch f32 requests (host clock, synchronized):')
    fp_outs, fast_pitch = fast_pitch_request_phase(torch, fp_model, config,
                                                   tokens)
    fast_pitch['long'] = fast_pitch_long_phase(torch, fp_model)
    fast_pitch['serving'] = fast_pitch_serving_phase(torch, fp_model, config)
    torch.cuda.empty_cache()
    log('row 8 at FastPitch\'s width:')
    fp_lr = fast_pitch_lr_phase(torch)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_melgan_') as tmp:
        melgan = melgan_phase(torch, config, fp_model, fp_outs, tokens,
                              Path(tmp))
    torch.cuda.empty_cache()
    fast_pitch['phases_s'] = time.perf_counter() - t_fp
    log(f'FastPitch and MelGAN phases: {fast_pitch["phases_s"]:.1f} s')

    # training: the kernels at full-width training shapes (with autograd on,
    # for cuDNN's yardstick), the bf16 and float32 train steps on synthetic
    # data in a temporary directory, and one step on card vs CPU
    results_train = train_kernel_phase(torch, model16)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_train_') as tmp:
        train_launches, training = train_bf16_phase(torch, config, Path(tmp))
        training['f32_step_ms'] = train_f32_phase(torch, config, Path(tmp))
        training['card_vs_cpu_rel'] = train_reference_phase(torch, config,
                                                            Path(tmp))
    training['lr_f32'] = results_train['lr_f32']
    # rows 1 and 2 in bf16 at one request, beside the serving numbers
    for name in ('pre_highway_stack', 'cbhg_front'):
        results16[name].update(
            {f'request_{k}': request16[name][k]
             for k in ('ms', 'plain_ms', 'bound_ms', 'yardstick_ms')})
    training['gru_train_fwd'] = results_train['gru_train_fwd']

    # the multispeaker models (configs/multispeaker.yaml) and FastPitch's
    # training: rows 6-10 at their new shapes, requests, serving, training
    multi = multispeaker_phases(torch, config, tokens)
    mk = multi['kernels']
    results16['lstm_lr_mel']['multispeaker'] = {
        'launches_per_serving_call': multi['serving_launches']['lstm_mel'],
        **{k: mk[f'lstm_lr_mel_{k}'] for k in ('serving', 'request')}}
    results16['lr_bidir']['multispeaker'] = {
        'launches_per_serving_call': multi['serving_launches']['lr_bidir']}
    results16['bidir_rnn']['multispeaker'] = {
        'launches_per_serving_call': multi['serving_launches']['gru'],
        **{k: mk[f'gru_{k}'] for k in ('dur_pred', 'pitch_cond_pred',
                                        'pitch_pred')}}
    results_train['lr']['multispeaker'] = {
        k[3:]: {m: v[m] for m in ('device_ms', 'event_ms', 'bound_ms',
                                  'plain_ms', 'plan') if m in v}
        for k, v in mk.items() if k.startswith('lr ')}
    mtrain = multi['training']['multi_forward_tacotron']['launches']
    results_train['lstm_train']['multispeaker'] = dict(
        mk['lstm_train'], launches_per_step=mtrain['lstm_train'])
    results_train['lstm_bwd']['multispeaker'] = dict(
        mk['lstm_bwd'], launches_per_step=mtrain['lstm_bwd'])
    results_train['gru_bwd']['multispeaker'] = {
        'launches_per_step': mtrain['gru_bwd'],
        **{k: mk[f'gru_bwd_{k}'] for k in ('dur_pred', 'pitch_pred')},
        **{f'forward_{k}': mk[f'gru_train_fwd_{k}']
           for k in ('dur_pred', 'pitch_pred')}}
    # the teacher (configs/singlespeaker.yaml's tacotron section): rows 1
    # and 2 at its shapes, its eval forward, generate, train steps, CLI;
    # no profiled step (each costs 20-60 s; --teacher profiles both
    # precisions at both r)
    teacher = teacher_phases(torch, config, tokens)
    for row in ('pre_highway_stack', 'cbhg_front'):
        for name, res in (('f32', results), ('bf16', results16)):
            res[row]['new_paths'] = {
                'teacher_generate': teacher['generate'][name]['launches'][row],
                **{f'teacher_{entry}': teacher['kernels'][f'{row}_{entry}_{name}']
                   for entry in ('encoder', 'postnet')}}
        results[row]['new_paths']['teacher_eval_forward'] = \
            teacher['eval']['launches'][row]
    # the data pipeline: preprocessing, the speaker encoder, the teacher's
    # attention extraction (rows 1-2 at B 32), the duration DP, the targets
    pipeline = pipeline_phase(torch, config)
    for row in ('pre_highway_stack', 'cbhg_front'):
        results[row]['new_paths'].update(
            extraction_batch=pipeline['extraction']['launches_per_batch'][row],
            **{f'extraction_{entry}_B32': pipeline['kernels'][
                f'{row}_{entry}_f32'] for entry in ('encoder', 'postnet')})
    # data parallelism: the mesh's serving calls and the ranks' train steps
    torch.cuda.empty_cache()
    dp = data_parallel_phase(torch, make_model(torch, config), config,
                             tokens, card)
    for res, row, modes in ((results16, 'gru_from_xp', ('gru_xp',)),
                            (results16, 'lstm_lr_mel', ('lstm_mel',)),
                            (results16, 'bidir_rnn', ('gru',)),
                            (results_train, 'lstm_train',
                             ('lstm_train', 'gru')),
                            (results_train, 'gru_bwd', ('gru_bwd',)),
                            (results_train, 'lstm_bwd', ('lstm_bwd',))):
        res[row]['data_parallel'] = dp_launches(dp, modes)
    # the remaining utils and entry points: the GTA export, the native
    # checkpoints, the trainers' plots, the profiler, the Synthesizer
    torch.cuda.empty_cache()
    entry = entry_points_phase(torch, config)
    plots = entry['plots']
    for res, row in ((results, 'pre_highway_stack'), (results, 'cbhg_front'),
                     (results, 'griffin_lim_iter'), (results_train, 'lr')):
        new = res[row].setdefault('new_paths', {})
        if row in entry['gta']['launches_per_batch']:
            new['gta_export_batch'] = entry['gta']['launches_per_batch'][row]
        for name in ('forward', 'multi', 'teacher'):
            if row in plots[name]['launches']:
                new[f'{name}_plot'] = plots[name]['launches'][row]
    # row 5 at one request beside its serving numbers
    results16['lr_bidir']['request'] = {
        k: request16['lr_bidir'][k]
        for k in ('ms', 'plain_ms', 'bound_ms', 'event_ms', 'device_ms',
                  'graph_ms', 'host_us', 'launches_profiled')}
    # rows 8 and 14 on the paths of FastPitch and the channels-major tail
    results_train['lr'].setdefault('new_paths', {}).update({
        'fast_pitch_f32_request': fast_pitch['lr_launches_per_request'],
        'fast_pitch_serving_call': 1,
        'fast_pitch_melgan_routed_group': 1,
        'C256': {k: {m: v[m] for m in ('device_ms', 'event_ms', 'bound_ms',
                                        'plain_ms', 'plan')}
                 for k, v in fp_lr.items()}})
    results_voc['mrf']['new_paths'] = {
        'cm_tail_f32_request': voc_request['cm_tail'],
        'cm_tail_bf16_routed': voc_routed['cm_tail']}
    # row 7's LSTM body (no path launches it) beside its GRU body
    results16['bidir_rnn']['lstm_body'] = {
        k: request16['lstm_body'][k]
        for k in ('max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
                  'bound_by', 'at')}

    rows = [  # (name, results, launches, source, TPU kernel body)
        ('pre_highway_stack', results, launches['pre_highway_stack'],
         'highway.cu', 'highway.py:113'),
        ('cbhg_front', results, launches['cbhg_front'], 'cbhg_front.cu',
         'cbhg.py:184'),
        ('griffin_lim_iter', results, launches['griffin_lim_iter'],
         'griffin_lim.cu', 'griffin_lim.py:171'),
        ('pre_highway_stack_bf16', results16,
         serving_launches['pre_highway_stack'], 'highway.cu',
         'highway.py:113'),
        ('cbhg_front_bf16', results16, serving_launches['cbhg_front'],
         'cbhg_front.cu', 'cbhg.py:184'),
        ('gru_from_xp', results16, serving_launches['gru_xp'], 'rnn.cu',
         'rnn.py:218'),
        ('lr_bidir', results16, serving_launches['lr_bidir'], 'lr_bidir.cu',
         'length_regulator.py:131'),
        ('lstm_lr_mel', results16, serving_launches['lstm_mel'], 'rnn.cu',
         'rnn.py:149'),
        ('bidir_rnn', results16,
         serving_launches['gru'] + serving_launches['lstm'], 'rnn.cu',
         'rnn.py:188'),
        ('lr', results_train, train_launches['lr'], 'lr.cu',
         'length_regulator.py:29'),
        ('lstm_train', results_train, train_launches['lstm_train'], 'rnn.cu',
         'rnn_train.py:55'),
        ('gru_bwd', results_train, train_launches['gru_bwd'], 'rnn_bwd.cu',
         'rnn_train.py:92'),
        ('lstm_bwd', results_train, train_launches['lstm_bwd'],
         'rnn_bwd.cu', 'rnn_train.py:149'),
        ('mrf', results_voc, voc_request['fused'], 'mrf.cu', 'mrf.py:52'),
        ('mrf_bf16', results_voc, voc_routed['fused'], 'mrf.cu',
         'mrf.py:52'),
        ('ups_mrf', results_voc, voc_request['tail'], 'mrf.cu',
         'mrf.py:189'),
        ('ups_mrf_bf16', results_voc, voc_routed['tail'], 'mrf.cu',
         'mrf.py:189'),
        ('highway_stack', results_var, highway_launches['f32'],
         'highway.cu', 'highway.py:53'),
        ('highway_stack_bf16', results_var, highway_launches['bf16'],
         'highway.cu', 'highway.py:53'),
        ('pool_proj1', results_var, req_launches['pool_proj']['pool_proj1'],
         'pool.cu', 'cbhg.py:35'),
        ('pool_proj1_bf16', results_var,
         var_launches['pool_proj']['pool_proj1'], 'pool.cu', 'cbhg.py:35'),
        ('pool_mask', results_var, req_launches['pool']['pool_mask'],
         'pool.cu', 'cbhg.py:109'),
        ('pool_mask_bf16', results_var, var_launches['pool']['pool_mask'],
         'pool.cu', 'cbhg.py:109')]
    kernels = []
    for name, res, n_launches, src, tpu in rows:
        r = res[name] if name in res else res[name.replace('_bf16', '')]
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'forwardtacotron_torch/ops/hopper/{src}',
            'replaces': f'forwardtacotron_tpu/ops/pallas/{tpu}',
            'launches': n_launches, 'max_abs_err': r['max_abs_err'],
            'ms': r['ms'], 'plain_ms': r['plain_ms'],
            'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
            'library_ms': r.get('library_ms'), 'at': r['at'],
            **{k: r[k] for k in ('levels', 'fused_level_ms', 'cudnn_level_ms',
                                 'yardstick_ms', 'tc_bound_ms', 'r16',
                                 'parts_ms',
                                 'sc_kernel', 'sc_twin',
                                 'postnet_ms', 'prenet_ms',
                                 'request_ms', 'request_plain_ms',
                                 'request_bound_ms', 'request_yardstick_ms',
                                 'lstm_body', 'ms_at_t', 'event_ms',
                                 'device_ms', 'graph_ms', 'host_us',
                                 'launches_profiled', 'plan',
                                 'tile_sweep_device_ms', 'shapes',
                                 'yardstick_device_ms', 'fill_device_ms',
                                 'request',
                                 'long_lists', 'gap_shapes', 'new_paths',
                                 'multispeaker', 'data_parallel')
               if k in r and r[k] != {}}})
    log(f'griffinlim split: {json.dumps(gl_split)}')
    log(f'serving: {json.dumps(serving)}')
    log(f'cbhg variants: {json.dumps(variants)}')
    log(f'vocoder: {json.dumps(vocoder)}')
    log(f'fast_pitch: {json.dumps(fast_pitch)}')
    log(f'melgan: {json.dumps(melgan)}')
    log(f'mrf cycle spans: {json.dumps(mrf_cycles)}')
    log(f'training: {json.dumps(training)}')
    log(f'multispeaker: {json.dumps(multi)}')
    log(f'teacher: {json.dumps(teacher)}')
    log(f'pipeline: {json.dumps(pipeline)}')
    log(f'data parallel: {json.dumps(dp)}')
    log(f'entry points: {json.dumps(entry)}')
    log(f'card: {card}')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        fail('unexpected error')
