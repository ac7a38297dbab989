#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root. Phases, each of which must pass:

1. build the Hopper kernels from the ``.cu`` sources in
   ``forwardtacotron_torch/ops/hopper`` with nvcc (one process per source,
   all started together);
2. hold each kernel against its plain-PyTorch twin on the card at the
   shapes the main path gives it, and time both (CUDA events, median of
   20 runs after warm-up);
3. drive the main path at full width: ``configs/singlespeaker.yaml`` with
   seeded random weights, 4 sentences of ``sentences.txt`` through
   ``TTSInference.generate_cropped`` and ``DSP.griffinlim``, with every
   kernel's launch count set to 0 just before and read just after, and the
   profiler showing which device kernels ran;
4. check the output: finite values of the expected lengths, and agreement
   with the plain path run on the CPU for one sentence.

Printed, in order: the card's name and power limit (nvidia-smi), the
build, one line per kernel comparison, the main-path stages, then a JSON
line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Any failure exits non-zero without the last line, as does a machine without
a CUDA device or a directory without the repository. The profiler's kernel
table goes to ``chiprun_out/chip_smoke_profile.txt``.
"""

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
# every token lasts this many frames: the longest of the 4 requests is
# ~10 s of audio, and the postnet sees ~900 frames (above the TPU kernel's
# 512-frame block)
FRAMES_PER_TOKEN = 9
SENTENCES = 4
REPS = 20
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# device memory bandwidth; the kernels here are float32 FMA kernels
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs twin, float32 with different summation orders: max abs error
# over max(1, max |twin|) (a relative error at the output's scale)
KERNEL_TOL = 1e-4
# 32 Griffin-Lim iterations drift apart chaotically from float32 rounding;
# the kernel's spectral convergence must be within 1% of the twin's
SC_REL_TOL = 0.01
# full model on card vs CPU plain path, mel max abs error
E2E_MEL_ATOL = 1e-3


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


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the float32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes \
        else 'bytes'


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
    times = build.build()
    log(f'build: {time.perf_counter() - t0:.1f} s wall, '
        + ', '.join(f'{k} {v:.1f} s' for k, v in times.items()))
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
    """Full-width ForwardTacotron with seeded random weights, random BN
    statistics, and a duration head that gives every token
    FRAMES_PER_TOKEN frames."""
    from forwardtacotron_torch.models.registry import init_tts_model
    torch.manual_seed(SEED)
    model = init_tts_model(config)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith('running_var'):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
        model.dur_pred.lin.weight.zero_()
        model.dur_pred.lin.bias.fill_(float(FRAMES_PER_TOKEN))
    return model


def kernel_phase(torch, model, config, n_tok, n_frames):
    """Each kernel against its twin at the main path's largest shapes."""
    from forwardtacotron_torch.models.synthesis import bucket_frames
    from forwardtacotron_torch.ops.hopper import cbhg, griffin_lim, highway
    from forwardtacotron_torch.ops.stft import initial_phase, stft_pair

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
    re, im = stft_pair(sig, n_fft, hop, win)
    mag = torch.sqrt(re * re + im * im)                  # [F, bins]
    f_true, bins = mag.shape
    log(f'kernel griffin_lim_iter ({n_samples / dsp["sample_rate"]:.2f} s: '
        f'F={f_true}, bins={bins}, n_fft={n_fft}, hop={hop})')
    consts = griffin_lim.gl_constants(n_fft, hop, win, dev)
    winsq = griffin_lim.ola_normalizer(n_fft, hop, f_true, win, dev)
    phase = initial_phase((f_true, bins), SEED).to(dev)
    spec_re = (mag * torch.cos(phase))[None].contiguous()
    spec_im = (mag * torch.sin(phase))[None].contiguous()
    tp_re, tp_im = randn(1, f_true, bins), randn(1, f_true, bins)
    magb = mag[None].contiguous()
    repl = griffin_lim.edge_frames(spec_re, spec_im, hop, consts,
                                   winsq).contiguous()
    it_args = (spec_re, spec_im, tp_re, tp_im, magb, repl, consts, hop)
    err = compare(torch, 'one iteration',
                  griffin_lim.griffin_lim_iter(*it_args),
                  griffin_lim.griffin_lim_iter_plain(*it_args))
    k_ms = time_ms(torch, lambda: griffin_lim.griffin_lim_iter(*it_args))
    p_ms = time_ms(torch,
                   lambda: griffin_lim.griffin_lim_iter_plain(*it_args))
    r = n_fft // hop
    flops = 2 * f_true * (2 * bins) * n_fft * 2 + f_true * n_fft * (2 * r - 1)
    nbytes = 4 * (5 * f_true * bins + 2 * r * n_fft + 4 * bins * n_fft
                  + n_fft + 4 * f_true * bins)
    b_ms, b_by = bound(flops, nbytes)
    log(f'    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, '
        f'bound {b_ms:.4f} ms ({b_by}) per iteration')
    results['griffin_lim_iter'] = dict(max_abs_err=err, ms=k_ms,
                                       plain_ms=p_ms, bound_ms=b_ms,
                                       bound_by=b_by,
                                       at=f'one iteration, F={f_true}')

    # 32 iterations end to end: spectral convergence of kernel vs twin
    def spectral_convergence(wav):
        r2, i2 = stft_pair(wav, n_fft, hop, win)
        m2 = torch.sqrt(r2 * r2 + i2 * i2)[:f_true]
        return float(torch.linalg.norm(m2 - mag) / torch.linalg.norm(mag))

    # the twin runs where the wrapper picks it: on CPU tensors
    mag_t, ph_t = mag.T[None].contiguous(), phase.T[None].contiguous()
    wav_k = griffin_lim.griffin_lim_fused(mag_t, ph_t, n_fft, hop, win,
                                          n_iter=32)[0]
    wav_p = griffin_lim.griffin_lim_fused(mag_t.cpu(), ph_t.cpu(), n_fft,
                                          hop, win, n_iter=32)[0].to(dev)
    sc_k, sc_p = spectral_convergence(wav_k), spectral_convergence(wav_p)
    ok = abs(sc_k - sc_p) <= SC_REL_TOL * sc_p and sc_k < 1.0
    log(f'  32 iterations: spectral convergence kernel {sc_k:.5f}, '
        f'twin {sc_p:.5f} (|diff| <= {SC_REL_TOL:g} x twin) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail('griffin_lim_iter: 32-iteration spectral convergence')
    return results


KERNEL_NAMES = {'pre_highway_stack': ['pre_highway_stack_kernel'],
                'cbhg_front': ['cbhg_front_kernel'],
                'griffin_lim_iter': ['gl_idft_kernel',
                                     'gl_dft_update_kernel']}


def main_path_phase(torch, model, config, tokens):
    """Text -> mel -> wav for every request, counts and profiler around it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.ops.hopper import cbhg, griffin_lim, highway
    mods = {'pre_highway_stack': highway, 'cbhg_front': cbhg,
            'griffin_lim_iter': griffin_lim}

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
    for m in mods.values():
        m.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [run(toks) for toks in tokens]
    launches = {k: m.launches for k, m in mods.items()}
    log(f'main path launches: {launches}')

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
    want = {'pre_highway_stack': 2 * len(tokens),
            'cbhg_front': len(tokens), 'griffin_lim_iter': 32 * len(tokens)}
    if launches != want:
        fail(f'launch counts {launches}, expected {want}')

    # the profiler's view of the same run
    events = prof.key_averages()
    kernels_run = [e for e in events if e.device_type == DeviceType.CUDA]
    device_names = [e.key for e in kernels_run]
    busy_ms = sum(e.self_device_time_total for e in kernels_run) / 1e3
    log(f'profiled main path: device busy {busy_ms:.1f} ms in '
        f'{sum(e.count for e in kernels_run)} device events')
    for e in sorted(kernels_run, key=lambda e: -e.self_device_time_total)[:8]:
        log(f'  device {e.self_device_time_total / 1e3:9.3f} ms '
            f'{e.count:6d} calls  {e.key[:70]}')
    out_dir = REPO / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    table = events.table(sort_by='device_time_total', row_limit=40)
    (out_dir / 'chip_smoke_profile.txt').write_text(table)
    if device_names:
        for names in KERNEL_NAMES.values():
            for n in names:
                if not any(n in d for d in device_names):
                    fail(f'profiler shows no {n} on the device')
        log(f'profiler: all {sum(map(len, KERNEL_NAMES.values()))} kernel '
            f'functions ran on the device ({len(device_names)} device '
            'event names recorded)')
    else:
        log('profiler: recorded no device time; the launch counts above '
            'are the evidence')

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


def reference_phase(torch, model, config, tokens, outs):
    """One request through the plain path on the CPU (twins, no kernels)
    against the card's result."""
    import copy

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


def main() -> None:
    try:
        import torch
    except ImportError:
        fail('PyTorch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device: this script measures the port on a GPU')
    if not (REPO / 'forwardtacotron_torch').is_dir():
        fail(f'{REPO} does not hold the repository (forwardtacotron_torch/ '
             'is missing)')
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from forwardtacotron_torch.ops.hopper import build
    from forwardtacotron_torch.utils.files import read_config

    card = nvidia_smi()
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'device {torch.cuda.get_device_name(0)}')
    build_phase(build)

    config = read_config(REPO / 'configs' / 'singlespeaker.yaml')
    tokens = request_tokens(config)
    model = make_model(torch, config)
    n_tok = max(len(t) for t in tokens)
    n_frames = FRAMES_PER_TOKEN * n_tok
    with torch.inference_mode():
        results = kernel_phase(torch, model.cuda(), config, n_tok, n_frames)
    launches, outs = main_path_phase(torch, model, config, tokens)
    reference_phase(torch, model, config, tokens, outs)

    sources = {'pre_highway_stack': ('highway.cu', 'highway.py:113'),
               'cbhg_front': ('cbhg_front.cu', 'cbhg.py:184'),
               'griffin_lim_iter': ('griffin_lim.cu', 'griffin_lim.py:171')}
    kernels = []
    for name, (src, tpu) in sources.items():
        r = results[name]
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'forwardtacotron_torch/ops/hopper/{src}',
            'replaces': f'forwardtacotron_tpu/ops/pallas/{tpu}',
            'launches': launches[name], 'max_abs_err': r['max_abs_err'],
            'ms': r['ms'], 'plain_ms': r['plain_ms'],
            'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
            'library_ms': None, 'at': r['at']})
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
