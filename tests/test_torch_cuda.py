"""The port's Hopper kernels against their plain twins on the card, at small
shapes with ragged edges (rows, frames and bins that are not tile
multiples, tail masks). Needs an NVIDIA GPU and nvcc; skips elsewhere.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -o addopts='' -m cuda tests/test_torch_cuda.py

Tolerance: float32 with different summation orders, max abs error at most
1e-4 of the output's scale (max(1, max |twin|)); 1e-3 for Griffin-Lim's
phase-normalized spectrum, where dividing by |up| amplifies rounding in
bins whose momentum update nearly cancels. bfloat16 kernels and twins round
at the same points, but a float32 sum taken in another order can land on
the neighbouring bfloat16 value (2^-8 relative) and a recurrence carries
such a step on: 3e-2 of the scale, inside the JAX package's own bf16
kernel tolerance of 5e-2; the backward sweeps' outputs, which carry dh
through T steps, the same, and the MRF level (alone or behind its upsample),
whose residual chains carry one bf16 step through 6 convolutions. The
length regulators copy rows: exact.
"""

import itertools

import pytest
import torch
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.ops.hopper import (cbhg, griffin_lim, highway, lr,
                                              lr_bidir, mrf, rnn, rnn_train,
                                              ups_mrf)

pytestmark = pytest.mark.cuda
TOL = 1e-4
BF16_TOL = 3e-2


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= tol * scale


@pytest.mark.parametrize('n,c_in,c', [(77, 80, 256), (33, 256, 256),
                                      (5, 12, 64), (41, 6, 128)])
def test_pre_highway_kernel_matches_twin(dev, n, c_in, c):
    """An input width of 6 is padded to 8 by the wrapper."""
    g = torch.Generator().manual_seed(n)
    layers = 4
    args = [torch.randn(s, generator=g) * sc for s, sc in (
        ((n, c_in), 1.0), ((n, c_in), 1.0), ((c_in, c), c_in ** -0.5),
        ((layers, c, 2 * c), c ** -0.5), ((layers, 2 * c), 0.1))]
    args = [a.to(dev) for a in args]
    before = highway.launches
    got = highway.pre_highway_stack(*args)
    torch.cuda.synchronize()
    assert highway.launches == before + 1
    _close([got], [highway.pre_highway_stack_plain(*args)])


@pytest.mark.parametrize('b,t,c_in,c,p,k_max', [(2, 70, 80, 256, 256, 8),
                                                (1, 9, 8, 16, 12, 3),
                                                (2, 40, 6, 10, 12, 3)])
def test_cbhg_front_kernel_matches_twin(dev, b, t, c_in, c, p, k_max):
    """C_in 6 and C 10 are padded to 8 and 12 by the wrapper."""
    g = torch.Generator().manual_seed(t)
    x = torch.randn(b, t, c_in, generator=g)
    mask = torch.ones(b, t)
    mask[-1, t // 2:] = 0.0
    x = x * mask[:, :, None]
    bank = [torch.randn(k, c_in, c, generator=g) * (k * c_in) ** -0.5
            for k in range(1, k_max + 1)]
    rest = [torch.rand(k_max, c, generator=g) + 0.5,
            0.1 * torch.randn(k_max, c, generator=g),
            torch.randn(3, k_max * c, p, generator=g) * (3 * k_max * c) ** -0.5,
            torch.rand(p, generator=g) + 0.5, 0.1 * torch.randn(p, generator=g)]
    args = [x.to(dev), mask.to(dev), [w.to(dev) for w in bank],
            *(a.to(dev) for a in rest)]
    got = cbhg.bank_pool_proj(*args)
    torch.cuda.synchronize()
    _close([got], [cbhg.bank_pool_proj_plain(*args)])


def _gl_args(dev, n_fft, hop, f, b=2):
    g = torch.Generator().manual_seed(f)
    bins = n_fft // 2 + 1
    consts = griffin_lim.gl_constants(n_fft, hop, n_fft, dev)
    winsq = griffin_lim.ola_normalizer(n_fft, hop, f, n_fft, dev)
    spec = [torch.randn(b, f, bins, generator=g).to(dev) for _ in range(4)]
    mag = torch.rand(b, f, bins, generator=g).to(dev)
    return (*spec, mag, winsq, consts, hop)


@pytest.mark.parametrize('n_fft,hop,f', [(1024, 256, 70), (64, 16, 9),
                                         (640, 64, 23), (2048, 128, 40),
                                         (2048, 128, 32)])
def test_griffin_lim_iter_kernel_matches_twin(dev, n_fft, hop, f):
    """R = 4, 10 and 16 (n_fft 2048, hop 128, down to F = 2R = 32 frames,
    every frame an edge frame): one launch pair against the twin."""
    args = _gl_args(dev, n_fft, hop, f)
    before = griffin_lim.launches
    got = griffin_lim.griffin_lim_iter(*args)
    torch.cuda.synchronize()
    assert griffin_lim.launches == before + 1
    want = griffin_lim.griffin_lim_iter_plain(*args)
    _close(got[2:], want[2:])                 # rebuilt spectrum
    _close(got[:2], want[:2], tol=10 * TOL)   # phase-normalized spectrum


@pytest.mark.parametrize('n_fft,hop,f', [(1024, 256, 70), (2048, 128, 40),
                                         (64, 16, 9)])
def test_griffin_lim_kernel_edge_rows_match_edge_frames(dev, n_fft, hop, f):
    """The first and last R frames the kernel builds from its IDFT frames:
    the rebuilt spectrum's rows there are the DFT of those frames alone, so
    they must equal the DFT of edge_frames' rows, per item."""
    args = _gl_args(dev, n_fft, hop, f)
    spec_re, spec_im, consts, r = args[0], args[1], args[6], n_fft // hop
    _, _, rb_re, rb_im = griffin_lim.griffin_lim_iter(*args)
    torch.cuda.synchronize()
    repl = griffin_lim.edge_frames(spec_re, spec_im, hop, consts, args[5])
    got = [torch.cat([x[:, :r], x[:, f - r:]], dim=1) for x in (rb_re, rb_im)]
    _close(got, [repl @ consts.fwd_re, repl @ consts.fwd_im])


def test_dsp_griffinlim_at_r16_matches_pair_path(dev):
    """DSP.griffinlim at n_fft 2048, hop 128 (R = 16) on the card, which
    runs griffin_lim.cu, against the pair path (ops/stft.py, plain torch)
    from the same phase: 32 iterations drift apart from float32 rounding,
    so the spectral convergence of each must agree within 1%."""
    import numpy as np

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.ops.stft import griffin_lim_pair, stft_pair

    n_fft, hop, sr = 2048, 128, 22050
    dsp = DSP(num_mels=80, sample_rate=sr, hop_length=hop, win_length=n_fft,
              n_fft=n_fft, fmin=0, fmax=8000, device=dev)
    t = torch.arange(hop * 199, device=dev) / sr
    sig = sum(0.2 / k * torch.sin(2 * torch.pi * k * (110 + 40 * t) * t)
              for k in range(1, 6))
    re, im = stft_pair(sig, n_fft, hop, n_fft)
    mel = torch.log(torch.clamp(dsp.mel_basis @ torch.sqrt(
        re * re + im * im).T, min=1e-5)).cpu().numpy()       # 200 frames
    linear = dsp._mel_to_stft(torch.exp(torch.as_tensor(mel, device=dev)))
    phase = np.random.RandomState(0).uniform(0, 2 * np.pi, linear.shape)
    before = griffin_lim.launches
    wav = dsp.griffinlim(mel, n_iter=32, phase=phase)
    assert griffin_lim.launches == before + 32
    pair = griffin_lim_pair(linear, torch.as_tensor(
        phase, dtype=torch.float32, device=dev), n_fft, hop, n_fft,
        n_iter=32)

    def convergence(w):
        re, im = stft_pair(torch.as_tensor(w, device=dev), n_fft, hop, n_fft)
        m = torch.sqrt(re * re + im * im)[:linear.shape[1]].T
        return float(torch.linalg.norm(m - linear) / torch.linalg.norm(linear))

    sc_k, sc_p = convergence(wav), convergence(pair)
    assert sc_k < 1.0 and abs(sc_k - sc_p) <= 0.01 * sc_p


def _rand(g, shape, scale, dev, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


def test_front_and_highway_raise_on_unsupported_shapes(dev):
    """Shapes the highway and CBHG-front kernels cannot take raise on the
    card, with the message of their ``shape_error``: a highway width that
    is not a multiple of 4 or too wide for shared memory, a bank whose taps
    reach past the JAX gate's halo (K = 18)."""
    g = torch.Generator().manual_seed(5)
    before = (highway.launches, cbhg.launches)
    for c_in, c, layers, match in ((80, 130, 1, 'multiple of 4'),
                                   (80, 29060, 0, 'shared memory')):
        args = [torch.randn(s, generator=g).to(dev) for s in (
            (9, c_in), (9, c_in), (c_in, c), (layers, c, 2 * c),
            (layers, 2 * c))]
        with pytest.raises(ValueError, match=match):
            highway.pre_highway_stack(*args)
    k_max, c_in, c, p = 18, 8, 16, 32
    args = [torch.randn(1, 9, c_in, generator=g).to(dev),
            torch.ones(1, 9, device=dev),
            [torch.randn(k, c_in, c, generator=g).to(dev)
             for k in range(1, k_max + 1)],
            torch.ones(k_max, c, device=dev),
            torch.zeros(k_max, c, device=dev),
            torch.randn(3, k_max * c, p, generator=g).to(dev),
            torch.ones(p, device=dev), torch.zeros(p, device=dev)]
    with pytest.raises(ValueError, match='K=18'):
        cbhg.bank_pool_proj(*args)
    assert (highway.launches, cbhg.launches) == before


def test_gates_raise_where_kernels_refuse(dev):
    """Where the JAX package's gates send a part to a Pallas kernel and the
    CUDA kernel does not take its shape, the forward raises on the card
    rather than run plain operations: an MRF level of 512 channels, a tail
    level of 512 channels. A CBHG front projecting to 320 columns,
    which the front kernel once refused, now launches it and matches the
    CPU."""
    from forwardtacotron_torch.models.layers import CBHG
    from forwardtacotron_torch.models.vocoder import HiFiGANGenerator

    m = CBHG(4, 80, 128, [320, 80], 4).eval()
    x = torch.randn(1, 9, 80, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want = m.pre_rnn(x)
        before = cbhg.launches
        got = m.to(dev).pre_rnn(x.to(dev))
        torch.cuda.synchronize()
    assert cbhg.launches == before + 1
    _close([got.cpu()], [want], 1e-3)
    before = (cbhg.launches, mrf.launches, ups_mrf.launches)
    for kw, match in ((dict(upsample_initial_channel=1024,
                            resblock_kernel_sizes=(3,),
                            resblock_dilation_sizes=((1, 3, 5),),
                            fuse_mrf_max_ch=512), 'C=512'),
                      (dict(upsample_rates=(2, 2),
                            upsample_kernel_sizes=(4, 4),
                            upsample_initial_channel=1024,
                            resblock_kernel_sizes=(3,),
                            resblock_dilation_sizes=((1, 3, 5),),
                            fuse_ups_tail_max_ch=512), 'C=512')):
        gen = HiFiGANGenerator(num_mels=8, **kw).eval().to(dev)
        with torch.no_grad(), pytest.raises(NotImplementedError,
                                            match=match):
            gen(torch.randn(1, 4, 8, device=dev))
    assert (cbhg.launches, mrf.launches, ups_mrf.launches) == before


@pytest.mark.parametrize('n,c_in,c', [(77, 80, 256), (33, 256, 256),
                                      (41, 6, 128)])
def test_pre_highway_bf16_kernel_matches_twin(dev, n, c_in, c):
    g = torch.Generator().manual_seed(n)
    layers = 4
    args = [_rand(g, (n, c_in), 1.0, dev), _rand(g, (n, c_in), 1.0, dev),
            _rand(g, (c_in, c), c_in ** -0.5, dev),
            _rand(g, (layers, c, 2 * c), c ** -0.5, dev),
            _rand(g, (layers, 2 * c), 0.1, dev, torch.float32)]
    got = highway.pre_highway_stack(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _close([got.float()], [highway.pre_highway_stack_plain(*args).float()],
           BF16_TOL)


@pytest.mark.parametrize('b,t', [(2, 70), (3, 9)])
def test_cbhg_front_bf16_kernel_matches_twin(dev, b, t):
    g = torch.Generator().manual_seed(t)
    c_in, c, p, k_max = 80, 256, 256, 8
    mask = torch.ones(b, t)
    mask[-1, t // 2:] = 0.0
    x = (torch.randn(b, t, c_in, generator=g) * mask[:, :, None]).to(
        dev, torch.bfloat16)
    bank = [_rand(g, (k, c_in, c), (k * c_in) ** -0.5, dev)
            for k in range(1, k_max + 1)]
    f32 = dict(device=dev, dtype=torch.float32)
    args = [x, mask.to(dev), bank,
            (torch.rand(k_max, c, generator=g) + 0.5).to(**f32),
            _rand(g, (k_max, c), 0.1, dev, torch.float32),
            _rand(g, (3, k_max * c, p), (3 * k_max * c) ** -0.5, dev),
            (torch.rand(p, generator=g) + 0.5).to(**f32),
            _rand(g, (p,), 0.1, dev, torch.float32)]
    got = cbhg.bank_pool_proj(*args)
    torch.cuda.synchronize()
    _close([got.float()], [cbhg.bank_pool_proj_plain(*args).float()],
           BF16_TOL)


def _front_args(g, b, t, dev, dtype, c_in=80, c=256, p=256, k_max=8):
    """Full-width postnet front inputs (K 8, C_in 80, C = P = 256 unless
    given), the last item masked from frame t // 2 (ragged tail)."""
    mask = torch.ones(b, t)
    mask[-1, t // 2:] = 0.0
    x = (torch.randn(b, t, c_in, generator=g) * mask[:, :, None]).to(
        dev, dtype)
    f32 = dict(device=dev, dtype=torch.float32)
    return [x, mask.to(dev),
            [_rand(g, (k, c_in, c), (k * c_in) ** -0.5, dev, dtype)
             for k in range(1, k_max + 1)],
            (torch.rand(k_max, c, generator=g) + 0.5).to(**f32),
            _rand(g, (k_max, c), 0.1, dev, torch.float32),
            _rand(g, (3, k_max * c, p), (3 * k_max * c) ** -0.5, dev, dtype),
            (torch.rand(p, generator=g) + 0.5).to(**f32),
            _rand(g, (p,), 0.1, dev, torch.float32)]


def _front_matches(args, dtype):
    before = cbhg.launches
    got = cbhg.bank_pool_proj(*args)
    torch.cuda.synchronize()
    assert cbhg.launches == before + 1 and got.dtype == dtype
    _close([got.float()], [cbhg.bank_pool_proj_plain(*args).float()],
           TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize('b,t', [(2, 1), (2, 127), (3, 128), (2, 129),
                                 (2, 256)])
def test_front_bf16_kernel_off_tile(dev, b, t):
    """The tensor-core front at full width, at T around its 128-frame tile
    (1, tile - 1, tile, tile + 1, two tiles) with a tail mask."""
    _front_matches(_front_args(torch.Generator().manual_seed(t), b, t, dev,
                               torch.bfloat16), torch.bfloat16)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('p', [320, 512])
def test_front_kernel_wide_projection(dev, dtype, p):
    """P > 256, which the JAX gate admits: both entries tile P."""
    _front_matches(_front_args(torch.Generator().manual_seed(p), 2, 70, dev,
                               dtype, p=p), dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_front_kernel_input_channel_chunks(dev, dtype):
    """C_in = 1600: the input halo does not fit shared memory whole, so
    both entries reload it in chunks of input channels (n_ci > 1); C 64 and
    P 96 are not multiples of the f32 entry's 256-column chunks."""
    c_in = 1600
    for dt in (torch.float32, torch.bfloat16):
        assert cbhg.plan(dt, 4, c_in, 64, 96)['n_ci'] > 1
    _front_matches(_front_args(torch.Generator().manual_seed(3), 1, 130,
                               dev, dtype, c_in=c_in, c=64, p=96, k_max=4),
                   dtype)


def _highway_args(g, n, c_in, c, layers, dev, dtype=torch.bfloat16):
    return [_rand(g, (n, c_in), 1.0, dev, dtype),
            _rand(g, (n, c_in), 1.0, dev, dtype),
            _rand(g, (c_in, c), c_in ** -0.5, dev, dtype),
            _rand(g, (layers, c, 2 * c), c ** -0.5, dev, dtype),
            _rand(g, (layers, 2 * c), 0.1, dev, torch.float32)]


@pytest.mark.parametrize('n', [1, 127, 128, 129, 256 * 3])
@pytest.mark.parametrize('c_in', [80, 256])
def test_highway_bf16_kernels_off_tile(dev, n, c_in):
    """Both tensor-core entries at the CBHGs' full width (C_in 80 or 256,
    C 256, 4 layers), at row counts around the 128-row tile."""
    g = torch.Generator().manual_seed(n)
    args = _highway_args(g, n, c_in, 256, 4, dev)
    x = _rand(g, (n, 256), 1.0, dev)
    before = (highway.launches, highway.stack_launches)
    got = highway.pre_highway_stack(*args)
    got_stack = highway.highway_stack(x, *args[3:])
    torch.cuda.synchronize()
    assert (highway.launches, highway.stack_launches) == (before[0] + 1,
                                                          before[1] + 1)
    _close([got.float()], [highway.pre_highway_stack_plain(*args).float()],
           BF16_TOL)
    _close([got_stack.float()],
           [highway.highway_stack_plain(x, *args[3:]).float()], BF16_TOL)


@pytest.mark.parametrize('c_in,c,layers', [(80, 1024, 2), (256, 2048, 1),
                                           (80, 3072, 1)])
def test_highway_bf16_kernel_takes_wide_rows(dev, c_in, c, layers):
    """Row tiles of 32 and 16 rows, and fewer than 16 (C = 3072)."""
    rows = highway.plan(c_in, c)['rows']
    assert rows == {1024: 32, 2048: 16, 3072: 15}[c]
    args = _highway_args(torch.Generator().manual_seed(c), 41, c_in, c,
                         layers, dev)
    got = highway.pre_highway_stack(*args)
    torch.cuda.synchronize()
    _close([got.float()], [highway.pre_highway_stack_plain(*args).float()],
           BF16_TOL)


def _durations(g, b, n, t_run):
    """Rounded durations with an empty item, zero durations and, for b > 1,
    one item longer than t_run."""
    reps = torch.randint(0, 4, (b, n), generator=g)
    reps[0, ::3] = 0
    if b > 1:
        reps[1] = t_run // n + 2
        reps[-1] = 0
    return torch.cumsum(reps, dim=1)


@pytest.mark.parametrize('b', [1, 3, 17])
@pytest.mark.parametrize('t_run', [1, 63, 65])
@pytest.mark.parametrize('dtype,c', [(torch.bfloat16, 512),
                                     (torch.float32, 12)])
def test_lr_bidir_kernel_matches_twin(dev, b, t_run, dtype, c):
    g = torch.Generator().manual_seed(b * 100 + t_run)
    n = 7
    ends = _durations(g, b, n, t_run)
    x = _rand(g, (b, n, c), 1.0, dev, dtype)
    ends32 = ends.to(dev, torch.int32)
    before = lr_bidir.launches
    got = lr_bidir.length_regulator_bidir(x, ends32, t_run)
    torch.cuda.synchronize()
    assert lr_bidir.launches == before + 1
    assert torch.equal(got, lr_bidir.length_regulator_bidir_plain(
        x, ends.to(dev), t_run))


def _rnn_weights(g, i, h, n_gates, dev):
    return (_rand(g, (2, i, n_gates * h), max(i, 1) ** -0.5, dev),
            _rand(g, (2, h, n_gates * h), h ** -0.5, dev),
            _rand(g, (2, n_gates * h), 0.1, dev),
            _rand(g, (2, n_gates * h), 0.1, dev))


@pytest.mark.parametrize('b', [1, 3, 17])
@pytest.mark.parametrize('t', [1, 63, 65])
def test_gru_xp_kernel_matches_twin(dev, b, t):
    g = torch.Generator().manual_seed(b * 100 + t)
    h = 256
    _, wh, _, bh = _rnn_weights(g, 16, h, 3, dev)
    xp2 = _rand(g, (t, 2, b, 3 * h), 1.0, dev)
    before = rnn.launches['gru_xp']
    got = rnn.gru_xp(xp2, wh, bh)
    torch.cuda.synchronize()
    assert rnn.launches['gru_xp'] == before + 1
    _close([got.float()], [rnn.gru_xp_plain(xp2, wh, bh).float()], BF16_TOL)


@pytest.mark.parametrize('b,t,h', [(b, t, 512) for b in (1, 3, 17, 64, 4096)
                                   for t in (1, 63, 81)]
                         + [(4096, 81, 1024), (300, 7, 1056)])
def test_gru_xp_step_major_matches_twin(dev, b, t, h):
    """The multi-GRU's step-major kernel at the serving width (H 512), a
    wide one (1024) and the widest the tile-major kernel took (1056, 66
    CTAs per direction), from one row to a serving batch: one launch, every
    element within BF16_TOL of the twin."""
    g = torch.Generator().manual_seed(b * 100 + t + h)
    _, wh, _, bh = _rnn_weights(g, 16, h, 3, dev)
    xp2 = _rand(g, (t, 2, b, 3 * h), 1.0, dev)
    before = dict(rnn.launches)
    got = rnn.gru_xp(xp2, wh, bh)
    torch.cuda.synchronize()
    assert rnn.launches == {**before, 'gru_xp': before['gru_xp'] + 1}
    _close([got.float()], [rnn.gru_xp_plain(xp2, wh, bh).float()], BF16_TOL)


def test_gru_xp_refused_width_raises(dev):
    """H = 1072 needs more CTAs than the card has SMs at every slice width
    (the tile-major kernel refused it too): the plan raises before any
    launch."""
    g = torch.Generator().manual_seed(3)
    h = 1072
    _, wh, _, bh = _rnn_weights(g, 16, h, 3, dev)
    before = dict(rnn.launches)
    with pytest.raises(ValueError, match='no gru_xp slice'):
        rnn.gru_xp(_rand(g, (2, 2, 5, 3 * h), 1.0, dev), wh, bh)
    assert rnn.launches == before


# (B, T, I, H) of the LSTMs beside the small shapes: the bf16 train step's
# bi-LSTM (batch 32, 928 frames, one 64-row tile), a batch of three tiles
# in two groups (130), full width and narrow, and an input of width 0 (no
# x rows: the gates from the bias and h alone)
LSTM_SHAPES = [(32, 928, 512, 512), (130, 65, 512, 512), (130, 3, 64, 128),
               (17, 5, 0, 128)]


@pytest.mark.parametrize('b,t,cell,i,h', [
    (b, t, cell, i, h) for b in (1, 3, 17) for t in (1, 65)
    for cell, i, h in (('gru', 80, 128), ('gru', 256, 256), ('lstm', 64, 128))
] + [(b, t, 'lstm', i, h) for b, t, i, h in LSTM_SHAPES])
def test_bidir_rnn_kernel_matches_twin(dev, b, t, cell, i, h):
    g = torch.Generator().manual_seed(b * 100 + t + i)
    wi, wh, bi, bh = _rnn_weights(g, i, h, 3 if cell == 'gru' else 4, dev)
    x2 = _rand(g, (t, 2, b, i), 1.0, dev)
    before = dict(rnn.launches)
    if cell == 'gru':
        got, want = rnn.gru(x2, wi, wh, bi, bh), rnn.gru_plain(
            x2, wi, wh, bi, bh)
    else:
        got, want = rnn.lstm(x2, wi, wh, bi + bh), rnn.lstm_plain(
            x2, wi, wh, bi + bh)
    torch.cuda.synchronize()
    assert rnn.launches == {**before, cell: before[cell] + 1}
    _close([got.float()], [want.float()], BF16_TOL)


@pytest.mark.parametrize('b', [1, 3, 17])
@pytest.mark.parametrize('t', [1, 63, 65])
def test_lstm_mel_kernel_matches_twin(dev, b, t):
    g = torch.Generator().manual_seed(b * 100 + t)
    i, h, m = 256, 128, 80
    wi, wh, bi, bh = _rnn_weights(g, i, h, 4, dev)
    wm = _rand(g, (2, h, m), h ** -0.5, dev)
    x2 = _rand(g, (t, 2, b, i), 1.0, dev)
    before = rnn.launches['lstm_mel']
    got = rnn.lstm_mel(x2, wi, wh, bi + bh, wm)
    torch.cuda.synchronize()
    assert rnn.launches['lstm_mel'] == before + 1
    _close([got.float()],
           [rnn.lstm_mel_plain(x2, wi, wh, bi + bh, wm).float()], BF16_TOL)


@pytest.mark.parametrize('b', [65, 257, 1100])
@pytest.mark.parametrize('t', [1, 2, 37])
@pytest.mark.parametrize('cell', ['gru', 'lstm_mel', 'lstm', 'lstm_train'])
def test_step_major_kernels_match_twins_across_tiles(dev, b, t, cell):
    """The step-major kernels at full width (the postnet GRU I 256, H 256;
    the LSTMs I 512, H 512, LSTM-mel M 80) at batches that cross 64-row
    tiles and group boundaries: 65 (two tiles, one per group), 257 (five
    tiles: the GRU's 8 groups hold one each, the LSTMs' 2 groups three, so
    two consumer warpgroups and c through memory), and a ragged batch
    above the groups' first round of tiles (1100, 18 tiles: every group
    walks two or more). lstm_train's hs and cs both."""
    g = torch.Generator().manual_seed(b * 100 + t)
    if cell == 'gru':
        i, h = 256, 256
        wi, wh, bi, bh = _rnn_weights(g, i, h, 3, dev)
        x2 = _rand(g, (t, 2, b, i), 1.0, dev)
        args, kernel, plain = (x2, wi, wh, bi, bh), rnn.gru, rnn.gru_plain
    else:
        i, h, m = 512, 512, 80
        wi, wh, bi, bh = _rnn_weights(g, i, h, 4, dev)
        x2 = _rand(g, (t, 2, b, i), 1.0, dev)
        args = (x2, wi, wh, bi + bh)
        kernel, plain = {'lstm': (rnn.lstm, rnn.lstm_plain),
                         'lstm_train': (rnn.lstm_train, rnn.lstm_train_plain),
                         'lstm_mel': (rnn.lstm_mel, rnn.lstm_mel_plain)}[cell]
        if cell == 'lstm_mel':
            args += (_rand(g, (2, h, m), h ** -0.5, dev),)
    before = dict(rnn.launches)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert rnn.launches == {**before, cell: before[cell] + 1}
    want = plain(*args)
    if cell != 'lstm_train':
        got, want = [got], [want]
    _close([v.float() for v in got], [v.float() for v in want], BF16_TOL)


# (cell, B, I, H) -> the plan's (unit, warpgroups, stages) on an H100
FEW_STAGES = {
    # the fewest stages the kernel takes, with two warpgroups
    ('gru', 1100, 192, 512): (32, 2, 3),
    ('lstm_mel', 1100, 640, 512): (16, 2, 3),
    # where the first slice leaves two stages: a narrower slice, one ring
    ('gru', 1100, 256, 512): (16, 2, 8),
    ('lstm_mel', 1100, 768, 512): (16, 1, 5),
    # where the first slice does not fit at all
    ('gru', 300, 256, 1024): (16, 2, 4),
}


@pytest.mark.parametrize('t', [1, 37])
@pytest.mark.parametrize('shape', sorted(FEW_STAGES))
def test_step_major_kernels_with_few_ring_stages(dev, t, shape):
    """Widths whose weight slice leaves the rings little room: the
    smallest ring the plan admits (3 stages, two warpgroups of several
    tiles each), and the plan's fallbacks to a narrower slice or one
    warpgroup. Every element within BF16_TOL of the twin, one launch."""
    cell, b, i, h = shape
    m = 80 if cell == 'lstm_mel' else 0
    if rnn.device_limits(dev) == (132, 232_448):
        p = rnn.plan(cell, b, t, i, h, m, *rnn.device_limits(dev))
        assert (p['unit'], p['warpgroups'], p['stages']) == FEW_STAGES[shape]
        assert p['tiles_per_group'] >= 2
    g = torch.Generator().manual_seed(b + t + i + h)
    wi, wh, bi, bh = _rnn_weights(g, i, h, 4 if m else 3, dev)
    x2 = _rand(g, (t, 2, b, i), 1.0, dev)
    if m:
        args = (x2, wi, wh, bi + bh, _rand(g, (2, h, m), h ** -0.5, dev))
        kernel, plain = rnn.lstm_mel, rnn.lstm_mel_plain
    else:
        args, kernel, plain = (x2, wi, wh, bi, bh), rnn.gru, rnn.gru_plain
    before = dict(rnn.launches)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert rnn.launches == {**before, cell: before[cell] + 1}
    _close([got.float()], [plain(*args).float()], BF16_TOL)


@pytest.mark.parametrize('cell', ['gru', 'lstm_mel', 'lstm', 'lstm_train'])
def test_step_major_gates_match_twin_to_one_bf16_step(dev, cell):
    """The gates alone, held tighter than BF16_TOL: one time step (h and c
    start at 0), every product exact in float32 (small integers times a
    power of two per weight column, zero biases; for LSTM-mel a W_mel that
    picks one unit per mel column), so kernel and twin see the same
    pre-activations and each output element must lie within one bfloat16
    step (2^-7 relative) of the twin's. The column scales reach 2^-26,
    where tanh(v) ~ v: a tanh or sigmoid that loses relative accuracy near
    0 (tanh as 2 sigmoid(2v) - 1 from a fast exponential) fails here."""
    g = torch.Generator().manual_seed(5)
    b, t = 300, 1
    i, h, m = (256, 256, 0) if cell == 'gru' else (512, 512, 80)
    cols = (3 if cell == 'gru' else 4) * h

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=g).float()

    scale = 2.0 ** -torch.randint(4, 27, (2, 1, cols), generator=g).float()
    x2 = (ints(t, 2, b, i) / 8).to(dev, torch.bfloat16)
    wi = (ints(2, i, cols) * scale).to(dev, torch.bfloat16)
    wh = _rand(g, (2, h, cols), h ** -0.5, dev)     # h_{-1} = 0: unused
    zero = torch.zeros(2, cols, dtype=torch.bfloat16, device=dev)
    if cell == 'gru':
        args, kernel, plain = (x2, wi, wh, zero, zero), rnn.gru, rnn.gru_plain
    elif cell == 'lstm_mel':
        wm = torch.zeros(2, h, m)
        wm[:, torch.arange(m) * 37 % h, torch.arange(m)] = 1.0
        args = (x2, wi, wh, zero, wm.to(dev, torch.bfloat16))
        kernel, plain = rnn.lstm_mel, rnn.lstm_mel_plain
    else:
        args = (x2, wi, wh, zero)
        kernel, plain = ((rnn.lstm, rnn.lstm_plain) if cell == 'lstm' else
                         (rnn.lstm_train, rnn.lstm_train_plain))
    got, want = kernel(*args), plain(*args)
    if cell == 'lstm_train':     # h and c of the step side by side
        got, want = torch.cat(got, -1), torch.cat(want, -1)
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    tiny = (want != 0) & (want.abs() < 1e-5)
    assert int(tiny.sum()) > 1000 and float(want.abs().max()) > 0.1
    assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs()).all())


@pytest.mark.parametrize('cell,fault', [('gru', 'carve'),
                                        ('lstm_mel', 'limit'),
                                        ('gru', 'stages'),
                                        ('lstm', 'carve'),
                                        ('lstm_train', 'stages')])
def test_step_entry_refuses_a_plan_that_does_not_fit(dev, cell, fault,
                                                     monkeypatch):
    """The entry checks the plan it is given: a carve that is not the
    kernel's own sum, one over the card's limit, or a ring of fewer than
    MIN_STAGES stages (whose producer and consumers would wait for each
    other), is refused and the wrapper raises without counting a launch."""
    real = rnn.plan

    def faulty(*args):
        p = dict(real(*args))
        stage = p['warpgroups'] * p['tile'] * p['chunk'] * 2
        if fault == 'carve':
            p['smem'] += 128
        else:
            n = rnn.MAX_STAGES if fault == 'limit' else rnn.MIN_STAGES - 1
            p['smem'] += (n - p['stages']) * stage
            p['stages'] = n
        return p

    monkeypatch.setattr(rnn, 'plan', faulty)
    g = torch.Generator().manual_seed(1)
    i = h = 256 if cell == 'gru' else 512
    wi, wh, bi, bh = _rnn_weights(g, i, h, 3 if cell == 'gru' else 4, dev)
    x2 = _rand(g, (3, 2, 300, i), 1.0, dev)    # five 64-row tiles
    before = dict(rnn.launches)
    with pytest.raises(RuntimeError, match='launch failed'):
        if cell == 'gru':
            rnn.gru(x2, wi, wh, bi, bh)
        elif cell == 'lstm_mel':
            rnn.lstm_mel(x2, wi, wh, bi + bh,
                         _rand(g, (2, h, 80), h ** -0.5, dev))
        else:
            getattr(rnn, cell)(x2, wi, wh, bi + bh)
    assert rnn.launches == before
    if fault == 'limit':    # over the card's limit, not only off the sum
        assert rnn.plan('lstm_mel', 300, 3, i, h, 80,
                        *rnn.device_limits(dev))['smem'] \
            > rnn.device_limits(dev)[1]


def test_unsupported_shapes_raise_on_the_card(dev):
    """A CUDA input the kernels do not take raises; it never runs the
    twin instead."""
    g = torch.Generator().manual_seed(0)
    wi, wh, bi, bh = _rnn_weights(g, 64, 100, 3, dev)     # H % 16 != 0
    x2 = _rand(g, (5, 2, 3, 64), 1.0, dev)
    before = dict(rnn.launches)
    with pytest.raises(ValueError, match='multiples of 16'):
        rnn.gru(x2, wi, wh, bi, bh)
    wi, wh, bi, bh = _rnn_weights(g, 64, 128, 3, dev)
    with pytest.raises(ValueError, match='bfloat16'):
        rnn.gru(x2.float(), wi, wh, bi, bh)
    with pytest.raises(ValueError, match='bad shapes'):
        rnn.gru_xp(_rand(g, (5, 2, 3, 3 * 128), 1.0, dev),
                   wh[:, :64].contiguous(), bh)
    assert rnn.launches == before
    with pytest.raises(ValueError, match='multiple of 16'):
        lr_bidir.length_regulator_bidir(
            _rand(g, (3, 4, 12), 1.0, dev),           # 24-byte rows
            torch.ones(3, 4, dtype=torch.int32, device=dev), 8)


@pytest.mark.parametrize('ragged', [False, True])
@pytest.mark.parametrize('b', [1, 3, 17])
def test_bigru_layer_on_card_matches_cpu_twins(dev, ragged, b):
    """A bf16 BiGRU on the card (kernel route, with the per-item flips of
    ``lengths``) against the same module on the CPU (twin route)."""
    import copy

    from forwardtacotron_torch.models.layers import BiGRU

    g = torch.Generator().manual_seed(b)
    t = 65
    module = BiGRU(256, 256).to(torch.bfloat16)
    x = torch.randn(b, t, 256, generator=g).to(torch.bfloat16)
    lens = (torch.randint(1, t + 1, (b,), generator=g) if ragged else None)
    with torch.no_grad():
        want = module(x, lens)
        before = rnn.launches['gru']
        got = copy.deepcopy(module).to(dev)(
            x.to(dev), None if lens is None else lens.to(dev))
        torch.cuda.synchronize()
    assert rnn.launches['gru'] == before + 1
    _close([got.float().cpu()], [want.float()], BF16_TOL)


@pytest.mark.parametrize('b', [1, 3, 17])
def test_lstm_lr_mel_layer_on_card_matches_cpu_twins(dev, b):
    """The fused frame trunk on the card against the CPU twins: zero
    durations, an empty item and an item over a 100-frame budget (not a
    multiple of the 64-frame run tile)."""
    import copy

    from forwardtacotron_torch.models.layers import BiLSTM, lstm_lr_mel

    g = torch.Generator().manual_seed(b)
    n, c, h, m, max_len = 7, 256, 128, 80, 100
    lstm = BiLSTM(c, h).to(torch.bfloat16)
    lin = torch.nn.Linear(2 * h, m).to(torch.bfloat16)
    x = torch.randn(b, n, c, generator=g).to(torch.bfloat16)
    dur = 3 * torch.rand(b, n, generator=g)
    dur[0, ::2] = 0.0
    if b > 1:
        dur[1] = 30.0
        dur[-1] = 0.0
    dur = dur.to(torch.bfloat16)
    with torch.no_grad():
        want = lstm_lr_mel(x, dur, max_len, lstm, lin)
        got = lstm_lr_mel(x.to(dev), dur.to(dev), max_len,
                          copy.deepcopy(lstm).to(dev),
                          copy.deepcopy(lin).to(dev))
        torch.cuda.synchronize()
    assert got.shape == (b, max_len, m)
    _close([got.float().cpu()], [want.float()], BF16_TOL)


@pytest.mark.parametrize('b', [1, 3, 17])
@pytest.mark.parametrize('t', [1, 63, 1280])
@pytest.mark.parametrize('dtype,c', [(torch.bfloat16, 512),
                                     (torch.float32, 512),
                                     (torch.float32, 4),      # one word
                                     (torch.bfloat16, 24)])   # three words
def test_lr_kernel_matches_twin(dev, b, t, dtype, c):
    """Zero durations, an empty item and an item over the budget; exact."""
    g = torch.Generator().manual_seed(b * 100 + t + c)
    n = 9
    ends = _durations(g, b, n, t)
    x = _rand(g, (b, n, c), 1.0, dev, dtype)
    ends32 = ends.to(dev, torch.int32)
    before = lr.launches
    got = lr.length_regulator_expand(x, ends32, t)
    torch.cuda.synchronize()
    assert lr.launches == before + 1
    assert torch.equal(got, lr.length_regulator_plain(x, ends.to(dev), t))


@pytest.mark.parametrize('b,n,t,c,dtype', [
    (32, 160, 1024, 512, torch.bfloat16),   # the train shape
    (32, 160, 1024, 512, torch.float32),
    (32, 160, 928, 512, torch.bfloat16),    # the bf16 step's frames
    (1, 92, 896, 512, torch.float32),       # one request
    (4096, 81, 256, 512, torch.bfloat16),
    (130, 9, 63, 4, torch.float32), (130, 9, 63, 8, torch.bfloat16)])
def test_lr_tile_kernel_at_the_port_shapes(dev, b, n, t, c, dtype):
    """The tile kernel at the shapes its callers give it (durations of
    2-9 frames, some items over the budget) and at batches past one wave
    of CTAs: one launch, exact."""
    g = torch.Generator().manual_seed(b + n + t)
    reps = torch.randint(2, 10, (b, n), generator=g)
    ends = torch.cumsum(reps, dim=1).to(dev, torch.int32)
    x = _rand(g, (b, n, c), 1.0, dev, dtype)
    before = lr.launches
    got = lr.length_regulator_expand(x, ends, t)
    torch.cuda.synchronize()
    assert lr.launches == before + 1
    assert torch.equal(got, lr.length_regulator_plain(x, ends, t))


def _lr_edge_ends(name):
    """[B, N] int32 span ends of an edge case (as ``duration_spans`` makes
    them from rounded durations), C and the budget."""
    g = torch.Generator().manual_seed(len(name))
    if name == 'mixed':      # zero, negative and half durations, an empty
        dur = torch.rand(4, 9, generator=g) * 6 - 1   # item, one far over
        dur[0, ::3] = 0.0
        dur[0, 1], dur[0, 2] = 0.5, 1.5
        dur[1], dur[2] = 30.0, -2.0
        c, t = 8, 100
    elif name == 'long_tokens':   # tokens spanning several tiles
        dur = torch.tensor([[3., 70, 0, 0, 5, 130, 1],
                            [40., 1, 1, 1, 200, 0, 9]])
        c, t = 24, 300
    elif name == 'empty_runs':    # runs of more than 32 empty tokens
        dur = torch.zeros(2, 100)
        dur[0, [0, 40, 41, 99]] = torch.tensor([3., 2, 7, 4])
        dur[1, 70:] = 2.0
        c, t = 8, 80
    else:                         # 2,000 tokens: a search of 3 probes
        dur = (torch.rand(2, 2000, generator=g) < 0.3).float()
        dur[1, 1500:] = 0.0
        c, t = 8, 700
    reps = torch.floor(dur.clamp(min=0) + 0.5).long()
    return torch.cumsum(reps, dim=1).to(torch.int32), c, t


@pytest.mark.parametrize('name', ['mixed', 'long_tokens', 'empty_runs',
                                  'many_tokens'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_lr_tile_kernel_edge_cases(dev, name, dtype):
    """Edge cases at the plan's tile and at tiles of 1 to 256 frames (tile
    boundaries inside a token's span, tokens over several tiles): exact."""
    ends, c, t = _lr_edge_ends(name)
    c = c if dtype == torch.bfloat16 else c // 2
    g = torch.Generator().manual_seed(c)
    ends = ends.to(dev)
    x = _rand(g, (ends.shape[0], ends.shape[1], c), 1.0, dev, dtype)
    want = lr.length_regulator_plain(x, ends, t)
    assert torch.equal(lr.length_regulator_expand(x, ends, t), want)
    pl = lr.plan(x.shape[0], x.shape[1], t, c, dtype)
    for tile in (1, 8, 32, 256):
        out = torch.full_like(want, float('nan'))
        lr.launch(x, ends, out, pl._replace(tile=tile))
        torch.cuda.synchronize()
        assert torch.equal(out, want), tile


def test_lr_refused_shape_raises_before_launch(dev, monkeypatch):
    """A shape the plan refuses (a grid past the limit, here lowered), a
    float16 input and rows that are not whole 16-byte words raise before
    any launch."""
    g = torch.Generator().manual_seed(2)
    ends = torch.ones(3, 4, dtype=torch.int32, device=dev).cumsum(
        1, dtype=torch.int32)
    before = lr.launches
    monkeypatch.setattr(lr, 'INT_MAX', 2)
    with pytest.raises(ValueError, match='grid holds at most 2'):
        lr.length_regulator_expand(_rand(g, (3, 4, 16), 1.0, dev), ends, 77)
    monkeypatch.undo()
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        lr.length_regulator_expand(_rand(g, (3, 4, 16), 1.0, dev,
                                         torch.float16), ends, 8)
    with pytest.raises(ValueError, match='16-byte'):
        lr.length_regulator_expand(_rand(g, (3, 4, 6), 1.0, dev,
                                         torch.float32), ends, 8)
    torch.cuda.synchronize()
    assert lr.launches == before


@pytest.mark.parametrize('b', [1, 17])
def test_lr_gradient_on_card_matches_cpu(dev, b):
    """The autograd route on the card (kernel forward, float32 running-sum
    backward) against the CPU; gradients of multiples of 1/4, whose sums
    are exact in any order, so the comparison is exact."""
    g = torch.Generator().manual_seed(b)
    n, c, t = 7, 512, 100
    ends = _durations(g, b, n, t).to(torch.int32)
    x = torch.randn(b, n, c, generator=g).to(torch.bfloat16)
    w = (torch.randint(-4, 5, (b, t, c), generator=g) / 4).to(torch.bfloat16)
    grads = []
    for device in ('cpu', dev):
        xd = x.detach().to(device).requires_grad_()
        out = lr.length_regulator(xd, ends.to(device), t)
        (out.float() * w.to(device).float()).sum().backward()
        grads.append(xd.grad.cpu())
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize('b,t,i,h', [
    (b, t, i, h) for b in (1, 3, 17) for t in (1, 65)
    for i, h in ((64, 128), (512, 512))] + LSTM_SHAPES)
def test_lstm_train_kernel_matches_twin(dev, b, t, i, h):
    g = torch.Generator().manual_seed(b * 100 + t + i)
    wi, wh, bi, bh = _rnn_weights(g, i, h, 4, dev)
    x2 = _rand(g, (t, 2, b, i), 1.0, dev)
    before = dict(rnn.launches)
    hs, cs = rnn.lstm_train(x2, wi, wh, bi + bh)
    torch.cuda.synchronize()
    assert rnn.launches == {**before, 'lstm_train': before['lstm_train'] + 1}
    want = rnn.lstm_train_plain(x2, wi, wh, bi + bh)
    _close([hs.float(), cs.float()], [w.float() for w in want], BF16_TOL)


@pytest.mark.parametrize('cell', ['lstm', 'lstm_train'])
def test_lstm_entries_launch_the_step_major_kernel(dev, cell):
    """One call of ``rnn.lstm`` / ``rnn.lstm_train`` at the train step's
    shape is one launch, counted once, of rnn.cu's step-major kernel in
    its mode (MODE_LSTM_X = 1, MODE_LSTM_TRAIN = 4) with the plan's slice
    width, and of no other recurrent kernel (where the profiler records
    device kernels)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(9)
    b, t, i, h = 32, 9, 512, 512
    wi, wh, bi, bh = _rnn_weights(g, i, h, 4, dev)
    x2 = _rand(g, (t, 2, b, i), 1.0, dev)
    fn = getattr(rnn, cell)
    unit = rnn.plan(cell, b, t, i, h, 0, *rnn.device_limits(dev))['unit']
    fn(x2, wi, wh, bi + bh)                     # built and loaded
    torch.cuda.synchronize()
    before = dict(rnn.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x2, wi, wh, bi + bh)
        torch.cuda.synchronize()
    assert rnn.launches == {**before, cell: before[cell] + 1}
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    recurrent = [n for n in names if 'rnn' in n]
    if names:
        mode = 1 if cell == 'lstm' else 4
        assert len(recurrent) == 1, recurrent
        assert re.search(rf'rnn_step_kernel<(\(int\))?{mode}, {unit}, 0>',
                         recurrent[0]), recurrent


@pytest.mark.parametrize('cell', ['lstm', 'lstm_train'])
def test_lstm_refused_shape_raises_before_launch(dev, cell):
    """H = 1072 needs more CTAs than the card has SMs at every slice width
    (the tile-major kernel the LSTMs ran before refused it too): the plan
    raises ValueError before any launch, and no count moves."""
    g = torch.Generator().manual_seed(4)
    i, h = 64, 1072
    wi, wh, bi, bh = _rnn_weights(g, i, h, 4, dev)
    before = dict(rnn.launches)
    with pytest.raises(ValueError, match=f'no {cell} slice'):
        getattr(rnn, cell)(_rand(g, (2, 2, 5, i), 1.0, dev), wi, wh, bi + bh)
    assert rnn.launches == before


def _bwd_inputs(g, cell, t, b, i, h, dev):
    """Weights, x2, the forward's saved states (from the twin) and an
    incoming gradient dhs."""
    n_gates = 4 if cell == 'lstm' else 3
    wi, wh, bi, bh = _rnn_weights(g, i, h, n_gates, dev)
    x2 = _rand(g, (t, 2, b, i), 1.0, dev)
    dhs = _rand(g, (t, 2, b, h), 1.0, dev)
    if cell == 'lstm':
        hs, cs = rnn.lstm_train_plain(x2, wi, wh, bi + bh)
        return dhs, hs, cs, x2, wi, wh, bi + bh
    return dhs, rnn.gru_plain(x2, wi, wh, bi, bh), x2, wi, wh, bi, bh


@pytest.mark.parametrize('b', [1, 3, 17])
@pytest.mark.parametrize('t', [1, 65])
@pytest.mark.parametrize('cell,i,h', [('gru', 256, 128), ('gru', 256, 256),
                                      ('lstm', 64, 128), ('lstm', 512, 512)])
def test_bwd_kernels_match_twins(dev, b, t, cell, i, h):
    """The reverse-time sweeps: dgx and dgh (GRU) or dgates (LSTM); two
    launches each, the gate product and the sweep."""
    _bwd_matches(dev, cell, t, b, i, h)


def _bwd_matches(dev, cell, t, b, i, h):
    g = torch.Generator().manual_seed(b * 100 + t + i + h)
    args = _bwd_inputs(g, cell, t, b, i, h, dev)
    name = f'{cell}_bwd'
    kernel = rnn_train.gru_bwd if cell == 'gru' else rnn_train.lstm_bwd
    plain = (rnn_train.gru_bwd_plain if cell == 'gru'
             else rnn_train.lstm_bwd_plain)
    before = rnn_train.launches[name]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert rnn_train.launches[name] == before + 2
    want = plain(*args)
    if cell == 'lstm':
        got, want = [got], [want]
    _close([x.float() for x in got], [x.float() for x in want], BF16_TOL)


@pytest.mark.parametrize('t', [1, 2, 161])
@pytest.mark.parametrize('b', [1, 17, 32, 33, 64])
@pytest.mark.parametrize('cell,i,h', [('gru', 256, 128), ('gru', 256, 256),
                                      ('gru', 64, 512), ('lstm', 512, 512),
                                      ('lstm', 64, 128)])
def test_bwd_kernels_across_tiles(dev, t, b, cell, i, h):
    """rnn_bwd.cu's gate product and sweep across their tile edges: one
    step (no exchange), two, 161 (the gate product's 64-row tiles hold 64 /
    B steps, so 161 ends a tile partway); batches of one row, partial and
    full 64-row sweep tiles; 8, 16 and 32 sweep CTAs per direction."""
    _bwd_matches(dev, cell, t, b, i, h)


@pytest.mark.parametrize('cell,b', [('gru', 65), ('gru', 300),
                                    ('lstm', 130)])
def test_bwd_kernels_walk_several_batch_tiles(dev, cell, b):
    """Batches of several 64-row tiles: the groups walk their tiles one
    after another, the barrier counters running on."""
    _bwd_matches(dev, cell, 37, b, 256, 256 if cell == 'gru' else 512)


@pytest.mark.parametrize('cell,kernel,fault', [('gru', 'sweep', 'carve'),
                                               ('lstm', 'sweep', 'stages'),
                                               ('gru', 'gates', 'carve'),
                                               ('lstm', 'gates', 'stages')])
def test_bwd_entries_refuse_a_plan_that_does_not_fit(dev, cell, kernel, fault,
                                                     monkeypatch):
    """The entries check the plan they are given: a carve that is not the
    kernel's own sum, or fewer ring stages than the kernel takes, is
    refused and the wrapper raises instead of launching a kernel that
    would hang or overrun its shared memory."""
    real = rnn_train.plan

    def faulty(*args):
        p = {k: dict(v) for k, v in real(*args).items()}
        if fault == 'carve':
            p[kernel]['smem'] += 128
        else:
            p[kernel]['stages'] = 1
        return p

    monkeypatch.setattr(rnn_train, 'plan', faulty)
    g = torch.Generator().manual_seed(2)
    args = _bwd_inputs(g, cell, 5, 3, 256, 256, dev)
    fn = rnn_train.gru_bwd if cell == 'gru' else rnn_train.lstm_bwd
    with pytest.raises(RuntimeError, match=f'rnn_train.{cell}_bwd '
                                           f'\\({kernel}\\)'):
        fn(*args)
    torch.cuda.synchronize()


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
@pytest.mark.parametrize('ragged', [False, True])
def test_trainable_rnn_on_card_matches_cpu(dev, cell, ragged):
    """``bidir_rnn_trainable`` (batch padding, flips, the cores' forward
    and backward kernels, the weight-gradient products) on the card
    against the CPU twins: output and every gradient."""
    from forwardtacotron_torch.models.layers import bidir_rnn_trainable
    g = torch.Generator().manual_seed(7)
    b, t, i, h = 5, 33, 256, 128
    n_gates = 4 if cell == 'lstm' else 3
    params = [torch.randn(s, generator=g).mul(sc).to(torch.bfloat16)
              for s, sc in (((2, i, n_gates * h), i ** -0.5),
                            ((2, h, n_gates * h), h ** -0.5),
                            ((2, n_gates * h), 0.1), ((2, n_gates * h), 0.1))]
    x = torch.randn(b, t, i, generator=g).to(torch.bfloat16)
    lens = torch.tensor([33, 4, 17, 1, 30]) if ragged else None
    w = torch.randn(b, t, 2 * h, generator=g)
    results = []
    for device in ('cpu', dev):
        leaves = [p.detach().to(device).requires_grad_()
                  for p in [x] + params]
        out = bidir_rnn_trainable(
            leaves[0], None if lens is None else lens.to(device),
            *leaves[1:], cell)
        (out.float() * w.to(device)).sum().backward()
        results.append([out.detach().float().cpu()]
                       + [v.grad.float().cpu() for v in leaves])
    torch.cuda.synchronize()
    _close(results[1], results[0], BF16_TOL)


def test_training_kernels_raise_on_unsupported_shapes(dev):
    """Shapes the training kernels cannot take raise instead of running the
    twins: a float32 input, a width that is not a multiple of 16, more
    sweep CTAs than the card has SMs (H = 1072; I = H = 1024, which the
    previous kernel refused, now launches), and length-regulator rows that
    are not whole, aligned 16-byte words."""
    g = torch.Generator().manual_seed(1)
    before = (dict(rnn.launches), dict(rnn_train.launches), lr.launches)
    dhs, hs, x2, wi, wh, bi, bh = _bwd_inputs(g, 'gru', 5, 3, 64, 128, dev)
    with pytest.raises(ValueError, match='bfloat16'):
        rnn_train.gru_bwd(dhs.float(), hs, x2, wi, wh, bi, bh)
    with pytest.raises(ValueError, match='bad shapes'):
        rnn_train.gru_bwd(dhs, hs, x2[..., :40].contiguous(),
                          wi[:, :40].contiguous(), wh, bi, bh)
    args = _bwd_inputs(g, 'lstm', 3, 2, 64, 1072, dev)   # 2 x 67 CTAs
    with pytest.raises(ValueError, match='rnn_train.plan'):
        rnn_train.lstm_bwd(*args)
    with pytest.raises(ValueError, match='int32'):
        lr.length_regulator_expand(_rand(g, (3, 4, 16), 1.0, dev),
                                   torch.ones(3, 4, dtype=torch.long,
                                              device=dev), 8)
    ends = torch.ones(3, 4, dtype=torch.int32, device=dev)
    for c, dtype in ((6, torch.float32), (5, torch.bfloat16)):
        with pytest.raises(ValueError, match='16-byte'):
            lr.length_regulator_expand(_rand(g, (3, 4, c), 1.0, dev, dtype),
                                       ends, 8)
    with pytest.raises(ValueError, match='16-byte'):     # misaligned rows
        lr.length_regulator_expand(_rand(g, (3 * 4 * 8 + 2,), 1.0, dev,
                                         torch.bfloat16)[2:].view(3, 4, 8),
                                   ends, 8)
    assert (dict(rnn.launches), dict(rnn_train.launches),
            lr.launches) == before


def _mrf_inputs(g, b, c, t, dev, dtype, krs=(3, 7, 11), units=3):
    x = _rand(g, (b, c, t), 1.0, dev, dtype)
    weights = []
    for kr in krs:
        for _ in range(2):
            weights += [_rand(g, (units, c, kr * c), (kr * c) ** -0.5, dev,
                              dtype),
                        _rand(g, (units, c, 1), 0.1, dev, dtype)]
    return x, tuple(weights)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,c,t', [(2, 64, 1000), (1, 32, 2113), (3, 16, 77),
                                   (1, 24, 300), (2, 64, 1), (2, 12, 500),
                                   (2, 128, 700), (1, 256, 333),
                                   (2, 8, 100), (1, 96, 257)])
def test_mrf_kernel_matches_twin(dev, dtype, b, c, t):
    """One MRF level (kr 3/7/11, d 1/3/5): ragged last tiles, a level
    shorter than one tile and its halo, C=24, 12, 8 and 96 padded to 32,
    16, 16 and 128 channels; C=128 and 256 in clusters of CTAs that share
    their channel slices, across tile boundaries."""
    g = torch.Generator().manual_seed(c + t)
    x, weights = _mrf_inputs(g, b, c, t, dev, dtype)
    before = mrf.launches
    got = mrf.mrf(x, weights, (3, 7, 11), (1, 3, 5))
    torch.cuda.synchronize()
    assert mrf.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    _close([got.float()],
           [mrf.mrf_plain(x, weights, (3, 7, 11), (1, 3, 5)).float()],
           TOL if dtype == torch.float32 else BF16_TOL)


def test_mrf_kernel_other_branches(dev):
    """Two branches of two units (kr 5/9, d 2/1), bf16 and f32; even kernel
    sizes (4/6, d 1/2) at one CTA per tile and in a cluster; eight kernel
    sizes of one unit each."""
    g = torch.Generator().manual_seed(7)
    for c, krs, dils in ((48, (5, 9), (2, 1)), (32, (4, 6), (1, 2)),
                         (128, (4, 6), (1, 2)),
                         (32, (2, 3, 4, 5, 6, 7, 3, 5), (1,))):
        for dtype in (torch.float32, torch.bfloat16):
            x, weights = _mrf_inputs(g, 2, c, 700, dev, dtype, krs=krs,
                                     units=len(dils))
            got = mrf.mrf(x, weights, krs, dils)
            torch.cuda.synchronize()
            _close([got.float()], [mrf.mrf_plain(x, weights, krs,
                                                 dils).float()],
                   TOL if dtype == torch.float32 else BF16_TOL)


LONG_LISTS = [(tuple(range(2, 12)), (1, 3, 5)),      # 10 kernel sizes
              ((3, 5), (1, 2) * 4 + (1,)),          # 9 dilations
              ((3,) * 12, (1,) * 9)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c', [32, 128])
def test_mrf_kernel_long_lists(dev, dtype, c):
    """More kernel sizes or dilations than v1's three, within the halo (10
    kernel sizes, 9 dilations, 12 by 9), at one CTA per tile and in a
    cluster of CTAs: one launch each, against the twin."""
    g = torch.Generator().manual_seed(c)
    for krs, dils in LONG_LISTS:
        x, weights = _mrf_inputs(g, 2, c, 500, dev, dtype, krs=krs,
                                 units=len(dils))
        before = mrf.launches
        got = mrf.mrf(x, weights, krs, dils)
        torch.cuda.synchronize()
        assert mrf.launches == before + 1
        _close([got.float()], [mrf.mrf_plain(x, weights, krs, dils).float()],
               TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize('c', [64, 256])
def test_mrf_kernel_fewest_ring_stages(dev, monkeypatch, c):
    """bf16 with the plan held to the fewest ring stages the kernel takes
    (2): the shared memory cut to the tile's buffers and two stages."""
    pl = mrf.plan(torch.bfloat16, c, (3, 7, 11), (1, 3, 5))
    slot = pl['cs'] * mrf.KC * 2
    monkeypatch.setattr(mrf, 'SMEM_BYTES',
                        pl['smem'] - (pl['stages'] - mrf.MIN_STAGES) * slot)
    low = mrf.plan(torch.bfloat16, c, (3, 7, 11), (1, 3, 5))
    assert (low['stages'], low['t_tile']) == (mrf.MIN_STAGES, pl['t_tile'])
    g = torch.Generator().manual_seed(c)
    x, weights = _mrf_inputs(g, 2, c, 600, dev, torch.bfloat16)
    got = mrf.mrf(x, weights, (3, 7, 11), (1, 3, 5))
    torch.cuda.synchronize()
    _close([got.float()],
           [mrf.mrf_plain(x, weights, (3, 7, 11), (1, 3, 5)).float()],
           BF16_TOL)


def test_mrf_kernel_raises_on_unsupported_shapes(dev):
    """C past the cap (512), more than 32 kernel sizes, a span past the
    halo, a float16 input: raised before any launch."""
    g = torch.Generator().manual_seed(3)
    before = mrf.launches
    x, weights = _mrf_inputs(g, 1, 512, 50, dev, torch.bfloat16, krs=(3,),
                             units=1)
    with pytest.raises(ValueError, match='C=512'):
        mrf.mrf(x, weights, (3,), (1,))
    x, weights = _mrf_inputs(g, 1, 32, 50, dev, torch.bfloat16,
                             krs=(3,) * 33, units=1)
    with pytest.raises(ValueError, match='at most 32'):
        mrf.mrf(x, weights, (3,) * 33, (1,))
    x, weights = _mrf_inputs(g, 1, 32, 50, dev, torch.bfloat16, krs=(13,))
    with pytest.raises(ValueError, match='halo'):
        mrf.mrf(x, weights, (13,), (1, 3, 5))
    x, weights = _mrf_inputs(g, 1, 32, 50, dev, torch.float16)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        mrf.mrf(x, weights, (3, 7, 11), (1, 3, 5))
    assert mrf.launches == before


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c,krs,n_units', [(32, (1,), 40), (128, (1, 1), 33)])
def test_mrf_kernel_one_tap_many_dilations(dev, dtype, c, krs, n_units):
    """A level of 1-tap convolutions (span 0) with more than 32 dilations,
    which the JAX gate sends to its Pallas kernel: one launch, against the
    twin, at one CTA per tile and in a cluster."""
    g = torch.Generator().manual_seed(n_units)
    dils = tuple(range(1, n_units + 1))
    x, weights = _mrf_inputs(g, 2, c, 400, dev, dtype, krs=krs,
                             units=n_units)
    before = mrf.launches
    got = mrf.mrf(x, weights, krs, dils)
    torch.cuda.synchronize()
    assert mrf.launches == before + 1
    _close([got.float()], [mrf.mrf_plain(x, weights, krs, dils).float()],
           TOL if dtype == torch.float32 else BF16_TOL)


def _ups_inputs(g, b, s_in, s_up, k, c_in, c, t_ps, dev, dtype):
    """A phase-stacked level's x, upsampler, bias (float32) and MRF weights
    (float32 biases) on the card."""
    x = _rand(g, (b, s_in * c_in, t_ps), 1.0, dev, dtype)
    up_w = _rand(g, (k, c, c_in), (k * c_in / s_up) ** -0.5, dev, dtype)
    up_b = _rand(g, (c,), 0.1, dev, torch.float32)
    weights = []
    for kr in (3, 7, 11):
        for _ in range(2):
            weights += [_rand(g, (3, c, kr * c), (kr * c) ** -0.5, dev, dtype),
                        _rand(g, (3, c, 1), 0.1, dev, torch.float32)]
    return x, up_w, up_b, tuple(weights)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,s_in,s_up,k,c_in,c,t_ps,t_valid', [
    (2, 1, 2, 4, 128, 64, 700, 700),    # HiFi-GAN v1 level 2
    (1, 2, 2, 4, 64, 32, 1031, 1031),   # v1 level 3
    (3, 1, 2, 4, 64, 32, 37, 30),       # shorter than a tile, padding lanes
    (2, 1, 4, 8, 32, 16, 300, 297),     # rate 4
    (1, 2, 2, 4, 24, 12, 200, 200),     # C_in 24, C 12: padded to 32, 16
    (2, 1, 3, 9, 64, 32, 301, 299),     # rate 3
    (1, 1, 2, 24, 64, 32, 257, 257),    # k_up 24
    (1, 1, 4, 32, 32, 16, 100, 100),    # k_up 32 at rate 4
    (2, 1, 2, 4, 256, 128, 300, 290),   # clusters of 2 (bf16)
    (1, 2, 2, 4, 512, 256, 70, 70)])    # clusters of 4 (bf16), 8 (f32)
def test_ups_mrf_kernel_matches_twin(dev, dtype, b, s_in, s_up, k, c_in, c,
                                     t_ps, t_valid):
    """One level of the phase-stacked tail (leaky, upsample, kr 3/7/11 and
    d 1/3/5 MRF): ragged last tiles and lanes past t_valid, rates 2, 3 and
    4, upsamplers of 4 to 32 taps, C up to 256."""
    g = torch.Generator().manual_seed(c_in + t_ps)
    args = (*_ups_inputs(g, b, s_in, s_up, k, c_in, c, t_ps, dev, dtype),
            s_in, s_up, (3, 7, 11), (1, 3, 5), t_valid)
    before = ups_mrf.launches
    got = ups_mrf.ups_mrf(*args)
    torch.cuda.synchronize()
    assert ups_mrf.launches == before + 1
    assert got.shape == (b, s_in * s_up * c, t_ps) and got.dtype == dtype
    want = ups_mrf.ups_mrf_plain(*args)
    assert not got[..., t_valid:].any()
    _close([got.float()], [want.float()],
           TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ups_mrf_kernel_long_lists(dev, dtype):
    """The tail's level (v1 level 3's shape, C 32, and a cluster at C 128)
    at LONG_LISTS: one launch each, against the twin."""
    g = torch.Generator().manual_seed(9)
    for (s_in, c_in, c, t_ps, t_valid), (krs, dils) in itertools.product(
            ((2, 64, 32, 301, 297), (1, 256, 128, 150, 150)), LONG_LISTS):
        x = _rand(g, (2, s_in * c_in, t_ps), 1.0, dev, dtype)
        up_w = _rand(g, (4, c, c_in), (2 * c_in) ** -0.5, dev, dtype)
        up_b = _rand(g, (c,), 0.1, dev, torch.float32)
        weights = []
        for kr in krs:
            for _ in range(2):
                weights += [_rand(g, (len(dils), c, kr * c), (kr * c) ** -0.5,
                                  dev, dtype),
                            _rand(g, (len(dils), c, 1), 0.1, dev,
                                  torch.float32)]
        args = (x, up_w, up_b, tuple(weights), s_in, 2, krs, dils, t_valid)
        before = ups_mrf.launches
        got = ups_mrf.ups_mrf(*args)
        torch.cuda.synchronize()
        assert ups_mrf.launches == before + 1
        _close([got.float()], [ups_mrf.ups_mrf_plain(*args).float()],
               TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,s_in,s_up,k,c_in,c,t_ps,t_valid', [
    (2, 1, 2, 34, 64, 32, 300, 297),    # 34 taps, reaching 9 input rows
    (1, 2, 2, 66, 64, 32, 301, 290),    # 66 taps, reaching 17
    (1, 1, 4, 36, 32, 16, 200, 200),    # 36 taps at rate 4
    (2, 1, 2, 4, 33, 16, 257, 250),     # C_in = 2 C + 1, padded to 64
    (1, 2, 2, 4, 65, 32, 300, 300)])    # C_in = 2 C + 1, padded to 128
def test_ups_mrf_kernel_wide_upsamplers_and_odd_inputs(
        dev, dtype, b, s_in, s_up, k, c_in, c, t_ps, t_valid):
    """Tail levels the JAX gate sends to its Pallas kernel past the old
    limits: upsamplers of more than 32 taps (the input tile's halo grows to
    the taps' reach) and C_in = 2 C + 1 (a generator whose channels are odd
    before a level): one launch, against the twin."""
    g = torch.Generator().manual_seed(k + c_in)
    args = (*_ups_inputs(g, b, s_in, s_up, k, c_in, c, t_ps, dev, dtype),
            s_in, s_up, (3, 7, 11), (1, 3, 5), t_valid)
    before = ups_mrf.launches
    got = ups_mrf.ups_mrf(*args)
    torch.cuda.synchronize()
    assert ups_mrf.launches == before + 1
    assert not got[..., t_valid:].any()
    _close([got.float()], [ups_mrf.ups_mrf_plain(*args).float()],
           TOL if dtype == torch.float32 else BF16_TOL)


def test_ups_mrf_kernel_raises_on_unsupported_shapes(dev):
    """Levels the kernel cannot take raise on the card: an upsampler with
    k - s odd, more than 1,024 input channels, a rate of 8, a float16
    input."""
    g = torch.Generator().manual_seed(4)
    before = ups_mrf.launches
    for (s_in, s_up, k, c_in, c), match in (
            ((1, 2, 5, 64, 32), 'kernel size 5'),
            ((1, 2, 4, 1088, 64), 'C_in'),
            ((1, 8, 16, 64, 32), 'rate')):
        args = _ups_inputs(g, 1, s_in, s_up, k, c_in, c, 40, dev,
                           torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            ups_mrf.ups_mrf(*args, s_in, s_up, (3, 7, 11), (1, 3, 5), 40)
    args = _ups_inputs(g, 1, 1, 2, 4, 64, 32, 40, dev, torch.float16)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        ups_mrf.ups_mrf(*args, 1, 2, (3, 7, 11), (1, 3, 5), 40)
    assert ups_mrf.launches == before


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_prepared_weights_launch_the_same(dev, dtype):
    """Weights prepared once (padded and, in bf16, packed into ring images:
    what the generator keeps) launch what preparing them per call launches,
    bit for bit, at padded channels (C 12 -> 16, C_in 24 -> 32); weights
    prepared for another plan raise before any launch."""
    krs, dils = (3, 7, 11), (1, 3, 5)
    g = torch.Generator().manual_seed(9)
    x, weights = _mrf_inputs(g, 2, 12, 300, dev, dtype)
    prep = mrf.prepare(weights, krs, dils)
    got = mrf.mrf(x, weights, krs, dils, prepared=prep)
    assert torch.equal(got, mrf.mrf(x, weights, krs, dils))
    x_up, *level = _ups_inputs(g, 2, 1, 2, 4, 24, 12, 200, dev, dtype)
    level = (*level, 1, 2, krs, dils)
    uprep = ups_mrf.prepare(*level)
    got = ups_mrf.ups_mrf(x_up, *level, 197, prepared=uprep)
    assert torch.equal(got, ups_mrf.ups_mrf(x_up, *level, 197))
    other = mrf.prepare(_mrf_inputs(g, 1, 64, 10, dev, dtype)[1], krs, dils)
    before = (mrf.launches, ups_mrf.launches)
    with pytest.raises(ValueError, match='prepared weights'):
        mrf.mrf(x, weights, krs, dils, prepared=other)
    with pytest.raises(ValueError, match='prepared weights'):
        ups_mrf.ups_mrf(x_up, *level, 197, prepared=other)
    assert (mrf.launches, ups_mrf.launches) == before
    torch.cuda.synchronize()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ups_tail_generator_on_card_matches_cpu(dev, dtype, monkeypatch):
    """A narrow generator whose last two levels take the tail on the card
    (two launches) against the same generator on the CPU, its device clause
    patched so that the tail's levels run the twin there."""
    import copy

    from forwardtacotron_torch.models import vocoder as vocoder_mod
    from forwardtacotron_torch.models.vocoder import HiFiGANGenerator

    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    torch.manual_seed(0)
    gen = HiFiGANGenerator(upsample_initial_channel=128, num_mels=20,
                           fuse_ups_tail_max_ch=16).eval().to(dtype)
    mel = torch.randn(2, 33, 20, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = gen(mel.to(dtype))
        before = ups_mrf.launches
        got = copy.deepcopy(gen).to(dev)(mel.to(dev, dtype))
        torch.cuda.synchronize()
    assert ups_mrf.launches == before + 2
    _close([got.float().cpu()], [want.float()],
           TOL if dtype == torch.float32 else BF16_TOL)


# --------------------------------------------- the CBHG variants' kernels

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,c,layers', [(77, 256, 4), (5, 128, 2),
                                        (33, 1024, 2), (19, 2048, 1)])
def test_highway_stack_kernel_matches_twin(dev, dtype, n, c, layers):
    """Rows not a multiple of the row tile, at widths the 32-row tile takes
    (128, 256) and at the 16- and 8-row tiles (1024, 2048)."""
    g = torch.Generator().manual_seed(n)
    args = [_rand(g, (n, c), 1.0, dev, dtype),
            _rand(g, (layers, c, 2 * c), c ** -0.5, dev, dtype),
            _rand(g, (layers, 2 * c), 0.1, dev, torch.float32)]
    before = highway.stack_launches
    got = highway.highway_stack(*args)
    torch.cuda.synchronize()
    assert highway.stack_launches == before + 1 and got.dtype == dtype
    _close([got.float()], [highway.highway_stack_plain(*args).float()],
           TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize('c_in,c', [(80, 1024), (256, 2048)])
def test_pre_highway_kernel_takes_wide_rows(dev, c_in, c):
    g = torch.Generator().manual_seed(c)
    args = [torch.randn(s, generator=g) * sc for s, sc in (
        ((21, c_in), 1.0), ((21, c_in), 1.0), ((c_in, c), c_in ** -0.5),
        ((2, c, 2 * c), c ** -0.5), ((2, 2 * c), 0.1))]
    args = [a.to(dev) for a in args]
    got = highway.pre_highway_stack(*args)
    torch.cuda.synchronize()
    _close([got], [highway.pre_highway_stack_plain(*args)])


def _pool_args(g, b, t, kc, dev, dtype):
    mask = torch.ones(b, t)
    mask[-1, t // 2:] = 0.0
    return _rand(g, (b, t, kc), 1.0, dev, dtype), mask.to(dev)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,t,kc', [(2, 70, 512), (3, 1, 64), (1, 33, 13),
                                    (4, 17, 2048)])
def test_pool_mask_kernel_matches_twin(dev, dtype, b, t, kc):
    """Exact, at a single frame and at a width (13) that takes the scalar
    path."""
    x, mask = _pool_args(torch.Generator().manual_seed(t), b, t, kc, dev,
                         dtype)
    before = cbhg.pool_mask_launches
    got = cbhg.pool_mask(x, mask)
    torch.cuda.synchronize()
    assert cbhg.pool_mask_launches == before + 1
    assert torch.equal(got, cbhg.pool_mask_plain(x, mask))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,t,kc,p', [(2, 70, 512, 256), (3, 9, 64, 12),
                                      (1, 300, 2048, 80), (2, 1, 32, 128),
                                      (1, 92, 4096, 256)])
def test_pool_proj1_kernel_matches_twin(dev, dtype, b, t, kc, p):
    """Frames not a multiple of the time tile, P padded to the column tile,
    one frame, and the f32 request's prenet shape (split over KC)."""
    g = torch.Generator().manual_seed(kc + t)
    x, mask = _pool_args(g, b, t, kc, dev, dtype)
    w = _rand(g, (3, kc, p), (3 * kc) ** -0.5, dev, dtype)
    before = cbhg.pool_proj1_launches
    got = cbhg.pool_proj1(x, mask, w)
    torch.cuda.synchronize()
    assert cbhg.pool_proj1_launches == before + 1 and got.shape == (b, t, p)
    _close([got.float()], [cbhg.pool_proj1_plain(x, mask, w).float()],
           TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize('t', [1, 81, 129, 512])
@pytest.mark.parametrize('kc,p', [(32, 80), (4096, 256), (4096, 300),
                                  (2048, 8)])
def test_pool_proj1_bf16_across_tiles(dev, t, kc, p):
    """The bf16 kernel's 128-frame tiles over the frames of all items (one
    gap frame after each): one frame per item, the prenet's 81, a tile
    edge inside an item, 512; P not a multiple of the column block (80 in
    a block of 96, 300 in two of 192), one block of 256, a narrow one; KC
    of one chunk and of 128; ragged tail masks."""
    g = torch.Generator().manual_seed(kc + t + p)
    b = 3 if t < 512 else 2
    x, mask = _pool_args(g, b, t, kc, dev, torch.bfloat16)
    mask[0, max(1, t - 5):] = 0.0
    w = _rand(g, (3, kc, p), (3 * kc) ** -0.5, dev, torch.bfloat16)
    before = cbhg.pool_proj1_launches
    got = cbhg.pool_proj1(x, mask, w)
    torch.cuda.synchronize()
    assert cbhg.pool_proj1_launches == before + 1
    _close([got.float()], [cbhg.pool_proj1_plain(x, mask, w).float()],
           BF16_TOL)


@pytest.mark.parametrize('fault', ['carve', 'stages', 'cols'])
def test_pool_proj1_entry_refuses_a_plan_that_does_not_fit(dev, fault,
                                                           monkeypatch):
    """The bf16 entry checks its plan: a carve that is not the kernel's
    sum, one ring stage, a column width it has no kernel for; the wrapper
    raises without counting a launch."""
    real = cbhg.pool_proj1_plan

    def faulty(*args, **kw):
        p = dict(real(*args, **kw))
        if fault == 'carve':
            p['smem'] += 128
        elif fault == 'stages':
            p['stages'] = 1
        else:
            p['n_cols'] = 80
        return p

    monkeypatch.setattr(cbhg, 'pool_proj1_plan', faulty)
    g = torch.Generator().manual_seed(4)
    x, mask = _pool_args(g, 2, 9, 64, dev, torch.bfloat16)
    w = _rand(g, (3, 64, 64), 0.1, dev, torch.bfloat16)
    before = cbhg.pool_proj1_launches
    with pytest.raises(RuntimeError, match='pool_proj1'):
        cbhg.pool_proj1(x, mask, w)
    assert cbhg.pool_proj1_launches == before


def test_variant_kernels_raise_on_unsupported_shapes(dev):
    """pool_proj1 with a bank concat that is not a multiple of 32 channels,
    highway_stack at a width that is not a multiple of 4, and a dtype the
    kernels do not take: ValueError before any launch."""
    g = torch.Generator().manual_seed(3)
    before = (cbhg.pool_proj1_launches, cbhg.pool_mask_launches,
              highway.stack_launches)
    x, mask = _pool_args(g, 1, 9, 48, dev, torch.float32)
    with pytest.raises(ValueError, match='multiple of 32'):
        cbhg.pool_proj1(x, mask, torch.zeros(3, 48, 8, device=dev))
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        cbhg.pool_mask(x.half(), mask)
    with pytest.raises(ValueError, match='multiple of 4'):
        highway.highway_stack(torch.zeros(3, 130, device=dev),
                              torch.zeros(1, 130, 260, device=dev),
                              torch.zeros(1, 260, device=dev))
    assert (cbhg.pool_proj1_launches, cbhg.pool_mask_launches,
            highway.stack_launches) == before


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('fields,counts', [
    (dict(fuse_pool_proj=True, fuse_front=False), (1, 0, 0)),
    (dict(fuse_pool=True, fuse_front=False), (0, 1, 0)),
    (dict(fuse_bank=True, fuse_pool=True, fuse_front=False), (0, 1, 0)),
    (dict(stream_pool_proj=True, fuse_front=False), (0, 0, 0))])
def test_cbhg_variants_on_card_match_cpu(dev, dtype, fields, counts):
    """A CBHG with each variant on the card (its launches counted) against
    the same module on the CPU, with ragged lengths; ``_highways_fused``
    the same."""
    import copy

    from forwardtacotron_torch.models.layers import CBHG

    torch.manual_seed(0)
    m = CBHG(4, 16, 128, [128, 16], 2, dropout=0.0, **fields).eval().to(dtype)
    x = torch.randn(3, 40, 16, generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([40, 23, 7])
    with torch.no_grad():
        want = m.pre_rnn(x.to(dtype), lengths)
        want_hw = m._highways_fused(want)
        card = copy.deepcopy(m).to(dev)
        before = (cbhg.pool_proj1_launches, cbhg.pool_mask_launches,
                  cbhg.launches, highway.stack_launches)
        got = card.pre_rnn(x.to(dev, dtype), lengths.to(dev))
        got_hw = card._highways_fused(got)
        torch.cuda.synchronize()
    after = (cbhg.pool_proj1_launches, cbhg.pool_mask_launches,
             cbhg.launches, highway.stack_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (*counts, 1)
    # bf16: cuDNN's and the CPU's bank convolutions round their sums
    # differently, and proj1, proj2 and the highways carry it on: the bf16
    # model tolerance of chip_smoke.py (E2E_BF16_TOL)
    tol = TOL if dtype == torch.float32 else 5e-2
    _close([got.float().cpu(), got_hw.float().cpu()],
           [want.float(), want_hw.float()], tol)


# ------------------------------- FastPitch, MelGAN, the channels-major tail

def _narrow_fast_pitch(dtype):
    from forwardtacotron_torch.models.fast_pitch import FastPitch
    torch.manual_seed(0)
    model = FastPitch(durpred_d_model=16, durpred_layers=1, durpred_d_fft=16,
                      pitch_d_model=16, pitch_layers=1, pitch_d_fft=16,
                      energy_d_model=16, energy_layers=1, energy_d_fft=16,
                      d_model=64, prenet_layers=2, prenet_fft=96,
                      postnet_layers=2, postnet_fft=96, n_mels=16).eval()
    with torch.no_grad():
        model.dur_pred.lin.weight.normal_(0.0, 0.3)
        model.dur_pred.lin.bias.fill_(2.2)
    return model


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fast_pitch_generate_on_card_matches_cpu(dev, dtype):
    """FastPitch through ``TTSInference.generate`` on the card (one ``lr``
    launch per decode, at C = d_model) against the CPU path; both compute
    the transformers in float32, with bf16 weights in bfloat16 (the bf16
    model tolerance of chip_smoke.py, 5e-2, covers TF32-free cuDNN sums in
    another order)."""
    import copy

    from forwardtacotron_torch.models.synthesis import TTSInference
    model = _narrow_fast_pitch(dtype)
    x = torch.randint(1, 60, (3, 17), generator=torch.Generator()
                      .manual_seed(2))
    x[1, 11:] = 0
    cpu = TTSInference(copy.deepcopy(model), dtype=dtype, device='cpu')
    card = TTSInference(copy.deepcopy(model), dtype=dtype, device=dev)
    want = cpu.generate(x)
    before = lr.launches
    got = card.generate(x)
    torch.cuda.synchronize()
    assert lr.launches == before + 1
    assert torch.equal(got['mel_len'].cpu(), want['mel_len'])
    tol = TOL if dtype == 'float32' else 5e-2
    _close([got[k].float().cpu() for k in ('mel', 'dur', 'pitch')],
           [want[k].float() for k in ('mel', 'dur', 'pitch')], tol)


def test_melgan_on_card_matches_cpu(dev):
    """A narrow MelGAN (float32) on the card against the CPU, and
    ``inference``'s tail pad and crop."""
    import copy

    from forwardtacotron_torch.models.vocoder import MelGANGenerator
    torch.manual_seed(0)
    gen = MelGANGenerator(mel_channels=16, base_channels=64).eval()
    mel = torch.randn(2, 21, 16, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = gen(mel), gen.inference(mel)
        card = copy.deepcopy(gen).to(dev)
        got = card(mel.to(dev)), card.inference(mel.to(dev))
        torch.cuda.synchronize()
    assert got[1].shape == (2, 21 * 256)
    _close([g.cpu() for g in got], want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cm_tail_generator_on_card_matches_per_conv(dev, dtype):
    """A narrow generator whose last two levels take the channels-major
    tail on the card (one ``mrf`` launch per tail level, none of
    ``ups_mrf``) against the same generator per convolution on the
    card."""
    import copy

    from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
    torch.manual_seed(0)
    gen = HiFiGANGenerator(upsample_initial_channel=128, num_mels=20,
                           fuse_tail_max_ch=16).eval().to(dev, dtype)
    plain = copy.deepcopy(gen)
    plain.fuse_tail_max_ch = 0
    mel = torch.randn(2, 33, 20, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = plain(mel.to(dev, dtype))
        before = (mrf.launches, ups_mrf.launches)
        got = gen(mel.to(dev, dtype))
        torch.cuda.synchronize()
    assert (mrf.launches - before[0], ups_mrf.launches - before[1]) == (2, 0)
    _close([got.float()], [want.float()],
           TOL if dtype == torch.float32 else BF16_TOL)


def test_cm_tail_gate_raises_before_any_launch(dev):
    """A tail with a level of 512 channels, which ``mrf.cu`` does not take:
    the forward raises before any launch."""
    from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
    gen = HiFiGANGenerator(upsample_initial_channel=1024, num_mels=8,
                           resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3, 5),),
                           fuse_tail_max_ch=512).eval().to(dev)
    before = (mrf.launches, ups_mrf.launches)
    with torch.no_grad(), pytest.raises(NotImplementedError, match='C=512'):
        gen(torch.zeros(1, 4, 8, device=dev))
    assert (mrf.launches, ups_mrf.launches) == before


# ---------------------------------------- the multispeaker models' shapes
#
# configs/multispeaker.yaml: the frame trunk's LSTM takes 2 x 256 + 256 =
# 768 inputs (row 6 at serving and requests, row 9 in training), the
# predictor GRUs run at H 128 and 256 from 256-wide convolutions (rows 7,
# 9, 10), and the length regulator copies rows of 768 (the trunk) and 512
# (MultiFastPitch's decode) channels (row 8).

@pytest.mark.parametrize('b,t', [(1, 65), (17, 1), (4096, 64)])
def test_lstm_mel_kernel_at_multispeaker_width(dev, b, t):
    """Row 6 at I 768, H 512, M 80; the plan is printed. At serving's 4096
    items the 184,320-byte weight slice leaves room for one ring: one
    consumer warpgroup, where I 512 takes 2."""
    g = torch.Generator().manual_seed(b + t)
    i, h, m = 768, 512, 80
    wi, wh, bi, bh = _rnn_weights(g, i, h, 4, dev)
    wm = _rand(g, (2, h, m), h ** -0.5, dev)
    x2 = _rand(g, (t, 2, b, i), 1.0, dev)
    plan = rnn.plan('lstm_mel', b, t, i, h, m, *rnn.device_limits(x2.device))
    print(f'plan lstm_mel B={b} T={t} I={i}: {plan}')
    if b == 4096:
        assert plan['warpgroups'] == 1
        assert rnn.plan('lstm_mel', b, t, 512, h, m, *rnn.device_limits(
            x2.device))['warpgroups'] == 2
    before = rnn.launches['lstm_mel']
    got = rnn.lstm_mel(x2, wi, wh, bi + bh, wm)
    torch.cuda.synchronize()
    assert rnn.launches['lstm_mel'] == before + 1
    _close([got.float()],
           [rnn.lstm_mel_plain(x2, wi, wh, bi + bh, wm).float()], BF16_TOL)


@pytest.mark.parametrize('b,t', [(1, 81), (17, 9), (4096, 81)])
@pytest.mark.parametrize('h', [128, 256])
def test_predictor_gru_kernel_at_multispeaker_width(dev, b, t, h):
    """Row 7 at the predictor GRUs' shapes: I 256, H 128 (duration, pitch
    condition) and 256 (pitch), up to serving's 4096 x 81 tokens."""
    g = torch.Generator().manual_seed(b + t + h)
    wi, wh, bi, bh = _rnn_weights(g, 256, h, 3, dev)
    x2 = _rand(g, (t, 2, b, 256), 1.0, dev)
    before = dict(rnn.launches)
    got = rnn.gru(x2, wi, wh, bi, bh)
    torch.cuda.synchronize()
    assert rnn.launches == {**before, 'gru': before['gru'] + 1}
    _close([got.float()], [rnn.gru_plain(x2, wi, wh, bi, bh).float()],
           BF16_TOL)


@pytest.mark.parametrize('b,n,t,c,dtype', [
    (1, 92, 896, 768, torch.float32),       # a multispeaker f32 request
    (32, 160, 928, 768, torch.bfloat16),    # the multispeaker bf16 step
    (32, 160, 1024, 768, torch.float32),
    (4096, 81, 256, 512, torch.float32),    # MultiFastPitch serving
    (1, 92, 896, 512, torch.float32)])
def test_lr_tile_kernel_at_multispeaker_widths(dev, b, n, t, c, dtype):
    """Row 8 at C 768 and 512: one launch, exact."""
    g = torch.Generator().manual_seed(b + n + t + c)
    reps = torch.randint(2, 10, (b, n), generator=g)
    ends = torch.cumsum(reps, dim=1).to(dev, torch.int32)
    x = _rand(g, (b, n, c), 1.0, dev, dtype)
    before = lr.launches
    got = lr.length_regulator_expand(x, ends, t)
    torch.cuda.synchronize()
    assert lr.launches == before + 1
    assert torch.equal(got, lr.length_regulator_plain(x, ends, t))


@pytest.mark.parametrize('b,t', [(32, 928), (3, 65)])
def test_lstm_train_and_bwd_at_multispeaker_width(dev, b, t):
    """Rows 9 and 10's LSTM at I 768, H 512: the forward with cells and the
    backward sweep (its two launches)."""
    g = torch.Generator().manual_seed(b + t)
    i, h = 768, 512
    wi, wh, bi, bh = _rnn_weights(g, i, h, 4, dev)
    x2 = _rand(g, (t, 2, b, i), 1.0, dev)
    before = rnn.launches['lstm_train']
    hs, cs = rnn.lstm_train(x2, wi, wh, bi + bh)
    torch.cuda.synchronize()
    assert rnn.launches['lstm_train'] == before + 1
    want = rnn.lstm_train_plain(x2, wi, wh, bi + bh)
    _close([hs.float(), cs.float()], [w.float() for w in want], BF16_TOL)
    _bwd_matches(dev, 'lstm', t, b, i, h)


@pytest.mark.parametrize('b,t', [(32, 160), (3, 65)])
@pytest.mark.parametrize('h', [128, 256])
def test_gru_train_and_bwd_at_multispeaker_width(dev, b, t, h):
    """Rows 9 and 10's predictor GRUs at I 256, H 128 and 256."""
    g = torch.Generator().manual_seed(b + t + h)
    wi, wh, bi, bh = _rnn_weights(g, 256, h, 3, dev)
    x2 = _rand(g, (t, 2, b, 256), 1.0, dev)
    got = rnn.gru(x2, wi, wh, bi, bh)
    _close([got.float()], [rnn.gru_plain(x2, wi, wh, bi, bh).float()],
           BF16_TOL)
    _bwd_matches(dev, 'gru', t, b, 256, h)


def _narrow_multi(family, dtype):
    """A narrow multispeaker model whose bf16 decode takes rows 5-7: trunk
    input 2 x 64 + 128 = 256, predictor GRUs of 128."""
    from forwardtacotron_torch.models.multi_fast_pitch import MultiFastPitch
    from forwardtacotron_torch.models.multi_forward_tacotron import \
        MultiForwardTacotron
    torch.manual_seed(0)
    if family == 'multi_forward_tacotron':
        model = MultiForwardTacotron(
            speaker_emb_dims=128, embed_dims=64, series_embed_dims=16,
            durpred_conv_dims=32, durpred_rnn_dims=128, pitch_conv_dims=32,
            pitch_rnn_dims=128, pitch_cond_conv_dims=32,
            pitch_cond_rnn_dims=128, energy_conv_dims=32, energy_rnn_dims=64,
            rnn_dims=128, prenet_dims=64, prenet_k=4, postnet_dims=128,
            postnet_k=4, n_mels=16)
    else:
        model = MultiFastPitch(
            speaker_emb_dims=32, durpred_d_model=16, durpred_layers=1,
            durpred_d_fft=16, pitch_d_model=16, pitch_layers=1,
            pitch_d_fft=16, energy_d_model=16, energy_layers=1,
            energy_d_fft=16, pitch_cond_d_model=16, pitch_cond_layers=1,
            pitch_cond_d_fft=16, d_model=64, prenet_layers=2, prenet_fft=96,
            postnet_layers=2, postnet_fft=96, n_mels=16)
    with torch.no_grad():
        # in bfloat16 every token lasts 3 frames, so that no duration lies
        # near a rounding point (card and CPU sum in other orders); in
        # float32 the durations vary, so requests route to several groups
        std = 4.0 if family == 'multi_forward_tacotron' else 0.3
        model.dur_pred.lin.weight.normal_(
            0.0, std if dtype == 'float32' else 0.0)
        model.dur_pred.lin.bias.fill_(3.0)
    return model.eval()


@pytest.mark.parametrize('family', ['multi_forward_tacotron',
                                    'multi_fast_pitch'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_multispeaker_generate_on_card_matches_cpu(dev, family, dtype):
    """``generate_fused`` and ``generate_routed`` with a speaker per item on
    the card against the CPU path, with the launches of one call: in bf16
    MultiForwardTacotron takes row 7 for its three 128-wide predictor GRUs
    and the postnet GRU (the prenet's, 64 wide, and energy's stay loops),
    rows 5 + 6 for the trunk; in float32 its trunk and MultiFastPitch's
    decode take row 8."""
    import copy

    import numpy as np

    from forwardtacotron_torch.models.synthesis import TTSInference
    model = _narrow_multi(family, dtype)
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(1, 60, (3, 17), generator=gen)
    x[1, 11:] = 0
    semb = torch.rand(3, model.speaker_emb_dims, generator=gen)
    cpu = TTSInference(copy.deepcopy(model), dtype=dtype, device='cpu')
    card = TTSInference(copy.deepcopy(model), dtype=dtype, device=dev)
    tol = TOL if dtype == 'float32' else 5e-2
    want = cpu.generate_fused(x, 64, speaker_emb=semb)
    before = (dict(rnn.launches), lr.launches, lr_bidir.launches)
    got = card.generate_fused(x, 64, speaker_emb=semb)
    torch.cuda.synchronize()
    fused = family == 'multi_forward_tacotron' and dtype == 'bfloat16'
    assert rnn.launches['gru'] - before[0]['gru'] == (4 if fused else 0)
    assert rnn.launches['lstm_mel'] - before[0]['lstm_mel'] == int(fused)
    assert lr_bidir.launches - before[2] == int(fused)
    assert lr.launches - before[1] == (0 if fused else 1)
    _close([got[k].float().cpu() for k in ('mel', 'mel_post', 'dur')],
           [want[k].float() for k in ('mel', 'mel_post', 'dur')], tol)
    assert torch.equal(got['pitch_cond'].cpu(), want['pitch_cond'])
    want = cpu.generate_routed(x, speaker_emb=semb, frame_bucket=16)
    got = card.generate_routed(x, speaker_emb=semb, frame_bucket=16)
    groups = len(np.unique((want['mel_len'].numpy() + 15) // 16))
    assert groups > 1 or dtype == 'bfloat16'
    assert torch.equal(got['mel_len'].cpu(), want['mel_len'])
    _close([got['mel_post'].float().cpu()], [want['mel_post'].float()], tol)


# ------------------------------------------------------------- the teacher

def _narrow_teacher():
    """A narrow Tacotron teacher (its encoder CBHG 128 wide, as every
    teacher's; a 128-wide postnet, so both CBHGs take rows 1 and 2) with
    random BatchNorm statistics."""
    from forwardtacotron_torch.models.tacotron import Tacotron
    torch.manual_seed(0)
    model = Tacotron(embed_dims=32, encoder_dims=128, decoder_dims=64,
                     lstm_dims=64, postnet_dims=128, encoder_k=8,
                     postnet_k=4, num_highways=2, n_mels=16,
                     speaker_emb_dim=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith('running_var'):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return model.eval()


def _teacher_batch():
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(1, 60, (3, 23), generator=gen)
    x[1, 17:] = 0
    x[2, 9:] = 0
    return ({'x': x, 'mel': torch.randn(3, 40, 16, generator=gen) - 5.0},
            torch.tensor([23, 17, 9]))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_teacher_eval_and_generate_on_card_match_cpu(dev, dtype):
    """The teacher-forced eval forward (ragged tokens) and ``generate`` on
    the card against the CPU path: 2 ``pre_highway_stack`` and 2
    ``cbhg_front`` launches each, no recurrent kernel, whatever
    ``rnn_mode`` is set."""
    import copy

    model = _narrow_teacher().to(dtype)
    batch, lens = _teacher_batch()
    batch['mel'] = batch['mel'].to(dtype)
    card = copy.deepcopy(model).to(dev)
    tol = TOL if dtype == torch.float32 else 5e-2
    with torch.no_grad(), rnn_train.rnn_mode('on'):
        want = model(batch, r=2, x_lens=lens)
        want_gen = model.generate(batch['x'], steps=48, chunk=16)
        before = (highway.launches, cbhg.launches, dict(rnn.launches))
        got = card({k: v.to(dev) for k, v in batch.items()}, r=2,
                   x_lens=lens.to(dev))
        got_gen = card.generate(batch['x'].to(dev), steps=48, chunk=16)
        torch.cuda.synchronize()
    assert (highway.launches - before[0], cbhg.launches - before[1]) == (4, 4)
    assert rnn.launches == before[2]
    _close([g.float().cpu() for g in got], [w.float() for w in want], tol)
    _close([g.float().cpu() for g in got_gen[:3]],
           [w.float() for w in want_gen[:3]], tol)
    assert torch.equal(got_gen[3].cpu(), want_gen[3])


@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
def test_teacher_train_step_on_card_matches_cpu(dev, precision, tmp_path):
    """One TacoTrainer step on the card against the CPU (dropout and
    zoneout off): loss and global gradient norm within 1e-3 (float32) and
    5e-2 (bf16) relative; no kernel launches."""
    import copy

    from forwardtacotron_torch.models.tacotron import PreNet
    from forwardtacotron_torch.train.state import create_train_state
    from forwardtacotron_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_torch.utils.paths import Paths

    model = _narrow_teacher()
    for m in model.modules():
        if isinstance(m, PreNet):
            m.dropout = 0.0
        elif isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    model.decoder.zoneout = 0.0
    config = {'tacotron': {'training': {'schedule': ['2, 1e-3, 1, 3'],
                                        'precision': precision}}}
    paths = Paths(tmp_path / 'data', 'teacher', tmp_path / 'ckpt')
    batch, _ = _teacher_batch()
    got = {}
    before = (highway.launches, cbhg.launches, dict(rnn.launches),
              dict(rnn_train.launches))
    for device in ('cpu', dev):
        trainer = TacoTrainer(paths, None, config, device=device)
        state = create_train_state(copy.deepcopy(model).to(device),
                                   trainer.tx)
        m, attn = trainer.train_step(
            state, {k: v.to(device) for k, v in batch.items()}, 2)
        got[str(device)] = [float(m['loss']), float(m['grad_norm'])]
    torch.cuda.synchronize()
    assert (highway.launches, cbhg.launches, dict(rnn.launches),
            dict(rnn_train.launches)) == before
    tol = 1e-3 if precision == 'float32' else 5e-2
    for g, c in zip(got[str(dev)], got['cpu']):
        assert abs(g - c) <= tol * abs(c)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('entry', ['encoder', 'postnet'])
def test_rows_1_2_at_teacher_shapes(dev, dtype, entry):
    """Rows 1 and 2 at the full-width teacher's CBHGs (encoder: K 16, C_in
    128, C 128, P 128; postnet: K 8, C_in 80, C 128, P 256), ragged items,
    against their twins."""
    from forwardtacotron_torch.models.tacotron import Tacotron
    from forwardtacotron_torch.utils.files import read_config

    torch.manual_seed(0)
    config = read_config('configs/singlespeaker.yaml')
    model = Tacotron.from_config(config).eval().to(dev, dtype)
    mod = model.encoder.cbhg if entry == 'encoder' else model.postnet
    c_in = mod.conv1d_bank[0].conv.in_channels
    gen = torch.Generator().manual_seed(3)
    b, t = 3, 181
    mask = torch.ones(b, t)
    mask[1, 120:] = 0.0
    mask[2, 7:] = 0.0
    x = (torch.randn(b, t, c_in, generator=gen) * mask[:, :, None]).to(
        dev, dtype)
    mask = mask.to(dev)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    with torch.no_grad():
        args = mod.front_args(x, mask)
        got = cbhg.bank_pool_proj(*args)
        torch.cuda.synchronize()
        _close([got.float()], [cbhg.bank_pool_proj_plain(*args).float()],
               tol)
        a = torch.randn(b * t, c_in, generator=gen).to(dev, dtype)
        args = mod.highway_args(a, torch.randn(b * t, c_in, generator=gen)
                                .to(dev, dtype))
        got = highway.pre_highway_stack(*args)
        torch.cuda.synchronize()
        _close([got.float()],
               [highway.pre_highway_stack_plain(*args).float()], tol)


@pytest.mark.parametrize('entry,b,t', [('encoder', 32, 180),
                                       ('postnet', 32, 1000)])
def test_rows_1_2_at_extraction_batch(dev, entry, b, t):
    """Rows 1 and 2 at one attention-extraction batch of 32 (the encoder's
    tokens of equal length, the postnet's frames ragged), float32."""
    from forwardtacotron_torch.models.tacotron import Tacotron
    from forwardtacotron_torch.utils.files import read_config

    torch.manual_seed(0)
    model = Tacotron.from_config(read_config('configs/singlespeaker.yaml'))
    mod = (model.encoder.cbhg if entry == 'encoder'
           else model.postnet).eval().to(dev)
    c_in = mod.conv1d_bank[0].conv.in_channels
    gen = torch.Generator().manual_seed(4)
    mask = torch.ones(b, t)
    if entry == 'postnet':
        for i in range(b):
            mask[i, t - 17 * i:] = 0.0
    x = (torch.randn(b, t, c_in, generator=gen) * mask[:, :, None]).to(dev)
    with torch.no_grad():
        args = mod.front_args(x, mask.to(dev))
        _close([cbhg.bank_pool_proj(*args)],
               [cbhg.bank_pool_proj_plain(*args)])
        args = mod.highway_args(
            torch.randn(b * t, c_in, generator=gen).to(dev),
            torch.randn(b * t, c_in, generator=gen).to(dev))
        _close([highway.pre_highway_stack(*args)],
               [highway.pre_highway_stack_plain(*args)])


# ------------------------------------------------------- the data pipeline

def _write_extraction_items(paths, n_mels=16):
    """6 items in two token-length bins, random mels."""
    import pickle

    import numpy as np

    from forwardtacotron_torch.text.symbols import phonemes

    rs = np.random.RandomState(0)
    text_dict, items = {}, []
    for i in range(6):
        n_tok = (7, 12)[i % 2]
        mel_len = 3 * n_tok + i
        item_id = f'item{i}'
        text_dict[item_id] = ''.join(rs.choice(phonemes[12:60], n_tok))
        np.save(paths.mel / f'{item_id}.npy',
                (rs.randn(n_mels, mel_len) - 5).astype(np.float32))
        np.save(paths.speaker_emb / f'{item_id}.npy',
                np.zeros(256, np.float32))
        items.append((item_id, mel_len))
    for path, obj in ((paths.text_dict, text_dict),
                      (paths.speaker_dict, {i: 's' for i, _ in items}),
                      (paths.train_dataset, items[:4]),
                      (paths.val_dataset, items[4:])):
        path.write_bytes(pickle.dumps(obj))
    return items


def test_extract_attentions_on_card_matches_cpu(dev, tmp_path):
    """``extract_attentions`` with the PreNet's dropout off: the card's
    ``att_pred`` within 1e-4 of the CPU's, 2 ``pre_highway_stack`` and 2
    ``cbhg_front`` launches a batch (4 batches: 3 items of each token
    length in batches of at most 2)."""
    import numpy as np

    from forwardtacotron_torch.duration.extractor import DurationExtractor
    from forwardtacotron_torch.duration.pipeline import \
        DurationExtractionPipeline
    from forwardtacotron_torch.utils.paths import Paths

    model = _narrow_teacher()
    model.decoder.prenet.dropout = 0.0
    att = {}
    for device in ('cpu', dev):
        paths = Paths(tmp_path / str(device), 't', tmp_path / 'ckpt')
        items = _write_extraction_items(paths)
        before = (highway.launches, cbhg.launches)
        score = DurationExtractionPipeline(
            paths, {}, DurationExtractor(-11.0, 0.25)).extract_attentions(
                model, max_batch_size=2, device=device)
        att[str(device)] = (score, {i: np.load(paths.att_pred / f'{i}.npy')
                                    for i, _ in items})
        if device == dev:
            assert (highway.launches - before[0],
                    cbhg.launches - before[1]) == (8, 8)
    (s_cpu, a_cpu), (s_dev, a_dev) = att['cpu'], att[str(dev)]
    assert abs(s_cpu - s_dev) <= 1e-4
    for k, v in a_cpu.items():
        assert np.abs(a_dev[k] - v).max() <= 1e-4


def test_speaker_encoder_and_mel_on_card_match_cpu(dev, tmp_path):
    """The VoiceEncoder's embedding (seeded weights) and a preprocessed
    mel on the card against the CPU: 1e-4."""
    import numpy as np

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.speaker_encoder import (
        VoiceEncoder, init_voice_encoder_params)
    from forwardtacotron_torch.utils.files import read_config

    rs = np.random.RandomState(0)
    t = np.arange(3 * 22050) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 150 * t)
           + 0.02 * rs.randn(len(t))).astype(np.float32)
    params = init_voice_encoder_params(5)
    embs = [VoiceEncoder(params, device=d).embed_utterance(wav, 22050)
            for d in ('cpu', dev)]
    assert np.abs(embs[0] - embs[1]).max() <= 1e-4
    config = read_config('configs/singlespeaker.yaml')
    mels = [DSP.from_config(config, device=d).wav_to_mel(wav)
            for d in ('cpu', dev)]
    assert mels[1].shape == (80, 1 + len(wav) // 256)
    assert np.linalg.norm(mels[1] - mels[0]) <= 1e-4 * np.linalg.norm(
        mels[0])


# ------------------------------------------------------ data parallelism


def _dp_mesh():
    """Every card, or the one card twice (replicas that share it)."""
    from forwardtacotron_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    return make_mesh(devices=[f'cuda:{i}' for i in range(n)] if n > 1
                     else ['cuda:0', 'cuda:0'])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_data_parallel_serving_split_on_card(dev, dtype):
    """TTSInference over the mesh against one replica: a 7-row batch
    (padded to a multiple of the replicas), ``generate`` and
    ``generate_fused``; every replica launches one replica's recurrent
    kernels (bf16: rows 4-7), mel_len exact, mel_post within the kernels'
    tolerance of the scale (the shares are other batch sizes, so a plan or
    a product may sum in another order)."""
    import copy

    from forwardtacotron_torch.models.forward_tacotron import \
        ForwardTacotron
    from forwardtacotron_torch.models.synthesis import TTSInference

    torch.manual_seed(0)
    model = ForwardTacotron(
        embed_dims=128, series_embed_dims=16, durpred_conv_dims=32,
        durpred_rnn_dims=32, pitch_conv_dims=32, pitch_rnn_dims=64,
        energy_conv_dims=32, energy_rnn_dims=32, rnn_dims=128,
        prenet_dims=128, prenet_k=4, prenet_num_highways=2, postnet_dims=128,
        postnet_k=4, postnet_num_highways=2, n_mels=16).eval()
    with torch.no_grad():
        model.dur_pred.lin.weight.zero_()
        model.dur_pred.lin.bias.fill_(3.0)
    mesh = _dp_mesh()
    one = TTSInference(copy.deepcopy(model), dtype=dtype, device='cuda')
    dp = TTSInference(copy.deepcopy(model), dtype=dtype, mesh=mesh)
    g = torch.Generator().manual_seed(7)
    x = torch.randint(1, 60, (7, 20), generator=g)
    for i in range(7):
        x[i, 20 - 2 * i:] = 0
    tol = BF16_TOL if dtype == 'bfloat16' else TOL
    for entry, kwargs in (('generate', {}),
                          ('generate_fused', {'max_len': 64})):
        before = dict(rnn.launches)
        want = getattr(one, entry)(x, **kwargs)
        torch.cuda.synchronize()
        per_call = {k: rnn.launches[k] - before[k] for k in before}
        before = dict(rnn.launches)
        got = getattr(dp, entry)(x, **kwargs)
        torch.cuda.synchronize()
        assert {k: rnn.launches[k] - before[k] for k in before} == {
            k: len(mesh) * v for k, v in per_call.items()}
        if dtype == 'bfloat16':
            assert per_call['gru_xp' if entry == 'generate_fused'
                            else 'gru'] > 0
        assert got['mel_post'].device == torch.device('cuda', 0)
        assert torch.equal(got['mel_len'], want['mel_len'])
        assert got['mel_post'].shape == want['mel_post'].shape == (
            7, got['mel_post'].shape[1], 16)
        _close([got['mel_post'].float()], [want['mel_post'].float()], tol)


def test_data_parallel_two_gloo_ranks_on_one_card(dev, tmp_path):
    """Two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card)
    take a bf16 ForwardTrainer step, each on its own rows at its own
    padded shape, against one process on the global batch on the card:
    every rank ends with the same parameters, the loss and gradient norm
    within 5e-2, the updates a tenth of the learning rate on average, the
    trainable recurrences (rows 9-10) launched in each rank."""
    from torch_parallel_worker import (launch, make_items, rank_batches,
                                       train_steps)
    from torch_training_setup import N_MELS, narrow_config

    from forwardtacotron_torch.models.registry import init_tts_model

    config = narrow_config('bfloat16', tmp_path)
    torch.manual_seed(0)
    batches, global_batch = rank_batches(make_items(8, 1, N_MELS), 2)
    job = {'trainer': 'forward', 'config': config, 'backend': 'cpu',
           'device': 'cuda:0', 'batches': batches,
           'state_dict': init_tts_model(config).state_dict()}
    ranks = launch(job, tmp_path, timeout=300)
    for key, value in ranks[0]['state'].items():
        assert torch.equal(ranks[1]['state'][key], value), key
    for res in ranks:
        assert res['launches']['lstm_train'] == 1
        assert res['launches']['gru_bwd'] > 0 and res['launches']['lstm_bwd']
    (want,), state, _, _ = train_steps(job, global_batch, 'cuda:0')
    got = ranks[0]['metrics']
    for key in ('loss', 'grad_norm'):
        assert abs(got[key] - want[key]) <= 5e-2 * abs(want[key]), key
    diffs = [(ranks[0]['state'][k].float() - v.float()).abs().flatten()
             for k, v in state.items() if v.is_floating_point()
             and not k.endswith(('running_mean', 'running_var', 'step'))]
    assert float(torch.cat(diffs).mean()) <= 0.1 * 1e-3


def test_data_parallel_kernel_keeps_callers_device(dev):
    """One host thread serving two cards: a kernel launched on cuda:0
    while cuda:1 is current runs on cuda:0 and leaves cuda:1 current (each
    extern "C" entry's DeviceGuard). Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two cards')
    g = torch.Generator().manual_seed(3)
    h = 256
    _, wh, _, bh = _rnn_weights(g, 16, h, 3, dev)
    xp2 = _rand(g, (9, 2, 3, 3 * h), 1.0, dev)
    args = [torch.randn(s, generator=g).to('cuda:0') for s in
            ((33, 80), (33, 80), (80, 128), (4, 128, 256), (4, 256))]
    with torch.cuda.device(1):
        assert torch.cuda.current_device() == 1
        got_rnn = rnn.gru_xp(xp2, wh, bh)
        assert torch.cuda.current_device() == 1
        got_hw = highway.pre_highway_stack(*args)
        assert torch.cuda.current_device() == 1
        after = torch.zeros(1, device='cuda')
    assert after.device == torch.device('cuda', 1)
    torch.cuda.synchronize(0)
    assert got_rnn.device == torch.device('cuda', 0)
    _close([got_rnn.float()], [rnn.gru_xp_plain(xp2, wh, bh).float()],
           BF16_TOL)
    _close([got_hw], [highway.pre_highway_stack_plain(*args)])


def _entry_setup(tmp_path):
    """The narrow ForwardTacotron of tests/torch_training_setup.py with
    seeded weights (dropout and pitch zoneout on) and its synthetic
    dataset: 6 training and 2 validation items."""
    from torch_training_setup import narrow_config, write_dataset

    from forwardtacotron_torch.models.registry import init_tts_model

    config = narrow_config('float32', tmp_path)
    section = config['forward_tacotron']
    section['training']['filter']['filter_duration_stats'] = False
    section['training']['pitch_zoneout'] = 0.2
    for key in section['model']:
        if key.endswith('_dropout'):
            section['model'][key] = 0.3
    paths = write_dataset(config)
    torch.manual_seed(0)
    return config, paths, init_tts_model(config)


def test_export_gta_launches_on_card(dev, tmp_path):
    """``export_gta`` on the card (one training and one validation batch
    of 8): per batch a ``pre_highway_stack`` launch for each CBHG, a
    ``cbhg_front`` launch for each whose front the JAX gate fuses (at
    these widths both CBHGs'; at full width the postnet's alone) and one
    ``lr``, nothing else; every file within 1e-4 of the CPU export's
    scale."""
    import copy

    import numpy as np

    from forwardtacotron_torch.models.layers import CBHG
    from forwardtacotron_torch.train_forward import export_gta

    config, paths, model = _entry_setup(tmp_path)
    cpu_model = copy.deepcopy(model)
    cbhgs = [m for m in model.modules() if isinstance(m, CBHG)]
    before = (highway.launches, cbhg.launches, lr.launches,
              griffin_lim.launches, dict(rnn.launches))
    assert export_gta(model, paths, config, dev) == 8
    torch.cuda.synchronize()
    assert (highway.launches, cbhg.launches, lr.launches,
            griffin_lim.launches, dict(rnn.launches)) == (
        before[0] + 2 * sum(m.highways_fusable for m in cbhgs),
        before[1] + 2 * sum(m.front_fusable for m in cbhgs),
        before[2] + 2, before[3], before[4])
    card = {p.stem: np.load(p) for p in paths.gta.glob('*.npy')}
    export_gta(cpu_model, paths, config, 'cpu')
    for item_id, got in card.items():
        want = np.load(paths.gta / f'{item_id}.npy')
        assert got.shape == want.shape
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= TOL * scale, item_id


def test_plots_leave_training_alone_on_card(dev, tmp_path, monkeypatch):
    """3 steps on the card with a plot after each against 3 without
    (dropout and zoneout on; cuDNN's deterministic algorithms, so that two
    runs can be bit-equal at all): parameters, BatchNorm statistics and
    optimizer state bit-equal; every plot made."""
    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.train import forward_trainer
    from forwardtacotron_torch.train.common import TTSSession
    from forwardtacotron_torch.train.state import create_train_state

    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    config, paths, _ = _entry_setup(tmp_path)
    section = config['forward_tacotron']['training']
    plotted = []
    real = forward_trainer.write_plots
    monkeypatch.setattr(forward_trainer, 'write_plots',
                        lambda *a: plotted.append(a[2]) or real(*a))
    dsp = DSP.from_config(config, device=dev)
    runs = {}
    for plot_every in (10 ** 9, 1):
        section['plot_every'] = plot_every
        torch.manual_seed(0)
        model = init_tts_model(config).to(dev)
        trainer = forward_trainer.ForwardTrainer(paths, dsp, config,
                                                 device=dev)
        state = create_train_state(model, trainer.tx)
        session = TTSSession(1, 1, 1e-3, 3, 3, *get_forward_dataloaders(
            paths, 3, seed=0, **section['filter']))
        trainer.train_session(state, session, seed=0)
        runs[plot_every] = (state, {k: v.detach().cpu() for k, v in
                                    model.state_dict().items()})
    assert plotted == [1, 2, 3]
    (s0, sd0), (s1, sd1) = runs[10 ** 9], runs[1]
    assert s0.step == s1.step == 3 and sorted(sd0) == sorted(sd1)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for name in ('mu', 'nu'):
        for k, v in s0.opt_state[name].items():
            assert torch.equal(v, s1.opt_state[name][k]), (name, k)


def test_chip_spec_names_the_card(dev):
    """The card is an H100 SXM, and chip_smoke.py's peaks are its spec's."""
    import chip_smoke
    from forwardtacotron_torch.utils.flops import chip_spec

    spec = chip_spec(dev)
    assert spec.name == 'h100'
    assert (spec.flops_f32, spec.flops_tf32, spec.flops_bf16,
            spec.hbm_gbps) == (chip_smoke.PEAK_F32_FLOPS,
                               chip_smoke.PEAK_TF32_FLOPS,
                               chip_smoke.PEAK_BF16_FLOPS,
                               chip_smoke.PEAK_BYTES) == (67e12, 495e12,
                                                          989e12, 3.35e12)
