"""The plain twins of the port's three Hopper kernels against the JAX Pallas
kernels they replace, run in interpret mode on the CPU.

On CPU tensors each wrapper runs its twin, so these tests hold the twin's
arithmetic (which the card's kernel is held against in chip_smoke.py and
tests/test_torch_cuda.py) to the TPU kernel's. Tolerance: float32,
atol 1e-5 / rtol 1e-4, except the Griffin-Lim waveform (atol 1e-4 /
rtol 1e-3 after several chaotic iterations). The Griffin-Lim iteration
takes the OLA normalizer ``winsq`` and makes its edge frames itself; at
R = n_fft / hop = 16, where the JAX package runs no fused kernel (its gate
stops at R = 9), it is held against the JAX pair path.
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.ops.hopper import cbhg, griffin_lim, highway


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize('c_in', [80, 256])
def test_pre_highway_twin_matches_pallas(c_in):
    from forwardtacotron_tpu.ops.pallas.highway import \
        pre_highway_stack_pallas

    rs = np.random.RandomState(c_in)
    n, c, layers = 50, 128, 4        # n not a multiple of the row block
    a = rs.randn(n, c_in).astype(np.float32)
    res = rs.randn(n, c_in).astype(np.float32)
    pre_w = (rs.randn(c_in, c) / np.sqrt(c_in)).astype(np.float32)
    w1, w2 = [(rs.randn(layers, c, c) / np.sqrt(c)).astype(np.float32)
              for _ in range(2)]
    b1, b2 = [(0.1 * rs.randn(layers, c)).astype(np.float32)
              for _ in range(2)]
    ref = pre_highway_stack_pallas(a, res, pre_w, w1, b1, w2, b2,
                                   block_rows=32, interpret=True)
    got = highway.pre_highway_stack(
        _t(a), _t(res), _t(pre_w), _t(np.concatenate([w1, w2], -1)),
        _t(np.concatenate([b1, b2], -1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-4)
    assert highway.launches == 0      # CPU tensors never reach the kernel


def test_cbhg_front_twin_matches_pallas():
    from forwardtacotron_tpu.ops.pallas.cbhg import bank_pool_proj_pallas

    rs = np.random.RandomState(8)
    b, t, c_in, c, p, k_max = 2, 40, 16, 32, 24, 8
    x = rs.randn(b, t, c_in).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 27:] = 0.0                # item 1 is 27 frames long
    x[1, 27:] = 0.0                   # the caller zeroes the tail
    bank_w = [(rs.randn(k, c_in, c) / np.sqrt(k * c_in)).astype(np.float32)
              for k in range(1, k_max + 1)]
    bn_scale = rs.uniform(0.5, 1.5, (k_max, c)).astype(np.float32)
    bn_bias = (0.1 * rs.randn(k_max, c)).astype(np.float32)
    proj_w = (rs.randn(3, k_max * c, p) / np.sqrt(3 * k_max * c)) \
        .astype(np.float32)
    ps = rs.uniform(0.5, 1.5, p).astype(np.float32)
    pb = (0.1 * rs.randn(p)).astype(np.float32)

    ref = bank_pool_proj_pallas(x, mask, tuple(bank_w), bn_scale, bn_bias,
                                proj_w, ps, pb, ks=tuple(range(1, k_max + 1)),
                                interpret=True)
    got = cbhg.bank_pool_proj(_t(x), _t(mask), [_t(w) for w in bank_w],
                              _t(bn_scale), _t(bn_bias), _t(proj_w), _t(ps),
                              _t(pb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-4)


N_FFT, HOP, WIN = 64, 16, 64


def _gl_inputs(seed, n_items=2, n_samples=400):
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.stft import stft_pair
    rs = np.random.RandomState(seed)
    sig = rs.randn(n_items, n_samples).astype(np.float32) * 0.3
    mags = []
    for i in range(n_items):
        re, im = stft_pair(jnp.asarray(sig[i]), N_FFT, HOP, WIN)
        mags.append(np.asarray(jnp.sqrt(re ** 2 + im ** 2)).T)
    return np.stack(mags)                          # [B, bins, F]


def test_edge_frames_match_jax():
    from forwardtacotron_tpu.ops.pallas.griffin_lim import (_edge_frames,
                                                            _lane_pad)

    rs = np.random.RandomState(4)
    b, f, bins = 2, 23, N_FFT // 2 + 1
    re = rs.randn(b, f, bins).astype(np.float32)
    im = rs.randn(b, f, bins).astype(np.float32)
    pad = ((0, 0), (0, 0), (0, _lane_pad(bins) - bins))
    ref = _edge_frames(np.pad(re, pad), np.pad(im, pad), N_FFT, HOP, WIN, f)
    consts = griffin_lim.gl_constants(N_FFT, HOP, WIN, torch.device('cpu'))
    winsq = griffin_lim.ola_normalizer(N_FFT, HOP, f, WIN,
                                       torch.device('cpu'))
    got = griffin_lim.edge_frames(_t(re), _t(im), HOP, consts, winsq)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('n_iter', [1, 4])
def test_griffin_lim_twin_matches_pallas(n_iter):
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.griffin_lim import griffin_lim_fused

    mag = _gl_inputs(0)
    b, bins, f = mag.shape
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    ref = griffin_lim_fused(jnp.asarray(mag), keys, N_FFT, HOP, WIN,
                            n_iter=n_iter, compute_dtype=jnp.float32,
                            block_frames=8, interpret=True)
    # the JAX function's own phase draw, injected into the port
    phase = np.asarray(2.0 * jnp.pi * jax.vmap(
        lambda k: jax.random.uniform(k, (bins, f)))(keys))
    got = griffin_lim.griffin_lim_fused(_t(mag), _t(phase), N_FFT, HOP, WIN,
                                        n_iter=n_iter)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-3)


def test_griffin_lim_twin_matches_pair_path():
    """The banded iteration equals the plain istft -> stft iteration of
    ops.stft.griffin_lim_pair (the path for mels under 2R frames)."""
    from forwardtacotron_torch.ops.stft import griffin_lim_pair

    mag = _gl_inputs(1, n_items=1)
    rs = np.random.RandomState(2)
    phase = rs.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    fused = griffin_lim.griffin_lim_fused(_t(mag), _t(phase), N_FFT, HOP,
                                          WIN, n_iter=3)
    pair = griffin_lim_pair(_t(mag[0]), _t(phase[0]), N_FFT, HOP, WIN,
                            n_iter=3)
    np.testing.assert_allclose(fused[0].numpy(), pair.numpy(),
                               atol=1e-4, rtol=1e-3)


def _phase(mag):
    return np.random.RandomState(5).uniform(
        0, 2 * np.pi, mag.shape).astype(np.float32)


def _iterate_plain(mag, phase, n_fft, hop, win, n_iter):
    """``n_iter`` iterations of griffin_lim_iter_plain with its winsq
    contract, then the synthesis istft: [B, samples]."""
    from forwardtacotron_torch.ops.stft import istft_pair

    consts = griffin_lim.gl_constants(n_fft, hop, win, torch.device('cpu'))
    m = _t(mag).transpose(1, 2).contiguous()
    ph = _t(phase).transpose(1, 2)
    spec_re, spec_im = m * torch.cos(ph), m * torch.sin(ph)
    tp_re, tp_im = torch.zeros_like(m), torch.zeros_like(m)
    winsq = griffin_lim.ola_normalizer(n_fft, hop, m.shape[1], win,
                                       torch.device('cpu'))
    for _ in range(n_iter):
        spec_re, spec_im, tp_re, tp_im = griffin_lim.griffin_lim_iter_plain(
            spec_re, spec_im, tp_re, tp_im, m, winsq, consts, hop)
    return istft_pair(spec_re, spec_im, n_fft, hop, win)


def test_griffin_lim_iter_plain_matches_pallas():
    """The iteration's winsq contract at R = 4: its edge frames from
    edge_frames inside, against the JAX fused kernel (interpret mode) with
    its own phase draw injected."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.griffin_lim import griffin_lim_fused

    mag = _gl_inputs(3)
    b, bins, f = mag.shape
    keys = jax.random.split(jax.random.PRNGKey(11), b)
    ref = griffin_lim_fused(jnp.asarray(mag), keys, N_FFT, HOP, WIN,
                            n_iter=2, compute_dtype=jnp.float32,
                            block_frames=8, interpret=True)
    phase = np.asarray(2.0 * jnp.pi * jax.vmap(
        lambda k: jax.random.uniform(k, (bins, f)))(keys))
    got = _iterate_plain(mag, phase, N_FFT, HOP, WIN, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize('n_iter', [1, 3])
def test_griffin_lim_twin_matches_jax_pair_at_r16(n_iter):
    """n_fft 2048, hop 128 (R = 16, 31-term OLA band, 32 edge frames of 40):
    the port's fused Griffin-Lim on the CPU (its twin) against the JAX
    package's griffin_lim_pair with the JAX phase draw injected."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.stft import griffin_lim_pair, stft_pair
    n_fft, hop = 2048, 128
    rs = np.random.RandomState(16)
    sig = rs.randn(hop * 39).astype(np.float32) * 0.3
    re, im = stft_pair(jnp.asarray(sig), n_fft, hop, n_fft)
    mag = np.asarray(jnp.sqrt(re ** 2 + im ** 2)).T          # [bins, 40]
    key = jax.random.PRNGKey(16)
    ref = griffin_lim_pair(jnp.asarray(mag), key, n_fft, hop, n_fft,
                           n_iter=n_iter)
    phase = np.asarray(2.0 * jnp.pi * jax.random.uniform(key, mag.shape))
    got = griffin_lim.griffin_lim_fused(_t(mag[None]), _t(phase[None]),
                                        n_fft, hop, n_fft, n_iter=n_iter)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-3)
    plain = _iterate_plain(mag[None], phase[None], n_fft, hop, n_fft, n_iter)
    np.testing.assert_allclose(plain[0].numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-3)


def test_griffin_lim_kernel_weights_are_the_twins():
    """The kernel's padded weight copies hold the twin's matrices: inv_pad
    is inv_w with zero padding, fwd_pad interleaves fwd_re and fwd_im per
    bin; both are whole tiles."""
    for n_fft, hop in ((64, 16), (1024, 256), (640, 64), (2048, 128)):
        c = griffin_lim.gl_constants(n_fft, hop, n_fft, torch.device('cpu'))
        bins = n_fft // 2 + 1
        assert c.inv_pad.shape[0] % griffin_lim.TILE_K == 0
        assert c.inv_pad.shape[1] % griffin_lim.TILE_N == 0
        assert c.fwd_pad.shape[0] % griffin_lim.TILE_K == 0
        assert c.fwd_pad.shape[1] % griffin_lim.TILE_N == 0
        assert torch.equal(c.inv_pad[:2 * bins, :n_fft], c.inv_w)
        assert torch.equal(c.fwd_pad[:n_fft, 0:2 * bins:2], c.fwd_re)
        assert torch.equal(c.fwd_pad[:n_fft, 1:2 * bins:2], c.fwd_im)
        for pad in (c.inv_pad[2 * bins:], c.inv_pad[:, n_fft:],
                    c.fwd_pad[n_fft:], c.fwd_pad[:, 2 * bins:]):
            assert not pad.any()


@pytest.mark.parametrize('n_fft,hop,f', [(64, 16, 8), (64, 16, 9), (64, 16, 23),
                                         (640, 64, 20), (2048, 128, 33)])
def test_griffin_lim_kernel_frames_walk(n_fft, hop, f):
    """griffin_lim.cu's launch 2 builds each frame from the IDFT frames f
    alone: sample t of frame i sits at N = i hop + t of the overlap-added
    signal, reflected about the trimmed signal's first and last samples for
    the first and last R frames, and sums the R frames j with j hop <= N <
    j hop + n_fft; interior frames times q, edge frames over winsq[N] times
    the window. That walk, in numpy over two items, equals the twin's
    frames (banded OLA plus edge_frames)."""
    rs = np.random.RandomState(f)
    b, bins, r = 2, n_fft // 2 + 1, n_fft // hop
    re, im = (rs.randn(b, f, bins).astype(np.float32) for _ in range(2))
    cpu = torch.device('cpu')
    consts = griffin_lim.gl_constants(n_fft, hop, n_fft, cpu)
    winsq = griffin_lim.ola_normalizer(n_fft, hop, f, n_fft, cpu)
    want = griffin_lim.pre_dft_frames(_t(re), _t(im), winsq, consts, hop)

    frames = (_t(re) @ consts.inv_w[:bins]
              + _t(im) @ consts.inv_w[bins:]).numpy().reshape(b * f, n_fft)
    q, win, wsq = consts.q.numpy(), consts.win.numpy(), winsq.numpy()
    half, last = n_fft // 2, n_fft // 2 + hop * (f - 1) - 1
    got = np.zeros((b * f, n_fft), np.float64)
    for row in range(b * f):
        item, fi = divmod(row, f)
        edge = fi < r or fi >= f - r
        for t in range(n_fft):
            n = fi * hop + t
            if edge:
                n = 2 * half - n if n < half else n
                n = 2 * last - n if n > last else n
            s = 0.0
            for j in range(n // hop - r + 1, n // hop + 1):
                if 0 <= j < f:
                    s += frames[item * f + j, n - j * hop]
            got[row, t] = s / wsq[n] * win[t] if edge else s * q[t]
    np.testing.assert_allclose(got.reshape(b, f, n_fft), want.numpy(),
                               atol=1e-5, rtol=1e-4)
