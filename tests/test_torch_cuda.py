"""The port's Hopper kernels against their plain twins on the card, at small
shapes with ragged edges (rows, frames and bins that are not tile
multiples, tail masks). Needs an NVIDIA GPU and nvcc; skips elsewhere.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -o addopts='' -m cuda tests/test_torch_cuda.py

Tolerance: float32 with different summation orders, max abs error at most
1e-4 of the output's scale (max(1, max |twin|)); 1e-3 for Griffin-Lim's
phase-normalized spectrum, where dividing by |up| amplifies rounding in
bins whose momentum update nearly cancels.
"""

import pytest
import torch

from forwardtacotron_torch.ops.hopper import cbhg, griffin_lim, highway

pytestmark = pytest.mark.cuda
TOL = 1e-4


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
                                      (5, 12, 64)])
def test_pre_highway_kernel_matches_twin(dev, n, c_in, c):
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
                                                (1, 9, 8, 16, 12, 3)])
def test_cbhg_front_kernel_matches_twin(dev, b, t, c_in, c, p, k_max):
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


@pytest.mark.parametrize('n_fft,hop,f', [(1024, 256, 70), (64, 16, 9)])
def test_griffin_lim_iter_kernel_matches_twin(dev, n_fft, hop, f):
    g = torch.Generator().manual_seed(f)
    bins = n_fft // 2 + 1
    consts = griffin_lim.gl_constants(n_fft, hop, n_fft, dev)
    winsq = griffin_lim.ola_normalizer(n_fft, hop, f, n_fft, dev)
    spec = [torch.randn(2, f, bins, generator=g).to(dev) for _ in range(4)]
    mag = torch.rand(2, f, bins, generator=g).to(dev)
    repl = griffin_lim.edge_frames(spec[0], spec[1], hop, consts,
                                   winsq).contiguous()
    args = (*spec, mag, repl, consts, hop)
    got = griffin_lim.griffin_lim_iter(*args)
    torch.cuda.synchronize()
    want = griffin_lim.griffin_lim_iter_plain(*args)
    _close(got[2:], want[2:])                 # rebuilt spectrum
    _close(got[:2], want[:2], tol=10 * TOL)   # phase-normalized spectrum
