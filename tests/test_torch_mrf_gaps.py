"""The MRF kernels' shape limits against what the JAX package's Pallas
kernels (ops/pallas/mrf.py) can run, shape by shape.

Taken by ``mrf.cu``, as the JAX generator's gates send them to Pallas:
- a level of 1-tap convolutions only (span 0) with more than 32 dilations:
  a 1-tap convolution needs no dilation, so the launch parameters need not
  hold them;
- a tail level whose upsampler has more than 32 taps, reaching more than 8
  input rows: the input tile's halo grows to the taps' reach;
- a tail level of C_in = 2 C + 1 input channels: ``HiFiGANGenerator``
  halves the channels at every level, rounding down, so an odd width before
  a level gives it one input channel past 2 C.
Here: a generator of 1-tap levels against the JAX one. The twins against
the Pallas kernels in interpret mode at these shapes, the tail's generator
and gate against the JAX package's, and the plans are cases of
tests/test_torch_vocoder.py, tests/test_torch_ups_mrf.py and
tests/test_torch_mrf_plan.py; tests/test_torch_cuda.py holds the kernel to
the twin.

Refused, as the Pallas kernel cannot hold the level either: more than 256
channels with HiFi-GAN's branch set (kernel sizes 3/7/11, dilations
1/3/5). ``mrf_pallas`` keeps every weight of a level in VMEM
(ops/pallas/mrf.py:148-160) and sets no ``vmem_limit_bytes``, so the
compiler's scoped limit holds, 16 MB as the JAX package names it
(models/vocoder.py:380-382). :func:`pallas_mrf_vmem_bytes` counts what the
kernel's blocks and scratch must hold at least.

Tolerances, the JAX package's own (tests/test_mrf.py): float32 atol 2e-5;
bfloat16 atol 5e-2 at the output's scale.
"""

import numpy as np
import pytest
import torch
from test_torch_vocoder import F32_ATOL, _close_at_scale, _jax_generator
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.models import vocoder as vocoder_mod
from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
from forwardtacotron_torch.ops.hopper import mrf
from forwardtacotron_torch.utils.convert import hifigan_from_jax_params

KRS, DILS = (3, 7, 11), (1, 3, 5)
# the scoped VMEM limit the JAX package names (models/vocoder.py:380-382),
# read as the larger 16 MiB
SCOPED_VMEM = 16 * 2 ** 20


def pallas_mrf_vmem_bytes(c, krs, n_units, t, elt):
    """At least the VMEM one ``mrf_pallas`` step holds, as the JAX
    generator calls it (``im2col=True``, the default 1024-sample tile cut
    to the level): every weight and bias of the level (unblocked VMEM
    inputs, ops/pallas/mrf.py:148-160), the double-buffered input window,
    mask and output blocks, and the im2col scratch. The compiler's own
    temporaries and its padding of the biases' last dimension to 128 lanes
    come on top."""
    t_tile = min(1024, max(128, -(-t // 128) * 128))
    t_w = t_tile + 2 * 64
    weights = sum(2 * n_units * (c * kr * c + c) for kr in krs) * elt
    blocks = 2 * (c * t_w + t_w + c * t_tile) * elt
    scratch = max(krs) * c * t_w * elt
    return weights + blocks + scratch


# ---------------------------------------------------------------- closed

ONE_TAP_CFG = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                   upsample_initial_channel=64, resblock_kernel_sizes=(1,),
                   resblock_dilation_sizes=(tuple(range(1, 34)),))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_one_tap_generator_matches_jax(dtype, monkeypatch):
    """A generator of 1-tap MRF branches with 33 dilations at
    ``fuse_mrf_max_ch=16``: level 1 (16 channels) takes the fused path on
    both sides (the JAX side's backend clause patched, so ``mrf_pallas``
    runs in interpret mode; the port's device clause patched, so its CPU
    tensors reach ``mrf``, which runs the twin), and the outputs agree.
    The MRF weights are drawn at a quarter of the initializer's scale: at
    full scale 33 residual units grow the activations so far that the JAX
    package's own fused and per-convolution outputs differ past the float32
    tolerance."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN

    jmodel, variables, port = _jax_generator(ONE_TAP_CFG, seed=5, n_mels=8,
                                             fuse_mrf_max_ch=16)
    params = {k: jax.tree.map(lambda a: a / 4, v)
              if k.startswith('resblocks') else v
              for k, v in variables['params'].items()}
    variables = {'params': params}
    port.load_state_dict(hifigan_from_jax_params(params))
    mel = np.random.RandomState(5).randn(2, 20, 8).astype(np.float32)
    tdt = getattr(torch, dtype)
    port = port.to(tdt)
    if dtype == 'bfloat16':
        jmodel = jmodel.clone(dtype=jnp.bfloat16)
        variables = jax.tree.map(lambda a: a.astype(jnp.bfloat16), variables)
    monkeypatch.setattr(JaxHiFiGAN, '_mrf_fusable',
                        lambda self, ch: not self.is_initializing()
                        and 0 < ch <= self.fuse_mrf_max_ch)
    port_calls, jax_calls = [], []
    orig = HiFiGANGenerator._mrf_fused
    monkeypatch.setattr(HiFiGANGenerator, '_mrf_fused',
                        lambda self, x, level: (port_calls.append(level),
                                                orig(self, x, level))[1])
    jorig = JaxHiFiGAN._mrf_fused
    monkeypatch.setattr(JaxHiFiGAN, '_mrf_fused',
                        lambda self, x, level: (jax_calls.append(level),
                                                jorig(self, x, level))[1])
    want = np.asarray(jmodel.apply(variables, mel), np.float32)
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).float().numpy()
    assert jax_calls == port_calls == [1]
    assert got.shape == want.shape == (2, 20 * 16)
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        _close_at_scale(got, want, 5e-2)


# --------------------------------------------------------------- refused

@pytest.mark.parametrize('elt', [4, 2], ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('c', [257, 384, 512, 1024])
def test_wide_v1_levels_exceed_the_pallas_vmem(c, elt):
    """A level of more than 256 channels with HiFi-GAN's branch set cannot
    run in ``mrf_pallas`` on its TPU: at its smallest tile its blocks,
    scratch and weights (6 x 21 x C^2 elements, 16.6 MB at C 257 in bf16,
    132 MB at C 512 in f32) hold more than the 16 MiB scoped limit. (C 256
    itself is past it in the JAX kernel; the port takes it.)"""
    need = pallas_mrf_vmem_bytes(c, KRS, len(DILS), 1, elt)
    assert need > SCOPED_VMEM
    assert 6 * 21 * c * c * elt <= need


@pytest.mark.parametrize('c', [257, 384, 512, 1024])
def test_wide_levels_are_refused_with_the_kernels_reason(c):
    """The port refuses such a level, card-free, with this message; on a
    card its gate raises it (tests/test_torch_gates.py)."""
    want = (f"C={c} is not supported: the kernel splits a tile's channels "
            'over a cluster of at most 8 CTAs of at most 64 channels each, '
            'which holds C <= 256')
    assert mrf.shape_error(c, KRS, DILS) == want
    with pytest.raises(ValueError, match=f'C={c} is not supported'):
        mrf.plan(torch.bfloat16, c, KRS, DILS)


def test_v1_branch_set_fits_the_pallas_vmem_only_narrower():
    """The count's other side: at its smallest tile, a v1 level of 128
    channels or fewer leaves room under the scoped limit in both dtypes
    (the count is a lower bound, so no refusal could rest on it), and the
    port takes it."""
    for c in (32, 64, 128):
        for elt in (2, 4):
            assert pallas_mrf_vmem_bytes(c, KRS, 3, 1, elt) < SCOPED_VMEM
        assert mrf.shape_error(c, KRS, DILS) is None
