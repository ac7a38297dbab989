"""The MRF kernels' shape limits against what the JAX package's Pallas
kernels (ops/pallas/mrf.py) can run, shape by shape.

The Pallas kernels keep every weight of a level in VMEM
(ops/pallas/mrf.py:148-160, 325-327) and set no ``vmem_limit_bytes``, so
the compiler's scoped limit holds, 16 MB as the JAX package names it
(models/vocoder.py:380-382), read here as 16 MiB.
:func:`pallas_mrf_vmem_bytes` and :func:`pallas_ups_mrf_vmem_bytes` count
what their blocks, scratch and weights must hold at least. Past the shapes
``mrf.cu`` took before (C <= 256, at most 32 kernel sizes, an input tile
that fits whole), the port takes a level exactly where that count stays
within the limit, and refuses the rest with the Pallas reason:
- more than 256 channels (the wide form: each CTA of a cluster of up to 16
  keeps only its own channel slice and streams the source from the others);
- more than 32 kernel sizes (the branches in a table in device memory);
- a tail level whose input tile does not fit whole (it loads in chunks of
  input channels), such as C 256 behind 513 inputs in float32.

Taken by ``mrf.cu`` before, as the JAX generator's gates send them to Pallas:
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

Refused, as the Pallas kernel cannot hold the level either: e.g. more than
256 channels with HiFi-GAN's branch set (kernel sizes 3/7/11, dilations
1/3/5).

Tolerances, the JAX package's own (tests/test_mrf.py): float32 atol 2e-5;
bfloat16 atol 5e-2 at the output's scale.
"""

import numpy as np
import pytest
import torch
from test_torch_ups_mrf import _level_inputs, _torch_level
from test_torch_vocoder import (BF16_ATOL, F32_ATOL, _check_mrf_twin,
                                _close_at_scale, _jax_generator)
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.models import vocoder as vocoder_mod
from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
from forwardtacotron_torch.ops.hopper import mrf, ups_mrf
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


def pallas_ups_mrf_vmem_bytes(s_in, s_up, c_in, c, k_up, krs, n_units, t_ps,
                              elt):
    """At least the VMEM one ``ups_mrf_pallas`` step holds, as the JAX
    generator calls it (the default 512-lane tile cut to the level): its
    unblocked weights (ops/pallas/mrf.py:325-327, 334-335: the upsampler's
    kernel cast to the activation's dtype, its float32 bias, the MRF's
    weights with the float32 biases ``_ups_mrf_level`` stacks) and the
    double-buffered input window, input and output masks and output blocks
    (:319-332). The compiler's temporaries and lane padding come on top."""
    s_out = s_in * s_up
    t_tile = min(512, max(128, -(-t_ps // 128) * 128))
    halo = -(-64 // s_out) + 8
    t_w = t_tile + 2 * halo
    weights = (k_up * c_in * c * elt + c * 4
               + sum(2 * n_units * (c * kr * c * elt + c * 4) for kr in krs))
    blocks = 2 * (s_in * c_in * t_w + 2 * t_w + s_out * c * t_tile) * elt
    return weights + blocks


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
    """The port refuses such a level, card-free, with the Pallas kernel's
    reason in each dtype; on a card its gate raises it
    (tests/test_torch_gates.py)."""
    for dtype, elt in DTYPES.values():
        name = str(dtype).replace('torch.', '')
        want = (f'C={c} with kernel sizes {KRS} and 3 dilations in {name}: '
                "the JAX package's Pallas kernel would hold at least "
                f'{pallas_mrf_vmem_bytes(c, KRS, 3, 1, elt)} bytes of VMEM '
                'at its smallest tile, past the 16777216-byte scoped limit, '
                'so no shape like it runs there either')
        assert mrf.shape_error(c, KRS, DILS, dtype) == want
    assert mrf.shape_error(c, KRS, DILS).startswith(f'C={c} with')
    with pytest.raises(ValueError, match=f'C={c} with'):
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


# ------------------------------------------- closed: the Pallas frontier

# the frontier's branch sets: (kernel sizes, dilations)
BRANCH_SETS = {'1x1': ((1,), (1,)), '1x3': ((1,), DILS),
               '3x1': ((3,), (1,)), '7x1': ((7,), (1,)),
               '3_5x1': ((3, 5), (1,)), '3x3': ((3,), DILS),
               '5x3': ((5,), DILS), '3_7x3': ((3, 7), DILS),
               'v1': (KRS, DILS)}
WIDE_WIDTHS = (257, 384, 512, 641, 1024, 1061, 1214, 1807)
DTYPES = {'float32': (torch.float32, 4), 'bfloat16': (torch.bfloat16, 2)}
# the largest C each branch set holds within the scoped limit at the
# smallest tile, (bf16, f32)
FRONTIER = {'1x1': (1807, 1214), '1x3': (1099, 754), '3x1': (1061, 717),
            '7x1': (687, 463), '3_5x1': (662, 451), '3x3': (641, 441),
            '5x3': (495, 341), '3_7x3': (353, 243), 'v1': (244, 168)}


def _jax_gates(monkeypatch, krs, dils, c):
    """The JAX generator's fused-level gate and phase-stacked tail gate
    (a tail of one rate-2 level, C_in = 2 C) for a level of ``c`` channels,
    their backend clauses read as a TPU's."""
    import jax

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    gen = JaxHiFiGAN(upsample_rates=(2,), upsample_kernel_sizes=(4,),
                     upsample_initial_channel=2 * c,
                     resblock_kernel_sizes=krs,
                     resblock_dilation_sizes=(dils,) * len(krs), num_mels=8,
                     fuse_mrf_max_ch=c, fuse_ups_tail_max_ch=c).bind({})
    return gen._mrf_fusable(c), gen._ups_tail_fusable(c, 0, 8)


def _check_new_plan(pl, dtype, c, c_in=0):
    assert pl['smem'] <= mrf.SMEM_BYTES and pl['c_pad'] >= c
    assert pl['c_pad'] == pl['cs'] * pl['cluster']
    if pl['wide']:
        assert pl['cs'] in mrf.WIDE_SLICES and pl['c_pad'] % 64 == 0
        assert pl['cluster'] <= mrf.WIDE_CLUSTER
        if dtype == torch.bfloat16 and pl['cs'] > 64:
            assert pl['tw'] <= 256
    if dtype == torch.bfloat16:
        assert mrf.MIN_STAGES <= pl['stages'] <= mrf.MAX_STAGES
        assert pl['acc_regs'] <= mrf.MAX_ACC_REGS
    if c_in:
        assert pl['c_in_pad'] >= c_in
        assert pl['c_in_pad'] == pl['groups'] * pl['cw']
        assert pl['groups'] == 1 or pl['cw'] % mrf.KC == 0


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('name', list(BRANCH_SETS))
def test_wide_levels_plan_exactly_within_the_pallas_count(monkeypatch, name,
                                                          dtype):
    """Over C from 257 to 1,807: both JAX gates admit every level, and the
    port plans a level (alone, and as a tail level behind 2 C and 2 C + 1
    inputs) exactly where the Pallas kernel can hold it by the count, in
    the call's dtype; past the count ``shape_error`` gives the Pallas
    reason. The port's own counts are these."""
    krs, dils = BRANCH_SETS[name]
    tdt, elt = DTYPES[dtype]
    planned = refused = 0
    for c in WIDE_WIDTHS:
        assert _jax_gates(monkeypatch, krs, dils, c) == (True, True)
        need = pallas_mrf_vmem_bytes(c, krs, len(dils), 1, elt)
        assert mrf.pallas_vmem_bytes(c, krs, len(dils), elt) == need
        err = mrf.shape_error(c, krs, dils, tdt)
        if need <= SCOPED_VMEM:
            assert err is None
            _check_new_plan(mrf.plan(tdt, c, krs, dils), tdt, c)
        else:
            assert f'C={c} ' in err and 'Pallas kernel would hold' in err
        for c_in in (2 * c, 2 * c + 1):
            need = pallas_ups_mrf_vmem_bytes(1, 2, c_in, c, 4, krs,
                                             len(dils), 1, elt)
            assert ups_mrf.pallas_vmem_bytes(1, 2, c_in, c, 4, krs,
                                             len(dils), elt) == need
            err = ups_mrf.shape_error(1, 2, c_in, c, 4, krs, dils, tdt)
            if need <= SCOPED_VMEM:
                assert err is None
                _check_new_plan(ups_mrf.plan(tdt, 1, 2, c_in, c, 4, krs,
                                             dils), tdt, c, c_in)
                planned += 1
            else:
                assert f'C_in={c_in} ' in err \
                    and 'Pallas kernel would hold' in err
                refused += 1
    assert refused and (planned or name in ('3_7x3', 'v1')
                        or dtype == 'float32')


@pytest.mark.parametrize('name', list(BRANCH_SETS))
def test_frontier_of_the_pallas_count(name):
    """The largest C of each branch set within the count, at the smallest
    tile, in both dtypes: the port plans it and refuses one channel more
    (v1's branch set: C <= 256 keeps the plans it had, past the count)."""
    krs, dils = BRANCH_SETS[name]
    for (dtype, elt), top in zip(DTYPES.values(), FRONTIER[name][::-1]):
        assert pallas_mrf_vmem_bytes(top, krs, len(dils), 1, elt) \
            <= SCOPED_VMEM < pallas_mrf_vmem_bytes(top + 1, krs, len(dils),
                                                   1, elt)
        assert mrf.shape_error(top, krs, dils, dtype) is None
        if top + 1 > mrf.MAX_CHANNELS:
            assert 'Pallas' in mrf.shape_error(top + 1, krs, dils, dtype)


@pytest.mark.parametrize('n', [33, 40])
def test_many_kernel_sizes_plan(n):
    """A level of 33 or 40 kernel sizes (the branch table lives in device
    memory), within the count at C 64 (~5.1 MB in bf16 at 33 sizes of 3):
    it plans, alone and as a tail level; past the count (C 256, dilations
    1/3/5) it is refused with the Pallas reason."""
    krs = tuple((3, 5, 1, 7)[i % 4] for i in range(n))
    for dtype in (torch.float32, torch.bfloat16):
        _check_new_plan(mrf.plan(dtype, 64, krs, DILS), dtype, 64)
        _check_new_plan(ups_mrf.plan(dtype, 1, 2, 128, 64, 4, krs, DILS),
                        dtype, 64, 128)
        assert mrf.shape_error(64, krs, DILS, dtype) is None
        assert 'Pallas' in mrf.shape_error(256, krs, DILS, dtype)
    assert pallas_mrf_vmem_bytes(64, (3,) * 33, 3, 1, 2) < 5.2e6


def test_tail_levels_past_the_carve_plan_in_chunks():
    """A tail level of 256 channels in float32 behind 513 inputs overflows
    the input tile's carve: it now loads in chunks of input channels; the
    bf16 level, which fits whole, keeps its plan and is no longer refused
    for the float32 one. v1's branch set there, and 512 inputs behind taps
    reaching past 9 input rows (38 taps at rate 2), stay past the count."""
    pl = ups_mrf.plan(torch.float32, 1, 2, 513, 256, 4, (3,), DILS)
    assert pl['groups'] > 1 and not pl['wide']
    _check_new_plan(pl, torch.float32, 256, 513)
    bf = ups_mrf.plan(torch.bfloat16, 1, 2, 513, 256, 4, (3,), DILS)
    assert bf['groups'] == 1
    assert ups_mrf.shape_error(1, 2, 513, 256, 4, (3,), DILS,
                               torch.bfloat16) is None
    assert ups_mrf.tap_reach(2, 38) > 9
    for c_in, k, krs in ((513, 4, KRS), (512, 38, (3,)), (512, 38, (1,))):
        err = ups_mrf.shape_error(1, 2, c_in, 256, k, krs, DILS,
                                  torch.float32)
        assert 'Pallas' in err and pallas_ups_mrf_vmem_bytes(
            1, 2, c_in, 256, k, krs, 3, 1, 4) > SCOPED_VMEM


# ---------------------------------- closed: the twins against Pallas

@pytest.mark.parametrize('dtype,c,krs,dils', [
    ('bfloat16', 512, (3,), DILS), ('float32', 1024, (1,), (1,)),
    ('float32', 16, tuple((3, 5, 1, 7)[i % 4] for i in range(33)), (2,))],
    ids=['c512_bf16', 'c1024_f32', '33_kernel_sizes_f32'])
def test_closed_level_twin_matches_pallas(dtype, c, krs, dils):
    """The twin against ``mrf_pallas`` in interpret mode at levels the port
    now takes: C 512 with (3,) x (1, 3, 5) in bf16, C 1,024 of 1-tap
    convolutions in f32, 33 kernel sizes; one tile."""
    _check_mrf_twin(dtype, c, 40, 128, krs, dils)


def test_closed_tail_level_twin_matches_pallas():
    """The tail's twin against ``ups_mrf_pallas`` in interpret mode at a
    float32 level of 256 channels behind 513 inputs, (3,) x (1, 3, 5), with
    padding lanes."""
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.mrf import ups_mrf_pallas

    krs, c_in, c, t_ps, t_valid = (3,), 513, 256, 20, 17
    inputs = _level_inputs(1, 2, 4, c_in, c, t_ps, seed=3, krs=krs,
                           n_units=3)
    x, up_w, up_b, weights = inputs
    ref = np.asarray(ups_mrf_pallas(
        jnp.asarray(x), jnp.asarray(up_w), jnp.asarray(up_b),
        tuple(jnp.asarray(w) for w in weights), 1, 2, krs, DILS, t_valid,
        interpret=True), np.float32)
    got = ups_mrf.ups_mrf_plain(*_torch_level(inputs, torch.float32), 1, 2,
                                krs, DILS, t_valid)
    assert got.shape == ref.shape == (2, 2 * c, t_ps)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_ATOL)


WIDE_CFG = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                upsample_initial_channel=1024)


@pytest.mark.parametrize('dtype,krs,dils', [
    ('bfloat16', (3,), DILS), ('float32', (1,), (1,))],
    ids=['bfloat16_3x3', 'float32_1x1'])
def test_wide_generator_matches_jax(dtype, krs, dils, monkeypatch):
    """A generator whose first level has 512 channels, fused on both sides
    at ``fuse_mrf_max_ch=512`` (levels of 512 and 256 channels; the JAX
    side's backend clause patched, so ``mrf_pallas`` runs in interpret
    mode; the port's device clause patched, so its CPU tensors reach
    ``mrf``, which runs the twin): the outputs agree. (3,) x (1, 3, 5) in
    bf16 (11.0 MB by the count), 1-tap convolutions in f32 (at C 512 the
    (3,) x 3 set is past the count in f32)."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN

    cfg = dict(WIDE_CFG, resblock_kernel_sizes=krs,
               resblock_dilation_sizes=(dils,))
    jmodel, variables, port = _jax_generator(cfg, seed=7, n_mels=8,
                                             fuse_mrf_max_ch=512)
    mel = np.random.RandomState(7).randn(2, 10, 8).astype(np.float32)
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
    assert jax_calls == port_calls == [0, 1]
    assert got.shape == want.shape == (2, 10 * 4)
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        _close_at_scale(got, want, BF16_ATOL)
