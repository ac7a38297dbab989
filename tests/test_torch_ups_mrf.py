"""The port's phase-stacked HiFi-GAN tail (``fuse_ups_tail_max_ch``) against
the JAX package's: the ``ups_mrf`` twin against ``ups_mrf_pallas`` in
interpret mode, the upsampler's weight packing, the generator with the tail
on (and the levels that take it), and the tail's gate over a grid.

Inputs are made from seeds with numpy. Tolerances, the JAX package's own
(tests/test_mrf.py): float32 atol 2e-5 for one level, rtol 1e-5 / atol 1e-6
for whole generators; bfloat16 atol 5e-2 at the output's scale (both sides
round at the same points, but a float32 sum taken in another order can land
on the neighbouring bf16 value and a residual chain carries it on).
"""

import itertools

import numpy as np
import pytest
import torch
from test_torch_vocoder import _close_at_scale, _jax_generator

from forwardtacotron_torch.models import vocoder as vocoder_mod
from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
from forwardtacotron_torch.ops.hopper import ups_mrf

KRS, DILS = (3, 7, 11), (1, 3, 5)
F32_ATOL, BF16_ATOL = 2e-5, 5e-2


def _level_inputs(s_in, s_up, k, c_in, c, t_ps, seed, krs=KRS,
                  n_units=len(DILS)):
    """x [2, s_in*C_in, T_ps], the upsampler in the JAX layout [k, C_in, C]
    and its bias [C], and the MRF weights (float32 biases), float32
    numpy."""
    rs = np.random.RandomState(seed)
    x = rs.randn(2, s_in * c_in, t_ps).astype(np.float32)
    up_w = (rs.randn(k, c_in, c) * np.sqrt(s_up / (k * c_in))).astype(
        np.float32)
    up_b = (0.1 * rs.randn(c)).astype(np.float32)
    weights = []
    for kr in krs:
        for _ in range(2):
            weights.append((rs.randn(n_units, c, kr * c) / np.sqrt(kr * c))
                           .astype(np.float32))
            weights.append((0.1 * rs.randn(n_units, c, 1))
                           .astype(np.float32))
    return x, up_w, up_b, weights


def _torch_level(inputs, dtype):
    """The level's inputs for the port: the upsampler in the kernel's layout
    [k, C, C_in] (:func:`ups_mrf.pack_up_weight`)."""
    x, up_w, up_b, weights = inputs
    return (torch.from_numpy(x).to(dtype),
            torch.from_numpy(up_w).transpose(1, 2).contiguous().to(dtype),
            torch.from_numpy(up_b),
            tuple(torch.from_numpy(w).to(torch.float32 if i % 2 else dtype)
                  for i, w in enumerate(weights)))


# (s_in, s_up, k, T_ps, t_valid, t_tile): one tile; several 128-lane tiles
# with a ragged edge and padding lanes; rate 4
LEVELS = [(1, 2, 4, 100, 100, 512), (2, 2, 4, 300, 293, 128),
          (1, 4, 8, 90, 90, 512)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('s_in,s_up,k,t_ps,t_valid,t_tile', LEVELS,
                         ids=['s1x2', 's2x2_tiles', 's1x4'])
def test_ups_mrf_twin_matches_pallas(dtype, s_in, s_up, k, t_ps, t_valid,
                                     t_tile):
    _check_ups_mrf_twin(dtype, s_in, s_up, k, t_ps, t_valid, t_tile, KRS,
                        DILS)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_ups_mrf_twin_matches_pallas_even_kr(dtype):
    """Even kernel sizes, which the JAX gate admits and the card's kernel
    takes, in phase space (a tap at (j - kr // 2) * d of an even kr), over
    several tiles with a ragged edge."""
    _check_ups_mrf_twin(dtype, 2, 2, 4, 300, 293, 128, (4, 6), (1, 2))


@pytest.mark.parametrize('dtype,krs,dils', [
    ('float32', tuple(range(2, 12)), DILS),
    ('bfloat16', (3, 5), (1, 2) * 4 + (1,))],
    ids=['10_kernel_sizes', '9_dilations'])
def test_ups_mrf_twin_matches_pallas_long_lists(dtype, krs, dils):
    """10 kernel sizes (odd and even, float32) and 9 dilations (bfloat16)
    within the halo, in phase space, over several tiles with a ragged edge
    and padding lanes."""
    _check_ups_mrf_twin(dtype, 2, 2, 4, 150, 143, 128, krs, dils)


def _check_ups_mrf_twin(dtype, s_in, s_up, k, t_ps, t_valid, t_tile, krs,
                        dils):
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.mrf import ups_mrf_pallas

    inputs = _level_inputs(s_in, s_up, k, 32, 16, t_ps, seed=t_ps, krs=krs,
                           n_units=len(dils))
    x, up_w, up_b, weights = inputs
    jdt = jnp.dtype(dtype)
    ref = ups_mrf_pallas(
        jnp.asarray(x, jdt), jnp.asarray(up_w, jdt), jnp.asarray(up_b),
        tuple(jnp.asarray(w, jnp.float32 if i % 2 else jdt)
              for i, w in enumerate(weights)),
        s_in, s_up, krs, dils, t_valid, t_tile=t_tile, interpret=True)
    ref = np.asarray(ref, np.float32)
    tdt = getattr(torch, dtype)
    got = ups_mrf.ups_mrf_plain(*_torch_level(inputs, tdt), s_in, s_up, krs,
                                dils, t_valid)
    assert got.dtype == tdt and got.shape == ref.shape \
        == (2, s_in * s_up * 16, t_ps)
    assert not got[..., t_valid:].any()
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_ATOL)
    else:
        _close_at_scale(got.float().numpy(), ref, BF16_ATOL)


def test_ups_mrf_wrapper_takes_the_twin_on_cpu(monkeypatch):
    args = (*_torch_level(_level_inputs(2, 2, 4, 32, 16, 40, seed=1),
                          torch.float32), 2, 2, KRS, DILS, 40)
    calls = []
    plain = ups_mrf.ups_mrf_plain
    monkeypatch.setattr(ups_mrf, 'ups_mrf_plain',
                        lambda *a: (calls.append(1), plain(*a))[1])
    before = ups_mrf.launches
    got = ups_mrf.ups_mrf(*args)
    assert calls == [1] and ups_mrf.launches == before
    assert torch.equal(got, plain(*args))


def test_phase_stack_round_trip():
    x = torch.arange(2 * 3 * 8).reshape(2, 3, 8)
    ps = ups_mrf.phase_stack(x, 2)
    # row r*C + c, lane t holds sample 2t + r of channel c
    assert ps[1, 1 * 3 + 2, 3] == x[1, 2, 2 * 3 + 1]
    assert torch.equal(ups_mrf.phase_unstack(ps, 2), x)


def test_pack_up_weight_matches_jax():
    """pack_up_weight of the port's (converted) upsampler weights gives the
    JAX package's ``ups_i/kernel`` with each tap's matrix transposed."""
    cfg = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
               upsample_initial_channel=32)
    _, variables, port = _jax_generator(cfg, seed=5, n_mels=8)
    for i, up in enumerate(port.ups):
        np.testing.assert_array_equal(
            ups_mrf.pack_up_weight(up.weight).transpose(1, 2).detach()
            .numpy(),
            np.asarray(variables['params'][f'ups_{i}']['kernel']))


# the narrow v1 shape of tests/test_mrf.py (levels of 64/32/16/8 channels,
# the tail from level 2, whose input spans several kernel tiles) and its
# two-level x2/x2 config (the tail from level 0); tails the kernel takes
# since its widening: a last level at rate 3, and an upsampler of 24 taps.
# (config, fuse_ups_tail_max_ch, (batch, frames), n_mels, tail levels)
TAIL_CFGS = {
    'v1_narrow': (dict(upsample_initial_channel=128), 16, (1, 24), 20,
                  [2, 3]),
    'two_levels': (dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=128), 64, (2, 24), 20,
                   [0, 1]),
    'rate3': (dict(upsample_rates=(4, 4, 3), upsample_kernel_sizes=(8, 8, 9),
                   upsample_initial_channel=64), 8, (2, 21), 20, [2]),
    'k_up24': (dict(upsample_rates=(4, 2, 2), upsample_kernel_sizes=(8, 24, 4),
                    upsample_initial_channel=64), 16, (2, 20), 20, [1, 2])}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', list(TAIL_CFGS))
def test_generator_tail_matches_jax(name, dtype, monkeypatch):
    """The port's generator with the tail on (its device clause patched, so
    CPU tensors reach ``ups_mrf``, which runs the twin) against the JAX
    generator with the same option under FTT_PALLAS_INTERPRET=1: the same
    levels take the tail (on the card the gate does not raise: rate 3 and
    24 taps included), and the outputs agree; in float32 also with the
    port's per-convolution path."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN

    cfg, max_ch, (b, t), n_mels, levels = TAIL_CFGS[name]
    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')
    jmodel, variables, port = _jax_generator(cfg, seed=7, n_mels=n_mels,
                                             fuse_ups_tail_max_ch=max_ch)
    mel = np.random.RandomState(3).randn(b, t, n_mels).astype(np.float32)
    tdt = getattr(torch, dtype)
    port = port.to(tdt)
    if dtype == 'bfloat16':
        jmodel = jmodel.clone(dtype=jnp.bfloat16)
        variables = jax.tree.map(lambda a: a.astype(jnp.bfloat16), variables)

    port_levels, jax_levels = [], []
    orig = HiFiGANGenerator._ups_mrf_level
    monkeypatch.setattr(HiFiGANGenerator, '_ups_mrf_level',
                        lambda self, x, level, s_in: (
                            port_levels.append(level),
                            orig(self, x, level, s_in))[1])
    jorig = JaxHiFiGAN._ups_mrf_level
    monkeypatch.setattr(JaxHiFiGAN, '_ups_mrf_level',
                        lambda self, x, level, s_in, t_valid: (
                            jax_levels.append(level),
                            jorig(self, x, level, s_in, t_valid))[1])
    with torch.no_grad():
        plain = port(torch.from_numpy(mel)).float().numpy()
    assert port_levels == []            # CPU tensors: per-convolution
    want = np.asarray(jax.jit(jmodel.apply)(variables, mel), np.float32)
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).float().numpy()
    assert jax_levels == port_levels == levels
    assert got.shape == want.shape == (b, t * port.hop_length)
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
    else:
        _close_at_scale(got, want, BF16_ATOL)


def _jax_gate(cfg, max_ch):
    """The JAX generator's ``_ups_tail_fusable``, bound without variables
    (the gate reads only the module's attributes)."""
    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    return JaxHiFiGAN(**cfg, fuse_ups_tail_max_ch=max_ch).bind(
        {})._ups_tail_fusable


GATE_RATES = {(8, 8, 2, 2): (16, 16, 4, 4), (8, 8, 4): (16, 16, 8),
              (2, 2): (4, 4), (4, 4): (8, 8), (8, 8, 3): (16, 16, 5),
              (4, 2, 2): (8, 34, 4)}
GATE_BLOCKS = {'1_uniform': ('1', ((1, 3, 5),) * 3),
               '1_mixed': ('1', ((1, 3, 5), (1, 3, 5), (1, 2, 4))),
               '2_uniform': ('2', ((1, 3),) * 3)}


@pytest.mark.parametrize('block', list(GATE_BLOCKS))
def test_ups_tail_gate_matches_jax(block, monkeypatch):
    """On a card, over rates, channel caps, widths and lengths: the port's
    gate admits a tail exactly where the JAX gate does and the kernel takes
    every level of it (rates 2, 3 and 4, up to 256 output channels), and
    raises where the JAX gate admits a tail with a level the kernel does
    not take (an upsampler of 34 taps); every tail it admits passes the
    kernel's check."""
    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    resblock, dils = GATE_BLOCKS[block]
    admitted = raised = 0
    for (rates, sizes), initial in itertools.product(GATE_RATES.items(),
                                                     (64, 256)):
        cfg = dict(resblock=resblock, upsample_rates=rates,
                   upsample_kernel_sizes=sizes,
                   upsample_initial_channel=initial,
                   resblock_dilation_sizes=dils, num_mels=8)
        port = HiFiGANGenerator(**cfg)
        for max_ch in (0, 16, 32, 64, 128):
            port.fuse_ups_tail_max_ch = max_ch  # the gate reads nothing else
            jax_gate = _jax_gate(cfg, max_ch)
            for level, up in enumerate(port.ups):
                kernel_ok = all(
                    ups_mrf.shape_error(
                        int(np.prod(rates[level:j])), rates[j],
                        u.in_channels, u.out_channels, sizes[j],
                        port.resblock_kernel_sizes, dils[0]) is None
                    for j, u in enumerate(port.ups) if j >= level)
                for t_in in (24, 25, 48):
                    x = torch.zeros(1, up.in_channels, t_in)
                    want = jax_gate(up.out_channels, level, t_in)
                    if want and not kernel_ok:
                        with pytest.raises(NotImplementedError,
                                           match='ups_mrf'):
                            port._ups_tail_fusable(up.out_channels, level, x)
                        raised += 1
                        continue
                    got = port._ups_tail_fusable(up.out_channels, level, x)
                    assert got == want, (cfg, max_ch, level, t_in)
                    admitted += got
    if resblock == '1' and block.endswith('uniform'):
        assert admitted and raised
    else:
        assert not admitted and not raised


def test_tail_option_defaults_off(monkeypatch):
    """fuse_ups_tail_max_ch defaults to 0, as in the JAX package, and then
    no level takes the tail, even on a card."""
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    gen = HiFiGANGenerator(upsample_initial_channel=128)
    assert gen.fuse_ups_tail_max_ch == 0 and gen.fuse_mrf_max_ch == 0
    assert not any(gen._ups_tail_fusable(up.out_channels, i,
                                         torch.zeros(1, 1, 8))
                   for i, up in enumerate(gen.ups))
