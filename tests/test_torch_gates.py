"""The port's kernel gates send a part to its kernel where the JAX
package's gates send it to Pallas, and on a card raise where the kernel
does not take the shape (no part gives way to plain operations there); the
wrappers' zero-channel padding is exact. No card is needed: each gate's
device clause is patched, each wrapper's shape check runs without one, and
the padding is held on the plain twins (on a card the wrappers pad the same
way before they launch).

- ``HiFiGANGenerator._mrf_fusable`` -> ``mrf.shape_error``;
- ``HiFiGANGenerator._tail_fusable`` (the channels-major tail) ->
  ``mrf.shape_error`` for every level of the tail;
- ``CBHG.front_fusable`` -> ``cbhg.shape_error``;
- ``CBHG.highways_fusable`` -> ``highway.shape_error``.
"""

import itertools

import pytest
import torch
import torch.nn.functional as F
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.models import vocoder as vocoder_mod
from forwardtacotron_torch.models.layers import CBHG
from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
from forwardtacotron_torch.ops.hopper import cbhg, highway, mrf, ups_mrf

KRS, DILS = (3, 7, 11), (1, 3, 5)


MRF_BLOCKS = ((KRS, ((1, 3, 5),) * 3), ((3, 5), ((1, 2), (1, 2))),
              ((13,), ((1, 3, 5),)), ((4, 6), ((1, 2), (1, 2))))


def _jax_mrf_gate(monkeypatch, gen):
    """The JAX generator's ``_mrf_fusable`` for the port generator's shape
    and cap, bound without variables and with its backend clause read as
    a TPU's."""
    import jax

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    return JaxHiFiGAN(
        upsample_initial_channel=gen.upsample_initial_channel,
        resblock_kernel_sizes=gen.resblock_kernel_sizes,
        resblock_dilation_sizes=gen.resblock_dilation_sizes, num_mels=8,
        fuse_mrf_max_ch=gen.fuse_mrf_max_ch).bind({})._mrf_fusable


def test_mrf_gate_admits_only_kernel_shapes(monkeypatch):
    """On a card, over widths, caps, kernel sizes and dilations: the gate
    admits a level where the JAX gate does and the kernel takes it, and
    raises where the JAX gate admits a level the kernel does not take
    (past the Pallas kernel's VMEM, in the activation's dtype); it never
    gives way to the per-convolution path. The levels of 12 and 6 channels
    that the kernel once refused, of 128 and 256 channels and of even
    kernel sizes are admitted, and a bf16 level of 512 channels."""
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    admitted, raised = set(), set()
    for initial, (krs, dils) in itertools.product((96, 256, 40), MRF_BLOCKS):
        gen = HiFiGANGenerator(upsample_initial_channel=initial,
                               resblock_kernel_sizes=krs,
                               resblock_dilation_sizes=dils, num_mels=8)
        for cap in (16, 64, 128, 256):
            gen.fuse_mrf_max_ch = cap           # the gate reads nothing else
            jax_gate = _jax_mrf_gate(monkeypatch, gen)
            for up in gen.ups:
                c = up.out_channels
                x = torch.zeros(1, c, 4)
                err = mrf.shape_error(c, krs, dils[0])
                if jax_gate(c) and err:
                    with pytest.raises(NotImplementedError, match='mrf.cu'):
                        gen._mrf_fusable(c, x)
                    raised.add((c, krs))
                    continue
                got = gen._mrf_fusable(c, x)
                assert got == jax_gate(c), (initial, krs, cap, c)
                if got:
                    assert err is None
                    admitted.add(c)
    assert {12, 6, 48, 24, 64, 5, 10, 128} <= admitted  # 40 -> 20, 10, 5
    assert not raised
    # a level past the kernel's reach, which the JAX gate admits: v1's
    # branch set at 512 channels, past the Pallas kernel's VMEM too
    gen = HiFiGANGenerator(upsample_initial_channel=1024, num_mels=8)
    gen.fuse_mrf_max_ch = 512
    assert _jax_mrf_gate(monkeypatch, gen)(512)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(NotImplementedError, match='C=512'):
            gen._mrf_fusable(512, torch.zeros(1, 512, 4, dtype=dtype))
    assert gen._mrf_fusable(256, torch.zeros(1, 256, 4))
    # (3,) x (1, 3, 5) at 512 channels: within the count in bf16, which the
    # wide form takes; past it in f32
    gen = HiFiGANGenerator(upsample_initial_channel=1024,
                           resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3, 5),), num_mels=8)
    gen.fuse_mrf_max_ch = 512
    assert gen._mrf_fusable(512, torch.zeros(1, 512, 4,
                                             dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match='Pallas'):
        gen._mrf_fusable(512, torch.zeros(1, 512, 4))
    # the per-convolution path on CPU tensors, whatever the shape
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: False)
    assert not gen._mrf_fusable(128, torch.zeros(1, 128, 4))


# (kernel sizes, dilations, the kernel takes them) past HiFi-GAN's three
# and three: within the halo, past it, and 33 dilations of 1-tap
# convolutions (span 0: the JAX gates admit them, and the kernel takes any
# number of units of a 1-tap convolution, which needs no dilation)
LONG_BLOCKS = {'10_kernel_sizes': (tuple(range(2, 12)), (1, 3, 5), True),
               '9_dilations': ((3, 5), (1, 2) * 4 + (1,), True),
               '12_by_9': ((3,) * 12, (1,) * 9, True),
               'past_halo': ((3,) * 10, (1,) * 33, False),
               '33_one_tap_units': ((1,), (1,) * 33, True)}


@pytest.mark.parametrize('name', list(LONG_BLOCKS))
def test_gates_fuse_long_lists(monkeypatch, name):
    """On a card, a level of more kernel sizes or dilations than HiFi-GAN's
    three: the fused-level gate and the tail's gate admit it where the JAX
    gates do and the kernel takes it (every list within the halo), refuse
    it where the JAX gate does (the fused level's, past the halo), and
    raise, with the kernel's reason, where the JAX gate admits a level the
    kernel does not take (the tail's gate reads no halo)."""
    import jax

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    krs, dils, takes = LONG_BLOCKS[name]
    cfg = dict(upsample_rates=(4, 2, 2), upsample_kernel_sizes=(8, 4, 4),
               upsample_initial_channel=64, resblock_kernel_sizes=krs,
               resblock_dilation_sizes=(dils,) * len(krs), num_mels=8)
    gen = HiFiGANGenerator(**cfg)
    gen.fuse_mrf_max_ch = gen.fuse_ups_tail_max_ch = 16
    jax_gen = JaxHiFiGAN(**cfg, fuse_mrf_max_ch=16,
                         fuse_ups_tail_max_ch=16).bind({})
    c, level = gen.ups[1].out_channels, 1
    x = torch.zeros(1, gen.ups[1].in_channels, 8)
    jax_mrf, jax_tail = jax_gen._mrf_fusable(c), jax_gen._ups_tail_fusable(
        c, level, 8)
    assert (mrf.shape_error(c, krs, dils) is None) == takes
    # the JAX tail gate reads no halo: it admits all five
    assert jax_tail and jax_mrf == (name != 'past_halo')
    reason = 'halo' if name == 'past_halo' else 'at most 32'
    for port_gate, want in (
            (lambda: gen._mrf_fusable(c, torch.zeros(1, c, 8)), jax_mrf),
            (lambda: gen._ups_tail_fusable(c, level, x), jax_tail)):
        if want and not takes:
            with pytest.raises(NotImplementedError, match=reason):
                port_gate()
        else:
            assert port_gate() == want


# (upsample_rates, upsample_kernel_sizes) of the channels-major tail's
# grid: v1's, a rate-3 level, a geometry without the polyphase form (k - s
# odd) and a rate-1 level
CM_TAIL_RATES = {(8, 8, 2, 2): (16, 16, 4, 4), (4, 3, 2): (8, 5, 4),
                 (4, 4, 2): (8, 7, 4), (4, 1, 2): (8, 3, 4)}


def test_cm_tail_gate_matches_jax(monkeypatch):
    """On a card (device clause patched), over configs, widths, caps and
    levels: the channels-major tail's gate admits a tail where the JAX
    gate does (its backend clause read as a TPU's), and the kernel takes
    every level of it; on the CPU it admits none."""
    import jax

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    admitted = refused = 0
    for (rates, sizes), initial, (krs, dils), cap in itertools.product(
            CM_TAIL_RATES.items(), (64, 512), MRF_BLOCKS[:2],
            (16, 64, 256)):
        cfg = dict(upsample_rates=rates, upsample_kernel_sizes=sizes,
                   upsample_initial_channel=initial,
                   resblock_kernel_sizes=krs, resblock_dilation_sizes=dils,
                   num_mels=8)
        gen = HiFiGANGenerator(**cfg, fuse_tail_max_ch=cap)
        jgate = JaxHiFiGAN(**cfg, fuse_tail_max_ch=cap).bind(
            {})._tail_fusable
        for level, up in enumerate(gen.ups):
            c = up.out_channels
            x = torch.zeros(1, up.in_channels, 4)
            got = gen._tail_fusable(c, level, x)
            assert got == jgate(c, level), (rates, initial, krs, cap, level)
            admitted += got
            refused += not got
            if got:
                assert all(mrf.shape_error(u.out_channels, krs, dils[0])
                           is None for u in gen.ups[level:])
    assert admitted and refused
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: False)
    gen = HiFiGANGenerator(upsample_initial_channel=64, fuse_tail_max_ch=64)
    assert not gen._tail_fusable(32, 0, torch.zeros(1, 64, 4))


def test_cm_tail_gate_raises_where_mrf_refuses(monkeypatch):
    """A tail that the JAX gate admits with a level of 512 channels of v1's
    branch set, which ``mrf.cu`` does not take (past the Pallas kernel's
    VMEM): the gate raises ``kernel_gap`` on a card, naming the level,
    before any launch; a cap that starts the tail below it is admitted. The
    (3,) x (1, 3, 5) level of 512 channels is admitted in bf16 (the wide
    form) and raises in f32 (past the count)."""
    import jax

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    cfg = dict(upsample_initial_channel=1024, num_mels=8)
    gen = HiFiGANGenerator(**cfg, fuse_tail_max_ch=512)
    assert JaxHiFiGAN(**cfg, fuse_tail_max_ch=512).bind(
        {})._tail_fusable(512, 0)
    assert mrf.shape_error(512, KRS, DILS)
    with pytest.raises(NotImplementedError,
                       match='tail level 0 .*C=512'):
        gen._tail_fusable(512, 0, torch.zeros(1, 1024, 4))
    gen.fuse_tail_max_ch = 256
    assert not gen._tail_fusable(512, 0, torch.zeros(1, 1024, 4))
    assert gen._tail_fusable(256, 1, torch.zeros(1, 512, 4))
    gen = HiFiGANGenerator(**cfg, resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3, 5),),
                           fuse_tail_max_ch=512)
    assert gen._tail_fusable(512, 0, torch.zeros(1, 1024, 4,
                                                 dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match='tail level 0 .*Pallas'):
        gen._tail_fusable(512, 0, torch.zeros(1, 1024, 4))


def test_cbhg_gates_admit_only_kernel_shapes(monkeypatch):
    """On a card, over bank sizes, widths and projections: a front or
    highway stack that the JAX gates route to a kernel takes the kernel
    where its check passes and raises where it does not, so no part gives
    way to plain operations; the JAX package's routing of the default
    configs is kept."""
    from forwardtacotron_torch.models import layers
    monkeypatch.setattr(layers, '_on_cuda', lambda x: True)
    for k, c_in, c, p in itertools.product((1, 4, 8, 16), (6, 80, 256),
                                           (10, 128, 256), (12, 256, 320)):
        m = CBHG(k, c_in, c, [p, 6 if c_in == 6 else c_in], 4).eval()
        x = torch.zeros(1, 4, c_in)
        for fusable, err in (
                (m.front_fusable, cbhg.shape_error(k, c_in, c, p)),
                (m.highways_fusable,
                 highway.shape_error(m.pre_highway.in_features, c))):
            if fusable and err:
                with pytest.raises(NotImplementedError, match='ROADMAP'):
                    m._takes_kernel(fusable, err, 'part', x)
            else:
                assert m._takes_kernel(fusable, err, 'part', x) == fusable
        assert m.highways_fusable == (c % 128 == 0)
    # P 320: the kernel tiles P, so the gate admits the front and the
    # forward reaches the wrapper (on CPU tensors, its twin)
    m = CBHG(4, 80, 128, [320, 80], 4).eval()
    assert m.front_fusable and m.front_error is None
    with torch.no_grad():
        assert m(torch.zeros(1, 9, 80)).shape == (1, 9, 256)
    # in training, and on CPU tensors, plain operations or the twin
    assert not m.train()._takes_kernel(True, 'err', 'part', x)
    monkeypatch.setattr(layers, '_on_cuda', lambda x: False)
    assert m.eval()._takes_kernel(True, 'err', 'part', x)
    # configs/singlespeaker.yaml: the K=8 postnet front and both highway
    # stacks take the kernels, the K=16 prenet front the plain path
    for m, front in ((CBHG(8, 80, 256, [256, 80], 4), True),
                     (CBHG(16, 256, 256, [256, 256], 4), False)):
        assert m.front_fusable == front and m.highways_fusable
        assert m.front_error is None and m.highways_error is None
    # the front's check refuses only what the JAX gate refuses: taps past
    # its halo
    assert 'K=18' in cbhg.shape_error(18, 80, 256, 256)
    assert not CBHG(18, 80, 256, [256, 80], 4).front_fusable
    # an input width of 6 is padded to 8: admitted
    assert CBHG(8, 80, 128, [256, 6], 4).highways_fusable
    assert highway.shape_error(6, 128) is None
    # rows of any width the JAX gate admits, down to one row per CTA
    assert highway.shape_error(1024, 2048) is None
    assert highway.shape_error(29056, 128) is None
    assert highway.shape_error(29060, 128) is not None


@pytest.mark.parametrize('p', [320, 512])
def test_front_gate_admits_wide_projections(monkeypatch, p):
    """Fronts projecting to more than 256 columns, which the JAX gate
    admits: the port's gate admits them too, the kernel's check passes in
    both dtypes and ``_takes_kernel`` sends them to the kernel on a card
    (device clause patched) without raising; the pre-RNN output on CPU
    tensors is the plain route's."""
    from forwardtacotron_torch.models import layers
    m = CBHG(8, 80, 256, [p, 80], 4).eval()
    assert m.front_fusable and m.front_error is None
    assert cbhg.shape_error(8, 80, 256, p) is None
    for dtype in (torch.float32, torch.bfloat16):
        fp = cbhg.plan(dtype, 8, 80, 256, p)
        assert fp['p_pad'] >= p and fp['smem'] <= cbhg.SMEM_BYTES
    x = torch.randn(2, 11, 80, generator=torch.Generator().manual_seed(p))
    monkeypatch.setattr(layers, '_on_cuda', lambda x: True)
    assert m._takes_kernel(m.front_fusable, m.front_error, 'front', x)
    monkeypatch.setattr(layers, '_on_cuda', lambda x: False)
    with torch.no_grad():
        got = m.pre_rnn(x, torch.tensor([11, 7]))
        m.fuse_front = False
        want = m.pre_rnn(x, torch.tensor([11, 7]))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _mrf_weights(g, c, dtype=torch.float32):
    weights = []
    for kr in KRS:
        for _ in range(2):
            weights += [torch.randn(3, c, kr * c, generator=g) / (kr * c) ** .5,
                        0.1 * torch.randn(3, c, 1, generator=g)]
    return tuple(w.to(dtype) for w in weights)


# Each wrapper's padding, held on the twins: the first C output channels of
# the padded problem equal the unpadded result (zero terms only; atol 1e-6
# for the float32 sums that the CPU's convolutions block differently).

def test_mrf_padding_is_exact():
    g = torch.Generator().manual_seed(0)
    for c in (12, 6):
        x = torch.randn(2, c, 150, generator=g)
        weights = _mrf_weights(g, c)
        want = mrf.mrf_plain(x, weights, KRS, DILS)
        got = mrf.mrf_plain(F.pad(x, (0, 0, 0, 16 - c)),
                            mrf.pad_weights(weights, KRS, c, 16), KRS, DILS)
        torch.testing.assert_close(got[:, :c], want, rtol=0, atol=1e-6)
        assert not got[:, c:].any()


def test_highway_padding_is_exact():
    g = torch.Generator().manual_seed(1)
    n, c_in, c = 37, 6, 128
    args = [torch.randn(n, c_in, generator=g), torch.randn(n, c_in, generator=g),
            torch.randn(c_in, c, generator=g) / c_in ** .5,
            torch.randn(4, c, 2 * c, generator=g) / c ** .5,
            0.1 * torch.randn(4, 2 * c, generator=g)]
    want = highway.pre_highway_stack_plain(*args)
    got = highway.pre_highway_stack_plain(
        *highway.pad_input_width(*args[:3], 8), *args[3:])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_cbhg_front_padding_is_exact():
    g = torch.Generator().manual_seed(2)
    b, t, k_max, c_in, c, p = 2, 21, 3, 6, 10, 12
    mask = torch.ones(b, t)
    mask[1, 15:] = 0
    x = torch.randn(b, t, c_in, generator=g) * mask[:, :, None]
    bank = [torch.randn(k, c_in, c, generator=g) for k in range(1, 4)]
    bn = [torch.rand(k_max, c, generator=g) + 0.5,
          0.1 * torch.randn(k_max, c, generator=g)]
    proj = torch.randn(3, k_max * c, p, generator=g) / (3 * k_max * c) ** .5
    tail = [torch.rand(p, generator=g) + 0.5, 0.1 * torch.randn(p, generator=g)]
    want = cbhg.bank_pool_proj_plain(x, mask, bank, *bn, proj, *tail)
    px, pbank, pscale, pbias, pproj = cbhg.pad_channels(x, bank, *bn, proj,
                                                        8, 12)
    got = cbhg.bank_pool_proj_plain(px, mask, pbank, pscale, pbias, pproj,
                                    *tail)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_ups_mrf_padding_is_exact():
    g = torch.Generator().manual_seed(3)
    s_in, s_up, k, c_in, c, t_ps = 2, 2, 4, 24, 12, 70
    x = torch.randn(2, s_in * c_in, t_ps, generator=g)
    up_w = torch.randn(k, c, c_in, generator=g) / c_in ** .5
    up_b = 0.1 * torch.randn(c, generator=g)
    weights = _mrf_weights(g, c)
    want = ups_mrf.ups_mrf_plain(x, up_w, up_b, weights, s_in, s_up, KRS,
                                 DILS, t_ps - 3)
    prep = ups_mrf.prepare(up_w, up_b, weights, s_in, s_up, KRS, DILS)
    assert (prep.c_in_pad, prep.c_pad) == (32, 16) and prep.packed is None
    got = ups_mrf.ups_mrf_plain(ups_mrf.pad_input(x, s_in, 32), prep.up_w,
                                prep.up_b, prep.weights, s_in, s_up, KRS,
                                DILS, t_ps - 3)
    assert got.shape == (2, s_in * s_up * 16, t_ps)
    torch.testing.assert_close(ups_mrf.unpad_output(got, s_in * s_up, c),
                               want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('kw,match', [
    (dict(upsample_initial_channel=1024, fuse_mrf_max_ch=512), 'C=512'),
    (dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
          upsample_initial_channel=1024, fuse_ups_tail_max_ch=512),
     'tail level 0 .*C=512'),
    (dict(upsample_initial_channel=1024, fuse_tail_max_ch=512), 'C=512')],
    ids=['mrf', 'tail', 'cm_tail'])
def test_generator_raises_where_kernel_refuses(monkeypatch, kw, match):
    """The generator's forward on a card (device clause patched) raises at
    the first level the JAX gate admits and the kernel does not take (v1's
    branch set at 512 channels, past the Pallas kernel's VMEM), before any
    launch; on the CPU the same generator runs per convolution."""
    gen = HiFiGANGenerator(num_mels=8, **kw).eval()
    mel = torch.zeros(1, 4, 8)
    with torch.no_grad():
        assert gen(mel).shape == (1, 4 * gen.hop_length)
        monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
        before = (mrf.launches, ups_mrf.launches)
        with pytest.raises(NotImplementedError, match=match):
            gen(mel)
    assert (mrf.launches, ups_mrf.launches) == before


@pytest.mark.parametrize('route', ['fuse_mrf_max_ch', 'fuse_ups_tail_max_ch',
                                   'fuse_tail_max_ch'])
def test_gates_admit_wide_bf16_levels(monkeypatch, route):
    """Beside the refusals above: with (3,) x (1, 3, 5), the level of 512
    channels (behind 1,024 inputs in the tail) lies within the Pallas
    kernel's VMEM in bf16, so on a card each route's gate admits it as the
    JAX gate does, and each level's kernel has a plan; in f32 the same
    level is past the count and the gate raises."""
    import jax

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    cfg = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
               upsample_initial_channel=1024, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3, 5),), num_mels=8)
    gen = HiFiGANGenerator(**cfg, **{route: 512})
    jgen = JaxHiFiGAN(**cfg, **{route: 512}).bind({})
    x = torch.zeros(1, 1024, 8, dtype=torch.bfloat16)
    u = torch.zeros(1, 512, 8, dtype=torch.bfloat16)
    gate, want = {
        'fuse_mrf_max_ch': (lambda x, u: gen._mrf_fusable(512, u),
                            jgen._mrf_fusable(512)),
        'fuse_ups_tail_max_ch': (lambda x, u: gen._ups_tail_fusable(
            512, 0, x), jgen._ups_tail_fusable(512, 0, 8)),
        'fuse_tail_max_ch': (lambda x, u: gen._tail_fusable(512, 0, x),
                             jgen._tail_fusable(512, 0))}[route]
    assert want and gate(x, u)
    assert mrf.shape_error(512, (3,), DILS, torch.bfloat16) is None
    assert ups_mrf.shape_error(1, 2, 1024, 512, 4, (3,), DILS,
                               torch.bfloat16) is None
    with pytest.raises(NotImplementedError, match='Pallas'):
        gate(x.float(), u.float())
