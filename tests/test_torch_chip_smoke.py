"""chip_smoke.py's Griffin-Lim profiler check, fed with counts on the CPU.

On the card the check profiles ``griffin_lim_fused`` at 2 and at 4
iterations, each several times, keeps per device-event name the median
count over the runs (``typical_count``) and fails unless the 4-iteration
run adds exactly the 4 ``gl_gemm_kernel`` launches of its 2 more iterations
and nothing else (``gl_iteration_extra_work``). These tests hold both
functions to that with counts shaped as the card records them: 5 host to
device copies, 2 cuBLAS products and 19 elementwise kernels around the
iterations.
"""

import collections
import re
import types

import pytest
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

import chip_smoke

GL0 = 'void (anonymous namespace)::gl_gemm_kernel<32, 0>(float const*)'
GL1 = 'void (anonymous namespace)::gl_gemm_kernel<32, 1>(float const*)'
COPY = 'Memcpy HtoD (Pageable -> Device)'
GEMM = 'sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3'
EW = 'void at::native::vectorized_elementwise_kernel<4, ...>'
EW2 = 'void at::native::elementwise_kernel<128, 2, ...>'


def _around(**extra):
    """The device events of one griffin_lim_fused call besides its
    iterations' launches, plus ``extra``."""
    return collections.Counter({COPY: 5, GEMM: 2, EW: 11, EW2: 8, **extra})


def _call(n_iter, **extra):
    c = _around(**extra)
    c.update({GL0: n_iter, GL1: n_iter})
    return c


@pytest.mark.parametrize('case,at_2,at_4,passes', [
    ('equal', _call(2), _call(4), True),
    # a leftover op in every iteration (an edge_frames kernel): +2 at 4
    ('op_per_iteration', _call(2, edge=2), _call(4, edge=4), False),
    # one more copy per iteration (a constant built inside the loop)
    ('copy_per_iteration', _call(2, **{COPY: 7}), _call(4, **{COPY: 9}),
     False),
    # one op more over the two extra iterations
    ('one_op', _call(2), _call(4, **{EW: 12}), False),
    # an iteration that skips one of its launches
    ('missing_launch', _call(2), _call(4) - collections.Counter({GL1: 1}),
     False),
    # one op swapped for another: the totals agree, the names do not
    ('swapped_op', _call(2), _call(4, **{EW: 10, EW2: 9}), False),
])
def test_gl_iteration_check(case, at_2, at_4, passes):
    extra = chip_smoke.gl_iteration_extra_work(at_2, at_4)
    assert (extra == []) == passes, (case, extra)


def test_gl_check_survives_a_lost_record_only():
    """A record lost in one of the runs (a run on the card once counted
    25 events where every other run counted 26) leaves the per-name
    median, and so the check, unchanged; an op that every 4-iteration run
    adds per iteration still fails it, whichever run loses a record."""
    lost = _call(4) - collections.Counter({COPY: 1})
    at_4 = chip_smoke.typical_count([_call(4), lost, _call(4)])
    assert at_4 == _call(4)
    assert chip_smoke.gl_iteration_extra_work(_call(2), at_4) == []
    leftover = [_call(4, edge=4), _call(4, edge=4) - collections.Counter(
        {EW: 1}), _call(4, edge=4)]
    at_2 = chip_smoke.typical_count([_call(2, edge=2)] * 3)
    extra = chip_smoke.gl_iteration_extra_work(
        at_2, chip_smoke.typical_count(leftover))
    assert extra == ['edge: 2 at 2 iterations, 4 at 4']


def test_gl_check_survives_a_record_moved_between_runs():
    """A record missed at the end of the last 2-iteration run and counted
    in the first 4-iteration run (a run on the card once counted 17 copies
    at 4 iterations against 16 at 2) moves neither median; two runs of five
    with a missed or a late record in each batch leave it too."""
    runs_2 = [_call(2)] * 4 + [_call(2) - collections.Counter({EW2: 1})]
    runs_4 = [_call(4) + collections.Counter({EW2: 1})] + [_call(4)] * 4
    assert chip_smoke.gl_iteration_extra_work(
        chip_smoke.typical_count(runs_2),
        chip_smoke.typical_count(runs_4)) == []
    runs_2 = [_call(2, **{COPY: 4}), _call(2, **{COPY: 6}), _call(2),
              _call(2), _call(2)]
    runs_4 = [_call(4, **{COPY: 6}), _call(4), _call(4, **{EW: 10}),
              _call(4), _call(4)]
    assert chip_smoke.gl_iteration_extra_work(
        chip_smoke.typical_count(runs_2),
        chip_smoke.typical_count(runs_4)) == []


@pytest.mark.parametrize('runs,expected', [
    # a name absent from a minority of runs keeps its count
    ([{'a': 3}, {}, {'a': 3}], {'a': 3}),
    # one run's stray event does not add the name
    ([{'a': 1}, {'a': 1, 'b': 1}, {'a': 1}], {'a': 1}),
    # an even number of runs takes the lower middle count
    ([{'a': 2}, {'a': 3}], {'a': 2}),
])
def test_typical_count_is_the_median_per_name(runs, expected):
    got = chip_smoke.typical_count([collections.Counter(r) for r in runs])
    assert +got == collections.Counter(expected)


def test_gl_check_fails_work_in_most_runs():
    """An extra op per iteration that the profiler records in three runs
    of five, and misses in two, still fails the check."""
    runs_2 = [_call(2, edge=2)] * 3 + [_call(2)] * 2
    runs_4 = [_call(4, edge=4)] * 3 + [_call(4)] * 2
    extra = chip_smoke.gl_iteration_extra_work(
        chip_smoke.typical_count(runs_2), chip_smoke.typical_count(runs_4))
    assert extra == ['edge: 2 at 2 iterations, 4 at 4']


def _events(name, us, device=True):
    """Profiler events of one name, one per time in ``us``."""
    from torch.autograd import DeviceType
    return [types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(elapsed_us=lambda u=u: u),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)
        for u in us]


LR_TILE = 'void (anonymous namespace)::lr_tile_kernel(uint4 const*, ...)'
LR_OLD = 'void (anonymous namespace)::lr_kernel(uint4 const*, ...)'
LR_BIDIR = 'void (anonymous namespace)::lr_bidir_kernel(uint4 const*, ...)'


def test_per_launch_ms_reads_one_kernel():
    """The device time per launch of the kernels a pattern names, from the
    profiler's events: the median launch, so a few launches recorded with
    a wrong time move it little; host-side records of the same name, other
    kernels (lr_bidir beside lr) and copies do not count; no match is
    (None, 0)."""
    events = (_events(LR_TILE, [15.0] * 17 + [2.0, 3.0, 90.0])
              + _events(LR_TILE, [9e3] * 20, device=False)
              + _events(LR_BIDIR, [10.0] * 5) + _events(COPY, [7.0]))
    assert chip_smoke.per_launch_ms(events, chip_smoke.LR_KERNEL) \
        == (0.015, 20)
    assert chip_smoke.per_launch_ms(events, 'lr_kernel') == (None, 0)
    assert chip_smoke.per_launch_ms(events, 'lr_bidir_kernel') == (0.01, 5)


@pytest.mark.parametrize('name,hit', [(LR_TILE, True), (LR_OLD, True),
                                      (LR_BIDIR, False)])
def test_lr_kernel_patterns(name, hit):
    """LR_ANY_KERNEL names row 8's kernel in this tree (the tile kernel)
    and in a checkout before it, and not row 5's."""
    assert bool(re.search(chip_smoke.LR_ANY_KERNEL, name)) == hit
    assert bool(re.search(chip_smoke.LR_KERNEL, name)) == (name == LR_TILE)


def test_gemm_pattern_names_only_products():
    """``GEMM_KERNEL`` (the channels-major tail's upsampler GEMM in the
    profiler) matches cuBLAS's and CUTLASS's product kernels, not the
    copies and elementwise kernels around them."""
    for name in (GEMM, 'nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN',
                 'sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256',
                 'void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>'):
        assert re.search(chip_smoke.GEMM_KERNEL, name), name
    for name in (COPY, EW, EW2,
                 'void at::native::(anonymous namespace)::CatArrayBatched'
                 'Copy<...>', 'void at::native::unrolled_elementwise_kernel'):
        assert not re.search(chip_smoke.GEMM_KERNEL, name), name


def test_melgan_checkpoint_is_the_published_format(tmp_path):
    """``write_melgan_checkpoint`` writes seungwonpark/melgan's format (the
    ``Sequential``'s keys, weight-normed, under 'model_g') that
    ``load_melgan`` reads back as the seeded generator."""
    import torch

    from forwardtacotron_torch.models.vocoder import MelGANGenerator
    from forwardtacotron_torch.utils.vocoder_checkpoints import load_melgan
    path = tmp_path / 'melgan.pt'
    chip_smoke.write_melgan_checkpoint(torch, path, 8)
    sd = torch.load(str(path))['model_g']
    assert {'generator.1.weight_g', 'generator.1.weight_v',
            'generator.3.weight_v', 'generator.4.blocks.2.2.weight_g',
            'generator.13.shortcuts.0.bias',
            'generator.16.weight_v'} <= set(sd)
    assert len(sd) == 3 * 2 + 4 * (3 + 9 * 3)    # (g, v, bias) per conv
    torch.manual_seed(chip_smoke.SEED)
    want = MelGANGenerator(mel_channels=8).eval()
    got = load_melgan(str(path), device='cpu')
    mel = torch.randn(1, 6, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(got(mel), want(mel), atol=1e-5,
                                   rtol=1e-4)
