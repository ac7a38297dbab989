"""chip_smoke.py's Griffin-Lim profiler check, fed with counts on the CPU.

On the card the check profiles ``griffin_lim_fused`` at 2 and at 4
iterations, each several times, keeps per device-event name the largest
count over the runs (``most_recorded``) and fails unless the 4-iteration
run adds exactly the 4 ``gl_gemm_kernel`` launches of its 2 more iterations
and nothing else (``gl_iteration_extra_work``). These tests hold both
functions to that with counts shaped as the card records them: 5 host to
device copies, 2 cuBLAS products and 19 elementwise kernels around the
iterations.
"""

import collections

import pytest

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
    maximum, and so the check, unchanged; an op that every 4-iteration run
    adds per iteration still fails it, whichever run loses a record."""
    lost = _call(4) - collections.Counter({COPY: 1})
    at_4 = chip_smoke.most_recorded([_call(4), lost, _call(4)])
    assert at_4 == _call(4)
    assert chip_smoke.gl_iteration_extra_work(_call(2), at_4) == []
    leftover = [_call(4, edge=4), _call(4, edge=4) - collections.Counter(
        {EW: 1}), _call(4, edge=4)]
    at_2 = chip_smoke.most_recorded([_call(2, edge=2)] * 3)
    extra = chip_smoke.gl_iteration_extra_work(
        at_2, chip_smoke.most_recorded(leftover))
    assert extra == ['edge: 2 at 2 iterations, 4 at 4']
