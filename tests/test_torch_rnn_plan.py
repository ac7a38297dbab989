"""The launch plan of rnn.cu's step-major recurrences (``rnn.plan``), which
needs no card: at an H100's 132 SMs and 232,448 B of opt-in shared memory,
for the shapes the serving, request and training paths give the five
modes of the step-major kernel, the carve fits, the grid is resident, every
batch row falls in exactly one tile of one group, and a launch takes T
barrier rounds. The multi-GRU's recurrence (``gru_xp``) and the LSTMs
(``lstm``, ``lstm_train``) are planned at every shape the tile-major
kernel they replaced took.
"""

import pytest
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.ops.hopper import rnn

H100_SMS = 132
H100_SMEM = 232_448

# (mode, B, T, I, H, M): serving (batch 4096) rows 6 and 7, the request
# shapes (batch 1, budget 896), the train step's GRU forwards (batch 32:
# pitch and prenet over 160 tokens, postnet over 1024 frames), and the
# narrow widths the card tests use, across tile and group boundaries
SHAPES = [
    ('lstm_mel', 4096, 256, 512, 512, 80),
    ('gru', 4096, 256, 256, 256, 0),
    ('lstm_mel', 1, 896, 512, 512, 80),
    ('gru', 1, 896, 256, 256, 0),
    ('gru', 32, 160, 256, 128, 0),
    ('gru', 32, 160, 256, 256, 0),
    ('gru', 32, 1024, 256, 256, 0),
    ('lstm_mel', 257, 37, 512, 512, 80),
    ('gru', 65, 2, 256, 256, 0),
    ('gru', 1100, 1, 64, 128, 0),
    ('lstm_mel', 17, 37, 128, 128, 80),
    # widths where the preferred slice leaves too few ring stages, and the
    # ones where it leaves the fewest the kernel takes
    ('gru', 4096, 256, 256, 512, 0),
    ('lstm_mel', 4096, 256, 768, 512, 80),
    ('gru', 4096, 256, 256, 1024, 0),
    ('gru', 1, 896, 256, 1024, 0),
    ('gru', 1100, 37, 192, 512, 0),
    ('lstm_mel', 1100, 37, 640, 512, 80),
    # the multi-GRU (token GRUs 64 + 128 + 64 + prenet 256) at serving and
    # at a request, and the widest the tile-major kernel took
    ('gru_xp', 4096, 81, 0, 512, 0),
    ('gru_xp', 1, 92, 0, 512, 0),
    ('gru_xp', 4096, 81, 0, 1056, 0),
    ('gru_xp', 65, 2, 0, 128, 0),
    # the LSTM body and the LSTM forward with cells: the bf16 train step
    # (batch 32, 928 frames), a request (batch 1, budget 896), batches of
    # several tiles and groups (130: three tiles in two groups; 4096), and
    # input widths other than H
    ('lstm_train', 32, 928, 512, 512, 0),
    ('lstm', 32, 928, 512, 512, 0),
    ('lstm', 1, 896, 512, 512, 0),
    ('lstm_train', 1, 896, 512, 512, 0),
    ('lstm', 130, 37, 512, 512, 0),
    ('lstm_train', 130, 37, 512, 512, 0),
    ('lstm', 4096, 3, 512, 512, 0),
    ('lstm_train', 4096, 3, 512, 512, 0),
    ('lstm_train', 32, 928, 1024, 256, 0),
    ('lstm', 130, 37, 64, 128, 0),
    ('lstm_train', 17, 65, 128, 256, 0),
    ('lstm', 1100, 2, 768, 512, 0),
]

# (mode, B, T, I, H, M) -> (unit, warpgroups, stages): the slice and rings
# that plan falls back to where its first choice does not fit, and the
# shapes that leave exactly MIN_STAGES
FALLBACKS = {
    # 32 units x 2 rings leave 2 stages: 16 units
    ('gru', 4096, 256, 256, 512, 0): (16, 2, 8),
    # 2 rings leave 2 stages: one warpgroup, 5 stages
    ('lstm_mel', 4096, 256, 768, 512, 80): (16, 1, 5),
    # 32 units do not fit beside any ring: 16 units (a width the tile-major
    # kernel took at serving batch)
    ('gru', 4096, 256, 256, 1024, 0): (16, 2, 4),
    # 8 units make 256 CTAs, more than the SMs: 16 units
    ('gru', 1, 896, 256, 1024, 0): (16, 1, 8),
    ('gru', 1100, 37, 192, 512, 0): (32, 2, 3),
    ('lstm_mel', 1100, 37, 640, 512, 80): (16, 2, 3),
}


def _carve(p, i_dim, h, xp=False):
    """rnn.cu step_carve, summed from its parts: the weight slice (K padded
    to whole chunks, 4 gate blocks and the mel columns; gru_xp 3 gate
    blocks), the biases, the rings' full and empty barriers, gru_xp's gx
    slots and their barriers, a ring per warpgroup and the alignment
    slack."""
    def a128(n):
        return -(-n // 128) * 128

    def pad(n):
        return -(-n // p['chunk']) * p['chunk']
    cols = 3 * p['unit'] if xp else 4 * p['unit'] + p['mel_cols']
    gx = (128 + p['warpgroups'] * rnn.GX_SLOTS * 3 * p['tile'] * p['unit']
          * 2) if xp else 0
    return (a128((pad(i_dim) + pad(h)) * cols * 2) + a128(2 * 4 * p['unit'] * 4)
            + a128(32 * rnn.MAX_STAGES) + gx + 1024
            + p['warpgroups'] * p['stages'] * p['tile'] * p['chunk'] * 2)


@pytest.mark.parametrize('mode,batch,t_len,i_dim,h,m', SHAPES)
def test_plan_fits_and_covers(mode, batch, t_len, i_dim, h, m):
    p = rnn.plan(mode, batch, t_len, i_dim, h, m, H100_SMS, H100_SMEM)
    _check_plan(p, mode, batch, t_len, i_dim, h, m)
    if (mode, batch, t_len, i_dim, h, m) not in FALLBACKS:
        assert p['warpgroups'] == (2 if p['tiles_per_group'] >= 2 else 1)


def _check_plan(p, mode, batch, t_len, i_dim, h, m):
    # the carve fits, and is the kernel's sum with at least three stages
    # (with two the producer and the consumers wait for each other)
    assert p['smem'] == _carve(p, i_dim, h, mode == 'gru_xp') <= H100_SMEM
    assert rnn.MIN_STAGES == 3
    assert rnn.MIN_STAGES <= p['stages'] <= rnn.MAX_STAGES
    # 64-row tiles; two warpgroups on alternate tiles where a group has two
    # and their rings fit, else one
    assert p['tile'] == 64
    assert p['warpgroups'] in (1, 2)
    assert p['warpgroups'] == 1 or p['tiles_per_group'] >= 2
    # resident: one CTA per SM, H / unit CTAs per direction and group
    s, dirs, groups = p['grid']
    assert s * p['unit'] == h and dirs == 2 and groups == p['groups']
    assert s * dirs * groups <= H100_SMS
    assert p['cluster'] == 1
    # every row in exactly one tile of one group; tile k in group k mod R
    tile, n_tiles = p['tile'], -(-batch // p['tile'])
    owner = [None] * batch
    for g in range(groups):
        tiles = range(g, n_tiles, groups)
        assert 1 <= len(tiles) <= p['tiles_per_group']
        for k in tiles:
            for b in range(k * tile, min(batch, (k + 1) * tile)):
                assert owner[b] is None
                owner[b] = g
    assert None not in owner
    # one barrier round per time step, whatever the batch
    assert p['rounds'] == t_len
    if mode == 'lstm_mel':
        # the fewest wgmma-wide (8) columns per CTA that cover M
        assert p['mel_cols'] % 8 == 0 and s * p['mel_cols'] >= m
        assert s * (p['mel_cols'] - 8) < m


@pytest.mark.parametrize('batch', [1, 3, 64, 4096, 8192])
@pytest.mark.parametrize('h', [128, 256, 384, 512, 640, 768, 896, 1024])
def test_gru_xp_plan_covers_the_serving_grid(batch, h):
    """The multi-GRU's step-major plan at every width of 128 to 1024 and
    batches from one row to two serving batches: the serving width (512)
    takes 32-unit slices (wgmma N = 96, a 96 KB weight slice) and 4 groups
    of 32 CTAs at batch 4096, as the tile-major kernel's replacement."""
    p = rnn.plan('gru_xp', batch, 81, 0, h, 0, H100_SMS, H100_SMEM)
    _check_plan(p, 'gru_xp', batch, 81, 0, h, 0)
    assert p['mel_cols'] == 0
    if (batch, h) == (4096, 512):
        assert (p['unit'], p['groups'], p['warpgroups']) == (32, 4, 2)
        assert 3 * p['unit'] * (h // 64) * 64 * 2 == 96 * 1024


@pytest.mark.parametrize('batch', [1, 3, 17, 64, 65, 4096, 8192])
def test_gru_xp_plan_takes_every_tile_major_width(batch):
    """Every (B, H) the tile-major rnn_kernel<MODE_GRU_XP> took -- H a
    multiple of 16, 16 to 1056 (its 16-unit CTAs, 2 H/16 of them, had to be
    resident) -- has a step-major plan, so no shape that ran before raises
    now; H = 1072 is refused by both."""
    for h in range(16, 1057, 16):
        p = rnn.plan('gru_xp', batch, 3, 0, h, 0, H100_SMS, H100_SMEM)
        _check_plan(p, 'gru_xp', batch, 3, 0, h, 0)
    with pytest.raises(ValueError, match='CTAs > 132 SMs'):
        rnn.plan('gru_xp', batch, 3, 0, 1072, 0, H100_SMS, H100_SMEM)


@pytest.mark.parametrize('shape', sorted(FALLBACKS))
def test_plan_falls_back(shape):
    """Where the first slice width leaves fewer than MIN_STAGES stages or
    more CTAs than SMs, plan takes the next width, then one warpgroup."""
    p = rnn.plan(*shape, H100_SMS, H100_SMEM)
    assert (p['unit'], p['warpgroups'], p['stages']) == FALLBACKS[shape]


@pytest.mark.parametrize('case', ['mode', 'carve', 'mel', 'sms', 'xp_in'])
def test_plan_refuses(case):
    """Shapes the step-major kernel cannot take raise ValueError: a mode it
    does not have (the LSTM's backward sweep is rnn_bwd.cu's), a carve
    over the limit, more than 16 mel columns per CTA, more CTAs per group
    than the card has SMs, an input width for gru_xp (whose input is the
    projection)."""
    args = {'mode': ('lstm_bwd', 4, 3, 128, 128, 0, H100_SMS, H100_SMEM),
            'carve': ('lstm_mel', 4, 3, 2048, 512, 80, H100_SMS, H100_SMEM),
            'mel': ('lstm_mel', 4, 3, 128, 128, 200, H100_SMS, H100_SMEM),
            'sms': ('gru', 4, 3, 256, 256, 0, 8, H100_SMEM),
            'xp_in': ('gru_xp', 4, 3, 64, 128, 0, H100_SMS, H100_SMEM)}[case]
    match = {'mode': 'no step-major kernel', 'carve': r'\d+ B\)',
             'mel': 'mel columns', 'sms': 'CTAs > 8 SMs',
             'xp_in': 'in_dim 0'}[case]
    with pytest.raises(ValueError, match=match):
        rnn.plan(*args)


@pytest.mark.parametrize('mode', ['lstm', 'lstm_train'])
@pytest.mark.parametrize('batch,unit,warpgroups,groups', [
    (1, 8, 1, 1), (32, 8, 1, 1), (64, 8, 1, 1), (65, 8, 2, 1),
    (130, 16, 2, 2), (4096, 16, 2, 2)])
def test_lstm_plan_slices(mode, batch, unit, warpgroups, groups):
    """The LSTMs at I = H = 512: at one 64-row tile (a request, the bf16
    train step's batch 32) the narrow slice first, 8 units (wgmma N = 32,
    a 64 KB weight slice, 2 x 64 CTAs: more SMs and a shorter step than 16
    units); at two tiles two consumer warpgroups on that slice before a
    wider one; from three tiles 16 units (32 units, a 256 KB slice, do not
    fit) in as many groups as the SMs hold, two consumer warpgroups where a
    group has two tiles."""
    p = rnn.plan(mode, batch, 928, 512, 512, 0, H100_SMS, H100_SMEM)
    _check_plan(p, mode, batch, 928, 512, 512, 0)
    assert (p['unit'], p['warpgroups'], p['groups']) == (unit, warpgroups,
                                                         groups)
    assert p['grid'] == (512 // unit, 2, groups)
    if unit == 8:
        assert 4 * unit * 1024 * 2 == 64 * 1024 and p['stages'] == 8


def _tile_major_admits(i_dim, h, n_sm=H100_SMS, smem_limit=H100_SMEM):
    """Whether the tile-major rnn_kernel the LSTMs ran before took (I, H):
    16-unit CTAs whose carve at its smallest batch tile (16 rows: the
    [I+H, 64 + 8] weight slice, the [16, I+H+8] staged rows, f32 sums, c
    and bias, each 128-byte aligned) fits the opt-in limit, and 2 H / 16
    CTAs resident -- counted here as generously as the SM's 228 KB and
    2048 threads allow (at most 8 CTAs of 256 threads), so the set is a
    superset of what the launch took."""
    def a128(n):
        return -(-n // 128) * 128
    if h % 16 or i_dim % 16:
        return False
    ka = i_dim + h
    carve = (a128(ka * 72 * 2) + a128(16 * (ka + 8) * 2) + a128(16 * 64 * 4)
             + a128(16 * 16 * 4) + a128(64 * 4))
    if carve > smem_limit:
        return False
    per_sm = min(8, 233_472 // (carve + 1024))
    return 2 * (h // 16) <= per_sm * n_sm


@pytest.mark.parametrize('mode', ['lstm', 'lstm_train'])
@pytest.mark.parametrize('batch', [1, 32, 130, 4096])
def test_lstm_plan_takes_every_tile_major_shape(mode, batch):
    """Every (B, I, H) the tile-major rnn_kernel<MODE_LSTM_X /
    MODE_LSTM_TRAIN> took has a step-major plan that fits, so no shape that
    ran before raises now; H = 1072, the first width it refused at every
    I (2 x 67 CTAs), is refused by both."""
    taken = 0
    for i_dim in range(0, 1409, 16):
        for h in range(16, 1073, 16):
            if not _tile_major_admits(i_dim, h):
                continue
            taken += 1
            p = rnn.plan(mode, batch, 3, i_dim, h, 0, H100_SMS, H100_SMEM)
            assert p['smem'] == _carve(p, i_dim, h) <= H100_SMEM
            assert p['stages'] >= rnn.MIN_STAGES
            assert p['grid'][0] * p['unit'] == h
            assert p['grid'][0] * 2 * p['groups'] <= H100_SMS
    assert taken > 2000
    assert not any(_tile_major_admits(i_dim, 1072)
                   for i_dim in range(16, 1409, 16))
    assert _tile_major_admits(16, 1056) and _tile_major_admits(1264, 16)
    for i_dim in (16, 512):
        with pytest.raises(ValueError, match='CTAs > 132 SMs'):
            rnn.plan(mode, batch, 3, i_dim, 1072, 0, H100_SMS, H100_SMEM)
