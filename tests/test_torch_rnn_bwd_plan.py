"""rnn_bwd.cu's order of operations and launch plans, without a card.

The model below walks the two launches of one backward sweep as the kernels
do, in plain torch: the gate recompute hoisted out of the time loop (one
product per direction over all steps, tile by tile, with the weights as
``rnn_train.pack_gate_weights`` packs them), its epilogue's float32
coefficients in the layout ``rnn_train.coef_shape`` gives, and the reverse
walk that forms each step's dgates from those coefficients and the carried
dh (and dc) and adds dgates_t @ Wh^T as two warpgroups' halves of the K
chunks. It is held to the twins (``rnn_train.gru_bwd_plain`` /
``lstm_bwd_plain``) and, through the weight and bias gradients the JAX
package forms from dgates, to the Pallas kernels in interpret mode.

Tolerances: float32, 1e-4 of the scale max(1, max |want|) (the JAX
package's kernel-vs-scan gradient tolerance; the model multiplies the
coefficients in another order than the twin and sums the products in
chunks). bfloat16 (the kernel's own rounding points: dgates rounded where
the twin rounds them, the exchange reading the rounded values), chip_smoke's
sweep check: each gate block within a third of SWEEP_TOL relative L2.

The plans, at an H100's 132 SMs and 232,448 B of opt-in shared memory: at
every width the published config uses the carves fit and are the kernel's
sums, the grid is resident, every batch row and step falls in one tile,
and every (I, H) the previous kernel took still has a plan.
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.ops.hopper import rnn, rnn_train

H100_SMS = 132
H100_SMEM = 232_448
F32_TOL = 1e-4


def _round(n, m):
    return -(-n // m) * m


def _gate_product(cell, hs, cs, dhs, x2, wi, wh, biases, p):
    """bwd_gates_kernel: per direction and 64-row tile (``rows`` batch rows
    x ``steps`` steps), A = [x_t | h_{t-1}] (I and H each padded to the
    chunk) times the packed weights, then the epilogue's coefficients into
    [T, 2, H/16, B, NK, 16]."""
    f = torch.float32
    t_len, _, batch, i_dim = x2.shape
    h = wh.shape[1]
    lstm = cell == 'lstm'
    wpk = rnn_train.pack_gate_weights(cell, wi, wh).float()
    ip = _round(i_dim, rnn_train.CHUNK)
    coef = torch.full(rnn_train.coef_shape(cell, t_len, batch, h),
                      float('nan'))
    bb, tb = p['rows'], p['steps']
    nbb = -(-batch // bb)
    unit_of = [(n // rnn_train.GATE_N) * rnn_train.GATE_UNITS
               + n % rnn_train.GATE_UNITS for n in range(p['n_cols'])]
    for d in range(2):
        for mt in range(p['m_tiles']):
            t0, b0 = (mt // nbb) * tb, (mt % nbb) * bb
            rows = [(t0 + r // bb, b0 + r % bb) for r in range(bb * tb)]
            rows = [(t, b) for t, b in rows if t < t_len and b < batch]
            a = torch.zeros(len(rows), p['k'])
            for n, (t, b) in enumerate(rows):
                a[n, :i_dim] = x2[t, d, b].float()
                if t > 0:
                    a[n, ip:ip + h] = hs[t - 1, d, b].float()
            acc = a @ wpk[d].T                        # [rows, n_cols]
            # columns [tile][gate][unit] -> [gate][unit] per row
            gates = torch.zeros(len(rows), 4, h)
            for n in range(p['n_cols']):
                if unit_of[n] < h:
                    gates[:, (n % rnn_train.GATE_N) // rnn_train.GATE_UNITS,
                          unit_of[n]] = acc[:, n]
            for n, (t, b) in enumerate(rows):
                g = gates[n]
                dh = dhs[t, d, b].float()
                if lstm:
                    bias = biases[0][d].float().view(4, h)
                    i, fg, o = (torch.sigmoid(g[k] + bias[k]) for k in (0, 1, 3))
                    gg = torch.tanh(g[2] + bias[2])
                    tc = torch.tanh(cs[t, d, b].float())
                    c_prev = cs[t - 1, d, b].float() if t else torch.zeros(h)
                    co = [dh, o * (1 - tc * tc), gg * i * (1 - i),
                          c_prev * fg * (1 - fg), i * (1 - gg * gg),
                          tc * o * (1 - o), fg]
                else:
                    bi, bh = (x[d].float().view(3, h) for x in biases)
                    r = torch.sigmoid(g[0] + bi[0] + bh[0])
                    z = torch.sigmoid(g[1] + bi[1] + bh[1])
                    hn = g[3] + bh[2]
                    nn_ = torch.tanh(g[2] + bi[2] + r * hn)
                    h_prev = hs[t - 1, d, b].float() if t else torch.zeros(h)
                    an = (1 - z) * (1 - nn_ * nn_)
                    co = [dh, an * hn * r * (1 - r), (h_prev - nn_) * z * (1 - z),
                          an, an * r, z]
                coef[t, d, :, b] = torch.stack(co).view(
                    len(co), h // rnn_train.UNIT, rnn_train.UNIT).transpose(0, 1)
    return coef


def _reverse_walk(cell, coef, wh, dtype, p):
    """bwd_sweep_kernel: per direction and 64-row batch tile, from t = T-1
    down: dgates from the coefficient block, dhs and the carry, rounded to
    dtype; then dgates_t @ Wh^T over the K chunks, warpgroup 0's first half
    plus warpgroup 1's second half, as the carry of step t-1."""
    t_len, _, s_n, batch, nk, u = coef.shape
    h = s_n * u
    lstm = cell == 'lstm'
    ng = 4 if lstm else 3
    g = ng * h
    gp = _round(g, rnn_train.CHUNK)
    whp = torch.zeros(2, h, gp)
    whp[:, :, :g] = wh.float()
    dgx = torch.full((t_len, 2, batch, g), float('nan'), dtype=dtype)
    dgh = None if lstm else torch.full_like(dgx, float('nan'))
    exch = dgx if lstm else dgh
    nch = gp // rnn_train.CHUNK
    halves = [range(0, (nch + 1) // 2), range((nch + 1) // 2, nch)]
    tile = p['tile']
    for d in range(2):
        for b0 in range(0, batch, tile):
            rows = slice(b0, min(batch, b0 + tile))
            n = rows.stop - b0
            carry = torch.zeros(n, h)
            dc = torch.zeros(n, h)
            prod = torch.zeros(n, h)
            for t in range(t_len - 1, -1, -1):
                c = coef[t, d, :, rows].permute(2, 1, 0, 3).reshape(nk, n, h)
                dh = c[0] + (carry + prod)
                if lstm:
                    dct = dh * c[1] + dc
                    gv = [dct * c[2], dct * c[3], dct * c[4], dh * c[5]]
                    dc = dct * c[6]
                else:
                    gv = [dh * c[1], dh * c[2], dh * c[3], dh * c[4]]
                    carry = dh * c[5]
                dgx[t, d, rows] = torch.cat(gv[:ng], -1).to(dtype)
                if not lstm:
                    dgh[t, d, rows] = torch.cat([gv[0], gv[1], gv[3]],
                                                -1).to(dtype)
                if t > 0:
                    e = torch.zeros(n, gp)
                    e[:, :g] = exch[t, d, rows].float()
                    k = rnn_train.CHUNK
                    prod = sum(sum((e[:, q * k:(q + 1) * k]
                                    @ whp[d, :, q * k:(q + 1) * k].T
                                    for q in half), torch.zeros(n, h))
                               for half in halves)
    return [dgx] if lstm else [dgx, dgh]


def _model(cell, args, dtype):
    if cell == 'lstm':
        dhs, hs, cs, x2, wi, wh, b = args
        biases = (b,)
    else:
        dhs, hs, x2, wi, wh, bi, bh = args
        cs, biases = None, (bi, bh)
    t_len, _, batch, i_dim = x2.shape
    p = rnn_train.plan(cell, batch, t_len, i_dim, wh.shape[1], H100_SMS,
                       H100_SMEM)
    coef = _gate_product(cell, hs, cs, dhs, x2, wi, wh, biases, p['gates'])
    assert not torch.isnan(coef).any()      # every (t, d, b, unit) written
    return _reverse_walk(cell, coef, wh, dtype, p['sweep'])


def _inputs(cell, t_len, batch, i_dim, h, dtype, seed=0):
    """Seeded numpy inputs; the forward's saved states from the twins."""
    rs = np.random.RandomState(seed)
    ng = 4 if cell == 'lstm' else 3

    def arr(shape, scale):
        return torch.from_numpy(
            (scale * rs.randn(*shape)).astype(np.float32)).to(dtype)
    wi, wh = arr((2, i_dim, ng * h), i_dim ** -0.5), arr((2, h, ng * h),
                                                         h ** -0.5)
    bi, bh = arr((2, ng * h), 0.1), arr((2, ng * h), 0.1)
    x2 = arr((t_len, 2, batch, i_dim), 0.5)
    dhs = arr((t_len, 2, batch, h), 1.0)
    if cell == 'lstm':
        hs, cs = rnn.lstm_train_plain(x2, wi, wh, bi + bh)
        return (dhs, hs, cs, x2, wi, wh, bi + bh)
    return (dhs, rnn.gru_plain(x2, wi, wh, bi, bh), x2, wi, wh, bi, bh)


def _close(got, want, tol, name):
    for g, w in zip(got, want):
        scale = max(1.0, float(w.float().abs().max()))
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


# (cell, T, B, I, H): one step, a batch that fills 64-row tiles with 12
# steps each, one that is two batch tiles (the sweep walks them in turn),
# H not a multiple of the gate tile's 32 units nor G of the 64-wide chunk
MODEL_SHAPES = [('gru', 1, 3, 32, 48), ('gru', 9, 5, 32, 48),
                ('gru', 7, 70, 16, 32), ('lstm', 1, 3, 16, 16),
                ('lstm', 9, 5, 48, 32), ('lstm', 6, 65, 32, 16)]


@pytest.mark.parametrize('cell,t_len,batch,i_dim,h', MODEL_SHAPES)
def test_model_matches_twin_f32(cell, t_len, batch, i_dim, h):
    args = _inputs(cell, t_len, batch, i_dim, h, torch.float32)
    twin = (rnn_train.lstm_bwd_plain if cell == 'lstm'
            else rnn_train.gru_bwd_plain)(*args)
    want = [twin] if cell == 'lstm' else list(twin)
    _close(_model(cell, args, torch.float32), want, F32_TOL, cell)


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
def test_model_matches_twin_bf16(cell):
    """The kernel's rounding points in bf16: within the card's sweep check
    of the twin, with room to spare."""
    import chip_smoke

    args = _inputs(cell, 13, 6, 32, 32, torch.bfloat16, seed=2)
    twin = (rnn_train.lstm_bwd_plain if cell == 'lstm'
            else rnn_train.gru_bwd_plain)(*args)
    want = [twin] if cell == 'lstm' else list(twin)
    rel, _ = chip_smoke.sweep_error(_model(cell, args, torch.bfloat16), want,
                                    4 if cell == 'lstm' else 3)
    assert rel <= chip_smoke.SWEEP_TOL / 3, rel


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
def test_model_matches_pallas_f32(cell):
    """Through what the JAX package forms from dgates (dx2, dwi, dwh, the
    bias gradients), the model against _gru_core_bwd / _lstm_core_bwd with
    the Pallas kernels in interpret mode."""
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas import rnn_train as jrt

    t_len, batch, i_dim, h = 7, 16, 32, 128   # the JAX cores take B % 16 == 0
    args = _inputs(cell, t_len, batch, i_dim, h, torch.float32, seed=1)
    j = [jnp.asarray(a.numpy()) for a in args]
    if cell == 'lstm':
        dhs, hs, cs, x2, wi, wh, b = j
        want = jrt._lstm_core_bwd(h, True, (x2, wi, wh, b, hs, cs), dhs)
        dgx = dgh = _model(cell, args, torch.float32)[0]
    else:
        dhs, hs, x2, wi, wh, bi, bh = j
        want = jrt._gru_core_bwd(h, True, (x2, wi, wh, bi, bh, hs), dhs)
        dgx, dgh = _model(cell, args, torch.float32)
    x2t, wit = args[-4], args[-3]     # x2, wi (the LSTM's args end in b)
    if cell == 'gru':
        x2t, wit = args[2], args[3]
    dx2, dwi, dwh = rnn_train._weight_grads(
        x2t, rnn_train._zero_first(args[1]), dgx, dgh, wit)
    got = [dx2, dwi, dwh, dgx.sum((0, 2))]
    if cell == 'gru':
        got.append(dgh.sum((0, 2)))
    _close(got, [torch.from_numpy(np.array(w)) for w in want], F32_TOL,
           cell)


# ----------------------------------------------------------------- plans


# the published config's recurrences in the bf16 train step (batch 32: the
# pitch and prenet GRUs over 160 tokens, H 128 / 256, the postnet GRU over
# 1024 frames, the bi-LSTM I = H = 512) and the card tests' shapes, across
# batch tiles and groups
PLAN_SHAPES = [('gru', 32, 160, 256, 128), ('gru', 32, 160, 256, 256),
               ('gru', 32, 1024, 256, 256), ('lstm', 32, 1024, 512, 512),
               ('gru', 1, 1, 256, 128), ('gru', 17, 161, 64, 128),
               ('gru', 33, 2, 256, 256), ('gru', 64, 161, 256, 512),
               ('lstm', 1, 2, 512, 512), ('lstm', 17, 161, 64, 128),
               ('lstm', 33, 1, 512, 256), ('lstm', 64, 161, 512, 512),
               ('gru', 4096, 5, 256, 256), ('lstm', 4096, 5, 512, 512),
               ('lstm', 3, 2, 1024, 1024)]


def _sweep_carve(cell, h, rows, stages):
    """rnn_bwd.cu sweep_carve, from its parts: the Wh rows (G padded to a
    chunk), two coefficient blocks of ``rows`` rows, warpgroup 1's partial
    sums, the mbarriers, two rings of [rows, 64] stages, the alignment
    slack and the tail the last stage's 64-row tile reads past its rows."""
    g = rnn_train.N_GATES[cell] * h
    return (_round(16 * _round(g, 64) * 2, 128)
            + 2 * rows * rnn_train.N_COEF[cell] * 16 * 4 + 8 * 128 * 4
            + _round((4 * rnn_train.MAX_STAGES + 4) * 8, 128) + 1024
            + (2 * stages * rows + 64 - rows) * 64 * 2)


@pytest.mark.parametrize('cell,batch,t_len,i_dim,h', PLAN_SHAPES)
def test_plan_fits_and_covers(cell, batch, t_len, i_dim, h):
    p = rnn_train.plan(cell, batch, t_len, i_dim, h, H100_SMS, H100_SMEM)
    gates, sweep = p['gates'], p['sweep']
    # the gate product: its carve, stages, and every (step, row) in one tile
    assert gates['smem'] == 128 + 1024 + gates['stages'] * rnn_train.GATE_STAGE
    assert gates['smem'] <= H100_SMEM
    assert rnn_train.GATE_MIN_STAGES <= gates['stages'] <= \
        rnn_train.GATE_MAX_STAGES
    bb, tb = gates['rows'], gates['steps']
    assert bb * tb <= 64 and bb == min(batch, 64)
    nbb = -(-batch // bb)
    seen = np.zeros((t_len, batch), int)
    for mt in range(gates['m_tiles']):
        t0, b0 = (mt // nbb) * tb, (mt % nbb) * bb
        seen[t0:t0 + tb, b0:b0 + bb] += 1
    assert (seen == 1).all()
    assert gates['n_tiles'] * 32 >= h > (gates['n_tiles'] - 1) * 32
    assert gates['grid'] == gates['n_tiles'] * 2 * -(-gates['m_tiles'] // 2)
    assert gates['k'] == _round(i_dim, 64) + _round(h, 64)
    # the sweep: the carve fits and is the kernel's sum, the grid resident
    assert sweep['rows'] == (64 if batch >= 64 else _round(batch, 8))
    assert sweep['unit'] == 16
    assert sweep['smem'] == _sweep_carve(cell, h, sweep['rows'],
                                         sweep['stages']) <= H100_SMEM
    assert rnn_train.MIN_STAGES <= sweep['stages'] <= rnn_train.MAX_STAGES
    s, dirs, groups = sweep['grid']
    assert s * 16 == h and dirs == 2 and s * dirs * groups <= H100_SMS
    n_tiles = -(-batch // 64)
    assert 1 <= groups <= n_tiles
    assert sweep['tiles_per_group'] == -(-n_tiles // groups)
    assert sweep['rounds'] == sweep['tiles_per_group'] * (t_len - 1)


def _old_kernel_took(cell, i_dim, h):
    """Whether the previous rnn_bwd.cu (one kernel, the gate slice [I+H,
    NG*16] and a staged [16, max(I+H, G)] row block in shared memory,
    H/16 CTAs per direction, up to eight CTAs per SM) launched (I, H) on an
    H100."""
    lstm = cell == 'lstm'
    ng = 4 if lstm else 3
    nc, ka, g = ng * 16, i_dim + h, ng * h

    def a128(n):
        return _round(n, 128)
    total = (a128(ka * (nc + 8) * 2) + a128(16 * (max(ka, g) + 8) * 2)
             + a128(max(16 * nc * 4 * (1 if lstm else 2), 8 * 256 * 4))
             + a128(16 * 16 * 4) * (2 if lstm else 1) + a128(2 * nc * 4))
    per_sm = min(8, H100_SMEM // total)
    return per_sm >= 1 and per_sm * H100_SMS >= 2 * (h // 16)


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
@pytest.mark.parametrize('i_dim', [16, 64, 256, 512, 1024])
def test_plan_takes_every_old_shape(cell, i_dim):
    """Every (I, H), H a multiple of 16, that the previous kernel launched
    has a plan (the sweep does not depend on I, the gate product takes any
    I in chunks); the widest the new sweep takes is H = 1056 (132 CTAs)."""
    took = 0
    for h in range(16, 1057, 16):
        if _old_kernel_took(cell, i_dim, h):
            took += 1
            for batch in (1, 32, 65):
                rnn_train.plan(cell, batch, 3, i_dim, h, H100_SMS, H100_SMEM)
    assert took > 0
    with pytest.raises(ValueError, match='more than 132 SMs'):
        rnn_train.plan(cell, 4, 3, i_dim, 1072, H100_SMS, H100_SMEM)


@pytest.mark.parametrize('case', ['cell', 'width', 'sms', 'smem'])
def test_plan_refuses(case):
    """What the kernels cannot take raises ValueError: another cell, a
    width that is not a multiple of 16, more CTAs per direction than SMs,
    a Wh slice that leaves no room for the rings."""
    args = {'cell': ('rnn', 4, 3, 64, 128, H100_SMS, H100_SMEM),
            'width': ('gru', 4, 3, 40, 128, H100_SMS, H100_SMEM),
            'sms': ('gru', 4, 3, 256, 256, 8, H100_SMEM),
            'smem': ('lstm', 4, 3, 512, 2048, 512, H100_SMEM)}[case]
    match = {'cell': 'no backward sweep', 'width': 'multiple of 16',
             'sms': 'more than 8 SMs', 'smem': 'shared memory'}[case]
    with pytest.raises(ValueError, match=match):
        rnn_train.plan(*args)


def test_packed_weights_hold_each_gate_column():
    """pack_gate_weights: column [tile][gate][unit] of direction d holds
    the weights of that gate and unit, the GRU's n_x only its x rows and
    n_h only its h rows, zeros in the padding."""
    h, i_dim = 48, 24
    for cell in ('gru', 'lstm'):
        ng = rnn_train.N_GATES[cell]
        wi = torch.arange(2 * i_dim * ng * h, dtype=torch.float32).view(
            2, i_dim, ng * h) + 1
        wh = -torch.arange(2 * h * ng * h, dtype=torch.float32).view(
            2, h, ng * h) - 1
        wpk = rnn_train.pack_gate_weights(cell, wi, wh)
        ip = _round(i_dim, 64)
        assert wpk.shape == (2, 4 * _round(h, 32), ip + _round(h, 64))
        for n in range(wpk.shape[1]):
            gate, unit = (n % 128) // 32, (n // 128) * 32 + n % 32
            col = wpk[:, n]
            if unit >= h:
                assert not col.any()
                continue
            src = gate if cell == 'lstm' else min(gate, 2)
            x_rows = wi[:, :, src * h + unit]
            h_rows = wh[:, :, src * h + unit]
            if cell == 'gru' and gate == 3:
                x_rows = torch.zeros_like(x_rows)
            if cell == 'gru' and gate == 2:
                h_rows = torch.zeros_like(h_rows)
            assert torch.equal(col[:, :i_dim], x_rows)
            assert not col[:, i_dim:ip].any()
            assert torch.equal(col[:, ip:ip + h], h_rows)
            assert not col[:, ip + h:].any()
