"""The recurrent kernels' plain twins (ops/hopper/rnn.py and
ops/hopper/lr_bidir.py) and the layers that route to them, against the JAX
package's Pallas kernels run in interpret mode on the CPU, with the same
inputs and weights.

On CPU tensors each wrapper runs its twin, so these tests hold the twins'
arithmetic (which the card's kernels are held against in chip_smoke.py and
tests/test_torch_cuda.py) to the TPU kernels'. Tolerances: float32, atol
2e-5 for the recurrences (the JAX package's own kernel-vs-scan tolerance,
tests/test_fused_rnn.py) and 1e-6 for the length regulator (a copy, as in
tests/test_fused_trunk.py); bfloat16, atol 5e-2 (the JAX package's bf16 trunk
tolerance, tests/test_fused_trunk.py): both sides round h and c to bfloat16
every step at the same points but sum in other orders, and XLA may keep
excess precision between fused operations outside the kernels.
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.models import layers
from forwardtacotron_torch.ops.hopper import lr_bidir, rnn
from forwardtacotron_torch.ops.length_regulator import duration_spans

F32_ATOL, BF16_ATOL = 2e-5, 5e-2
DTYPES = {'float32': (torch.float32, F32_ATOL),
          'bfloat16': (torch.bfloat16, BF16_ATOL)}


@pytest.fixture()
def interp(monkeypatch):
    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')


def _jnp(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32)


def _np(a):
    return np.asarray(a, np.float32)


def _dir_params(rs, in_dim, hidden, n_gates, scale=0.3):
    """(wi [I, G], wh [H, G], bi [G], bh [G]) as float32 numpy."""
    g = n_gates * hidden
    return tuple(rs.uniform(-scale, scale, s).astype(np.float32)
                 for s in ((in_dim, g), (hidden, g), (g,), (g,)))


def _load_rnn(module, fwd, bwd, dtype):
    """Set a port BiGRU/BiLSTM to JAX-layout (fwd, bwd) parameters."""
    with torch.no_grad():
        for suffix, (wi, wh, bi, bh) in (('_l0', fwd), ('_l0_reverse', bwd)):
            getattr(module, 'weight_ih' + suffix).copy_(torch.from_numpy(wi.T))
            getattr(module, 'weight_hh' + suffix).copy_(torch.from_numpy(wh.T))
            getattr(module, 'bias_ih' + suffix).copy_(torch.from_numpy(bi))
            getattr(module, 'bias_hh' + suffix).copy_(torch.from_numpy(bh))
    return module.to(dtype)


def _durations(rs, b, n):
    """Item 0 ragged with zero durations, item 1 far over a 100-frame
    budget, item 2 empty, the rest short."""
    dur = rs.uniform(0.0, 3.0, (b, n))
    dur[0, ::3] = 0.2
    dur[1] = 30.0
    dur[2] = 0.0
    return dur.astype(np.float32)


@pytest.mark.parametrize('b', [3, 17])
@pytest.mark.parametrize('dtype', DTYPES)
def test_lr_bidir_twin_matches_pallas(interp, b, dtype):
    from forwardtacotron_tpu.ops.length_regulator import \
        duration_spans as jax_spans
    from forwardtacotron_tpu.ops.pallas.length_regulator import \
        length_regulator_bidir_pallas

    dt, _ = DTYPES[dtype]
    rs = np.random.RandomState(b)
    n, c, t_run = 9, 32, 128
    x = rs.randn(b, n, c).astype(np.float32)
    dur = _durations(rs, b, n)
    starts, ends = jax_spans(dur)
    ref = length_regulator_bidir_pallas(_jnp(x, dt), starts, ends, t_run,
                                        interpret=True)
    _, ends_t = duration_spans(torch.from_numpy(dur))
    got = lr_bidir.length_regulator_bidir(torch.from_numpy(x).to(dt), ends_t,
                                          t_run)
    assert got.shape == (t_run, 2, b, c) and got.dtype == dt
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=0,
                               atol=1e-6)
    assert lr_bidir.launches == 0     # CPU tensors never reach the kernel


@pytest.mark.parametrize('dtype', DTYPES)
def test_gru_xp_twin_matches_pallas(interp, dtype):
    from forwardtacotron_tpu.ops.pallas.rnn import gru_from_xp_pallas

    dt, atol = DTYPES[dtype]
    rs = np.random.RandomState(3)
    b, t, hidden = 17, 9, 128             # batch not a multiple of 16
    xp_f, xp_b = (rs.randn(b, t, 3 * hidden).astype(np.float32)
                  for _ in range(2))
    wh = rs.uniform(-0.3, 0.3, (2, hidden, 3 * hidden)).astype(np.float32)
    bh = rs.uniform(-0.3, 0.3, (2, 3 * hidden)).astype(np.float32)
    hs, b_true = gru_from_xp_pallas(_jnp(xp_f, dt), _jnp(xp_b, dt),
                                    _jnp(wh, dt), _jnp(bh, dt), hidden,
                                    interpret=True)
    xp2 = torch.from_numpy(np.stack([xp_f, xp_b])).permute(2, 0, 1, 3)
    got = rnn.gru_xp(xp2.contiguous().to(dt), torch.from_numpy(wh).to(dt),
                     torch.from_numpy(bh).to(dt))
    assert got.shape == (t, 2, b, hidden) and got.dtype == dt
    np.testing.assert_allclose(got.float().numpy(), _np(hs)[:, :, :b_true],
                               rtol=0, atol=atol)


@pytest.mark.parametrize('b', [1, 3, 65])
@pytest.mark.parametrize('dtype', DTYPES)
def test_gru_xp_twin_matches_pallas_batches(interp, b, dtype):
    """The multi-GRU twin at one row, a ragged few and just past one 64-row
    tile of the step-major kernel, against gru_from_xp_pallas."""
    from forwardtacotron_tpu.ops.pallas.rnn import gru_from_xp_pallas

    dt, atol = DTYPES[dtype]
    rs = np.random.RandomState(b)
    t, hidden = 5, 128
    xp_f, xp_b = (rs.randn(b, t, 3 * hidden).astype(np.float32)
                  for _ in range(2))
    wh = rs.uniform(-0.3, 0.3, (2, hidden, 3 * hidden)).astype(np.float32)
    bh = rs.uniform(-0.3, 0.3, (2, 3 * hidden)).astype(np.float32)
    hs, b_true = gru_from_xp_pallas(_jnp(xp_f, dt), _jnp(xp_b, dt),
                                    _jnp(wh, dt), _jnp(bh, dt), hidden,
                                    interpret=True)
    assert b_true == b
    xp2 = torch.from_numpy(np.stack([xp_f, xp_b])).permute(2, 0, 1, 3)
    got = rnn.gru_xp(xp2.contiguous().to(dt), torch.from_numpy(wh).to(dt),
                     torch.from_numpy(bh).to(dt))
    assert got.shape == (t, 2, b, hidden) and got.dtype == dt
    np.testing.assert_allclose(got.float().numpy(), _np(hs)[:, :, :b],
                               rtol=0, atol=atol)
    assert rnn.launches['gru_xp'] == 0   # CPU tensors never reach the kernel


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
@pytest.mark.parametrize('ragged', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@torch.no_grad()
def test_bidir_rnn_twin_matches_pallas(interp, cell, ragged, dtype):
    """The kernel route of ``_bidir_scan`` (flip, time-major stack, one
    recurrence, unflip) against ``bidir_rnn_pallas``."""
    import jax

    from forwardtacotron_tpu.ops.pallas.rnn import bidir_rnn_pallas

    dt, atol = DTYPES[dtype]
    rs = np.random.RandomState(5)
    b, t, in_dim, hidden = 3, 11, 32, 128
    n_gates = 4 if cell == 'lstm' else 3
    fwd = _dir_params(rs, in_dim, hidden, n_gates)
    bwd = _dir_params(rs, in_dim, hidden, n_gates)
    x = (0.5 * rs.randn(b, t, in_dim)).astype(np.float32)
    lens = np.array([11, 4, 7]) if ragged else None
    ref = bidir_rnn_pallas(
        _jnp(x, dt), None if lens is None else _jnp(lens, None).astype(int),
        jax.tree.map(lambda a: _jnp(a, dt), fwd),
        jax.tree.map(lambda a: _jnp(a, dt), bwd), hidden, cell,
        interpret=True)

    lens_t = None if lens is None else torch.from_numpy(lens)
    x2 = layers.time_major(torch.from_numpy(x).to(dt), lens_t)
    wi, wh, bi, bh = (torch.from_numpy(np.stack(p)).to(dt)
                      for p in zip(fwd, bwd))
    hs = (rnn.lstm(x2, wi, wh, bi + bh) if cell == 'lstm'
          else rnn.gru(x2, wi, wh, bi, bh))
    got = layers.unstack(hs, lens_t)
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=0,
                               atol=atol)
    if dt == torch.bfloat16:
        # the module's own route: bf16, H % 128 == 0 -> the same twin
        module = (layers.BiLSTM if cell == 'lstm' else layers.BiGRU)(
            in_dim, hidden)
        _load_rnn(module, fwd, bwd, dt)
        via_module = module(torch.from_numpy(x).to(dt), lens_t)
        torch.testing.assert_close(via_module, got, rtol=0, atol=0)


@pytest.mark.parametrize('dtype,max_len', [('float32', 100),
                                           ('bfloat16', 100),
                                           ('bfloat16', 128)])
@torch.no_grad()
def test_lstm_lr_mel_matches_pallas(interp, dtype, max_len):
    """The fused frame trunk (LR twin + LSTM-mel twin + flip-add) against
    ``lstm_lr_mel_pallas``, on every frame: an empty item, zero durations,
    an item over the budget, a budget that is not a multiple of 64."""
    import jax

    from forwardtacotron_tpu.ops.pallas.rnn import lstm_lr_mel_pallas

    dt, atol = DTYPES[dtype]
    rs = np.random.RandomState(7)
    b, n, c, hidden, m = 3, 7, 128, 128, 20
    x = (0.5 * rs.randn(b, n, c)).astype(np.float32)
    dur = _durations(rs, b, n)
    fwd = _dir_params(rs, c, hidden, 4)
    bwd = _dir_params(rs, c, hidden, 4)
    w_mel = (0.1 * rs.randn(2 * hidden, m)).astype(np.float32)
    b_mel = (0.1 * rs.randn(m)).astype(np.float32)
    ref = lstm_lr_mel_pallas(
        _jnp(x, dt), _jnp(dur, dt),
        jax.tree.map(lambda a: _jnp(a, dt), fwd),
        jax.tree.map(lambda a: _jnp(a, dt), bwd), hidden,
        _jnp(w_mel, dt), _jnp(b_mel, dt), max_len, interpret=True)

    lstm = _load_rnn(layers.BiLSTM(c, hidden), fwd, bwd, dt)
    lin = torch.nn.Linear(2 * hidden, m)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w_mel.T))
        lin.bias.copy_(torch.from_numpy(b_mel))
    got = layers.lstm_lr_mel(torch.from_numpy(x).to(dt),
                             torch.from_numpy(dur).to(dt), max_len, lstm,
                             lin.to(dt))
    assert got.shape == (b, max_len, m) and got.dtype == dt
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=0,
                               atol=atol)


def _gru_entries(rs, b, t, specs, ragged):
    """JAX multi_bigru entries and the port's, with the same weights."""
    jax_entries, port_entries = [], []
    for in_dim, hidden in specs:
        x = rs.randn(b, t, in_dim).astype(np.float32)
        lens = rs.randint(2, t + 1, (b,)) if ragged else None
        fwd = _dir_params(rs, in_dim, hidden, 3, 0.2)
        bwd = _dir_params(rs, in_dim, hidden, 3, 0.2)
        jax_entries.append((x, lens, (fwd, bwd), hidden))
        port_entries.append((x, lens, (fwd, bwd), layers.BiGRU(in_dim,
                                                               hidden)))
    return jax_entries, port_entries


@pytest.mark.parametrize('dtype,specs', [
    ('float32', [(5, 4), (7, 8), (6, 4)]),           # per-step loop route
    ('bfloat16', [(16, 32), (32, 64), (16, 32)]),    # H = 128: gru_xp route
])
@pytest.mark.parametrize('ragged', [False, True])
@torch.no_grad()
def test_multi_bigru_matches_jax(interp, monkeypatch, dtype, specs, ragged):
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.layers import \
        multi_bigru as jax_multi_bigru
    from forwardtacotron_tpu.ops.pallas.rnn import pallas_rnns

    dt, atol = DTYPES[dtype]
    rs = np.random.RandomState(11)
    jax_entries, port_entries = _gru_entries(rs, 3, 9, specs, ragged)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    with pallas_rnns('on'):
        ref = jax_multi_bigru([
            (jnp.asarray(x, jdt), None if lens is None else jnp.asarray(lens),
             jax.tree.map(lambda a: jnp.asarray(a, jdt), dirs), h)
            for x, lens, dirs, h in jax_entries])

    calls = []
    plain = rnn.gru_xp_plain
    monkeypatch.setattr(rnn, 'gru_xp_plain',
                        lambda *a: calls.append(1) or plain(*a))
    got = layers.multi_bigru([
        (torch.from_numpy(x).to(dt),
         None if lens is None else torch.from_numpy(lens),
         _load_rnn(module, *dirs, dt))
        for x, lens, dirs, module in port_entries])
    assert len(calls) == (dt == torch.bfloat16)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == dt
        np.testing.assert_allclose(g.float().numpy(), _np(r), rtol=0,
                                   atol=atol if dt == torch.bfloat16
                                   else 1e-6)
