"""The trainable recurrences (``models.layers.bidir_rnn_trainable`` around
ops/hopper/rnn_train.py's GruCore / LstmCore, with the ``lstm_train``
forward twin and the ``gru_bwd`` / ``lstm_bwd`` backward-sweep twins)
against the JAX package's
``rnn_train.bidir_rnn_trainable`` with its Pallas kernels in interpret mode,
at the shapes of tests/test_rnn_train_vjp.py: the output and every gradient
(dx, and wi, wh, bi, bh per direction), lengths None and given.

Tolerances: float32, 1e-4 (the JAX package's own kernel-vs-scan gradient
tolerance, tests/test_rnn_train_vjp.py; both sides carry dh in float32 and
sum in other orders); bfloat16, 5e-2 of the scale max(1, max |JAX|) (the
JAX package's bf16 kernel tolerance): both round the saved states, the
incoming gradient and the dgates to bfloat16 at the same points, but a
float32 sum in another order can land on the neighbouring bfloat16 value,
and the sweep carries it on.
"""

import numpy as np
import pytest
import torch
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.models import layers
from forwardtacotron_torch.ops.hopper import rnn, rnn_train

B, T, I, H = 5, 11, 32, 128
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _close(got, want, dtype, name):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 5e-2 * scale, name


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
@pytest.mark.parametrize('with_lengths', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
def test_trainable_rnn_matches_pallas(cell, with_lengths, dtype):
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.rnn_train import bidir_rnn_trainable

    dt = DTYPES[dtype]
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    n_gates = 4 if cell == 'lstm' else 3
    rs = np.random.RandomState(0 if cell == 'gru' else 1)
    x = rs.randn(B, T, I).astype(np.float32)
    lengths = np.array([T, 3, 7, 1, T - 1]) if with_lengths else None
    dirs = [tuple(rs.uniform(-0.3, 0.3, s).astype(np.float32)
                  for s in ((I, n_gates * H), (H, n_gates * H),
                            (n_gates * H,), (n_gates * H,)))
            for _ in range(2)]
    w_out = rs.randn(B, T, 2 * H).astype(np.float32)

    def loss(x, fwd, bwd):
        out = bidir_rnn_trainable(
            x, None if lengths is None else jnp.asarray(lengths), fwd, bwd,
            H, cell, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w_out), out

    (_, ref), (g_x, g_fwd, g_bwd) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x, jdt), *[tuple(jnp.asarray(a, jdt) for a in d)
                               for d in dirs])

    xt = torch.from_numpy(x).to(dt).requires_grad_()
    stacked = [torch.from_numpy(np.stack(p)).to(dt).requires_grad_()
               for p in zip(*dirs)]                  # wi, wh, bi, bh
    out = layers.bidir_rnn_trainable(
        xt, None if lengths is None else torch.from_numpy(lengths),
        *stacked, cell)
    (out.float() * torch.from_numpy(w_out)).sum().backward()

    assert out.dtype == dt
    _close(out, ref, dt, 'out')
    _close(xt.grad, g_x, dt, 'dx')
    for d, grads in enumerate((g_fwd, g_bwd)):
        for p, g, name in zip(stacked, grads, ('wi', 'wh', 'bi', 'bh')):
            _close(p.grad[d], g, dt, f'{cell} dir{d} d{name}')
    assert rnn_train.launches == {'gru_bwd': 0, 'lstm_bwd': 0}
    assert rnn.launches['lstm_train'] == 0


@pytest.mark.parametrize('mode,calls', [('train', 1), ('off', 0), ('on', 0)])
def test_bidir_scan_routes_by_mode(monkeypatch, mode, calls):
    """bf16 with H % 128 == 0: ``rnn_mode('train')`` takes the
    differentiable core, 'off' the per-step loop (the same function: the
    outputs agree), 'on' the inference kernel's twin."""
    taken = []
    core = rnn_train.LstmCore.apply
    monkeypatch.setattr(rnn_train.LstmCore, 'apply',
                        lambda *a: taken.append(1) or core(*a))
    torch.manual_seed(0)
    lstm = layers.BiLSTM(32, 128).to(torch.bfloat16)
    x = torch.randn(3, 6, 32).to(torch.bfloat16)
    lens = torch.tensor([6, 2, 5])
    with rnn_train.rnn_mode(mode):
        out = lstm(x, lens)
    with rnn_train.rnn_mode('off'):
        loop = lstm(x, lens)
    assert len(taken) == calls
    assert rnn_train.current_mode() == 'on'
    torch.testing.assert_close(out.float(), loop.float(), rtol=0, atol=3e-2)
    if mode != 'on':
        out.float().sum().backward()
        assert all(p.grad is not None for p in lstm.parameters())


# ------------------------------------------------ the card's sweep check


def _gru_sweep(dhs, hs, x2, wi, wh, bi, bh, fault):
    """``rnn_train.gru_bwd_plain`` with one fault a kernel could have:
    'no_carry' drops the carried dgh @ Wh^T term, 'hn_no_bias' leaves bh
    out of the hn that dr takes, 'dgh_n_no_r' forgets dgh_n = dgn * r."""
    wif, whf = wi.float(), wh.float()
    bif, bhf = bi.float()[:, None], bh.float()[:, None]
    h_prevs = rnn_train._zero_first(hs)
    dgx = torch.empty(*hs.shape[:3], wi.shape[-1], dtype=x2.dtype)
    dgh = torch.empty_like(dgx)
    dh = torch.zeros(hs.shape[1:])
    for t in range(hs.shape[0] - 1, -1, -1):
        h_prev = h_prevs[t].float()
        xr, xz, xn = torch.baddbmm(bif, x2[t].float(), wif).chunk(3, dim=-1)
        hr, hz, hn = torch.baddbmm(bhf, h_prev, whf).chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh_total = dhs[t].float() + dh
        dgn = dh_total * (1.0 - z) * (1.0 - n * n)
        hn_used = hn - bhf[..., 2 * hn.shape[-1]:] if fault == 'hn_no_bias' \
            else hn
        dgr = dgn * hn_used * r * (1.0 - r)
        dgz = dh_total * (h_prev - n) * z * (1.0 - z)
        dgx[t] = torch.cat([dgr, dgz, dgn], dim=-1).to(x2.dtype)
        dgh[t] = torch.cat([dgr, dgz, dgn if fault == 'dgh_n_no_r'
                            else dgn * r], dim=-1).to(x2.dtype)
        dh = dh_total * z
        if fault != 'no_carry':
            dh = dh + torch.bmm(dgh[t].float(), whf.transpose(1, 2))
    return [dgx, dgh]


def _lstm_sweep(dhs, hs, cs, x2, wi, wh, b, fault):
    """``rnn_train.lstm_bwd_plain`` with one fault: 'no_carry' drops the
    carried dgates @ Wh^T term, 'no_dc_carry' the carried dc * f,
    'c_t_for_c_prev' takes c_t where dgf needs c_{t-1}."""
    wif, whf, bf = wi.float(), wh.float(), b.float()[:, None]
    h_prevs, c_prevs = rnn_train._zero_first(hs), rnn_train._zero_first(cs)
    dgates = torch.empty(*hs.shape[:3], wi.shape[-1], dtype=x2.dtype)
    dh = torch.zeros(hs.shape[1:])
    dc = torch.zeros_like(dh)
    for t in range(hs.shape[0] - 1, -1, -1):
        gates = (torch.bmm(x2[t].float(), wif)
                 + torch.bmm(h_prevs[t].float(), whf) + bf)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, fg, g, o = (torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg),
                       torch.sigmoid(go))
        tc = torch.tanh(cs[t].float())
        dh_total = dhs[t].float() + dh
        dc_total = dh_total * o * (1.0 - tc * tc) + dc
        c_used = cs[t] if fault == 'c_t_for_c_prev' else c_prevs[t]
        dgates[t] = torch.cat([dc_total * g * i * (1.0 - i),
                               dc_total * c_used.float() * fg * (1.0 - fg),
                               dc_total * i * (1.0 - g * g),
                               dh_total * tc * o * (1.0 - o)],
                              dim=-1).to(x2.dtype)
        dh = (torch.zeros_like(dh) if fault == 'no_carry'
              else torch.bmm(dgates[t].float(), whf.transpose(1, 2)))
        dc = dc_total * (0.0 if fault == 'no_dc_carry' else fg)
    return [dgates]


def _sweep_case(cell, dtype=torch.bfloat16):
    """chip_smoke's inputs at a small shape: the layer's initial weights,
    x at 0.5 and the incoming gradient at unit scale; the forward's saved
    states from the twin."""
    torch.manual_seed(3)
    mod = (layers.BiLSTM if cell == 'lstm' else layers.BiGRU)(64, 128)
    with torch.no_grad():
        wi, wh, bi, bh = [p.to(dtype) for p in mod.stacked_params()]
    x2 = (0.5 * torch.randn(40, 2, 4, 64)).to(dtype)
    dhs = torch.randn(40, 2, 4, 128).to(dtype)
    if cell == 'lstm':
        hs, cs = rnn.lstm_train_plain(x2, wi, wh, bi + bh)
        return dhs, hs, cs, x2, wi, wh, bi + bh
    return dhs, rnn.gru_plain(x2, wi, wh, bi, bh), x2, wi, wh, bi, bh


@pytest.mark.parametrize('cell,fault', [
    ('lstm', 'no_carry'), ('lstm', 'no_dc_carry'), ('lstm', 'c_t_for_c_prev'),
    ('gru', 'no_carry'), ('gru', 'hn_no_bias'), ('gru', 'dgh_n_no_r')])
def test_sweep_check_fails_faulty_sweeps(cell, fault):
    """chip_smoke.py's check of the backward-sweep kernels (each gate
    block's relative L2 error within SWEEP_TOL) fails a sweep with any of
    these faults by a factor of 10 or more; the same code without the
    fault is the twin, exactly."""
    import chip_smoke

    args = _sweep_case(cell)
    sweep, blocks = ((_lstm_sweep, 4) if cell == 'lstm' else (_gru_sweep, 3))
    twin = (rnn_train.lstm_bwd_plain if cell == 'lstm'
            else rnn_train.gru_bwd_plain)
    want = twin(*args)
    want = [want] if cell == 'lstm' else list(want)
    for g, w in zip(sweep(*args, None), want):
        assert torch.equal(g, w)
    rel, _ = chip_smoke.sweep_error(sweep(*args, fault), want, blocks)
    assert rel >= 10 * chip_smoke.SWEEP_TOL, rel


@pytest.mark.parametrize('cell', ['lstm', 'gru'])
def test_sweep_check_passes_bf16_rounding(cell):
    """The whole of the sweeps' bf16 rounding (the bf16 twin against the
    float32 twin on the same inputs) stays under a third of SWEEP_TOL: a
    kernel that rounds at the twin's points and sums in another order
    differs from it by less."""
    import chip_smoke

    args = _sweep_case(cell)
    f32 = [a.float() for a in args]
    if cell == 'lstm':
        got = [rnn_train.lstm_bwd_plain(*args)]
        want = [rnn_train.lstm_bwd_plain(*f32)]
    else:
        got = list(rnn_train.gru_bwd_plain(*args))
        want = list(rnn_train.gru_bwd_plain(*f32))
    rel, _ = chip_smoke.sweep_error(got, want, 4 if cell == 'lstm' else 3)
    assert rel <= chip_smoke.SWEEP_TOL / 3, rel
