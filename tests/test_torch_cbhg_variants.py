"""The CBHG's inference variants in the port against the JAX package's: the
plain twins of the highway-stack, pool + proj1 and pool + mask kernels
against the Pallas kernels they replace (interpret mode), the port's
``CBHG`` against the JAX ``CBHG`` with each variant field set, with the same
weights carried across by ``from_jax_variables``, and the routing: which
route each side takes (spies on both), at the gates' edges, in training and
after a field is set on a built module.

The JAX side runs with FTT_PALLAS_INTERPRET=1, as tests/test_cbhg_stream.py
runs it; the port runs on the CPU, where each kernel wrapper takes its twin.

Tolerances: float32 atol 2e-5, as tests/test_cbhg_stream.py holds the JAX
routes to each other (the pool + mask twin exactly); bfloat16 atol 5e-2 of
the output's scale, the port's bf16 kernel tolerance
(tests/test_torch_serving.py).
"""

import numpy as np
import pytest
import torch
from test_torch_layers import _port, _random_bn
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.models import layers
from forwardtacotron_torch.ops.hopper import cbhg, highway

F32_ATOL, BF16_ATOL = 2e-5, 5e-2
BF16 = torch.bfloat16
DTYPES = {'f32': torch.float32, 'bf16': BF16}


@pytest.fixture()
def interp(monkeypatch):
    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    atol = F32_ATOL if dtype == torch.float32 \
        else BF16_ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def _jnp(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.float32 if dtype == torch.float32
                       else jnp.bfloat16)


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ------------------------------------------------------------------ twins

@pytest.mark.parametrize('dtype,n,c,n_layers', [
    ('f32', 50, 128, 4), ('bf16', 50, 128, 4), ('f32', 37, 256, 2),
    ('bf16', 37, 256, 2), ('f32', 21, 1024, 2), ('f32', 9, 2048, 1)])
def test_highway_stack_twin_matches_pallas(interp, dtype, n, c, n_layers):
    """Rows not a multiple of the row block; widths past the 32-row tile
    (1024, 2048), which the kernel now takes at 16 and 8 rows."""
    from forwardtacotron_tpu.ops.pallas.highway import highway_stack_pallas

    dt = DTYPES[dtype]
    rs = np.random.RandomState(c + n_layers)
    x = rs.randn(n, c).astype(np.float32)
    w1, w2 = [(rs.randn(n_layers, c, c) / np.sqrt(c)).astype(np.float32)
              for _ in range(2)]
    b1, b2 = [(0.1 * rs.randn(n_layers, c)).astype(np.float32)
              for _ in range(2)]
    ref = highway_stack_pallas(_jnp(x, dt), _jnp(w1, dt), b1, _jnp(w2, dt),
                               b2, block_rows=16)
    got = highway.highway_stack(_torch(x, dt),
                                _torch(np.concatenate([w1, w2], -1), dt),
                                torch.from_numpy(np.concatenate([b1, b2], -1)))
    assert got.dtype == dt and highway.stack_launches == 0
    _close(got, ref, dt)


def _pool_inputs(seed, b, t, kc):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, t, kc).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[-1, t // 2:] = 0.0                       # the last item is ragged
    return rs, x, mask


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_pool_mask_twin_matches_pallas(interp, dtype):
    """Exact: a max and a multiply by 0 or 1."""
    from forwardtacotron_tpu.ops.pallas.cbhg import pool_mask_pallas

    dt = DTYPES[dtype]
    _, x, mask = _pool_inputs(1, 3, 19, 256)
    ref = pool_mask_pallas(_jnp(x, dt), mask)
    got = cbhg.pool_mask(_torch(x, dt), torch.from_numpy(mask))
    assert got.dtype == dt and cbhg.pool_mask_launches == 0
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_pool_proj1_twin_matches_pallas(interp, dtype):
    """P of 24, padded by the wrapper to the kernel's column tile: the
    padded weight's extra columns are zero, so the first P columns of its
    product are the unpadded ones."""
    from forwardtacotron_tpu.ops.pallas.cbhg import pool_proj1_pallas

    dt = DTYPES[dtype]
    rs, x, mask = _pool_inputs(2, 3, 37, 256)
    w = (rs.randn(3, 256, 24) / np.sqrt(3 * 256)).astype(np.float32)
    ref = pool_proj1_pallas(_jnp(x, dt), mask, _jnp(w, dt))
    got = cbhg.pool_proj1(_torch(x, dt), torch.from_numpy(mask),
                          _torch(w, dt))
    assert got.shape == (3, 37, 24) and got.dtype == dt
    assert cbhg.pool_proj1_launches == 0
    _close(got, ref, dt)
    if dt == torch.float32:
        packed = cbhg.pack_proj_weight(_torch(w, dt), cbhg.PROJ_TILE)
        assert packed.shape == (3, cbhg.PROJ_TILE, 256)
        w_pad = packed.transpose(1, 2)
    else:
        # the stage images [block][chunk][tap][n/8][4][8 columns][8
        # channels], unpacked to [3, KC, n x blocks]
        plan = cbhg.pool_proj1_plan(3, 37, 256, 24)
        n, nb = plan['n_cols'], plan['n_blocks']
        packed = cbhg.pack_proj_stages(_torch(w, dt), n, nb)
        assert packed.shape == (nb, 256 // cbhg.POOL_KCH, 3, n // 8, 4, 8, 8)
        w_pad = packed.permute(2, 1, 4, 6, 0, 3, 5).reshape(3, 256, n * nb)
    padded = cbhg.pool_proj1_plain(_torch(x, dt), torch.from_numpy(mask),
                                   w_pad)
    torch.testing.assert_close(padded[..., :24], got, rtol=0, atol=0)
    assert not padded[..., 24:].any()


# --------------------------------------------------------------- the CBHG

K, C_IN, C, P = 4, 16, 128, 128


def _spy(monkeypatch, owner, name, route, calls):
    orig = getattr(owner, name)

    def spy(*args, **kwargs):
        calls.append(route)
        return orig(*args, **kwargs)
    monkeypatch.setattr(owner, name, spy)


def _spy_jax(monkeypatch, calls):
    from forwardtacotron_tpu.models.layers import CBHG as JaxCBHG
    from forwardtacotron_tpu.ops.pallas import cbhg as jcbhg
    for name, route in (('_front_fused', 'front'),
                        ('_bank_pool_proj1_streamed', 'streamed'),
                        ('_pool_proj1_fused', 'pool_proj'),
                        ('_bank_fused', 'bank_fused'),
                        ('_pre_highways_fused', 'highways')):
        _spy(monkeypatch, JaxCBHG, name, route, calls)
    _spy(monkeypatch, jcbhg, 'pool_mask_pallas', 'pool', calls)


def _spy_port(monkeypatch, calls):
    for owner, name, route in (
            (cbhg, 'bank_pool_proj', 'front'),
            (layers.CBHG, '_bank_pool_proj1_streamed', 'streamed'),
            (cbhg, 'pool_proj1', 'pool_proj'),
            (layers.CBHG, '_bank_fused', 'bank_fused'),
            (cbhg, 'pool_mask', 'pool'),
            (highway, 'pre_highway_stack', 'highways')):
        _spy(monkeypatch, owner, name, route, calls)


def _pair(seed, k=K, c=C, p=P, c_in=C_IN, **fields):
    """A JAX CBHG with random BatchNorm statistics and its port, loaded
    with the same variables (float32)."""
    import jax

    from forwardtacotron_tpu.models.layers import CBHG as JaxCBHG
    rs = np.random.RandomState(seed)
    jm = JaxCBHG(K=k, channels=c, proj_channels=[p, c_in], num_highways=2,
                 dropout=0.0, **fields)
    x0 = np.zeros((1, 8, c_in), np.float32)
    v = _random_bn(jm.init(jax.random.PRNGKey(seed), x0), rs)
    tm = _port(layers.CBHG(k, c_in, c, [p, c_in], 2, dropout=0.0, **fields),
               v)
    return jm, v, tm, rs


def _pre_rnn_both(monkeypatch, jm, v, tm, x, lengths, dt):
    """(port output, JAX output, port routes, JAX routes) of ``pre_rnn``
    in dtype ``dt`` (the variables and the module cast as a bf16
    TTSInference casts them)."""
    import jax

    from forwardtacotron_tpu.models.layers import CBHG as JaxCBHG
    jcalls, tcalls = [], []
    _spy_jax(monkeypatch, jcalls)
    _spy_port(monkeypatch, tcalls)
    jv = jax.tree.map(lambda a: _jnp(a, dt), v)
    jl = None if lengths is None else np.asarray(lengths)
    ref = jax.jit(lambda v, x, jl: jm.apply(
        v, x, train=False, lengths=jl, method=JaxCBHG.pre_rnn))(
            jv, _jnp(x, dt), jl)
    tl = None if lengths is None else torch.as_tensor(lengths)
    with torch.no_grad():
        got = tm.to(dt).pre_rnn(_torch(x, dt), tl)
    return got, ref, tcalls, jcalls


VARIANTS = {
    'defaults': ({}, {'front', 'highways'}),
    'fuse_front=False': ({'fuse_front': False}, {'highways'}),
    'fuse_highways=False': ({'fuse_highways': False}, {'front'}),
    'fuse_bank': ({'fuse_bank': True, 'fuse_front': False},
                  {'bank_fused', 'highways'}),
    'stream_pool_proj': ({'stream_pool_proj': True, 'fuse_front': False},
                         {'streamed', 'highways'}),
    'fuse_pool_proj': ({'fuse_pool_proj': True, 'fuse_front': False},
                       {'pool_proj', 'highways'}),
    'fuse_pool': ({'fuse_pool': True, 'fuse_front': False},
                  {'pool', 'highways'}),
    'fuse_bank+fuse_pool': ({'fuse_bank': True, 'fuse_pool': True,
                             'fuse_front': False},
                            {'bank_fused', 'pool', 'highways'}),
}


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_cbhg_variant_matches_jax(interp, monkeypatch, variant, dtype):
    """Each field (with the front off where the front would take the work
    first) routes to the same route on both sides, and the outputs agree,
    with ragged lengths."""
    fields, routes = VARIANTS[variant]
    jm, v, tm, rs = _pair(7, **fields)
    x = rs.randn(3, 23, C_IN).astype(np.float32)
    got, ref, tcalls, jcalls = _pre_rnn_both(
        monkeypatch, jm, v, tm, x, [23, 11, 5], DTYPES[dtype])
    assert set(tcalls) == set(jcalls) == routes
    assert got.dtype == DTYPES[dtype]
    _close(got, ref, DTYPES[dtype])


# (K, C, T, dtype) at the edges of the pool + proj1 gate: T = 512 / 513,
# K*C = 480 (not a multiple of 128), and the 2 MB block: K*C = 1152 at
# T = 480 is 2.2 MB in float32 and 1.1 MB in bfloat16
GATE_CASES = {'T=512': (4, 128, 512, 'f32', True),
              'T=513': (4, 128, 513, 'f32', False),
              'KC=480': (5, 96, 16, 'f32', False),
              '2MB f32': (9, 128, 480, 'f32', False),
              '2MB bf16': (9, 128, 480, 'bf16', True)}


@pytest.mark.parametrize('case', list(GATE_CASES))
def test_pool_proj_gate_routes_as_jax(interp, monkeypatch, case):
    """Both sides send the same work to pool + proj1, and agree in value,
    at the edges of the JAX gate."""
    k, c, t, dtype, fused = GATE_CASES[case]
    jm, v, tm, rs = _pair(11, k=k, c=c, p=16, fuse_pool_proj=True,
                          fuse_front=False, fuse_highways=False)
    x = rs.randn(1, t, C_IN).astype(np.float32)
    got, ref, tcalls, jcalls = _pre_rnn_both(monkeypatch, jm, v, tm, x,
                                             None, DTYPES[dtype])
    assert ('pool_proj' in tcalls) == ('pool_proj' in jcalls) == fused
    assert set(tcalls) == set(jcalls)
    _close(got, ref, DTYPES[dtype])


def test_pool_proj_gate_matches_jax_gate(interp):
    """The port's ``pool_proj_fusable`` against the JAX
    ``_pool_proj_fusable`` over sequence lengths, bank widths and dtypes,
    on and off."""
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.layers import CBHG as JaxCBHG
    for (k, c), on in zip(((4, 128), (3, 160), (4, 384), (8, 256),
                           (16, 256)), (True, True, True, True, False)):
        jgate = JaxCBHG(K=k, channels=c, proj_channels=[16, 16],
                        num_highways=1, fuse_pool_proj=on
                        ).bind({})._pool_proj_fusable
        tm = layers.CBHG(k, 16, c, [16, 16], 1, fuse_pool_proj=on)
        for t in (1, 81, 256, 257, 400, 512, 513):
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, BF16)):
                assert tm.pool_proj_fusable(t, tdt) == jgate(t, jdt), \
                    (k, c, t, tdt)


def test_training_takes_the_plain_path(interp, monkeypatch):
    """With every variant on, a module in training mode runs none of them,
    on either side."""
    import jax

    fields = dict(fuse_bank=True, stream_pool_proj=True, fuse_pool_proj=True,
                  fuse_pool=True)
    jm, v, tm, rs = _pair(3, **fields)
    x = rs.randn(2, 12, C_IN).astype(np.float32)
    jcalls, tcalls = [], []
    _spy_jax(monkeypatch, jcalls)
    _spy_port(monkeypatch, tcalls)
    jm.apply(v, x, train=True, rngs={'dropout': jax.random.PRNGKey(0)},
             mutable=['batch_stats'])
    tm.train()(torch.from_numpy(x))
    assert jcalls == [] and tcalls == []


def test_fields_set_after_construction_change_the_route(monkeypatch):
    """The gates read the fields at each call: a module built with the
    defaults and then given a variant routes, and computes, as one built
    with it."""
    torch.manual_seed(0)
    m = layers.CBHG(K, C_IN, C, [P, C_IN], 2, dropout=0.0).eval()
    x = torch.randn(2, 14, C_IN)
    calls = []
    _spy_port(monkeypatch, calls)
    steps = [({}, {'front', 'highways'}),
             ({'fuse_front': False, 'fuse_pool_proj': True},
              {'pool_proj', 'highways'}),
             ({'fuse_pool_proj': False, 'fuse_pool': True},
              {'pool', 'highways'}),
             ({'fuse_highways': False}, {'pool'})]
    fields = {}
    with torch.no_grad():
        for change, routes in steps:
            for name, value in change.items():
                setattr(m, name, value)
            fields.update(change)
            calls.clear()
            got = m.pre_rnn(x, torch.tensor([14, 9]))
            assert set(calls) == routes, change
            built = layers.CBHG(K, C_IN, C, [P, C_IN], 2, dropout=0.0,
                                **fields).eval()
            built.load_state_dict(m.state_dict())
            torch.testing.assert_close(
                built.pre_rnn(x, torch.tensor([14, 9])), got, rtol=0,
                atol=0)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_highways_fused_matches_jax_and_chain(interp, dtype):
    """``_highways_fused`` (no caller in ``pre_rnn``, on either side)
    against the JAX method and, in float32, the port's plain layer
    chain."""
    from forwardtacotron_tpu.models.layers import CBHG as JaxCBHG
    import jax

    dt = DTYPES[dtype]
    jm, v, tm, rs = _pair(5)
    x = rs.randn(2, 13, C).astype(np.float32)
    ref = jm.apply(jax.tree.map(lambda a: _jnp(a, dt), v), _jnp(x, dt),
                   method=JaxCBHG._highways_fused)
    tm = tm.to(dt)
    with torch.no_grad():
        got = tm._highways_fused(_torch(x, dt))
        chain = _torch(x, dt)
        for hw in tm.highways:
            chain = hw(chain)
    assert got.shape == (2, 13, C) and got.dtype == dt
    _close(got, ref, dt)
    if dt == torch.float32:
        torch.testing.assert_close(got, chain, rtol=0, atol=F32_ATOL)


def test_wide_highway_stacks_take_the_kernel(monkeypatch):
    """On a card (device clause patched) a highway stack of 1024 or 2048
    channels is admitted by the gate and its kernel, where it used to
    raise."""
    monkeypatch.setattr(layers, '_on_cuda', lambda x: True)
    x = torch.zeros(1, 4, 80)
    for c in (1024, 2048):
        m = layers.CBHG(2, 80, c, [64, 80], 1).eval()
        assert m.highways_error is None
        assert m._takes_kernel(m.highways_fusable, m.highways_error,
                               'part', x)
