"""The length regulator's plain twin and its gradient (ops/hopper/lr.py,
reached through ops/length_regulator.py) against the JAX package's Pallas
kernel ``length_regulator_pallas`` run in interpret mode, with its custom
VJP, on the CPU.

Exact, in float32 and bfloat16: every output frame copies one token, and the
incoming gradients are multiples of 1/4 small enough that their sums over a
token's frames are exact in any order and in bfloat16, so the port's float32
running sum and the JAX einsum give the same bits.
"""

import numpy as np
import pytest
import torch
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.ops import length_regulator as port_lr
from forwardtacotron_torch.ops.hopper import lr

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _jnp(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32)


def _inputs(seed, b=3, n=9, c=32):
    """Tokens, durations with zeros, negatives and halves, item 1 far over
    any budget below 270 frames and item 2 empty."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, c).astype(np.float32)
    dur = rs.uniform(-1.0, 5.0, (b, n)).astype(np.float32)
    dur[0, ::3] = 0.0
    dur[0, 1] = 0.5
    dur[1] = 30.0
    dur[2] = -2.0
    return rs, x, dur


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('max_len', [100, 300])
def test_lr_forward_and_gradient_match_pallas(dtype, max_len):
    import jax

    from forwardtacotron_tpu.ops.pallas.length_regulator import \
        length_regulator_pallas

    dt = DTYPES[dtype]
    rs, x, dur = _inputs(max_len)
    g = (rs.randint(-2, 3, (x.shape[0], max_len, x.shape[2])) / 4).astype(
        np.float32)

    ref, vjp = jax.vjp(
        lambda xx: length_regulator_pallas(xx, _jnp(dur, None), max_len,
                                           interpret=True), _jnp(x, dt))
    (ref_dx,) = vjp(_jnp(g, dt))

    xt = torch.from_numpy(x).to(dt).requires_grad_()
    out = port_lr.length_regulator(xt, torch.from_numpy(dur), max_len)
    out.backward(torch.from_numpy(g).to(dt))
    assert out.shape == (x.shape[0], max_len, x.shape[2])
    assert out.dtype == dt and xt.grad.dtype == dt
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(ref, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(ref_dx, np.float32))
    assert lr.launches == 0           # CPU tensors never reach the kernel


def test_lr_twin_matches_gather_reference():
    """The twin on its own (integer span ends, as the kernel takes them)
    against a per-item repeat_interleave, the reference's formulation
    (reference models/common_layers.py:12-24)."""
    _, x, dur = _inputs(5)
    xt, dt = torch.from_numpy(x), torch.from_numpy(dur)
    reps = port_lr.round_durations(dt)
    ends = torch.cumsum(reps, dim=1).to(torch.int32)
    max_len = 64
    got = lr.length_regulator_plain(xt, ends, max_len)
    for b in range(x.shape[0]):
        rows = torch.repeat_interleave(xt[b], reps[b], dim=0)[:max_len]
        want = torch.zeros(max_len, x.shape[2])
        want[:len(rows)] = rows
        assert torch.equal(got[b], want)
