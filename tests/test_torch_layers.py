"""The port's layers (forwardtacotron_torch/models/layers.py) against the JAX
package's, with the same weights carried across by ``from_jax_variables``.

Tolerance: float32, atol 1e-5 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.models import layers
from forwardtacotron_torch.utils.convert import from_jax_variables

ATOL, RTOL = 1e-5, 1e-4


def _port(module, variables):
    """Load JAX variables into a port module; only BN counters may be
    missing from the converted set."""
    missing, unexpected = module.load_state_dict(
        from_jax_variables(variables), strict=False)
    assert unexpected == [] and all('num_batches_tracked' in k
                                    for k in missing)
    return module.eval()


def _random_bn(variables, rs):
    """Random BatchNorm affine and running stats in a flax tree."""
    import jax

    def fix(path, leaf):
        names = [getattr(p, 'key', None) for p in path]
        if 'bnorm' not in names:
            return leaf
        if names[-1] in ('scale', 'var'):
            return rs.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rs.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fix, variables)


@pytest.mark.parametrize('kernel', [3, 4])
def test_batchnorm_conv_matches_jax(kernel):
    import jax

    from forwardtacotron_tpu.models.layers import BatchNormConv

    rs = np.random.RandomState(kernel)
    x = rs.randn(2, 11, 6).astype(np.float32)
    jm = BatchNormConv(8, kernel)
    v = _random_bn(jm.init(jax.random.PRNGKey(0), x), rs)
    ref = jm.apply(v, x)
    tm = _port(layers.BatchNormConv(6, 8, kernel), v)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 11, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_flip_sequences_matches_jax():
    from forwardtacotron_tpu.models.layers import flip_sequences

    x = np.random.RandomState(0).randn(3, 7, 2).astype(np.float32)
    lengths = np.array([7, 3, 12])     # 12 > T: indices clamp to T-1
    ref = flip_sequences(x, lengths)
    got = layers.flip_sequences(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        layers.flip_sequences(torch.from_numpy(x), None).numpy(),
        np.asarray(flip_sequences(x, None)))


@pytest.mark.parametrize('cell', ['gru', 'lstm'])
def test_birnn_with_lengths_matches_jax(cell):
    import jax

    from forwardtacotron_tpu.models.layers import BiGRU, BiLSTM

    rs = np.random.RandomState(1)
    x = rs.randn(3, 9, 5).astype(np.float32)
    lengths = np.array([9, 4, 6])
    jcls, tcls = (BiGRU, layers.BiGRU) if cell == 'gru' \
        else (BiLSTM, layers.BiLSTM)
    jm = jcls(7)
    v = jm.init(jax.random.PRNGKey(2), x, lengths)
    ref = jax.jit(jm.apply)(v, x, lengths)
    tm = _port(tcls(5, 7), v)
    got = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('channels', [32, 128])
def test_cbhg_with_lengths_matches_jax(channels, monkeypatch):
    """Both sides route as their gates say: the JAX CBHG runs its front
    (and at 128 channels its highway stack) as Pallas kernels in interpret
    mode, the port runs the twins of its CUDA kernels."""
    import jax

    from forwardtacotron_tpu.models.layers import CBHG

    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')
    rs = np.random.RandomState(channels)
    c_in = 12
    x = rs.randn(2, 21, c_in).astype(np.float32)
    lengths = np.array([21, 13])
    jm = CBHG(K=4, channels=channels, proj_channels=[channels, c_in],
              num_highways=2, dropout=0.0)
    v = _random_bn(jm.init(jax.random.PRNGKey(3), x), rs)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False,
                                        lengths=lengths))(v, x)
    tm = _port(layers.CBHG(4, c_in, channels, [channels, c_in], 2), v)
    assert tm.front_fusable and tm.highways_fusable == (channels == 128)
    got = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_cbhg_unfused_front_matches_jax():
    """A front too large for one dispatch (the K=16 prenet's route) takes
    plain convolutions on both sides."""
    import jax

    from forwardtacotron_tpu.models.layers import CBHG

    rs = np.random.RandomState(5)
    x = rs.randn(1, 10, 8).astype(np.float32)
    jm = CBHG(K=3, channels=16, proj_channels=[16, 8], num_highways=1,
              dropout=0.0, fuse_front=False)
    v = _random_bn(jm.init(jax.random.PRNGKey(4), x), rs)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    tm = _port(layers.CBHG(3, 8, 16, [16, 8], 1, fuse_front=False), v)
    assert not tm.front_fusable
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_front_route_matches_jax_budget():
    """The port keeps the K=16 prenet front on plain convolutions and sends
    the K=8 postnet front to its kernel, as the JAX gate does."""
    from forwardtacotron_tpu.ops.pallas.cbhg import _front_groups

    for k, c_in in ((16, 256), (8, 80)):
        jax_one_group = len(_front_groups(tuple(range(1, k + 1)), c_in,
                                          256, 256)) == 1
        assert layers._front_fits_one_dispatch(k, c_in, 256, 256) \
            == jax_one_group
        assert jax_one_group == (k == 8)


def test_maxpool_time_left_pad_is_neg_inf():
    x = torch.tensor([[[-3.0], [-5.0], [-1.0]]])
    np.testing.assert_array_equal(layers.maxpool_time(x)[0, :, 0].numpy(),
                                  [-3.0, -3.0, -1.0])
