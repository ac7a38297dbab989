"""The port's msgpack codec (forwardtacotron_torch/utils/msgpack.py)
against flax's ``serialization.msgpack_serialize`` / ``msgpack_restore``:
the same bytes as flax's default (sorted) output for the trees the JAX
package's ``.ckpt`` holds, each reading what the other writes (the port
also flax's unsorted ``in_place`` output), and chunked arrays (with the
chunk size patched small on both sides: the port reads flax's chunks and
refuses to write an array over the size)."""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.utils import msgpack as codec


def _trees():
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    bf16 = rs.randn(3, 5).astype(np.float32)
    return {
        'float32': ({'w': rs.randn(4, 3).astype(np.float32)}, None),
        'bfloat16': ({'w': np.asarray(jnp.asarray(bf16, jnp.bfloat16))},
                     {'w': torch.from_numpy(bf16).to(torch.bfloat16)}),
        'ints': ({'a': np.arange(6, dtype=np.int32).reshape(2, 3),
                  'b': np.array([-(2 ** 40), 7], np.int64),
                  'c': np.arange(3, dtype=np.uint8)}, None),
        'bool': ({'m': np.array([True, False, True])}, None),
        '0-d and scalars': ({'count': np.asarray(3, np.int32),
                             'lr': np.asarray(1e-3, np.float32),
                             'np_scalar': np.float32(0.5),
                             'np_int': np.int64(-9)}, None),
        'nested and empty dicts': ({'z': {'y': {}, 'x': {'k': np.ones(2)}},
                                    'a': {}, '0': {'1': {}}}, None),
        'str, bin and python scalars': (
            {'config_yaml': 'dsp:\n  num_mels: 80\n' * 4, 'blob': b'\x00\xff' * 300,
             'version': 1, 'step': 123456, 'neg': [-1, -33, -200, -70000],
             'big': [127, 128, 255, 256, 70000, 2 ** 33], 'f': 0.25,
             't': True, 'n': None, 'long': 'x' * 70000,
             'many': {f'k{i:02d}': i for i in range(20)}}, None),
    }


@pytest.mark.parametrize('name', list(_trees()))
def test_bytes_equal_flax(name):
    from flax import serialization

    tree, torch_tree = _trees()[name]
    mine = torch_tree if torch_tree is not None else tree
    assert codec.msgpack_serialize(mine) == \
        serialization.msgpack_serialize(tree)


def _assert_tree_equal(got, want, path='', port=True):
    """Equal trees; where ``want`` (flax's reading) has a bfloat16 array,
    the port's reading has a torch.bfloat16 tensor (``port``)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f'{path}/{k}', port)
    elif isinstance(want, np.ndarray) and want.dtype.name == 'bfloat16':
        if port:
            assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
            got = got.float().numpy()
        else:
            assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      want.astype(np.float32), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize('name', list(_trees()))
def test_reads_flax_and_flax_reads_it(name):
    from flax import serialization

    tree, torch_tree = _trees()[name]
    for in_place in (False, True):
        flax_bytes = serialization.msgpack_serialize(tree, in_place=in_place)
        _assert_tree_equal(codec.msgpack_restore(flax_bytes),
                           serialization.msgpack_restore(flax_bytes))
    mine = codec.msgpack_serialize(torch_tree or tree)
    _assert_tree_equal(serialization.msgpack_restore(mine),
                       serialization.msgpack_restore(
                           serialization.msgpack_serialize(tree)),
                       port=False)


def test_chunked_arrays(monkeypatch):
    """Leaves that flax split over the chunk size (here 64 bytes: an array
    of 50 float32 goes in 4 chunks) are joined back; the port refuses to
    write a leaf over the size and writes one at it whole."""
    from flax import serialization

    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    monkeypatch.setattr(codec, 'MAX_CHUNK_SIZE', 64)
    tree = {'big': np.arange(50, dtype=np.float32).reshape(5, 10),
            'small': np.ones(3, np.float32), 'inner': {
                'big': np.arange(40, dtype=np.int32)}}
    flax_bytes = serialization.msgpack_serialize(tree)
    got = codec.msgpack_restore(flax_bytes)
    _assert_tree_equal(got, serialization.msgpack_restore(flax_bytes))
    np.testing.assert_array_equal(got['big'], tree['big'])
    np.testing.assert_array_equal(got['inner']['big'], tree['inner']['big'])
    with pytest.raises(ValueError, match='over the 64'):
        codec.msgpack_serialize(tree)
    at_limit = {'w': np.ones(16, np.float32), 'b': torch.ones(
        32, dtype=torch.bfloat16)}
    assert codec.msgpack_serialize(at_limit) == \
        serialization.msgpack_serialize(
            {'w': at_limit['w'], 'b': serialization.msgpack_restore(
                codec.msgpack_serialize({'b': at_limit['b']}))['b']})


def test_refuses_what_flax_refuses():
    with pytest.raises(TypeError):
        codec.msgpack_serialize({'t': (1, 2)})
    with pytest.raises(ValueError):
        codec.msgpack_serialize({'o': np.array([object()])})
    data = codec.msgpack_serialize({'w': np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        codec.msgpack_restore(data[:-3])
    with pytest.raises(ValueError):
        codec.msgpack_restore(data + b'\x00')
