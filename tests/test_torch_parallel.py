"""The port's data-parallel helpers (``forwardtacotron_torch/parallel/
mesh.py``) and serving (``TTSInference(mesh=)``, ``gen_forward
--data_parallel``) against the JAX package's, on the CPU
(tests/test_torch_parallel_train.py holds the data-parallel trainers):

- ``pad_batch_to_devices`` and ``shard_for_host`` give exactly the JAX
  outputs; ``initialize_distributed`` does nothing without torchrun's
  environment; a mesh of cards, or a NCCL rank, raises without a card;
- ``TTSInference(mesh=make_mesh(devices=['cpu', 'cpu']))`` on a 5-row
  batch (padded to 6, two shares of 3) against the JAX ``TTSInference``
  on a 2-device mesh: ``generate`` and ``generate_fused`` in float32 (1e-4
  of each output's scale, the slice-1 model tolerance) and bf16
  ``generate_fused`` (the JAX package's bf16 model tolerance, 8e-2 on
  valid frames, as tests/test_torch_serving.py), mel_len exact, the
  cropped batch size, each replica running the serving kernels' twins;
  and against the port's one-replica path (float32 1e-5, bf16 8e-2);
- ``gen_forward --data_parallel --device cpu`` with two CPU devices
  writes the mels it writes without the flag (1e-5).
"""

import copy

import numpy as np
import pytest
import torch

from forwardtacotron_torch.data.dataset import shard_for_host
from forwardtacotron_torch.models.registry import \
    init_tts_model as torch_init_tts_model
from forwardtacotron_torch.models.synthesis import TTSInference
from forwardtacotron_torch.ops.hopper import cbhg, highway, lr_bidir, rnn
from forwardtacotron_torch.parallel import mesh
from forwardtacotron_torch.utils.convert import from_jax_variables

from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)
from torch_training_setup import run_jax_step, scaled_close

F32_TOL = 1e-4
MODEL_ATOL = 8e-2     # the JAX package's bf16 model tolerance


# ------------------------------------------------------------ mesh helpers


@pytest.mark.parametrize('b,n', [(5, 2), (4, 2), (3, 4), (7, 8), (1, 3)])
def test_pad_batch_to_devices_matches_jax(b, n):
    from forwardtacotron_tpu.parallel.mesh import make_mesh as jax_mesh
    from forwardtacotron_tpu.parallel.mesh import \
        pad_batch_to_devices as jax_pad

    rs = np.random.RandomState(10 * b + n)
    batch = {'x': rs.randint(0, 9, (b, 6)),
             'mel': rs.randn(b, 5, 3).astype(np.float32),
             'mel_len': rs.randint(1, 5, b), 'x_len': rs.randint(1, 6, b),
             'item_id': [f'item{i}' for i in range(b)], 'r': 2}
    want = jax_pad(batch, jax_mesh(n_data=n))
    got = mesh.pad_batch_to_devices(batch,
                                    mesh.make_mesh(devices=['cpu'] * n))
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key
    assert len(got['item_id']) % n == 0


@pytest.mark.parametrize('count', [1, 2, 3, 4])
def test_shard_for_host_matches_jax(count):
    from forwardtacotron_tpu.data.dataset import \
        shard_for_host as jax_shard

    rs = np.random.RandomState(count)
    data = [(f'item{i:02d}', int(n)) for i, n in
            enumerate(rs.randint(10, 60, 23))]
    data[5] = ('item05', data[3][1])        # a tie, broken by id
    shares = [shard_for_host(data, r, count) for r in range(count)]
    for r, share in enumerate(shares):
        assert share == jax_shard(data, r, count)
    assert sorted(sum(shares, [])) == sorted(data)


def test_no_process_group_and_no_fallback(monkeypatch):
    """Without torchrun's environment there is no process group and every
    helper is the identity; without a card, a mesh of cards, a NCCL rank
    and TTSInference over cards raise instead of moving to the CPU."""
    for key in mesh.ENV:
        monkeypatch.delenv(key, raising=False)
    assert mesh.initialize_distributed('cpu') is False
    assert mesh.initialize_distributed('cpu') is False
    assert not torch.distributed.is_initialized()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    t = torch.arange(3.0)
    assert mesh.global_sum(t) is t and mesh.global_max(t) is t
    assert mesh.host_max([3, 5]) == [3, 5]
    assert mesh.make_mesh(devices=['cpu', 'cpu', 'cpu'], n_data=2) == (
        torch.device('cpu'), torch.device('cpu'))
    with pytest.raises(ValueError):
        mesh.make_mesh(n_data=3, devices=['cpu', 'cpu'])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='CUDA'):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match='CUDA'):
        TTSInference(torch.nn.Linear(2, 2), mesh=['cuda:0', 'cuda:1'])
    for key, value in (('RANK', '0'), ('WORLD_SIZE', '2'),
                       ('LOCAL_RANK', '0'), ('MASTER_ADDR', '127.0.0.1'),
                       ('MASTER_PORT', '29500')):
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match='NCCL'):
        mesh.initialize_distributed('cuda')
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- serving


@pytest.fixture(scope='module')
def serving_models():
    """tests/test_torch_serving.py's small model in both packages (its
    variables, durations of 0.8-2.3 frames) and a 5-row request batch
    (rows 3-4 repeat rows 1 and 0 with other neighbours)."""
    import jax
    from test_torch_serving import serving_config
    from test_torch_slice import SMALL_DSP, randomize

    from forwardtacotron_tpu.models.registry import init_tts_model

    config = serving_config()
    jmodel = init_tts_model(config)
    n = 13
    batch = {'x': np.ones((1, n), np.int64),
             'dur': np.ones((1, n), np.float32), 'mel_len': np.array([n]),
             'pitch': np.zeros((1, n), np.float32),
             'energy': np.zeros((1, n), np.float32),
             'mel': np.zeros((1, n, SMALL_DSP['num_mels']), np.float32)}
    init = jax.jit(lambda b: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        b, train=False))
    variables = randomize(run_jax_step(init, batch), seed=5)
    lin = variables['params']['dur_pred']['lin']
    lin['kernel'] *= 14.0
    lin['bias'][:] = 3.0
    tmodel = torch_init_tts_model(config)
    tmodel.load_state_dict(from_jax_variables(variables), strict=False)
    rs = np.random.RandomState(2)
    x = rs.randint(1, 60, (3, n)).astype(np.int64)
    x[1, 9:] = 0
    x[2, 5:] = 0
    return jmodel, variables, tmodel, np.concatenate([x, x[1::-1]])


def _spy(monkeypatch, module, names, calls):
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])


def _compare_serving(got, ref, atol, lengths):
    for key in ('dur', 'pitch', 'energy'):
        scaled_close(got[key], np.asarray(ref[key], np.float32), atol, 1.0,
                     key)
    for key in ('mel', 'mel_post'):
        assert tuple(got[key].shape) == np.asarray(ref[key]).shape, key
        g = got[key].float().numpy()
        r = np.asarray(ref[key], np.float32)
        for i, n in enumerate(lengths):
            scaled_close(g[i, :n], r[i, :n], atol, 1.0, f'{key}[{i}]')


@pytest.mark.parametrize('dtype,entry', [('float32', 'generate'),
                                         ('float32', 'generate_fused'),
                                         ('bfloat16', 'generate_fused')])
def test_mesh_serving_matches_jax_mesh(monkeypatch, serving_models, dtype,
                                       entry):
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.synthesis import TTSInference as JaxTTS
    from forwardtacotron_tpu.parallel.mesh import make_mesh as jax_mesh

    jmodel, variables, tmodel, x = serving_models
    bf16 = dtype == 'bfloat16'
    if bf16:
        monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')
    jinf = JaxTTS(jmodel, jax.tree.map(jnp.asarray, variables), dtype=dtype,
                  mesh=jax_mesh(n_data=2))
    calls = []
    _spy(monkeypatch, rnn, ['gru_xp_plain', 'lstm_mel_plain'], calls)
    _spy(monkeypatch, lr_bidir, ['length_regulator_bidir_plain'], calls)
    _spy(monkeypatch, highway, ['pre_highway_stack_plain'], calls)
    _spy(monkeypatch, cbhg, ['bank_pool_proj_plain'], calls)
    tinf = TTSInference(copy.deepcopy(tmodel), dtype=dtype, device='cpu',
                        mesh=mesh.make_mesh(devices=['cpu', 'cpu']))
    assert len(tinf.replicas) == 2
    assert tinf.replicas[0][1] is not tinf.replicas[1][1]
    kwargs = {'max_len': 24} if entry == 'generate_fused' else {}
    ref = getattr(jinf, entry)(x, **kwargs)
    got = getattr(tinf, entry)(x, **kwargs)
    assert got['mel'].shape[0] == len(x) == np.asarray(ref['mel']).shape[0]
    np.testing.assert_array_equal(got['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    lengths = np.minimum(got['mel_len'].numpy(), got['mel'].shape[1])
    _compare_serving(got, ref, MODEL_ATOL if bf16 else F32_TOL, lengths)
    if bf16:
        # each replica runs the whole serving path on its share
        assert sorted(set(calls)) == sorted(
            ['gru_xp_plain', 'length_regulator_bidir_plain',
             'lstm_mel_plain', 'pre_highway_stack_plain',
             'bank_pool_proj_plain'])
        assert calls.count('gru_xp_plain') == 2
        assert calls.count('lstm_mel_plain') == 2
    # and the one-replica path on the same batch
    one = getattr(TTSInference(copy.deepcopy(tmodel), dtype=dtype,
                               device='cpu'), entry)(x, **kwargs)
    np.testing.assert_array_equal(got['mel_len'].numpy(),
                                  one['mel_len'].numpy())
    _compare_serving(got, {k: v.float().numpy() for k, v in one.items()},
                     MODEL_ATOL if bf16 else 1e-5, lengths)


def test_gen_forward_data_parallel_writes_the_same_mels(tmp_path,
                                                       monkeypatch):
    """With two CPU devices visible, ``--data_parallel`` splits each
    batch over two replicas and writes the mels (``.npy`` exports) that
    one replica writes."""
    from test_torch_serving import serving_config

    from forwardtacotron_torch import gen_forward
    from forwardtacotron_torch.models.forward_tacotron import \
        ForwardTacotron

    torch.manual_seed(0)
    path = tmp_path / 'forward.pt'
    config = serving_config()
    torch.save({'model': torch_init_tts_model(config).state_dict(),
                'config': config}, str(path))
    text = tmp_path / 'text.txt'
    text.write_text('hello there.\nthe second, longer one!\nand three.\n',
                    encoding='utf-8')
    monkeypatch.setattr(torch.cpu, 'device_count', lambda: 2)
    assert len(mesh.visible_devices('cpu')) == 2
    decodes = []
    real = ForwardTacotron.generate
    monkeypatch.setattr(ForwardTacotron, 'generate', lambda self, x, *a: (
        decodes.append(len(x)), real(self, x, *a))[1])
    mels = {}
    for flag in ([], ['--data_parallel']):
        out = tmp_path / f'out{len(flag)}'
        gen_forward.main(['--checkpoint', str(path), '--text_file',
                          str(text), '--output', str(out), '--device', 'cpu',
                          '--batched', 'hifigan'] + flag)
        mels[len(flag)] = {p.name: np.load(p) for p in out.glob('*.npy')}
    # the flag's groups run as two shares each
    assert len(decodes) > 2 and len(decodes) % 3 == 0
    assert sorted(mels[0]) == sorted(mels[1]) and len(mels[0]) == 3
    for name, mel in mels[0].items():
        np.testing.assert_allclose(mels[1][name], mel, rtol=0, atol=1e-5)
