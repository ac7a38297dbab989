"""The Tacotron teacher on the port against the JAX package's, on the CPU.

One narrow teacher (16-wide embeddings, a 32-wide decoder and LSTMs, a
16-wide postnet, 16 mels, a 16-wide speaker embedding tiled onto the
tokens) in both packages with the same seeded variables. The encoder's
CBHG stays 128 wide, as every teacher's must (its residual adds the
PreNet's 128 outputs), which also sends its highways to row 1's kernel.
In eval mode the JAX package runs rows 1 and 2 in interpret mode
(``FTT_PALLAS_INTERPRET=1``) and the port their twins.

- the cells and the attention alone;
- the teacher-forced eval forward (with padded tokens) and ``generate``
  (running to its step budget, and stopping at the first chunk after its
  step 10 where every item is silent) with ``n_valid``: float32 within
  1e-5 of each output's scale max(1, max |JAX|), bfloat16 (every
  variable cast, as ``model.to(torch.bfloat16)`` casts them) within the
  JAX package's bf16 tolerance 5e-2, ``n_valid`` equal;
- one train step, float32 and bfloat16 mixed precision, against
  ``jax.grad`` of the JAX trainer's loss with dropout and zoneout off on
  both sides: outputs and loss (1e-4 of the scale in float32, 5e-2 in
  bf16), every gradient (float32: 1e-4 of max(1e-3, max |JAX|); bf16: held
  to the port's float32 gradients no further than the JAX package's bf16
  gradients are, as tests/test_torch_training.py does), the BatchNorm
  statistics; every parameter gets a finite gradient;
- the dropout and zoneout masks' rates, from an explicit generator;
- the BiGRUs of both CBHGs never reach a recurrent kernel, whatever
  ``rnn_mode`` is set around the call;
- the weight bridge both ways, the 254 keys of the reference schema, a
  reference ``.pt`` loaded with plain ``load_state_dict``;
- ``get_taco_dataloaders`` against the JAX package's;
- ``python -m forwardtacotron_torch.train_tacotron --device cpu``: two
  sessions to a checkpoint and the extraction after them, a resume,
  ``--force_gta``, ``--force_align``, ``--extract_pitch``.

The JAX decoder scan is compiled with unroll 1 (``DECODER_SCAN_UNROLL``,
read at trace time) and ``QUICK_COMPILE``, once per dtype.
"""

import copy
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from forwardtacotron_torch.models.tacotron import Tacotron
from forwardtacotron_torch.ops.hopper import rnn as rnn_ops
from forwardtacotron_torch.ops.hopper import rnn_train
from forwardtacotron_torch.text.symbols import phonemes
from forwardtacotron_torch.train.taco_trainer import TacoTrainer
from forwardtacotron_torch.utils.convert import (from_jax_variables,
                                                 to_jax_variables)
from forwardtacotron_torch.utils.files import read_config
from forwardtacotron_torch.utils.paths import Paths

from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)
from torch_training_setup import (  # noqa: F401 (no_tensorboard: a fixture)
    N_MELS, QUICK_COMPILE, _random_variables, no_tensorboard, scaled_close,
    write_dataset)

REPO = Path(__file__).resolve().parent.parent
NARROW = dict(embed_dims=16, encoder_dims=128, decoder_dims=32,
              lstm_dims=32, postnet_dims=16, encoder_k=4, postnet_k=3,
              num_highways=2, speaker_emb_dim=16)
BUFFERS = ['decoder.r', 'step', 'stop_threshold']
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
# generate: to the budget at r = 1, and with every frame "silent" at r = 2
# (each item stops after step 10 in frames, the decode at the chunk's end)
GEN_RUN = dict(steps=24, r=1, chunk=8)
GEN_STOP = dict(steps=24, r=2, chunk=4)


def make_inputs(seed=0):
    rs = np.random.RandomState(seed)
    x_lens = np.array([9, 7, 5])
    x = np.zeros((3, 9), np.int64)
    for i, n in enumerate(x_lens):
        x[i, :n] = rs.randint(1, len(phonemes), n)
    return {'x': x, 'x_len': x_lens,
            'mel': rs.randn(3, 12, N_MELS).astype(np.float32),
            'speaker_emb': rs.rand(3, 16).astype(np.float32)}


@functools.lru_cache(maxsize=1)
def _jax_teacher():
    """The narrow JAX teacher and seeded variables on the shapes of its
    init (``eval_shape``: nothing compiles)."""
    import jax

    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTacotron

    jmodel = JaxTacotron(num_chars=len(phonemes), n_mels=N_MELS, **NARROW)
    batch = make_inputs()
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        {k: jax.numpy.asarray(batch[k]) for k in ('x', 'mel', 'speaker_emb')},
        r=2, train=False))
    return jmodel, _random_variables(shapes, seed=7)


def port_teacher():
    """A port teacher with the JAX variables; they carry back exactly."""
    _, variables = _jax_teacher()
    model = Tacotron(num_chars=len(phonemes), n_mels=N_MELS, **NARROW)
    missing, unexpected = model.load_state_dict(
        from_jax_variables(variables), strict=False)
    assert sorted(missing) == BUFFERS and unexpected == []
    back = to_jax_variables(model.state_dict())
    for col in ('params', 'batch_stats'):
        flat = dict(_leaves(back[col]))
        want = dict(_leaves(variables[col]))
        assert flat.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    return model


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def no_dropout(model):
    """The port's dropout and zoneout off, in place."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, 'dropout') and isinstance(m.dropout, float):
            m.dropout = 0.0
    model.decoder.zoneout = 0.0
    return model


@pytest.fixture(scope='module', params=list(DTYPES))
def eval_case(request):
    """(dtype name, inputs, the JAX teacher's eval forward and both
    generate runs) with rows 1 and 2 in interpret mode; one compile per
    dtype."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models import tacotron as jax_tacotron
    from forwardtacotron_tpu.train.common import cast_floats

    jmodel, variables = _jax_teacher()
    inputs = make_inputs(1)
    mp = request.param == 'bfloat16'
    v = cast_floats(variables, jnp.bfloat16) if mp else variables
    batch = {k: jnp.asarray(inputs[k]) for k in ('x', 'mel', 'speaker_emb')}
    if mp:
        batch = cast_floats(batch, jnp.bfloat16)
    stopper = jmodel.clone(stop_threshold=1e9)

    def run(v, batch, x_lens):
        fwd = jmodel.apply(v, batch, r=2, train=False, x_lens=x_lens)
        gen = jmodel.apply(v, batch['x'], batch['speaker_emb'],
                           method=jmodel.generate, **GEN_RUN)
        stop = stopper.apply(v, batch['x'], batch['speaker_emb'],
                             method=stopper.generate, **GEN_STOP)
        return fwd, gen, stop

    with pytest.MonkeyPatch.context() as mp_env:
        mp_env.setenv('FTT_PALLAS_INTERPRET', '1')
        mp_env.setattr(jax_tacotron, 'DECODER_SCAN_UNROLL', 1)
        args = (v, batch, jnp.asarray(inputs['x_len']))
        want = jax.jit(run).lower(*args).compile(QUICK_COMPILE)(*args)
    return request.param, inputs, jax.tree.map(np.asarray, want)


def _close(got, want, tol, name):
    scaled_close(got, np.asarray(want, np.float32), tol, 1.0, name)


def test_eval_forward_and_generate_match_jax(eval_case):
    name, inputs, (fwd, gen, stop) = eval_case
    dtype = DTYPES[name]
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    model = port_teacher().to(dtype).eval()
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    batch = {'x': t['x'], 'mel': t['mel'].to(dtype),
             'speaker_emb': t['speaker_emb'].to(dtype)}
    with torch.inference_mode():
        got = model(batch, r=2, x_lens=t['x_len'])
        gen_got = model.generate(t['x'], batch['speaker_emb'], **GEN_RUN)
        stopper = copy.deepcopy(model)
        stopper.stop_threshold.fill_(1e9)
        stop_got = stopper.generate(t['x'], batch['speaker_emb'], **GEN_STOP)
    # the teacher-forced forward's decoder and postnet compute in float32
    assert [o.dtype for o in got] == [torch.float32] * 3
    for label, g, w in zip(('mel', 'linear', 'attention'), got, fwd):
        _close(g, w, tol, f'forward {label}')
    # padded tokens get no attention
    assert float(got[2][1, :, 7:].abs().max()) == 0.0
    for case, g, w in (('run', gen_got, gen), ('stop', stop_got, stop)):
        assert [o.dtype for o in g[:3]] == [dtype] * 3
        for label, gi, wi in zip(('mel', 'linear', 'attention'), g, w):
            _close(gi, wi, tol, f'generate ({case}) {label}')
        np.testing.assert_array_equal(g[3].numpy(), w[3])
    assert gen_got[3].tolist() == [24] * 3
    # every frame is below the threshold: each item stops at its first
    # step past frame 10 (step 6 at r = 2: 7 steps counted), the decode at
    # the end of that chunk of 4 steps, and the steps after it are zeros
    assert stop_got[3].tolist() == [7] * 3
    assert float(stop_got[0][:, 16:].abs().max()) == 0.0
    assert float(stop_got[0][:, :16].abs().min()) > 0.0


def test_cells_and_attention_match_jax():
    import jax.numpy as jnp

    from forwardtacotron_tpu.models import tacotron as jt

    from forwardtacotron_torch.models import tacotron as tt

    rs = np.random.RandomState(3)
    b, i, h, n = 4, 24, 16, 11
    x, hh, c = (rs.randn(b, d).astype(np.float32) for d in (i, h, h))
    gru = tt.GRUCellP(i, h)
    lstm = tt.LSTMCellP(i, h)
    lsa = tt.LSA(h)

    def cell_vars(cell):
        return {'params': {'wi': cell.weight_ih.detach().numpy().T,
                           'wh': cell.weight_hh.detach().numpy().T,
                           'bi': cell.bias_ih.detach().numpy(),
                           'bh': cell.bias_hh.detach().numpy()}}
    t = torch.from_numpy
    with torch.no_grad():
        want = jt.GRUCellP(h).apply(cell_vars(gru), jnp.asarray(x),
                                    jnp.asarray(hh))
        _close(gru(t(x), t(hh)), want, 1e-6, 'GRUCellP')
        want = jt.LSTMCellP(h).apply(cell_vars(lstm), jnp.asarray(x),
                                     jnp.asarray(hh), jnp.asarray(c))
        for g, w, name in zip(lstm(t(x), t(hh), t(c)), want, ('h', 'c')):
            _close(g, w, 1e-6, f'LSTMCellP {name}')
        proj = rs.randn(b, n, h).astype(np.float32)
        cum = rs.rand(b, n).astype(np.float32)
        att = rs.rand(b, n).astype(np.float32)
        mask = np.arange(n)[None] >= np.array([11, 9, 6, 3])[:, None]
        sd = {k: v.numpy() for k, v in lsa.state_dict().items()}
        lsa_vars = {'params': {
            'conv': {'kernel': sd['conv.weight'].transpose(2, 1, 0)},
            'L': {'kernel': sd['L.weight'].T, 'bias': sd['L.bias']},
            'W': {'kernel': sd['W.weight'].T, 'bias': sd['W.bias']},
            'v': {'kernel': sd['v.weight'].T}}}
        want = jt.LSA(h).apply(lsa_vars, jnp.asarray(proj), jnp.asarray(hh),
                               jnp.asarray(cum), jnp.asarray(att),
                               jnp.asarray(mask))
        got = lsa(t(proj), t(hh), t(cum), t(att), t(mask))
        _close(got, want, 1e-6, 'LSA')
        assert float(got[mask].abs().max()) == 0.0
        # a bf16 cell promotes to the float32 input's dtype, exactly
        gru16 = copy.deepcopy(gru).to(torch.bfloat16)
        promoted = copy.deepcopy(gru16).float()
        torch.testing.assert_close(gru16(t(x), t(hh)),
                                   promoted(t(x), t(hh)), rtol=0, atol=0)


@pytest.fixture(scope='module', params=list(DTYPES))
def train_case(request):
    """(precision, inputs, the JAX loss, outputs, gradients and updated
    BatchNorm statistics) at r = 2 with dropout and zoneout off."""
    import flax.linen
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models import tacotron as jax_tacotron
    from forwardtacotron_tpu.train.common import cast_floats

    class NoDropout(flax.linen.Module):
        rate: float = 0.0
        deterministic: bool = None

        def __call__(self, x, deterministic=None, rng=None):
            return x

    jmodel, variables = _jax_teacher()
    inputs = make_inputs(2)
    mp = request.param == 'bfloat16'

    def loss_fn(params, batch):
        apply_vars = {'params': cast_floats(params, jnp.bfloat16)
                      if mp else params,
                      'batch_stats': variables['batch_stats']}
        apply_batch = cast_floats(batch, jnp.bfloat16) if mp else batch
        (mel, lin, attn), mutated = jmodel.apply(
            apply_vars, apply_batch, r=2, train=True,
            rngs={'dropout': jax.random.PRNGKey(3)}, mutable=['batch_stats'])
        mel, lin, attn = (a.astype(jnp.float32) for a in (mel, lin, attn))
        m1 = jnp.mean(jnp.abs(mel - batch['mel']))
        m2 = jnp.mean(jnp.abs(lin - batch['mel']))
        return m1 + m2, (m1, m2, mel, lin, attn, mutated['batch_stats'])

    batch = {k: jnp.asarray(inputs[k]) for k in ('x', 'mel', 'speaker_emb')}
    params = jax.tree.map(jnp.asarray, variables['params'])
    with pytest.MonkeyPatch.context() as mp_env:
        mp_env.setattr(flax.linen, 'Dropout', NoDropout)
        mp_env.setattr(jax_tacotron, '_zoneout',
                       lambda key, prev, current, p=0.1: current)
        mp_env.setattr(jax_tacotron, 'DECODER_SCAN_UNROLL', 1)
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, aux), grads = step.lower(params, batch).compile(
            QUICK_COMPILE)(params, batch)
    return (request.param, inputs,
            jax.tree.map(np.asarray, (loss, aux, grads)))


def test_train_step_matches_jax(train_case, tmp_path, monkeypatch):
    precision, inputs, (loss, aux, grads) = train_case
    m1, m2, mel, lin, attn, stats = aux
    mp = precision == 'bfloat16'
    tol = 5e-2 if mp else 1e-4
    outs = {}
    real_forward = Tacotron.forward

    def keep_outputs(self, *args, **kwargs):
        out = real_forward(self, *args, **kwargs)
        outs['mel'], outs['linear'] = out[0], out[1]
        return out
    monkeypatch.setattr(Tacotron, 'forward', keep_outputs)

    def step(prec):
        config = teacher_config(tmp_path, prec)
        trainer = TacoTrainer(Paths.from_config(config), None, config,
                              device='cpu')
        model = no_dropout(port_teacher())
        params = dict(model.named_parameters())
        batch = {k: torch.from_numpy(inputs[k])
                 for k in ('x', 'mel', 'speaker_emb')}
        got = trainer.loss_fn(model.train(), params, batch, 2,
                              torch.Generator().manual_seed(0))
        got[0].backward()
        return model, params, got

    model, params, (t_loss, metrics, t_attn) = step(precision)
    _close(t_loss.detach(), loss, tol, 'loss')
    _close(metrics['m1'].detach(), m1, tol, 'm1')
    _close(metrics['m2'].detach(), m2, tol, 'm2')
    _close(outs['mel'].detach().float(), mel, tol, 'mel')
    _close(outs['linear'].detach().float(), lin, tol, 'linear')
    _close(t_attn.detach(), attn, tol, 'attention')
    ref = from_jax_variables({'params': grads})
    assert set(ref) == set(params)
    for name, p in params.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name
    if not mp:
        for name, p in params.items():
            scaled_close(p.grad, ref[name].numpy(), 1e-4, 1e-3, name)
    else:
        # bf16 rounds the encoder, its projections and the decoder PreNet:
        # the port's gradients are held to the float32 ones no further
        # than the JAX package's bf16 gradients are
        _, params32, _ = step('float32')
        sq = np.zeros(3)
        for name, p in params.items():
            truth = params32[name].grad.numpy()
            ours = np.sum((p.grad.numpy() - truth) ** 2)
            theirs = np.sum((ref[name].numpy() - truth) ** 2)
            norm = max(np.sum(truth ** 2), 1e-24)
            sq += (ours, theirs, np.sum(truth ** 2))
            assert np.sqrt(ours / norm) <= (1.5 * np.sqrt(theirs / norm)
                                            + 0.01), name
        assert np.sqrt(sq[0]) <= 1.25 * np.sqrt(sq[1]) + 0.01 * np.sqrt(sq[2])
    buffers = dict(model.named_buffers())
    for name, want in from_jax_variables({'batch_stats': stats}).items():
        if name.endswith(('running_mean', 'running_var')):
            _close(buffers[name], want.numpy(), tol, name)


def test_dropout_and_zoneout_masks():
    """The masks' rates: PreNet dropout 0.5 wherever ``dropout_on`` (or
    ``prenet_dropout_on``) is set, zoneout keeping ~10% of the previous
    state in training; both drawn from the generator passed, so a
    training forward repeats with the same seeds and changes with
    another."""
    from forwardtacotron_torch.models.tacotron import PreNet, _zoneout

    torch.manual_seed(0)
    prenet = PreNet(8)
    x = torch.rand(512, 8) + 1.0
    with torch.no_grad():
        clean = prenet(x)
        dropped = prenet(x, dropout_on=True,
                         generator=torch.Generator().manual_seed(1))
        again = prenet(x, dropout_on=True,
                       generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(dropped, again, rtol=0, atol=0)
    alive = clean > 0
    assert 0.2 < float((dropped[alive] == 0).float().mean()) < 0.8
    prev, cur = torch.zeros(256, 512), torch.ones(256, 512)
    kept = _zoneout(prev, cur, 0.1, torch.Generator().manual_seed(2))
    assert abs(float((kept == 0).float().mean()) - 0.1) < 0.005

    # through the model: eval with prenet_dropout_on differs from eval
    # without; training draws differ across generator seeds only
    model = port_teacher().eval()
    t = {k: torch.from_numpy(v) for k, v in make_inputs(1).items()}
    batch = {k: t[k] for k in ('x', 'mel', 'speaker_emb')}
    with torch.no_grad():
        plain = model(batch, r=2)[0]
        forced = model(batch, r=2, prenet_dropout_on=True,
                       generator=torch.Generator().manual_seed(3))[0]
        assert float((plain - forced).abs().max()) > 1e-3
        model.train()
        runs = []
        for seed in (4, 4, 5):
            # the CBHGs' nn.Dropout draws from torch's default generator
            torch.manual_seed(0)
            runs.append(model(batch, r=2, generator=torch.Generator()
                              .manual_seed(seed))[0])
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert float((runs[0] - runs[2]).abs().max()) > 1e-3
    with pytest.raises(ValueError, match='eval'):
        model.eval()(batch, r=2, train=True)


def test_bigrus_never_reach_recurrent_kernels(monkeypatch):
    """The encoder's BiGRU (H 128, 128 inputs: eligible in bf16) takes the
    per-step loop under every ``rnn_mode``, in eval, ``generate`` and a
    bf16 train step; every parameter gets a gradient."""
    def refuse(*args, **kwargs):
        raise AssertionError('the teacher reached a recurrent kernel')
    monkeypatch.setattr(rnn_ops, 'gru', refuse)
    monkeypatch.setattr(rnn_ops, 'lstm', refuse)
    monkeypatch.setattr(rnn_train.GruCore, 'apply', refuse)
    model = port_teacher().to(torch.bfloat16).eval()
    t = {k: torch.from_numpy(v) for k, v in make_inputs(1).items()}
    batch = {'x': t['x'], 'mel': t['mel'].bfloat16(),
             'speaker_emb': t['speaker_emb'].bfloat16()}
    for mode in ('on', 'train', 'off'):
        with rnn_train.rnn_mode(mode), torch.no_grad():
            model(batch, r=2)
            model.generate(t['x'], batch['speaker_emb'], steps=4, chunk=4)
    model = port_teacher().train()
    params = {k: p.bfloat16() for k, p in model.named_parameters()}
    for p in params.values():
        p.retain_grad()
    with rnn_train.rnn_mode('train'):
        out = torch.func.functional_call(model, params, (batch, 2))
    sum(o.float().abs().mean() for o in out[:2]).backward()
    for name, p in params.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name


@pytest.mark.parametrize('source', ['singlespeaker', 'multispeaker'])
def test_bridge_and_reference_schema(source, tmp_path):
    """Full width: the JAX teacher's variables -> the port (strict, only
    the buffers missing) -> back exactly, also through the JAX package's
    own converter; the singlespeaker teacher's state_dict is the
    reference schema's 254 keys and a reference-format .pt loads with
    plain ``load_state_dict``."""
    import jax

    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTacotron
    from forwardtacotron_tpu.utils.convert import convert_state_dict

    config = read_config(REPO / 'configs' / f'{source}.yaml')
    jmodel = JaxTacotron.from_config(config)
    semb = config['tacotron']['model']['speaker_emb_dim']
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        {'x': jax.numpy.ones((1, 8), np.int32),
         'mel': jax.numpy.zeros((1, 20, 80), np.float32),
         'speaker_emb': jax.numpy.zeros((1, max(semb, 1)), np.float32)},
        r=2, train=False))
    variables = _random_variables(shapes, seed=11)
    model = Tacotron.from_config(config)
    missing, unexpected = model.load_state_dict(
        from_jax_variables(variables), strict=False)
    assert sorted(missing) == BUFFERS and unexpected == []
    sd = model.state_dict()
    for back in (to_jax_variables(sd), convert_state_dict(sd)[0]):
        for col in ('params', 'batch_stats'):
            got, want = dict(_leaves(back[col])), dict(_leaves(variables[col]))
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if source == 'singlespeaker':
        schema = json.loads((REPO / 'tests' / 'resources' /
                             'reference_state_dict_schema.json').read_text())
        assert {k: list(v.shape) for k, v in sd.items()} == \
            schema['models']['tacotron']
        assert len(sd) == 254
        torch.save({'model': sd, 'config': config}, tmp_path / 'taco.pt')
        fresh = Tacotron.from_config(config)
        fresh.load_state_dict(torch.load(tmp_path / 'taco.pt')['model'])
        for k, v in fresh.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def teacher_config(tmp_path, precision='float32'):
    """configs/singlespeaker.yaml with the narrow teacher (no speaker
    embedding), 16 mels, two short sessions (r 2 to step 4 at batch 3, r 1
    to step 6 at batch 2) and the data under ``tmp_path``."""
    config = read_config(REPO / 'configs' / 'singlespeaker.yaml')
    config['dsp']['num_mels'] = N_MELS
    config['tacotron']['model'].update(NARROW, speaker_emb_dim=0)
    train = config['tacotron']['training']
    train['precision'] = precision
    train['schedule'] = ['2, 1e-3, 4, 3', '1, 1e-4, 6, 2']
    train['checkpoint_every'] = 2
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    return config


def test_taco_dataloaders_match_jax(tmp_path):
    from forwardtacotron_tpu.data.dataset import \
        get_taco_dataloaders as jax_loaders
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    from forwardtacotron_torch.data.dataset import get_taco_dataloaders

    config = teacher_config(tmp_path)
    write_dataset(config)
    filt = config['tacotron']['training']['filter']
    train, val = get_taco_dataloaders(Paths.from_config(config), 3, r=3,
                                      bucket_multiple=3, seed=0, **filt)
    j_train, j_val = jax_loaders(JaxPaths.from_config(config), 3, r=3,
                                 bucket_multiple=3, **filt)
    got, want = list(val), list(j_val)
    assert len(got) == len(want) == 1
    for key in ('x', 'mel', 'x_len', 'mel_len', 'speaker_emb', 'item_id'):
        np.testing.assert_array_equal(got[0][key], want[0][key], key)
    assert got[0]['mel'].shape[1] % 3 == 0
    ids = sorted(i for b in train for i in b['item_id'])
    assert ids == sorted(i for b in j_train for i in b['item_id'])
    assert len(ids) == 6 and all(b['mel'].shape[1] % 3 == 0 for b in train)


def _extraction_files(paths):
    """{subdirectory: {file name: contents}} of what the extraction
    writes."""
    return {sub: {p.name: np.load(p)
                  for p in sorted(getattr(paths, sub).glob('*.npy'))}
            for sub in ('att_pred', 'alg', 'phon_pitch', 'phon_energy')}


@pytest.mark.usefixtures('no_tensorboard')
def test_train_tacotron_cli_on_cpu(tmp_path, capsys):
    """Two sessions to a checkpoint, then the extraction that follows
    training (``att_pred/``, ``alg/``, ``duration_stats.pkl``,
    ``phon_pitch/``, ``phon_energy/`` for every item); a resume that only
    restores and extracts the same files again; ``--force_gta`` writing one
    .npy per item equal to the checkpoint's eval forward at r = 1;
    ``--force_align`` (extraction alone) and ``--extract_pitch`` (the
    targets alone) rewriting the same files."""
    from forwardtacotron_torch import train_tacotron
    from forwardtacotron_torch.data.dataset import (get_taco_dataloaders,
                                                    load_duration_stats)
    from forwardtacotron_torch.utils.checkpoints import (checkpoint_step,
                                                         restore_checkpoint)
    from forwardtacotron_torch.utils.files import unpickle_binary

    config = teacher_config(tmp_path)
    config['duration_extraction']['num_workers'] = 0
    paths = write_dataset(config)
    items = dict(unpickle_binary(paths.train_dataset)
                 + unpickle_binary(paths.val_dataset))
    texts = unpickle_binary(paths.text_dict)
    rs = np.random.RandomState(5)
    for item_id, mel_len in items.items():
        np.save(paths.raw_pitch / f'{item_id}.npy',
                rs.uniform(80, 300, mel_len).astype(np.float32))
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.dump(config))
    argv = ['--config', str(path), '--device', 'cpu']
    train_tacotron.main(argv)
    ckpt = restore_checkpoint(paths.taco_checkpoints)
    assert checkpoint_step(ckpt) == 6
    assert int(ckpt['model']['decoder.r']) == 1
    assert (paths.taco_checkpoints / 'taco_step0k.pt').is_file()
    assert set(ckpt['optim']) == {'count', 'mu', 'nu', 'learning_rate'}
    assert int(ckpt['optim']['count']) == 6
    log = (paths.taco_log / 'metrics.csv').read_text().splitlines()
    tags = {line.split(',')[1] for line in log}
    assert {'Loss/train', 'Loss/val', 'Attention_Score/loc',
            'Attention_Score/sharpness'} <= tags
    files = _extraction_files(paths)
    for sub, written in files.items():
        assert sorted(written) == sorted(f'{i}.npy' for i in items), sub
    for item_id, mel_len in items.items():
        n_tok = len(texts[item_id])
        assert files['att_pred'][f'{item_id}.npy'].shape == (mel_len, n_tok)
        alg = files['alg'][f'{item_id}.npy']
        assert alg.dtype == np.int64 and alg.sum() == mel_len
        for sub in ('phon_pitch', 'phon_energy'):
            target = files[sub][f'{item_id}.npy']
            assert target.shape == (n_tok,) and np.isfinite(target).all()
    assert sorted(load_duration_stats(paths.duration_stats)) == sorted(items)
    assert 'Avg attention sharpness' in capsys.readouterr().out
    train_tacotron.main(argv)
    assert 'Restored checkpoint at step 6' in capsys.readouterr().out
    assert int(restore_checkpoint(paths.taco_checkpoints)['optim']['count']) \
        == 6
    _assert_same_files(_extraction_files(paths), files)
    train_tacotron.main(argv + ['--force_gta'])
    written = sorted(p.stem for p in paths.gta.glob('*.npy'))
    assert written == [f'item{i}' for i in range(8)]
    model = Tacotron.from_config(config)
    model.load_state_dict(ckpt['model'])
    model.eval()
    train_set, _ = get_taco_dataloaders(paths, 8, r=1,
                                        **config['tacotron']['training'][
                                            'filter'])
    batch = next(iter(train_set))
    with torch.no_grad():
        _, linear, _ = model({k: torch.as_tensor(batch[k])
                              for k in ('x', 'mel', 'speaker_emb')}, r=1)
    for j, item_id in enumerate(batch['item_id']):
        gta = np.load(paths.gta / f'{item_id}.npy')
        assert gta.shape == (N_MELS, batch['mel_len'][j])
        np.testing.assert_allclose(
            gta, linear[j, :batch['mel_len'][j]].T.numpy(), rtol=0,
            atol=1e-5)
    # each mode rewrites its files from scratch
    for flag, subs in (('--force_align', files), ('--extract_pitch',
                                                  ('phon_pitch',
                                                   'phon_energy'))):
        for sub in subs:
            for p in getattr(paths, sub).glob('*.npy'):
                p.unlink()
        train_tacotron.main(argv + [flag])
        _assert_same_files(_extraction_files(paths), files)
    assert 'Restored checkpoint at step 6' in capsys.readouterr().out
    assert restore_checkpoint(paths.taco_checkpoints)['optim']['count'] == 6


def _assert_same_files(got, want):
    assert {k: sorted(v) for k, v in got.items()} == \
        {k: sorted(v) for k, v in want.items()}
    for sub, written in want.items():
        for name, value in written.items():
            np.testing.assert_array_equal(got[sub][name], value,
                                          f'{sub}/{name}')
