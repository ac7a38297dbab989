"""The port's MultiForwardTacotron against the JAX package's, with the same
seeded variables carried across by ``from_jax_variables``
(tests/torch_training_setup.py): ``forward`` in eval and train mode,
``predict_series`` (the pitch condition's argmax, the batch-wide
duration guard) and ``generate``; ``TTSInference``'s four entry points
with ``speaker_emb`` in float32 and bfloat16, the routed one with mixed
speakers in several groups; the reference state_dict schema at full
width, both directions of the weight bridge, and ``gen_forward
--speaker``.

The JAX side is compiled as few times as the checks allow: its
TTSInference runs ``generate`` in float32 and ``generate_fused`` in
bfloat16 once each, and the port's other entry points are held to the
same requests' rows of those outputs (an item's valid frames do not
depend on its batch or frame budget). The JAX side runs with
FTT_PALLAS_INTERPRET=1 in bfloat16, so its Pallas kernels run in
interpret mode: the narrow model's trunk LSTM (2 x 32 + 64 = 128 inputs)
takes the fused frame trunk and its 128-wide pitch GRU the recurrent
kernel, as at the published widths; the port runs its twins.
Tolerances: float32 1e-5 at the output's scale (max(1, max |JAX|));
bfloat16 the JAX package's bf16 model tolerance, 8e-2 at the output's
scale on valid frames (tests/test_fused_trunk.py), frame counts exact. The
JAX package's bf16 path takes the fused kernels only for a bf16 speaker
embedding (tests/test_fused_trunk.py passes one); the port casts the
embedding to the activations' dtype, so both sides are given bf16 values.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from forwardtacotron_torch.models.multi_forward_tacotron import \
    MultiForwardTacotron
from forwardtacotron_torch.models.registry import (MULTISPEAKER_MODELS,
                                                   init_tts_model,
                                                   is_multispeaker)
from forwardtacotron_torch.models.synthesis import TTSInference
from forwardtacotron_torch.ops.hopper import rnn
from forwardtacotron_torch.utils.convert import (from_jax_variables,
                                                 to_jax_variables)
from forwardtacotron_torch.utils.files import read_config

from torch_training_setup import (MULTI_NARROW, close_at_scale,
                                  family_config, family_models,
                                  full_width_model, jax_forward,
                                  make_multi_batch, narrow_config,
                                  rounding_margin, speaker_table,
                                  teacher_batch)

FAMILY = 'multi_forward_tacotron'
SCHEMA = Path('tests/resources/reference_state_dict_schema.json')
F32_ATOL, BF16_ATOL = 1e-5, 8e-2
DIMS = MULTI_NARROW['speaker_emb_dims']
# the smallest distance of a predicted duration from a rounding point
# (d + 0.5 an integer): bf16 predictions of the two packages differ by a
# few hundredths, which must not move a frame count
DUR_MARGIN = 0.04
# the smallest gap between a token's two largest pitch-condition logits
# (of up to 8): the argmax must not flip between the packages in bf16
PITCH_COND_GAP = 0.1
# the float32 entry points run at this alpha, bfloat16 at 1 (where the
# margins above are set); the fused budget holds every request uncropped
ALPHA, BUDGET = 1.2, 48


def _bf16_values(a):
    """float32 numpy values that bfloat16 holds exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.fixture(scope='module')
def models():
    """The JAX model and variables, the port's float32 model with the same
    weights, three requests (two padded) and their speakers. The
    pitch-condition head's logits vary by token (all three classes come
    out, no two top logits within PITCH_COND_GAP); the duration head reads
    the token embedding strongly (0-4 frames a token) and its bias is
    shifted so that no duration lies within DUR_MARGIN of a rounding
    point. The heads are tuned on the port's model, which holds the same
    weights (float32 agreement is checked by the tests)."""
    import jax

    config = family_config(FAMILY, 'float32', Path('unused'))
    jmodel, variables, tmodel = family_models(config)
    variables = jax.tree.map(np.copy, variables)
    rs = np.random.RandomState(8)
    x = rs.randint(1, 60, (3, 12)).astype(np.int64)
    x[1, 9:] = 0
    x[2, 5:] = 0
    semb = _bf16_values(speaker_table(3, DIMS, 9))
    tx, ts = torch.from_numpy(x), torch.from_numpy(semb)

    def load():
        missing, unexpected = tmodel.load_state_dict(
            from_jax_variables(variables), strict=False)
        assert missing == ['step'] and unexpected == []

    p = variables['params']['pitch_cond_pred']
    p['embedding']['embedding'] *= 4.0
    p['lin']['kernel'] *= 20.0
    p['lin']['bias'][:] = 0.0
    load()
    with torch.no_grad():
        lg = tmodel.pitch_cond_pred(tx, ts).numpy()
    p['lin']['bias'][:] = -lg.reshape(-1, 3).mean(0)
    load()
    with torch.no_grad():
        lg = np.sort(tmodel.pitch_cond_pred(tx, ts).numpy(), -1)
    assert float((lg[..., -1] - lg[..., -2]).min()) >= PITCH_COND_GAP
    p = variables['params']['dur_pred']
    p['embedding']['embedding'] *= 6.0
    p['lin']['kernel'] *= 3.0
    p['lin']['bias'][:] = 0.0
    load()
    with torch.no_grad():
        pitch_cond = tmodel.predict_series(tx, ts)['pitch_cond']
        dur = tmodel.dur_pred(tx, pitch_cond, ts)[..., 0].numpy()
    shift = 2.0 - dur.mean()
    dur = dur + shift
    best = max(np.linspace(0.0, 0.95, 20),
               key=lambda s: rounding_margin(dur + s))
    p['lin']['bias'][:] = shift + best
    assert rounding_margin(dur + best) >= DUR_MARGIN
    load()
    return jmodel, variables, tmodel, x, semb


@pytest.fixture(scope='module')
def jax_forward_outputs(models):
    jmodel, variables, _, x, semb = models
    return jax_forward(jmodel, variables, teacher_batch(x, semb))


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_forward_matches_jax(models, jax_forward_outputs, train):
    """The teacher-forced ``forward`` (the JAX ``__call__``): every output,
    the pitch-condition logits among them; in training mode with batch
    statistics (dropout 0), whose running statistics move as flax's."""
    _, _, tmodel, x, semb = models
    batch = teacher_batch(x, semb)
    want = jax_forward_outputs[train]
    if train:
        want, mutated = want
    model = copy.deepcopy(tmodel).train(train)
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    assert set(got) == set(want)
    assert got['pitch_cond'].shape == (3, 12, 3)
    for key in want:
        close_at_scale(got[key], want[key], F32_ATOL)
    if train:
        sd = model.state_dict()
        stats = mutated['batch_stats']
        for path in (('dur_pred', 'convs_0'), ('pitch_cond_pred', 'convs_2'),
                     ('postnet', 'conv_project2')):
            leaf = stats[path[0]][path[1]]['bnorm']
            key = '.'.join([path[0], *path[1].split('_'), 'bnorm'])
            if path[0] == 'postnet':
                key = 'postnet.conv_project2.bnorm'
            close_at_scale(sd[f'{key}.running_mean'], leaf['mean'], F32_ATOL)
            close_at_scale(sd[f'{key}.running_var'], leaf['var'], F32_ATOL)


@pytest.fixture(scope='module')
def jax_outputs(models):
    """The JAX TTSInference's float32 ``generate`` at ALPHA and bfloat16
    ``generate_fused`` at BUDGET (kernels in interpret mode, the calls
    into them recorded) for the three requests."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.synthesis import TTSInference as JTTS
    from forwardtacotron_tpu.ops.pallas import rnn as jrnn
    jmodel, variables, _, x, semb = models
    v = jax.tree.map(jnp.asarray, variables)
    f32 = JTTS(jmodel, v, dtype='float32').generate(
        x, speaker_emb=jnp.asarray(semb), alpha=ALPHA)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('FTT_PALLAS_INTERPRET', '1')
        for name in ('lstm_lr_mel_sharded', 'bidir_rnn_pallas_sharded'):
            fn = getattr(jrnn, name)
            mp.setattr(jrnn, name, lambda *a, _f=fn, _n=name, **k: (
                calls.append(_n), _f(*a, **k))[1])
        jtts = JTTS(jmodel, v, dtype='bfloat16')
        assert jtts.multispeaker
        bf16 = jtts.generate_fused(
            x, BUDGET, speaker_emb=jnp.asarray(semb, jnp.bfloat16))
    out = {'float32': f32, 'bfloat16': bf16}
    return ({dt: {k: np.array(o[k], np.float32) for k in o}
             for dt, o in out.items()}, sorted(set(calls)))


def test_predict_series_and_generate_match_jax(models, jax_outputs):
    """``predict_series`` at ALPHA (its ``pitch_cond`` the argmax, exactly
    the JAX one; the JAX TTSInference ran the same method), then
    ``generate`` at the JAX call's bucket: frames past each item's
    expanded length are zero."""
    _, _, tmodel, x, semb = models
    want = jax_outputs[0]['float32']
    with torch.no_grad():
        got = tmodel.predict_series(torch.from_numpy(x),
                                    torch.from_numpy(semb), alpha=ALPHA)
    np.testing.assert_array_equal(got['pitch_cond'].numpy(),
                                  want['pitch_cond'])
    assert len(np.unique(got['pitch_cond'].numpy())) == 3
    for key in ('dur', 'pitch', 'energy'):
        close_at_scale(got[key], want[key], F32_ATOL)
    series = [torch.from_numpy(want[k]) for k in ('dur', 'pitch', 'energy')]
    series.append(torch.from_numpy(want['pitch_cond']).long())
    budget = want['mel'].shape[1]
    with torch.no_grad():
        got = tmodel.generate(torch.from_numpy(x), torch.from_numpy(semb),
                              *series, budget)
    for key in ('mel', 'mel_post'):
        close_at_scale(got[key], want[key], F32_ATOL)
    lens = want['mel_len'].astype(int)
    assert 0 < lens.min() and lens.max() < budget
    for i, n in enumerate(lens):
        assert torch.count_nonzero(got['mel'][i, n:]) == 0


def test_predict_series_guard_is_batch_wide(models):
    """Where the truncated durations of the whole batch sum to <= 0 every
    duration becomes 2 frames, as in JAX."""
    from forwardtacotron_tpu.models.multi_forward_tacotron import \
        MultiForwardTacotron as JMFT
    jmodel, variables, _, x, semb = models
    v = copy.deepcopy(variables)
    v['params']['dur_pred']['lin']['kernel'][:] = 0.0
    v['params']['dur_pred']['lin']['bias'][:] = 0.6
    tmodel = init_tts_model(family_config(FAMILY, 'float32', Path('unused')))
    tmodel.load_state_dict(from_jax_variables(v), strict=False)
    want = jmodel.apply(v, x, semb, method=JMFT.predict_series)
    with torch.no_grad():
        got = tmodel.predict_series(torch.from_numpy(x),
                                    torch.from_numpy(semb))
    close_at_scale(got['dur'], want['dur'], F32_ATOL)
    assert bool((got['dur'] == 2.0).all())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_tts_inference_entry_points_match_jax(models, jax_outputs, dtype,
                                              monkeypatch):
    """generate, generate_cropped ([D] for one request), generate_routed
    (requests reordered, so each group mixes speakers; several groups)
    and generate_fused with ``speaker_emb``, each against the JAX
    TTSInference's outputs for the same requests (float32: its
    ``generate``; bfloat16: its ``generate_fused``, no request cropped by
    BUDGET). bfloat16 generate_fused reaches the same kernels on both
    sides: the fused trunk and the 128-wide pitch GRU (JAX: Pallas in
    interpret mode; the port: the twins)."""
    _, _, tmodel, x, semb = models
    outs, jcalls = jax_outputs
    want = outs[dtype]
    tts = TTSInference(copy.deepcopy(tmodel), dtype=dtype, device='cpu')
    assert tts.multispeaker
    atol = F32_ATOL if dtype == 'float32' else BF16_ATOL
    alpha = ALPHA if dtype == 'float32' else 1.0
    lens = want['mel_len'].astype(int)
    assert lens.max() <= BUDGET
    n = min(BUDGET, want['mel'].shape[1])

    def check(got, keys, rows=slice(None)):
        for key in keys:
            g = got[key]
            if key in ('mel', 'mel_post'):
                m = min(n, g.shape[1])
                valid = np.arange(m)[None] < lens[rows, None]
                close_at_scale(g[:, :m], want[key][rows, :m], atol, valid)
            else:
                close_at_scale(g, want[key][rows], atol)

    keys = ('mel', 'mel_post', 'dur', 'pitch', 'energy')
    got = tts.generate(x, speaker_emb=semb, alpha=alpha)
    np.testing.assert_array_equal(got['mel_len'].numpy(), lens)
    np.testing.assert_array_equal(got['pitch_cond'].numpy(),
                                  want['pitch_cond'])
    check(got, keys)

    got = tts.generate_cropped(x[2], speaker_emb=semb[2], alpha=alpha)
    assert got['mel'].shape == (want['mel'].shape[2], lens[2])
    check({k: torch.from_numpy(v[None]) if v.ndim == 1
           else torch.from_numpy(v.T[None]) for k, v in got.items()},
          keys, slice(2, 3))

    order = np.array([2, 0, 1])
    got = tts.generate_routed(x[order], speaker_emb=semb[order],
                              alpha=alpha, frame_bucket=8)
    assert len(np.unique(-(-lens // 8))) > 1
    np.testing.assert_array_equal(got['mel_len'].numpy(), lens[order])
    np.testing.assert_array_equal(got['pitch_cond'].numpy(),
                                  want['pitch_cond'][order])
    check(got, ('mel', 'mel_post', 'dur'), order)

    tcalls = []
    for name in ('lstm_mel_plain', 'gru_plain'):
        fn = getattr(rnn, name)
        monkeypatch.setattr(rnn, name, lambda *a, _f=fn, _n=name: (
            tcalls.append(_n), _f(*a))[1])
    got = tts.generate_fused(x, BUDGET, speaker_emb=semb, alpha=alpha)
    assert got['mel'].shape[1] == BUDGET
    if dtype == 'bfloat16':
        assert jcalls == ['bidir_rnn_pallas_sharded', 'lstm_lr_mel_sharded']
        assert sorted(tcalls) == ['gru_plain', 'lstm_mel_plain']
    else:
        assert tcalls == []
    np.testing.assert_array_equal(got['mel_len'].numpy(), lens)
    check(got, keys)


def test_speaker_embedding_is_not_broadcast(models):
    """One embedding for a batch of three is an error, as in JAX: the
    entry points take [B, D], or [D] for one request."""
    _, _, tmodel, x, semb = models
    tts = TTSInference(copy.deepcopy(tmodel), device='cpu')
    with pytest.raises(RuntimeError):
        tts.generate(x, speaker_emb=semb[0])
    one = tts.generate(x[:1], speaker_emb=semb[0])
    two = tts.generate(x[:1], speaker_emb=semb[:1])
    assert torch.equal(one['mel'], two['mel'])


@pytest.mark.parametrize('entry', ['generate', 'generate_fused',
                                   'generate_routed', 'generate_cropped'])
def test_speaker_emb_is_required_and_refused(models, tmp_path, entry):
    """A multispeaker model called without ``speaker_emb``, and a
    single-speaker model called with one, raise ValueError naming it."""
    _, _, tmodel, x, semb = models
    args = (x[:1], 16) if entry == 'generate_fused' else (x[:1],)
    multi = TTSInference(copy.deepcopy(tmodel), device='cpu')
    with pytest.raises(ValueError, match='needs speaker_emb'):
        getattr(multi, entry)(*args)
    single = TTSInference(init_tts_model(narrow_config('float32', tmp_path)),
                          device='cpu')
    assert not single.multispeaker
    with pytest.raises(ValueError, match='speaker_emb given'):
        getattr(single, entry)(*args, speaker_emb=semb[0])


# --------------------------------------------------- weights and registry

def test_registry_builds_both_multispeaker_families():
    config = read_config('configs/multispeaker.yaml')
    assert MULTISPEAKER_MODELS == {'multi_forward_tacotron',
                                   'multi_fast_pitch'}
    for family in sorted(MULTISPEAKER_MODELS):
        model, config = full_width_model(family)
        assert is_multispeaker(config) and not model.training
        assert model.speaker_emb_dims == 256
    assert isinstance(full_width_model(FAMILY)[0], MultiForwardTacotron)
    config = dict(config, tts_model='forward_tacotron')
    assert not is_multispeaker(config)
    config['tts_model'] = 'tacotron'
    with pytest.raises(ValueError, match='not supported'):
        init_tts_model(config)


def test_state_dict_matches_reference_schema():
    """353 keys of the reference's shapes; the trunk LSTM takes 768."""
    schema = json.loads(SCHEMA.read_text())['models'][FAMILY]
    got = {k: list(v.shape)
           for k, v in full_width_model(FAMILY)[0].state_dict().items()}
    assert len(got) == 353 and got == schema
    assert got['lstm.weight_ih_l0'] == [2048, 768]


def test_weight_bridge_both_ways():
    """The JAX converter accepts the port's state_dict (validated against
    the JAX init's tree, the new ``pitch_cond_embedding`` leaves among
    them); ``to_jax_variables`` gives the converter's tree exactly and
    ``from_jax_variables`` inverts it."""
    import jax

    from forwardtacotron_tpu.models.registry import \
        init_tts_model as jax_init_tts_model
    from forwardtacotron_tpu.utils.convert import (convert_state_dict,
                                                   validate_against)
    model, config = full_width_model(FAMILY)
    model = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.uniform_(0.5, 1.5)
    sd = model.state_dict()
    variables, _ = convert_state_dict(sd)
    batch = make_multi_batch(256)
    batch['mel'] = np.zeros((3, 8, 80), np.float32)
    jmodel = jax_init_tts_model(config)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        {k: batch[k] for k in ('x', 'dur', 'mel_len', 'pitch', 'energy',
                               'mel', 'speaker_emb', 'pitch_cond')},
        train=False))
    validate_against(variables, shapes)
    assert variables['params']['dur_pred']['pitch_cond_embedding'][
        'embedding'].shape == (4, 4)

    mine = to_jax_variables(sd)
    for col in ('params', 'batch_stats'):
        flat_a = dict(jax.tree_util.tree_flatten_with_path(mine[col])[0])
        flat_b = dict(jax.tree_util.tree_flatten_with_path(
            variables[col])[0])
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            np.testing.assert_array_equal(flat_a[k], flat_b[k],
                                          err_msg=str(k))
    back = from_jax_variables(variables)
    assert set(back) == set(sd) - {'step'}
    for k, v in back.items():
        if not k.endswith('num_batches_tracked'):
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(),
                                          err_msg=k)


# -------------------------------------------------------------- gen_forward

def _checkpoint(tmp_path, speakers):
    """A reference-format narrow multispeaker checkpoint: weights, config
    and the top-level speaker table."""
    config = family_config(FAMILY, 'float32', tmp_path)
    config['dsp'].update(sample_rate=8000, n_fft=64, hop_length=16,
                         win_length=64, fmin=0, fmax=4000)
    torch.manual_seed(2)
    model = init_tts_model(config)
    with torch.no_grad():
        model.dur_pred.lin.weight.zero_()
        model.dur_pred.lin.bias.fill_(2.0)
        model.step.fill_(7000)
    path = tmp_path / 'multi.pt'
    table = speaker_table(len(speakers), DIMS, 12)
    torch.save({'model': model.state_dict(), 'config': config,
                'speaker_embeddings': dict(zip(speakers, table))}, str(path))
    return path, model, table


@pytest.mark.parametrize('batched', [False, True], ids=['one', 'batched'])
def test_gen_forward_speaker(tmp_path, batched, capsys):
    """``gen_forward --speaker`` speaks as the named speaker (the exported
    mel is ``TTSInference``'s with that embedding, and another speaker's
    differs); without ``--speaker`` it takes the first, as JAX does."""
    from forwardtacotron_torch import gen_forward
    from forwardtacotron_torch.text.cleaners import Cleaner
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    path, model, table = _checkpoint(tmp_path, ['ann', 'bob', 'cid'])
    text = tmp_path / 'text.txt'
    text.write_text('hello there.\nthe second one!\n', encoding='utf-8')
    extra = ['--batched'] if batched else []
    mels = {}
    for speaker in ('bob', None):
        out = tmp_path / f'out_{speaker}'
        gen_forward.main(['--checkpoint', str(path), '--text_file',
                          str(text), '--output', str(out), '--device',
                          'cpu', 'hifigan'] + extra
                         + (['--speaker', speaker] if speaker else []))
        mels[speaker] = [np.load(str(p)) for p in sorted(out.glob('*.npy'))]
        assert [p.name for p in sorted(out.glob('*.npy'))] == [
            '1_forward_7k_alpha1.0.npy', '2_forward_7k_alpha1.0.npy']
    assert 'No --speaker given; using "ann"' in capsys.readouterr().out
    pre = read_config('configs/multispeaker.yaml')['preprocessing']
    cleaner = Cleaner(pre['cleaner_name'], use_phonemes=False,
                      lang=pre['language'])
    tts = TTSInference(model, device='cpu')
    toks = [Tokenizer()(cleaner(s)) for s in ('hello there.',
                                              'the second one!')]
    x = np.zeros((2, max(map(len, toks))), np.int64)
    for i, t in enumerate(toks):
        x[i, :len(t)] = t
    for speaker, row in (('bob', 1), (None, 0)):
        if batched:   # one routed batch, the embedding on every row
            out = tts.generate_routed(x, speaker_emb=np.tile(table[row],
                                                             (2, 1)))
            want = [out['mel_post'][i, :int(out['mel_len'][i])].T.numpy()
                    for i in range(2)]
        else:
            want = [tts.generate_cropped(t, speaker_emb=table[row])[
                'mel_post'] for t in toks]
        for got, w in zip(mels[speaker], want):
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-5)
    for i in range(2):
        assert np.abs(mels['bob'][i] - mels[None][i]).max() > 1e-3


def test_gen_forward_without_speaker_table_uses_zeros(tmp_path, capsys):
    from forwardtacotron_torch import gen_forward
    path, _, _ = _checkpoint(tmp_path, [])
    ckpt = torch.load(str(path), weights_only=False)
    del ckpt['speaker_embeddings']
    torch.save(ckpt, str(path))
    out = tmp_path / 'out'
    gen_forward.main(['--checkpoint', str(path), '--input_text', 'hi.',
                      '--output', str(out), '--device', 'cpu'])
    assert 'No speaker embeddings in checkpoint; using zeros' in \
        capsys.readouterr().out
    assert len(list(out.glob('*.wav'))) == 1
