"""The port's MultiFastPitch against the JAX package's, with the same seeded
variables carried across by ``from_jax_variables``
(tests/torch_training_setup.py): ``forward`` in eval and train mode
('mel' is 'mel_post', padding past the batch's longest ``mel_len``),
``predict_series`` with the JAX quirks (the pitch-condition head takes
``alpha``, no predictor takes a padding mask) and ``generate`` in float32
and bfloat16, ``TTSInference``'s entry points with ``speaker_emb``, the
reference state_dict schema at full width and both directions of the
weight bridge.

MultiFastPitch has no Pallas kernel of its own: the JAX side runs its plain
layers, the port its modules and the ``lr`` twin. In bfloat16 both compute
the transformers in float32 with bf16 weights (the float32 positional table
promotes them). The JAX side is compiled as few times as the checks allow:
its TTSInference runs ``generate`` at ALPHA and ``generate_fused`` at
alpha 1 in float32 and ``generate_fused`` in bfloat16, and the port's
model methods and other entry points are held to the same requests' rows
of those outputs (an item's valid frames do not depend on its batch or
frame budget). Tolerances: float32 1e-5 at the output's scale; bfloat16
the JAX package's bf16 model tolerance, 8e-2 at the output's scale on
valid frames, frame counts exact.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from forwardtacotron_torch.models.multi_fast_pitch import MultiFastPitch
from forwardtacotron_torch.models.synthesis import TTSInference
from forwardtacotron_torch.ops.hopper import lr
from forwardtacotron_torch.utils.convert import (from_jax_variables,
                                                 to_jax_variables)

from torch_training_setup import (MULTI_FP_NARROW, close_at_scale,
                                  family_config, family_models,
                                  full_width_model, jax_forward,
                                  make_multi_batch, rounding_margin,
                                  speaker_table, teacher_batch)

FAMILY = 'multi_fast_pitch'
SCHEMA = Path('tests/resources/reference_state_dict_schema.json')
F32_ATOL, BF16_ATOL = 1e-5, 8e-2
DIMS = MULTI_FP_NARROW['speaker_emb_dims']
# the smallest distance of a predicted duration from a rounding point, and
# of a token's two largest pitch-condition logits: in both dtypes the
# packages compute the predictors in float32 with the same weights, so
# they differ by float32 sums in other orders only
DUR_MARGIN = 0.04
PITCH_COND_GAP = 0.02
# the pitch-condition head's alpha, and a budget that holds every request
# uncropped at alpha 1
ALPHA, BUDGET = 1.3, 48


@pytest.fixture(scope='module')
def models():
    """The JAX model and variables, the port's float32 model with the same
    weights, three requests (two padded) and their speakers; the
    pitch-condition logits centred per class (all three classes come out,
    no two top logits within PITCH_COND_GAP), the durations 0-4 frames,
    none within DUR_MARGIN of a rounding point. The heads are tuned on the
    port's model, which holds the same weights (float32 agreement is
    checked by the tests)."""
    import jax

    config = family_config(FAMILY, 'float32', Path('unused'))
    jmodel, variables, tmodel = family_models(config)
    variables = jax.tree.map(np.copy, variables)
    rs = np.random.RandomState(8)
    x = rs.randint(1, 60, (3, 12)).astype(np.int64)
    x[1, 9:] = 0
    x[2, 5:] = 0
    semb = torch.from_numpy(speaker_table(3, DIMS, 9)).to(
        torch.bfloat16).float().numpy()
    tx, ts = torch.from_numpy(x), torch.from_numpy(semb)

    def load():
        missing, unexpected = tmodel.load_state_dict(
            from_jax_variables(variables), strict=False)
        assert unexpected == [] and set(missing) == {'step'} | {
            k for k in tmodel.state_dict() if k.endswith('.pe')}

    p = variables['params']['pitch_cond_pred']['lin']
    p['kernel'] *= 3.0
    p['bias'][:] = 0.0
    load()
    with torch.no_grad():
        lg = tmodel.pitch_cond_pred(tx, ts).numpy()
    p['bias'][:] = -lg.reshape(-1, 3).mean(0)
    load()
    with torch.no_grad():
        lg = np.sort(tmodel.pitch_cond_pred(tx, ts).numpy(), -1)
    assert float((lg[..., -1] - lg[..., -2]).min()) >= PITCH_COND_GAP
    p = variables['params']['dur_pred']['lin']
    p['bias'][:] = 0.0
    load()
    with torch.no_grad():
        pitch_cond = tmodel.predict_series(tx, ts)['pitch_cond']
        dur = tmodel.dur_pred(tx, pitch_cond, ts)[..., 0].numpy()
    shift = 2.0 - dur.mean()
    dur = dur + shift
    best = max(np.linspace(0.0, 0.95, 20),
               key=lambda s: rounding_margin(dur + s))
    p['bias'][:] = shift + best
    assert rounding_margin(dur + best) >= DUR_MARGIN
    load()
    return jmodel, variables, tmodel, x, semb


@pytest.fixture(scope='module')
def jax_forward_outputs(models):
    jmodel, variables, _, x, semb = models
    return jax_forward(jmodel, variables, teacher_batch(x, semb))


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_forward_matches_jax(models, jax_forward_outputs, train):
    """The teacher-forced ``forward``: the series heads with the token
    padding mask, the pitch-condition logits, 'mel' is 'mel_post' and
    ``padding_value`` past the batch's longest ``mel_len``; in training
    mode too (dropout 0)."""
    _, _, tmodel, x, semb = models
    batch = teacher_batch(x, semb)
    want = jax_forward_outputs[train]
    if train:
        want = want[0]
    model = copy.deepcopy(tmodel).train(train)
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    assert got['mel'] is got['mel_post'] and set(got) == set(want)
    assert got['pitch_cond'].shape == (3, 12, 3)
    for key in want:
        close_at_scale(got[key], want[key], F32_ATOL)
    assert (got['mel'][:, int(batch['mel_len'].max()):] == -11.5129).all()


@pytest.fixture(scope='module')
def jax_outputs(models):
    """The JAX TTSInference's outputs for the three requests: float32
    ``generate`` at ALPHA, float32 and bfloat16 ``generate_fused`` at
    BUDGET."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.synthesis import TTSInference as JTTS
    jmodel, variables, _, x, semb = models
    v = jax.tree.map(jnp.asarray, variables)
    f32 = JTTS(jmodel, v, dtype='float32')
    bf16 = JTTS(jmodel, v, dtype='bfloat16')
    assert f32.multispeaker and bf16.multispeaker
    out = {'generate': f32.generate(x, speaker_emb=jnp.asarray(semb),
                                    alpha=ALPHA),
           'float32': f32.generate_fused(x, BUDGET,
                                         speaker_emb=jnp.asarray(semb)),
           'bfloat16': bf16.generate_fused(
               x, BUDGET, speaker_emb=jnp.asarray(semb, jnp.bfloat16))}
    return {name: {k: np.array(o[k], np.float32) for k in o}
            for name, o in out.items()}


def _series(out):
    return ([torch.from_numpy(out[k]) for k in ('dur', 'pitch', 'energy')]
            + [torch.from_numpy(out['pitch_cond']).long()])


def test_predict_series_and_generate_match_jax(models, jax_outputs):
    """``predict_series`` at alpha 1 and ALPHA (which the pitch-condition
    head takes too, as in JAX), then ``generate`` at the JAX call's
    bucket: frames past each item's expanded length are zero."""
    _, _, tmodel, x, semb = models
    for alpha, name in ((1.0, 'float32'), (ALPHA, 'generate')):
        want = jax_outputs[name]
        with torch.no_grad():
            got = tmodel.predict_series(torch.from_numpy(x),
                                        torch.from_numpy(semb), alpha=alpha)
        np.testing.assert_array_equal(got['pitch_cond'].numpy(),
                                      want['pitch_cond'])
        for key in ('dur', 'pitch', 'energy'):
            close_at_scale(got[key], want[key], F32_ATOL)
    assert len(np.unique(jax_outputs['float32']['pitch_cond'])) == 3
    budget = want['mel'].shape[1]
    lr.launches = 0
    with torch.no_grad():
        got = tmodel.generate(torch.from_numpy(x), torch.from_numpy(semb),
                              *_series(want), budget)
    assert lr.launches == 0        # the CPU runs the lr twin
    assert got['mel'] is got['mel_post']
    close_at_scale(got['mel'], want['mel'], F32_ATOL)
    lens = want['mel_len'].astype(int)
    assert 0 < lens.min() and lens.max() < budget
    for i, n in enumerate(lens):
        assert torch.count_nonzero(got['mel'][i, n:]) == 0


def test_bf16_model_methods_match_jax(models, jax_outputs):
    """bfloat16 ``predict_series`` and ``generate`` (transformers in
    float32 with bf16 weights on both sides) against the JAX bfloat16
    ``generate_fused``, which runs the same two methods."""
    _, _, tmodel, x, semb = models
    want = jax_outputs['bfloat16']
    model = copy.deepcopy(tmodel).to(torch.bfloat16)
    with torch.no_grad():
        got = model.predict_series(torch.from_numpy(x),
                                   torch.from_numpy(semb))
        series = _series(want)
        ggen = model.generate(torch.from_numpy(x), torch.from_numpy(semb),
                              *[s.to(torch.bfloat16) for s in series[:3]],
                              series[3], BUDGET)
    np.testing.assert_array_equal(got['pitch_cond'].numpy(),
                                  want['pitch_cond'])
    for key in ('dur', 'pitch', 'energy'):
        close_at_scale(got[key], want[key], BF16_ATOL)
    lens = want['mel_len'].astype(int)
    assert lens.max() <= BUDGET
    mask = np.arange(BUDGET)[None, :] < lens[:, None]
    close_at_scale(ggen['mel'], want['mel'], BF16_ATOL, mask)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_tts_inference_entry_points_match_jax(models, jax_outputs, dtype,
                                              monkeypatch):
    """generate, generate_cropped (float32; [D] for one request),
    generate_routed (speakers mixed over several groups) and
    generate_fused with ``speaker_emb``, each against the JAX
    TTSInference's outputs for the same requests (float32: its
    ``generate`` at ALPHA and ``generate_fused``; bfloat16: its
    ``generate_fused``, no request cropped by BUDGET), one ``lr`` twin
    call per decode."""
    _, _, tmodel, x, semb = models
    tts = TTSInference(copy.deepcopy(tmodel), dtype=dtype, device='cpu')
    assert tts.multispeaker
    atol = F32_ATOL if dtype == 'float32' else BF16_ATOL
    alpha = ALPHA if dtype == 'float32' else 1.0
    want = jax_outputs['generate' if dtype == 'float32' else 'bfloat16']
    calls = []
    orig = lr.length_regulator_plain
    monkeypatch.setattr(lr, 'length_regulator_plain',
                        lambda *a: (calls.append(1), orig(*a))[1])

    def check(got, want, keys, rows=slice(None)):
        lens = want['mel_len'].astype(int)[rows]
        for key in keys:
            g, w = got[key], want[key][rows]
            if key in ('mel', 'mel_post'):
                m = min(g.shape[1], w.shape[1])
                valid = np.arange(m)[None] < lens[:, None]
                close_at_scale(g[:, :m], w[:, :m], atol, valid)
            else:
                close_at_scale(g, w, atol)

    keys = ('mel', 'mel_post', 'dur', 'pitch', 'energy')
    lens = want['mel_len'].astype(int)
    got = tts.generate(x, speaker_emb=semb, alpha=alpha)
    assert len(calls) == 1
    np.testing.assert_array_equal(got['mel_len'].numpy(), lens)
    check(got, want, keys)

    if dtype == 'float32':
        got = tts.generate_cropped(x[1], speaker_emb=semb[1], alpha=alpha)
        assert got['mel'].shape == (want['mel'].shape[2], lens[1])
        check({k: torch.from_numpy(v[None]) if v.ndim == 1
               else torch.from_numpy(v.T[None]) for k, v in got.items()},
              want, keys, slice(1, 2))

    order = np.array([1, 2, 0])
    calls.clear()
    got = tts.generate_routed(x[order], speaker_emb=semb[order],
                              alpha=alpha, frame_bucket=2)
    groups = len(np.unique(-(-lens // 2)))
    assert groups > 1 and len(calls) == groups
    np.testing.assert_array_equal(got['mel_len'].numpy(), lens[order])
    np.testing.assert_array_equal(got['pitch_cond'].numpy(),
                                  want['pitch_cond'][order])
    check(got, want, ('mel', 'mel_post', 'dur'), order)

    want = jax_outputs[dtype]
    calls.clear()
    got = tts.generate_fused(x, BUDGET, speaker_emb=semb)
    assert len(calls) == 1 and got['mel'].shape[1] == BUDGET
    assert want['mel_len'].max() <= BUDGET
    np.testing.assert_array_equal(got['mel_len'].numpy(), want['mel_len'])
    check(got, want, keys)


# --------------------------------------------------- weights and registry

def test_state_dict_matches_reference_schema():
    """334 keys of the reference's shapes: transformers of 512, predictors
    of 384 and 392."""
    schema = json.loads(SCHEMA.read_text())['models'][FAMILY]
    model = full_width_model(FAMILY)[0]
    assert isinstance(model, MultiFastPitch)
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert len(got) == 334 and got == schema
    assert got['dur_pred.transformer.norm.weight'] == [392]
    assert got['energy_pred.transformer.norm.weight'] == [384]


def test_weight_bridge_both_ways():
    """The JAX converter accepts the port's state_dict (validated against
    the JAX init's tree, the new ``conditional_embedding`` leaves among
    them); ``to_jax_variables`` gives the converter's tree exactly and
    ``from_jax_variables`` inverts it (every key but ``step`` and the
    positional tables)."""
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
    assert variables['params']['pitch_pred']['conditional_embedding'][
        'embedding'].shape == (4, 8)

    mine = to_jax_variables(sd)
    assert mine['batch_stats'] == {}
    flat_a = dict(jax.tree_util.tree_flatten_with_path(mine['params'])[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(
        variables['params'])[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=str(k))
    back = from_jax_variables(variables)
    skipped = {k for k in sd if k == 'step' or k.endswith('.pe')}
    assert set(back) == set(sd) - skipped and len(skipped) == 7
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
