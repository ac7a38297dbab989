"""The duration pipeline on the port against the JAX package's, on the CPU.

- the shortest monotonic path: the port's native (C++), numpy and scipy
  Dijkstra paths against the JAX package's numpy DP, node for node, on
  seeded and on quantised (tied) weights (on ties Dijkstra may take
  another path of the same cost: there it is held to the JAX package's
  Dijkstra node for node and to the DP's cost);
- ``DurationExtractor``: durations and ``att_score`` equal to the JAX
  package's, with the silence shift active, both methods;
- the targets: ``normalize_values``, ``phoneme_averages`` and
  ``extract_pitch_energy`` (two speakers, one broken item) write what the
  JAX package writes, exactly;
- the binned loader: the same batches in the same order;
- ``extract_durations``, serial and with 2 ``spawn`` workers: ``alg/``
  equal to the JAX package's and the same DurationStats, which load
  through ``load_duration_stats``;
- ``extract_attentions`` against the JAX package's on a narrow teacher
  with the PreNet's dropout off on both sides (the JAX model behind a shim
  whose ``apply`` forwards ``prenet_dropout_on=False``): ``att_pred``
  within 1e-5, the mean sharpness within 1e-6; with the dropout on, the
  port's draw follows its ``seed``;
- the pipeline's module imports no torch, so its spawn workers cannot
  initialise CUDA.

The synthetic data: 8 items in two token-length bins of 4, mels of 12-27
frames with "silent" frames (mean below the threshold), texts with silent
phonemes, raw pitch with unvoiced zeros, two speakers.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from forwardtacotron_torch.data.dataset import (get_binned_taco_dataloader,
                                                load_duration_stats)
from forwardtacotron_torch.duration import extractor as port_ext
from forwardtacotron_torch.duration import targets as port_targets
from forwardtacotron_torch.duration.pipeline import (
    DurationExtractionPipeline, max_consecutive_ones)
from forwardtacotron_torch.text.symbols import phonemes
from forwardtacotron_torch.utils.paths import Paths

from torch_cpu import (  # noqa: F401 (torch_one_thread: a fixture)
    subprocess_env, torch_one_thread)
from torch_training_setup import N_MELS

REPO = Path(__file__).resolve().parent.parent
EMB_DIMS = 16
SILENCE = dict(silence_threshold=-11.0, silence_prob_shift=0.25)
TOKENS = (6, 9)          # two bins of 4 items each
ITEMS = 8
MAX_BATCH = 4


def write_items(root: Path, seed: int = 0) -> Paths:
    """The synthetic dataset under ``root``; the same files for a seed."""
    paths = Paths(data_path=root / 'data', tts_id='t',
                  checkpoint_path=root / 'ckpt')
    rs = np.random.RandomState(seed)
    voiced = [p for p in phonemes[12:60]]
    text_dict, speaker_dict, items = {}, {}, []
    for i in range(ITEMS):
        item_id = f'item{i}'
        n_tok = TOKENS[i % 2]
        chars = list(rs.choice(voiced, n_tok))
        chars[n_tok // 2] = ' '          # a silent phoneme mid-sentence
        chars[-1] = '.'
        mel_len = 2 * n_tok + int(rs.randint(0, 10))
        mel = rs.randn(N_MELS, mel_len).astype(np.float32) - 5.0
        mel[:, mel_len // 2:mel_len // 2 + 2] = -12.0   # silent frames
        pitch = rs.uniform(60, 400, mel_len).astype(np.float32)
        pitch[rs.rand(mel_len) < 0.2] = 0.0
        np.save(paths.mel / f'{item_id}.npy', mel)
        np.save(paths.raw_pitch / f'{item_id}.npy', pitch)
        np.save(paths.speaker_emb / f'{item_id}.npy',
                rs.randn(EMB_DIMS).astype(np.float32))
        text_dict[item_id] = ''.join(chars)
        speaker_dict[item_id] = 'spkA' if i < 5 else 'spkB'
        items.append((item_id, mel_len))
    for path, obj in ((paths.text_dict, text_dict),
                      (paths.speaker_dict, speaker_dict),
                      (paths.train_dataset, items[:6]),
                      (paths.val_dataset, items[6:])):
        with open(path, 'wb') as f:
            pickle.dump(obj, f)
    return paths


def near_diagonal(rs, t, n):
    """A soft monotonic attention [t, n] with noise."""
    centre = np.linspace(0, n - 1, t)[:, None]
    logits = -2.0 * (np.arange(n)[None, :] - centre) ** 2 \
        + 0.5 * rs.randn(t, n)
    att = np.exp(logits - logits.max(1, keepdims=True))
    return (att / att.sum(1, keepdims=True)).astype(np.float32)


def write_attentions(paths: Paths, seed: int = 1) -> None:
    rs = np.random.RandomState(seed)
    tokens = pickle.loads(paths.text_dict.read_bytes())
    for item_id, mel_len in (pickle.loads(paths.train_dataset.read_bytes())
                             + pickle.loads(paths.val_dataset.read_bytes())):
        np.save(paths.att_pred / f'{item_id}.npy',
                near_diagonal(rs, mel_len, len(tokens[item_id])))


def jax_paths(paths: Paths):
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths
    return JaxPaths(data_path=paths.data, tts_id='t',
                    checkpoint_path=paths.base)


# ------------------------------------------------------------ shortest path

def _cost(w, path):
    return sum(w[i, j] for i, j in path[1:])


SHAPES = [(1, 1), (1, 7), (7, 1), (5, 3), (3, 5), (40, 13), (120, 37)]


@pytest.mark.parametrize('kind', ['seeded', 'quantised'])
@pytest.mark.parametrize('rows,cols', SHAPES)
def test_paths_match_jax_dp(kind, rows, cols):
    from forwardtacotron_tpu.duration.extractor import \
        _shortest_monotonic_path_dijkstra as jax_dijkstra
    from forwardtacotron_tpu.duration.extractor import \
        _shortest_monotonic_path_dp as jax_dp

    rs = np.random.RandomState(rows * 1000 + cols)
    for _ in range(2):
        w = rs.rand(rows, cols)
        if kind == 'quantised':      # many exact ties
            w = np.round(w * 3) / 3.0
        want = jax_dp(w)
        native = port_ext._shortest_monotonic_path_native(w)
        assert native is not None, 'the native DP did not build'
        assert native == want
        assert port_ext._shortest_monotonic_path_dp(w) == want
        dijkstra = port_ext._shortest_monotonic_path_dijkstra(w)
        if kind == 'seeded':
            assert dijkstra == want
        else:
            # on ties Dijkstra may take another path of the same cost: the
            # JAX package's Dijkstra's, node for node
            assert dijkstra == jax_dijkstra(w)
            assert _cost(w, dijkstra) == _cost(w, want)


@pytest.mark.parametrize('method', ['dp', 'dijkstra'])
def test_extractor_matches_jax(method):
    from forwardtacotron_tpu.duration.extractor import \
        DurationExtractor as JaxExtractor

    rs = np.random.RandomState(5)
    t, n = 60, 17
    x = rs.randint(1, len(phonemes), n)
    x[[4, 9, 16]] = [phonemes.index(c) for c in ' ,.']
    mel = rs.randn(N_MELS, t).astype(np.float32) - 5.0
    mel[:, 20:26] = -12.0
    att = near_diagonal(rs, t + 3, n)     # rows past the mel are cut
    def port(threshold):
        ext = port_ext.DurationExtractor(threshold, SILENCE[
            'silence_prob_shift'])
        if method == 'dp':
            return ext(x, mel, att)
        # the port extracts by the DP alone; Dijkstra is its cross-check
        shifted, sil = ext.shifted_attention(x, mel, att)
        path = port_ext._shortest_monotonic_path_dijkstra(1.0 - shifted)
        return port_ext.durations_from_path(path, n, shifted, sil)

    got = port(SILENCE['silence_threshold'])
    want = JaxExtractor(**SILENCE, method=method)(x, mel, att)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].sum() == t and got[1] == want[1]
    # the shift moved durations: without it they differ
    plain = port(-20.0)
    assert not np.array_equal(plain[0], got[0])


def test_max_consecutive_ones():
    assert max_consecutive_ones(np.array([1, 1, 2, 1, 1, 1])) == 3
    assert max_consecutive_ones(np.array([2, 3, 4])) == 0


# ------------------------------------------------------------------ targets

def test_normalize_and_averages_match_jax():
    from forwardtacotron_tpu.duration import targets as jt

    rs = np.random.RandomState(2)
    vals = [rs.uniform(50, 300, 7).astype(np.float32) for _ in range(3)]
    for v in vals:
        v[rs.rand(7) < 0.3] = 0.0
    got = [('a', v.copy()) for v in vals]
    want = [('a', v.copy()) for v in vals]
    assert port_targets.normalize_values(got) == jt.normalize_values(want)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # empty and constant inputs: std 1e10, zeros stay zero
    assert port_targets.normalize_values([]) == jt.normalize_values([])
    const = [('c', np.array([0.0, 5.0, 5.0], np.float32))]
    assert port_targets.normalize_values(const)[1] == 1e10
    dur = np.array([3, 0, 2, 4])
    frames = rs.uniform(0, 700, 9).astype(np.float32)
    frames[[1, 6]] = 0.0
    for kw in ({}, dict(lo=30, hi=600, exclude_zeros=True)):
        np.testing.assert_array_equal(
            port_targets.phoneme_averages(dur, frames, **kw),
            jt.phoneme_averages(dur, frames, **kw))


def test_extract_pitch_energy_matches_jax(tmp_path, capsys):
    from forwardtacotron_tpu.duration.targets import \
        extract_pitch_energy as jax_extract

    outs = []
    for name, fn in (('port', port_targets.extract_pitch_energy),
                     ('jax', jax_extract)):
        paths = write_items(tmp_path / name)
        rs = np.random.RandomState(3)
        for item_id, mel_len in (
                pickle.loads(paths.train_dataset.read_bytes())
                + pickle.loads(paths.val_dataset.read_bytes())):
            n_tok = len(pickle.loads(paths.text_dict.read_bytes())[item_id])
            cuts = np.sort(rs.choice(np.arange(1, mel_len), n_tok - 1,
                                     replace=False))
            dur = np.diff(np.concatenate([[0], cuts, [mel_len]]))
            if item_id == 'item3':        # broken: skipped by both
                dur[0] += 1
            np.save(paths.alg / f'{item_id}.npy', dur)
        mp = paths if name == 'port' else jax_paths(paths)
        outs.append((paths, fn(mp, pitch_min_freq=30, pitch_max_freq=600)))
    (port, got), (jax, want) = outs
    assert got == want
    assert 'skipping item3' in capsys.readouterr().out
    for sub in ('phon_pitch', 'phon_energy'):
        names = sorted(p.name for p in getattr(port, sub).glob('*.npy'))
        assert names == sorted(p.name for p in getattr(jax, sub).glob('*.npy'))
        assert len(names) == ITEMS - 1
        for n in names:
            np.testing.assert_array_equal(np.load(getattr(port, sub) / n),
                                          np.load(getattr(jax, sub) / n))


# ------------------------------------------------------------- data layer

def test_binned_loader_matches_jax(tmp_path):
    from forwardtacotron_tpu.data.dataset import \
        get_binned_taco_dataloader as jax_loader

    paths = write_items(tmp_path)
    got = list(get_binned_taco_dataloader(paths, 3))
    want = list(jax_loader(jax_paths(paths), 3))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g['item_id'] == w['item_id']
        assert len(set(g['x_len'].tolist())) == 1
        for key in ('x', 'mel', 'x_len', 'mel_len', 'speaker_emb'):
            np.testing.assert_array_equal(g[key], w[key], key)


# --------------------------------------------------------------- pipeline

@pytest.mark.parametrize('num_workers', [0, 2])
def test_extract_durations_matches_jax(tmp_path, num_workers):
    from forwardtacotron_tpu.duration.extractor import \
        DurationExtractor as JaxExtractor
    from forwardtacotron_tpu.duration.pipeline import \
        DurationExtractionPipeline as JaxPipeline

    port = write_items(tmp_path / 'port')
    jax = write_items(tmp_path / 'jax')
    for paths in (port, jax):
        write_attentions(paths)
    stats = DurationExtractionPipeline(
        port, {}, port_ext.DurationExtractor(**SILENCE)).extract_durations(
            num_workers=num_workers)
    want = JaxPipeline(jax_paths(jax), {}, JaxExtractor(
        **SILENCE)).extract_durations(num_workers=0)
    assert sorted(stats) == sorted(want) and len(stats) == ITEMS
    for item_id, mel_len in (pickle.loads(port.train_dataset.read_bytes())
                             + pickle.loads(port.val_dataset.read_bytes())):
        dur = np.load(port.alg / f'{item_id}.npy')
        assert dur.dtype == np.int64 and dur.sum() == mel_len
        np.testing.assert_array_equal(dur,
                                      np.load(jax.alg / f'{item_id}.npy'))
        assert vars(stats[item_id]) == vars(want[item_id])
    with open(port.duration_stats, 'wb') as f:
        pickle.dump(stats, f)
    loaded = load_duration_stats(port.duration_stats)
    assert {k: vars(v) for k, v in loaded.items()} == \
        {k: vars(v) for k, v in want.items()}


def _teacher():
    from test_torch_tacotron import NARROW, no_dropout, port_teacher

    assert NARROW['speaker_emb_dim'] == EMB_DIMS
    return no_dropout(port_teacher())


class _JaxNoDropout:
    """The JAX teacher, its ``apply`` with the PreNet's dropout off."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, **kw):
        return self.model.apply(variables, batch,
                                **{**kw, 'prenet_dropout_on': False})


def test_extract_attentions_matches_jax(tmp_path, monkeypatch):
    from forwardtacotron_tpu.duration.extractor import \
        DurationExtractor as JaxExtractor
    from forwardtacotron_tpu.duration.pipeline import \
        DurationExtractionPipeline as JaxPipeline
    from forwardtacotron_tpu.models import tacotron as jax_tacotron
    from test_torch_tacotron import _jax_teacher

    port = write_items(tmp_path / 'port')
    jax = write_items(tmp_path / 'jax')
    model = _teacher()
    pipe = DurationExtractionPipeline(port, {},
                                      port_ext.DurationExtractor(**SILENCE))
    got = pipe.extract_attentions(model, max_batch_size=MAX_BATCH,
                                  device='cpu')
    monkeypatch.setattr(jax_tacotron, 'DECODER_SCAN_UNROLL', 1)
    jmodel, variables = _jax_teacher()
    want = JaxPipeline(jax_paths(jax), {}, JaxExtractor(**SILENCE)) \
        .extract_attentions(_JaxNoDropout(jmodel), variables,
                            max_batch_size=MAX_BATCH)
    assert abs(got - want) <= 1e-6
    texts = pickle.loads(port.text_dict.read_bytes())
    for item_id, mel_len in (pickle.loads(port.train_dataset.read_bytes())
                             + pickle.loads(port.val_dataset.read_bytes())):
        att = np.load(port.att_pred / f'{item_id}.npy')
        assert att.shape == (mel_len, len(texts[item_id]))
        np.testing.assert_allclose(
            att, np.load(jax.att_pred / f'{item_id}.npy'), rtol=0, atol=1e-5)

    # the dropout on: a draw of the seed's generator, the same for a seed
    model.decoder.prenet.dropout = 0.5
    scores = [pipe.extract_attentions(model, MAX_BATCH, seed=s, device='cpu')
              for s in (42, 42, 7)]
    assert scores[0] == scores[1] != scores[2]


def test_pipeline_workers_import_no_torch():
    code = ('import sys; import forwardtacotron_torch.duration.pipeline; '
            'assert "torch" not in sys.modules')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=60,
                          env=subprocess_env())
    assert proc.returncode == 0, proc.stderr
