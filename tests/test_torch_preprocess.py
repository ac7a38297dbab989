"""Preprocessing on the port against the JAX package's, on the CPU.

- the metadata readers, all four formats (vctk also through its spawn
  pool), and their refusals: the same dicts;
- ``stratified_split`` with one and with three speakers: the same splits;
- ``MelStatsSpeakerEncoder``: bit-equal embeddings;
- ``run_preprocessing`` on 8 synthetic wavs (``chip_smoke.write_corpus``:
  voiced stretches, pauses, quiet ends), in the ``ljspeech`` and
  ``ljspeech_multi`` layouts: the same pickles; mels within 1e-5 (the JAX
  package's golden tolerance), raw pitch equal, speaker and mean speaker
  embeddings within 1e-5;
- ``Preprocessor`` on one file, on a broken one and on one too short
  (skipped), and with a failing mel (raised);
- ``python -m forwardtacotron_torch.preprocess --device cpu`` with 2 spawn
  workers writes what the serial run writes.

No resemblyzer weights are found (the working directory and HOME are
temporary), so both packages embed with the mel-statistics encoder; the
VoiceEncoder path is held in tests/test_torch_speaker_encoder.py.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.data.preprocess import (MelStatsSpeakerEncoder,
                                                   Preprocessor,
                                                   run_preprocessing,
                                                   stratified_split)
from forwardtacotron_torch.text.recipes import read_metadata
from forwardtacotron_torch.utils.files import read_config
from forwardtacotron_torch.utils.paths import Paths

from chip_smoke import write_corpus

REPO = Path(__file__).resolve().parent.parent
PICKLES = ('text_dict', 'speaker_dict', 'train_dataset', 'val_dataset')
# 8 utterances: 4 of 10 and 4 of 14 tokens, 3 frames a token
CORPUS = dict(token_lens=(10, 14), per_len=4, frames_per_token=3.0)


@pytest.fixture
def no_weights(tmp_path, monkeypatch):
    """No resemblyzer weights anywhere the finder looks."""
    monkeypatch.delenv('RESEMBLYZER_WEIGHTS', raising=False)
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    monkeypatch.chdir(tmp_path)


def config_for(root: Path, layout: str):
    config = read_config(REPO / 'tests' / 'resources' / 'test_config.yaml')
    config['data_path'] = str(root / 'data')
    config['checkpoint_path'] = str(root / 'ckpt')
    pre = config['preprocessing']
    pre.update(metafile_format=layout, cleaner_name='no_cleaners', n_val=3)
    return config


def corpus(root: Path, layout: str, config) -> Path:
    speakers = ('spkA', 'spkB', 'spkC') if layout == 'ljspeech_multi' \
        else None
    return write_corpus(root / 'corpus', sample_rate=config['dsp'][
        'sample_rate'], hop=config['dsp']['hop_length'], speakers=speakers,
        **CORPUS)


def data_files(paths):
    return {sub: sorted(p.name for p in getattr(paths, sub).glob('*.npy'))
            for sub in ('mel', 'raw_pitch', 'speaker_emb', 'mean_speaker_emb')}


# ------------------------------------------------------------------ recipes

def _write_metadata(root: Path, fmt: str) -> str:
    if fmt == 'ljspeech':
        (root / 'metadata.csv').write_text(
            'id1|some text\nid2|more|text with pipe\n', encoding='utf-8')
    elif fmt == 'ljspeech_multi':
        (root / 'metadata.csv').write_text(
            'id1|spk_a|hello\nid2|spk_b|world\nid3|lonely\n',
            encoding='utf-8')
    elif fmt == 'vctk':
        for spk, utt, line in (('p225', 'p225_001', 'first line'),
                               ('p226', 'p226_001', 'other line'),
                               ('p226', 'p226_002', 'third')):
            (root / spk).mkdir(exist_ok=True)
            (root / spk / f'{utt}.txt').write_text(
                line + '\nsecond line ignored\n', encoding='utf-8')
        return 'unused.csv'
    else:
        (root / 'metadata.tsv').write_text(
            'file_id\tspeaker_id\ttext\nid1\tspk_a\thello there\n'
            'id2\tspk_b\tgeneral kenobi\n', encoding='utf-8')
        return 'metadata.tsv'
    return 'metadata.csv'


@pytest.mark.parametrize('fmt,workers', [
    ('ljspeech', 1), ('ljspeech_multi', 1), ('vctk', 1), ('vctk', 2),
    ('pandas', 1)])
def test_recipes_match_jax(tmp_path, fmt, workers):
    from forwardtacotron_tpu.text.recipes import \
        read_metadata as jax_read

    metafile = _write_metadata(tmp_path, fmt)
    got = read_metadata(tmp_path, metafile, fmt, n_workers=workers)
    assert got == jax_read(tmp_path, metafile, fmt, n_workers=1)
    assert len(got[0]) >= 2


def test_recipes_refuse_like_jax(tmp_path):
    from forwardtacotron_tpu.text.recipes import \
        read_metadata as jax_read

    for fn in (read_metadata, jax_read):
        with pytest.raises(ValueError, match='Unknown metadata format'):
            fn(tmp_path, 'metadata.csv', 'bogus')
        with pytest.raises(ValueError, match='Could not find metafile'):
            fn(tmp_path, 'missing.csv', 'ljspeech')


# ------------------------------------------------------------------- splits

@pytest.mark.parametrize('n_speakers,n_val', [(1, 3), (3, 4), (3, 50)])
def test_stratified_split_matches_jax(n_speakers, n_val):
    from forwardtacotron_tpu.data.preprocess import \
        stratified_split as jax_split

    rs = np.random.RandomState(n_speakers)
    data = [(f'id{i}', int(rs.randint(20, 400))) for i in range(23)]
    speakers = {i: f'spk{k % n_speakers}' for k, (i, _) in enumerate(data)}
    got = stratified_split(data, speakers, n_val=n_val, seed=42)
    assert got == jax_split(data, speakers, n_val=n_val, seed=42)
    train, val = got
    # at least n_val items (the round that reaches it ends: all 23 here
    # for n_val 50, as in the JAX package)
    assert len(val) >= min(n_val, len(data) - 1)
    assert [v[1] for v in val] == sorted((v[1] for v in val), reverse=True)
    if n_speakers == 3 and n_val == 4:
        assert len({speakers[i] for i, _ in val}) == 3


def test_mel_stats_encoder_bit_equal():
    from forwardtacotron_tpu.data.preprocess import \
        MelStatsSpeakerEncoder as JaxEncoder

    mel = np.random.RandomState(4).randn(16, 37).astype(np.float32) - 5
    got = MelStatsSpeakerEncoder(16).embed(mel)
    assert got.shape == (256,)
    np.testing.assert_array_equal(got, JaxEncoder(16).embed(mel))


# ------------------------------------------------------------ preprocessing

@pytest.mark.parametrize('layout', ['ljspeech', 'ljspeech_multi'])
def test_run_preprocessing_matches_jax(tmp_path, no_weights, layout):
    from forwardtacotron_tpu.data.preprocess import \
        run_preprocessing as jax_run

    port_cfg = config_for(tmp_path / 'port', layout)
    jax_cfg = config_for(tmp_path / 'jax', layout)
    root = corpus(tmp_path, layout, port_cfg)
    port = run_preprocessing(port_cfg, root, n_workers=1, device='cpu')
    jax = jax_run(jax_cfg, root, n_workers=1)
    for name in PICKLES:
        got = pickle.loads(getattr(port, name).read_bytes())
        assert got == pickle.loads(getattr(jax, name).read_bytes()), name
    speakers = pickle.loads(port.speaker_dict.read_bytes())
    assert len(set(speakers.values())) == (3 if layout != 'ljspeech' else 1)
    files = data_files(port)
    assert files == data_files(jax) and len(files['mel']) == 8
    for name in files['mel']:
        mel = np.load(port.mel / name)
        np.testing.assert_allclose(mel, np.load(jax.mel / name),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.load(port.raw_pitch / name),
                                      np.load(jax.raw_pitch / name))
    for sub in ('speaker_emb', 'mean_speaker_emb'):
        for name in files[sub]:
            np.testing.assert_allclose(np.load(getattr(port, sub) / name),
                                       np.load(getattr(jax, sub) / name),
                                       rtol=0, atol=1e-5)
    # the quiet ends are trimmed (to the trim's 2048-sample frames): each
    # mel covers its 3 frames a token and at most 12 more
    lens = dict(pickle.loads(port.train_dataset.read_bytes())
                + pickle.loads(port.val_dataset.read_bytes()))
    texts = pickle.loads(port.text_dict.read_bytes())
    assert all(0 < n - 3 * len(texts[i]) <= 12 for i, n in lens.items()), \
        lens


def test_preprocessor_converts_one_file(tmp_path):
    config = config_for(tmp_path, 'ljspeech')
    root = corpus(tmp_path, 'ljspeech', config)
    paths = Paths.from_config(config)
    pre = Preprocessor(paths, config, {'utt000': 'abc'}, device='cpu')
    p = pre(root / 'wavs' / 'utt000.wav')
    assert (p.item_id, p.text) == ('utt000', 'abc')
    y = pre.host.load_trimmed(root / 'wavs' / 'utt000.wav')
    assert p.mel_len == 1 + len(y) // config['dsp']['hop_length']
    assert np.load(paths.mel / 'utt000.npy').shape == (16, p.mel_len)
    assert np.load(paths.raw_pitch / 'utt000.npy').shape == (p.mel_len,)
    # a broken file is skipped, not raised
    (root / 'wavs' / 'bad.wav').write_bytes(b'not a wav')
    assert pre(root / 'wavs' / 'bad.wav') is None
    # so is a file too short for the STFT
    from scipy.io import wavfile
    wavfile.write(str(root / 'wavs' / 'short.wav'),
                  config['dsp']['sample_rate'],
                  np.full(config['dsp']['n_fft'] // 4, 0.5, np.float32))
    assert pre(root / 'wavs' / 'short.wav') is None
    # but a failure of the mel on the device stops the run

    def fault(wav):
        raise RuntimeError('CUDA error: an illegal memory access')

    pre.dsp.wav_to_mel = fault
    with pytest.raises(RuntimeError, match='CUDA error'):
        pre(root / 'wavs' / 'utt000.wav')


def test_preprocess_cli_spawn_pool_matches_serial(tmp_path, no_weights):
    import yaml

    from forwardtacotron_torch import preprocess

    serial_cfg = config_for(tmp_path / 'serial', 'ljspeech')
    pool_cfg = config_for(tmp_path / 'pool', 'ljspeech')
    root = corpus(tmp_path, 'ljspeech', serial_cfg)
    serial = run_preprocessing(serial_cfg, root, n_workers=1, device='cpu')
    cfg_path = tmp_path / 'config.yaml'
    cfg_path.write_text(yaml.dump(pool_cfg))
    preprocess.main(['--path', str(root), '--config', str(cfg_path),
                     '--num_workers', '2', '--device', 'cpu'])
    pool = Paths.from_config(pool_cfg)
    for name in PICKLES:
        assert getattr(pool, name).read_bytes() == \
            getattr(serial, name).read_bytes(), name
    files = data_files(pool)
    assert files == data_files(serial)
    for sub, names in files.items():
        for name in names:
            np.testing.assert_array_equal(np.load(getattr(pool, sub) / name),
                                          np.load(getattr(serial, sub) / name))
