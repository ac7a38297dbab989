"""Dataset preprocessing: wav -> mel / raw pitch / cleaned text / speaker
embeddings, with a stratified train/val split (the port of
forwardtacotron_tpu/data/preprocess.py, reference preprocess.py:67-229).

The work is split between the host and the device:

* pool workers (``spawn``: no process is forked, so none can inherit a
  CUDA context) do the host work of each file: load, the VAD long-silence
  trim, the start/end trim, the peak normalisation (forced when the peak
  exceeds 1), the YIN pitch (numpy, saved to ``raw_pitch/``) and the text
  cleaning; they return the trimmed waveform;
* the main process computes each mel on the device as the results stream
  in (at most a few per worker in flight), saves it, embeds the speaker
  and drops the waveform, so a corpus holds O(workers) waveforms, not
  O(dataset).

Speaker embeddings, in order of preference: the resemblyzer package where
it is installed; the port's VoiceEncoder (models/speaker_encoder.py) on the
device when a ``pretrained.pt`` is found; else a deterministic mel-statistics
embedding (mean/std/percentiles projected to 256-d by a fixed random
matrix), with the same interface and files.
"""

import os
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from random import Random
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Tuple,
                    Union)

import numpy as np
import torch

from forwardtacotron_torch.dsp.dsp import DSP
from forwardtacotron_torch.dsp.pitch import new_pitch_extractor_from_config
from forwardtacotron_torch.text.cleaners import Cleaner
from forwardtacotron_torch.text.recipes import read_metadata
from forwardtacotron_torch.utils.device import resolve_device
from forwardtacotron_torch.utils.files import get_files, pickle_binary
from forwardtacotron_torch.utils.paths import Paths

SPEAKER_EMB_DIM = 256
# results in flight per pool worker: each holds one trimmed waveform
STREAM_DEPTH = 4


@dataclass
class DataPoint:
    item_id: str
    mel_len: int
    text: str
    speaker_name: str


@dataclass
class HostItem:
    """A file after the host half of its conversion."""
    item_id: str
    wav: np.ndarray
    text: str


class MelStatsSpeakerEncoder:
    """Deterministic fallback speaker embedding from mel statistics."""

    def __init__(self, n_mels: int, dim: int = SPEAKER_EMB_DIM) -> None:
        rs = np.random.RandomState(1234)
        self._proj = rs.randn(4 * n_mels, dim).astype(np.float32) \
            / np.sqrt(4 * n_mels)

    def embed(self, mel: np.ndarray, wav: Optional[np.ndarray] = None,
              sample_rate: Optional[int] = None) -> np.ndarray:
        feats = np.concatenate([
            mel.mean(axis=1), mel.std(axis=1),
            np.percentile(mel, 10, axis=1), np.percentile(mel, 90, axis=1),
        ]).astype(np.float32)
        emb = feats @ self._proj
        norm = np.linalg.norm(emb)
        return emb / norm if norm > 0 else emb


class _WavSpeakerEncoder:
    """A waveform speaker encoder: ``embed_wav(wav, sample_rate)`` on the
    utterance, the mel unused."""

    def __init__(self, embed_wav) -> None:
        self._embed_wav = embed_wav

    def embed(self, mel: np.ndarray, wav: Optional[np.ndarray] = None,
              sample_rate: Optional[int] = None) -> np.ndarray:
        return self._embed_wav(wav, sample_rate)


def find_resemblyzer_weights() -> Optional[str]:
    """Locate a Resemblyzer ``pretrained.pt`` for the VoiceEncoder:
    $RESEMBLYZER_WEIGHTS, then ./checkpoints, then ~/checkpoints."""
    candidates = [os.environ.get('RESEMBLYZER_WEIGHTS')]
    for d in (Path('checkpoints'), Path.home() / 'checkpoints'):
        candidates.append(str(d / 'pretrained.pt'))
    for c in candidates:
        if c and Path(c).is_file():
            return c
    return None


def make_speaker_encoder(n_mels: int,
                         device: Optional[Union[str, torch.device]] = None):
    """The speaker-embedding provider, in order of preference:

    1. the resemblyzer package (the reference's path, preprocess.py:172-182),
       if installed;
    2. the port's VoiceEncoder on ``device`` with a ``pretrained.pt`` that
       :func:`find_resemblyzer_weights` finds;
    3. the deterministic mel-statistics fallback: the same interface, but
       not a trained speaker encoder.
    """
    try:
        from resemblyzer import VoiceEncoder as ResemblyzerEncoder
        from resemblyzer import preprocess_wav
    except ImportError:
        pass
    else:
        encoder = ResemblyzerEncoder()
        return _WavSpeakerEncoder(lambda wav, sr: encoder.embed_utterance(
            preprocess_wav(wav, source_sr=sr)))
    weights = find_resemblyzer_weights()
    if weights is not None:
        from forwardtacotron_torch.models.speaker_encoder import (
            SAMPLE_RATE, VoiceEncoder, preprocess_for_embedding)
        try:
            encoder = VoiceEncoder(weights_path=weights, device=device)
        except ValueError as e:
            # an unrelated checkpoint named pretrained.pt
            print(f'Speaker encoder: ignoring {weights} ({e}); '
                  'using mel-stats fallback')
            return MelStatsSpeakerEncoder(n_mels)
        print(f'Speaker encoder: VoiceEncoder with {weights} on '
              f'{encoder.device}')
        # resemblyzer's preprocess_wav (volume, VAD trim) before the
        # embedding, as the reference pipeline runs it (preprocess.py:80,181)
        return _WavSpeakerEncoder(lambda wav, sr: encoder.embed_utterance(
            preprocess_for_embedding(wav, source_sr=sr),
            source_sr=SAMPLE_RATE))
    return MelStatsSpeakerEncoder(n_mels)


class HostPreprocessor:
    """The host half of a file's conversion (reference preprocess.py:55-98
    without the mel); picklable, so it runs in pool workers. Its DSP does
    only numpy work (load, trims) and holds nothing on a device."""

    def __init__(self, paths: Paths, config: Dict[str, Any],
                 text_dict: Dict[str, str]) -> None:
        self.paths = paths
        self.config = config
        self.text_dict = text_dict
        # made at first use in each worker (espeak handles do not pickle)
        self._dsp: Optional[DSP] = None
        self._pitch = None
        self._cleaner: Optional[Cleaner] = None

    def __getstate__(self):
        return {**self.__dict__, '_dsp': None, '_pitch': None,
                '_cleaner': None}

    def __call__(self, wav_path: Union[str, Path]) -> Optional[HostItem]:
        wav_path = Path(wav_path)
        try:
            return self._convert(wav_path, wav_path.stem)
        except Exception as e:  # skip broken files (reference :74-76)
            print(f'preprocess: failed {wav_path.stem}: {e}')
            return None

    def load_trimmed(self, wav_path: Union[str, Path]) -> np.ndarray:
        """The file's samples after the trims and the peak normalisation."""
        if self._dsp is None:
            self._dsp = DSP.from_config(self.config, device='cpu')
            self._pitch = new_pitch_extractor_from_config(self.config)
            self._cleaner = Cleaner.from_config(self.config)
        dsp = self._dsp
        y = dsp.load_wav(wav_path)
        if dsp.should_trim_long_silences:
            y = dsp.trim_long_silences(y)
        if dsp.should_trim_start_end_silence:
            y = dsp.trim_silence(y)
        peak = np.abs(y).max() if len(y) else 0.0
        if dsp.should_peak_norm or peak > 1.0:
            y = y / max(peak, 1e-8) * 0.95
        return y

    def _convert(self, wav_path: Path, item_id: str) -> HostItem:
        y = self.load_trimmed(wav_path)
        if len(y) <= self._dsp.n_fft // 2:
            # the STFT's reflect padding needs more samples than n_fft // 2
            raise ValueError(f'{len(y)} samples after trimming is too short')
        pitch = self._pitch(y).astype(np.float32)
        np.save(str(self.paths.raw_pitch / f'{item_id}.npy'), pitch,
                allow_pickle=False)
        return HostItem(item_id=item_id, wav=y,
                        text=self._cleaner(self.text_dict[item_id]))


class Preprocessor:
    """A file's whole conversion: the host half, then the mel on
    ``device`` (CUDA unless the caller names another), saved to ``mel/``.
    The waveform is not kept."""

    def __init__(self, paths: Paths, config: Dict[str, Any],
                 text_dict: Dict[str, str],
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.paths = paths
        self.dsp = DSP.from_config(config, device=device)
        self.host = HostPreprocessor(paths, config, text_dict)

    def __call__(self, wav_path: Union[str, Path]) -> Optional[DataPoint]:
        point, _ = self.finish(self.host(wav_path))
        return point

    def finish(self, item: Optional[HostItem]
               ) -> Tuple[Optional[DataPoint], Optional[np.ndarray]]:
        """(DataPoint, mel [n_mels, frames]) of a host item: its mel on the
        device, saved; (None, None) for an item that the host half skipped.
        A failure of the mel raises."""
        if item is None:
            return None, None
        # no catch here: a device fault must stop the run, not thin the
        # dataset (the host half already skipped the broken files)
        mel = self.dsp.wav_to_mel(item.wav)
        np.save(str(self.paths.mel / f'{item.item_id}.npy'), mel,
                allow_pickle=False)
        return DataPoint(item_id=item.item_id, mel_len=mel.shape[-1],
                         text=item.text, speaker_name=''), mel


def stratified_split(data: List[Tuple[str, int]],
                     speaker_dict: Dict[str, str],
                     n_val: int, seed: int
                     ) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]]]:
    """Per-speaker round-robin validation sampling with a seeded shuffle;
    val sorted longest-first (reference preprocess.py:194-211)."""
    speakers = sorted({speaker_dict[i] for i, _ in data})
    by_speaker: Dict[str, List[Tuple[str, int]]] = {s: [] for s in speakers}
    for item in data:
        by_speaker[speaker_dict[item[0]]].append(item)
    rng = Random(seed)
    for s in speakers:
        rng.shuffle(by_speaker[s])

    val: List[Tuple[str, int]] = []
    idx = 0
    while len(val) < min(n_val, len(data) - 1):
        progressed = False
        for s in speakers:
            if idx < len(by_speaker[s]) and len(val) < n_val:
                val.append(by_speaker[s][idx])
                progressed = True
        idx += 1
        if not progressed:
            break
    val_ids = {i for i, _ in val}
    train = [item for item in data if item[0] not in val_ids]
    rng.shuffle(train)
    val.sort(key=lambda x: -x[1])
    return train, val


# the host half in a pool worker, set once by the pool's initializer
_HOST: Dict[str, HostPreprocessor] = {}


def _init_host(host: HostPreprocessor) -> None:
    _HOST['host'] = host


def _host_convert(wav_path: Path) -> Optional[HostItem]:
    return _HOST['host'](wav_path)


def _host_items(host: HostPreprocessor, wav_files: Iterable[Path],
                n_workers: int) -> Iterator[Optional[HostItem]]:
    """The host half of every file, in order: in this process, or in a
    ``spawn`` pool with at most STREAM_DEPTH results per worker in
    flight."""
    if n_workers <= 1:
        for w in wav_files:
            yield host(w)
        return
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    with ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx,
                             initializer=_init_host,
                             initargs=(host,)) as pool:
        pending = deque()
        for w in wav_files:
            pending.append(pool.submit(_host_convert, w))
            if len(pending) >= STREAM_DEPTH * n_workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def run_preprocessing(config: Dict[str, Any],
                      dataset_path: Union[str, Path],
                      metafile: Optional[str] = None,
                      n_workers: int = 4,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Paths:
    """Full preprocessing pass (reference preprocess.py:112-229), the mels
    and the speaker encoder on ``device`` (CUDA unless the caller names
    another)."""
    device = resolve_device(device)
    paths = Paths.from_config(config)
    pre = config['preprocessing']
    audio_format = pre.get('audio_format', '.wav')

    wav_files = get_files(dataset_path, audio_format)
    text_dict, speaker_dict = read_metadata(
        Path(dataset_path), metafile or 'metadata.csv',
        pre['metafile_format'], n_workers=n_workers)

    wav_ids = {w.stem for w in wav_files}
    text_dict = {k: v for k, v in text_dict.items()
                 if k in wav_ids and len(v) >= pre.get('min_text_len', 2)}
    speaker_dict = {k: v for k, v in speaker_dict.items() if k in text_dict}
    wav_files = [w for w in wav_files if w.stem in text_dict]
    print(f'Preprocessing {len(wav_files)} wav files...')

    processor = Preprocessor(paths, config, text_dict, device=device)
    encoder = make_speaker_encoder(config['dsp']['num_mels'], device)
    sample_rate = config['dsp']['sample_rate']
    points = []
    for item in _host_items(processor.host, wav_files, n_workers):
        point, mel = processor.finish(item)
        if point is None:
            continue
        emb = encoder.embed(mel, wav=item.wav, sample_rate=sample_rate)
        np.save(str(paths.speaker_emb / f'{point.item_id}.npy'),
                np.asarray(emb, np.float32), allow_pickle=False)
        points.append(point)
        del item, mel

    clean_text_dict = {p.item_id: p.text for p in points}
    data = [(p.item_id, p.mel_len) for p in points]
    train, val = stratified_split(data, speaker_dict,
                                  n_val=pre.get('n_val', 200),
                                  seed=pre.get('seed', 42))

    pickle_binary(clean_text_dict, paths.text_dict)
    pickle_binary({k: speaker_dict[k] for k, _ in data}, paths.speaker_dict)
    pickle_binary(train, paths.train_dataset)
    pickle_binary(val, paths.val_dataset)

    # mean L2-normalized embedding per speaker (reference :218-227)
    by_speaker: Dict[str, List[np.ndarray]] = {}
    for item_id, _ in data:
        emb = np.load(str(paths.speaker_emb / f'{item_id}.npy'))
        by_speaker.setdefault(speaker_dict[item_id], []).append(emb)
    for speaker, embs in by_speaker.items():
        mean = np.mean(np.stack(embs), axis=0)
        norm = np.linalg.norm(mean)
        if norm > 0:
            mean = mean / norm
        np.save(str(paths.mean_speaker_emb / f'{speaker}.npy'),
                mean.astype(np.float32), allow_pickle=False)

    print(f'Preprocessing done: {len(train)} train / {len(val)} val items.')
    return paths
