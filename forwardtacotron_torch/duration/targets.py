"""Per-phoneme pitch/energy target extraction + per-speaker normalization
(the port's copy of forwardtacotron_tpu/duration/targets.py, numpy only).

Parity with reference train_tacotron.py:24-89: energy is the L2 norm of the
linear-power mel per frame; raw pitch is averaged over each phoneme's frame
span (band-filtered to [pitch_min_freq, pitch_max_freq], zeros excluded);
nonzero pitch values are z-normalized per speaker with zeros preserved.
"""

from typing import List, Tuple

import numpy as np

from forwardtacotron_torch.utils.files import unpickle_binary
from forwardtacotron_torch.utils.paths import Paths


def normalize_values(phoneme_val: List[Tuple[str, np.ndarray]]
                     ) -> Tuple[float, float]:
    """Z-normalize nonzero values in place across all items; zeros stay zero
    (reference train_tacotron.py:24-35)."""
    nonzeros = np.concatenate([v[v != 0.0] for _, v in phoneme_val]) \
        if phoneme_val else np.zeros(0)
    mean = float(np.mean(nonzeros)) if nonzeros.size else 0.0
    std = float(np.std(nonzeros)) if nonzeros.size else 1e10
    if not std > 0:
        std = 1e10
    for _, v in phoneme_val:
        zero_idx = v == 0.0
        v -= mean
        v /= std
        v[zero_idx] = 0.0
    return mean, std


def phoneme_averages(dur: np.ndarray, frame_values: np.ndarray,
                     lo: float = -np.inf, hi: float = np.inf,
                     exclude_zeros: bool = False) -> np.ndarray:
    """Average frame-level values over each phoneme's span from cumulative
    durations; empty/filtered spans yield 0."""
    ends = np.cumsum(dur).astype(int)
    starts = ends - dur.astype(int)
    out = np.zeros(len(dur), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        vals = frame_values[a:b]
        if exclude_zeros:
            vals = vals[vals != 0.0]
        vals = vals[(vals >= lo) & (vals <= hi)]
        out[i] = float(vals.mean()) if len(vals) else 0.0
    return out


def extract_pitch_energy(paths: Paths,
                         pitch_min_freq: float,
                         pitch_max_freq: float) -> Tuple[float, float]:
    """Build phon_pitch/ and phon_energy/ targets for every dataset item,
    with per-speaker pitch normalization. Returns the last speaker's
    (mean, std) like the reference."""
    speaker_dict = unpickle_binary(paths.speaker_dict)
    all_data = (unpickle_binary(paths.train_dataset)
                + unpickle_binary(paths.val_dataset))
    speakers = sorted({v for v in speaker_dict.values() if len(v) > 1})
    mean = std = 0.0

    for speaker in speakers:
        items = [(i, l) for i, l in all_data
                 if speaker_dict.get(i) == speaker]
        pitches, energies = [], []
        for item_id, mel_len in items:
            try:
                dur = np.load(str(paths.alg / f'{item_id}.npy'))
                mel = np.load(str(paths.mel / f'{item_id}.npy'))
                assert np.sum(dur) == mel_len, \
                    f'duration sum != mel len for {item_id}'
                energy = np.linalg.norm(np.exp(mel), axis=0, ord=2)
                raw_pitch = np.load(str(paths.raw_pitch / f'{item_id}.npy'))
                pitch_char = phoneme_averages(
                    dur, raw_pitch, lo=pitch_min_freq, hi=pitch_max_freq,
                    exclude_zeros=True)
                energy_char = phoneme_averages(dur, energy)
                pitches.append((item_id, pitch_char))
                energies.append((item_id, energy_char))
            except Exception as e:  # skip broken items like the reference
                print(f'extract_pitch_energy: skipping {item_id}: {e}')

        for item_id, e in energies:
            np.save(str(paths.phon_energy / f'{item_id}.npy'), e,
                    allow_pickle=False)
        mean, std = normalize_values(pitches)
        for item_id, p in pitches:
            np.save(str(paths.phon_pitch / f'{item_id}.npy'), p,
                    allow_pickle=False)
    return mean, std
