"""Frame-level pitch (F0) extraction (the port's copy of
forwardtacotron_tpu/dsp/pitch.py, numpy only).

The strategies of reference pitch_extraction/pitch_extractor.py:24-78
('librosa' pyin, 'pyworld' DIO), which need packages that may be absent,
and a built-in YIN (de Cheveigne & Kawahara 2002: the cumulative-mean-
normalized difference and parabolic interpolation) in numpy, one pitch
value per hop, n_frames = 1 + len(y) // hop, as the mel pipeline frames.
``new_pitch_extractor_from_config`` falls back to YIN when pyworld or
librosa is not installed, as the JAX package does.
"""

from typing import Any, Dict

import numpy as np


class PitchExtractor:
    def __call__(self, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class YinPitchExtractor(PitchExtractor):
    """Built-in YIN with voicing decision by CMND threshold."""

    def __init__(self, sample_rate: int, hop_length: int,
                 fmin: float = 30.0, fmax: float = 600.0,
                 frame_length: int = 2048,
                 threshold: float = 0.15) -> None:
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.fmin = max(fmin, 1.0)
        self.fmax = fmax
        self.frame_length = frame_length
        self.threshold = threshold

    def __call__(self, y: np.ndarray) -> np.ndarray:
        sr, hop, w = self.sample_rate, self.hop_length, self.frame_length
        n_frames = 1 + len(y) // hop
        tau_min = max(int(sr / self.fmax), 2)
        tau_max = min(int(sr / self.fmin), w // 2)
        if tau_max <= tau_min:
            return np.zeros(n_frames, np.float32)

        # center-padded framing like the STFT pipeline
        pad = w // 2
        ypad = np.pad(y.astype(np.float64), (pad, pad), mode='reflect')
        starts = np.arange(n_frames) * hop
        frames = ypad[starts[:, None] + np.arange(w)[None, :]]  # [F, w]

        # difference function via autocorrelation:
        # d(tau) = r(0) + r_tau(0) - 2*corr(tau), with FFT-based correlation
        half = w // 2
        fft_size = 1
        while fft_size < w + half:
            fft_size *= 2
        spec = np.fft.rfft(frames, fft_size, axis=1)
        window_head = frames[:, :half]
        spec_head = np.fft.rfft(window_head, fft_size, axis=1)
        corr = np.fft.irfft(spec * np.conj(spec_head), fft_size,
                            axis=1)[:, :tau_max + 1]
        sq = frames ** 2
        cum = np.concatenate(
            [np.zeros((n_frames, 1)), np.cumsum(sq, axis=1)], axis=1)
        e_head = cum[:, half]                       # energy of y[0:half]
        # energy of y[tau : tau+half] for each tau
        taus = np.arange(tau_max + 1)
        e_tau = cum[:, taus + half] - cum[:, taus]
        diff = e_head[:, None] + e_tau - 2.0 * corr  # [F, tau_max+1]
        diff = np.maximum(diff, 0.0)

        # cumulative mean normalized difference
        csum = np.cumsum(diff[:, 1:], axis=1)
        cmnd = np.ones_like(diff)
        cmnd[:, 1:] = diff[:, 1:] * np.arange(1, tau_max + 1) \
            / np.maximum(csum, 1e-12)

        pitch = np.zeros(n_frames, np.float32)
        band = cmnd[:, tau_min:tau_max]
        below = band < self.threshold
        for f in range(n_frames):
            idx = np.flatnonzero(below[f])
            if idx.size:
                # first dip below threshold, then local minimum of that dip
                t = idx[0]
                while t + 1 < band.shape[1] and band[f, t + 1] < band[f, t]:
                    t += 1
                tau = t + tau_min
            else:
                tau = int(np.argmin(band[f])) + tau_min
                if cmnd[f, tau] >= 0.6:   # unvoiced
                    continue
            # Octave-down guard: the search band starts at sr/fmax, so a
            # signal above fmax aliases onto its in-band subharmonic (e.g.
            # 1200 Hz -> a perfect dip at 2 periods = "600 Hz") and the
            # final band filter cannot catch it. If an integer fraction of
            # tau also dips below threshold, the true period is shorter;
            # take the shortest such lag and let the band filter zero it
            # when the true f0 is out of range.
            for k in (4, 3, 2):
                sub = int(round(tau / k))
                if sub >= 2:
                    lo, hi = max(sub - 1, 1), min(sub + 2, tau_max + 1)
                    if cmnd[f, lo:hi].min() < self.threshold:
                        tau = lo + int(np.argmin(cmnd[f, lo:hi]))
                        break
            # parabolic interpolation around the minimum
            if 1 <= tau < tau_max:
                a, b, c = diff[f, tau - 1], diff[f, tau], diff[f, tau + 1]
                denom = a - 2 * b + c
                shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
                tau_refined = tau + np.clip(shift, -1, 1)
            else:
                tau_refined = tau
            pitch[f] = sr / tau_refined
        pitch[(pitch < self.fmin) | (pitch > self.fmax)] = 0.0
        return pitch


class PyworldPitchExtractor(PitchExtractor):
    """DIO via the pyworld wheel (reference :50-61); optional dependency."""

    def __init__(self, sample_rate: int, hop_length: int) -> None:
        import pyworld  # noqa: F401 (fail here if it is not installed)
        self.sample_rate = sample_rate
        self.hop_length = hop_length

    def __call__(self, y: np.ndarray) -> np.ndarray:
        import pyworld
        frame_period = 1000.0 * self.hop_length / self.sample_rate
        pitch, _ = pyworld.dio(y.astype(np.float64), self.sample_rate,
                               frame_period=frame_period)
        return pitch.astype(np.float32)


class LibrosaPitchExtractor(PitchExtractor):
    """pyin via librosa (reference :24-47); optional dependency."""

    def __init__(self, sample_rate: int, hop_length: int,
                 fmin: float, fmax: float, frame_length: int) -> None:
        import librosa  # noqa: F401
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.fmin = fmin
        self.fmax = fmax
        self.frame_length = frame_length

    def __call__(self, y: np.ndarray) -> np.ndarray:
        import librosa
        pitch, _, _ = librosa.pyin(y, sr=self.sample_rate,
                                   fmin=self.fmin, fmax=self.fmax,
                                   frame_length=self.frame_length,
                                   hop_length=self.hop_length)
        return np.nan_to_num(pitch).astype(np.float32)


def new_pitch_extractor_from_config(config: Dict[str, Any]) -> PitchExtractor:
    pre = config['preprocessing']
    dsp = config['dsp']
    kind = pre.get('pitch_extractor', 'yin')
    if kind == 'yin':
        return YinPitchExtractor(sample_rate=dsp['sample_rate'],
                                 hop_length=dsp['hop_length'],
                                 fmin=pre.get('pitch_min_freq', 30),
                                 fmax=pre.get('pitch_max_freq', 600),
                                 frame_length=pre.get('pitch_frame_length', 2048))
    if kind == 'pyworld':
        try:
            return PyworldPitchExtractor(sample_rate=dsp['sample_rate'],
                                         hop_length=dsp['hop_length'])
        except ImportError:
            print('pyworld not installed; falling back to built-in YIN')
            return new_pitch_extractor_from_config(
                {**config, 'preprocessing': {**pre, 'pitch_extractor': 'yin'}})
    if kind == 'librosa':
        try:
            return LibrosaPitchExtractor(
                sample_rate=dsp['sample_rate'], hop_length=dsp['hop_length'],
                fmin=pre.get('pitch_min_freq', 30),
                fmax=pre.get('pitch_max_freq', 600),
                frame_length=pre.get('pitch_frame_length', 2048))
        except ImportError:
            print('librosa not installed; falling back to built-in YIN')
            return new_pitch_extractor_from_config(
                {**config, 'preprocessing': {**pre, 'pitch_extractor': 'yin'}})
    raise ValueError(f'Unknown pitch extractor: {kind}')
