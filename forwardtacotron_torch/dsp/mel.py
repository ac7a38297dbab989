"""Slaney-style mel filterbank, computed on host with numpy.

Reimplements the Slaney Auditory-Toolbox mel scale (the librosa default used
by reference utils/dsp.py:69-75: htk=False, norm='slaney', power=1) from the
published definition: linear below 1 kHz (break frequency), logarithmic above
with a step of log(6.4)/27 per mel.
"""

import numpy as np

_F_SP = 200.0 / 3.0           # Hz per mel in the linear region
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(log_region,
                    _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
                    mels)
    return mels


def mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = mels * _F_SP
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(log_region,
                     _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
                     freqs)
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(sample_rate: int,
                   n_fft: int,
                   n_mels: int,
                   fmin: float,
                   fmax: float) -> np.ndarray:
    """Triangular mel filterbank [n_mels, 1 + n_fft // 2] with Slaney area norm."""
    if fmax is None or fmax <= 0:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: each filter has unit area
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
