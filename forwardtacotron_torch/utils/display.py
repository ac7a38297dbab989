"""Console and matplotlib display helpers (the port's copy of
forwardtacotron_tpu/utils/display.py; reference utils/display.py).
matplotlib is imported at the first plot, so the package runs without it."""

import sys
import time
from typing import Any, List, Tuple

import numpy as np


def stream(message: str) -> None:
    sys.stdout.write(f'\r{message}')
    sys.stdout.flush()


def simple_table(rows: List[Tuple[str, Any]]) -> None:
    width = max(len(str(k)) for k, _ in rows) + 2
    print('+' + '-' * (width + 22) + '+')
    for key, value in rows:
        print(f'| {str(key):<{width}}: {str(value):<18} |')
    print('+' + '-' * (width + 22) + '+')


def progbar(i: int, n: int, size: int = 16) -> str:
    done = (i * size) // max(n, 1)
    return '█' * done + '░' * (size - done)


def time_since(start: float) -> str:
    m, s = divmod(int(time.time() - start), 60)
    h, m = divmod(m, 60)
    return f'{h}h {m}m {s}s' if h else f'{m}m {s}s'


def _agg_figure():
    import matplotlib
    matplotlib.use('agg')
    import matplotlib.pyplot as plt
    return plt


def plot_mel(mel: np.ndarray):
    """mel: [n_mels, T] log-mel."""
    plt = _agg_figure()
    fig, ax = plt.subplots(figsize=(12, 6))
    im = ax.imshow(mel, origin='lower', aspect='auto', interpolation='nearest')
    fig.colorbar(im, ax=ax)
    return fig


def plot_pitch(pitch: np.ndarray):
    plt = _agg_figure()
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.plot(np.asarray(pitch).ravel())
    ax.set_xlabel('phoneme index')
    ax.set_ylabel('pitch (normalized)')
    return fig


def plot_attention(attention: np.ndarray):
    """attention: [mel_len, x_len]."""
    plt = _agg_figure()
    fig, ax = plt.subplots(figsize=(12, 6))
    im = ax.imshow(attention, origin='lower', aspect='auto',
                   interpolation='nearest')
    fig.colorbar(im, ax=ax)
    ax.set_xlabel('text position')
    ax.set_ylabel('mel frame')
    return fig


def ignore_exception(fn):
    """Keep plot/audio generation from killing training
    (reference utils/decorators.py:6-15)."""
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            print(f'\n[ignored exception in {fn.__name__}]: {e}')
            return None
    return wrapped


def time_it(fn):
    def wrapped(*args, **kwargs):
        start = time.time()
        result = fn(*args, **kwargs)
        print(f'{fn.__name__} took {time.time() - start:.3f}s')
        return result
    return wrapped
