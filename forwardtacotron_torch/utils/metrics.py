"""Attention quality metrics (the port's copy of
forwardtacotron_tpu/utils/metrics.py, reference utils/metrics.py:4-31)."""

from typing import Tuple

import numpy as np


def attention_score(att: np.ndarray,
                    mel_lens: np.ndarray,
                    r: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Per-item (loc_score, sharp_score) for a batch of attention matrices.

    att: [B, S, N] attention over decoder steps; mel_lens: [B] mel frames.
    loc_score: fraction of adjacent argmax moves <= r, normalized by
    (mel_len//r - 1); sharp_score: masked mean of per-step max probability.
    """
    att = np.asarray(att, dtype=np.float64)
    mel_lens = np.asarray(mel_lens)
    s = att.shape[1]
    lens = mel_lens // r
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float64)

    max_loc = att.argmax(axis=2)
    move = np.abs(np.diff(max_loc, axis=1))
    loc = ((move >= 0) & (move <= r)).astype(np.float64) * mask[:, 1:]
    loc_score = loc.sum(axis=1) / np.maximum(lens - 1, 1)

    sharp = att.max(axis=2)
    sharp_score = (sharp * mask).sum(axis=1) / np.maximum(mask.sum(axis=1), 1)
    return loc_score, sharp_score
