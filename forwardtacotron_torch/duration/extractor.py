"""Attention -> phoneme durations via a shortest monotonic path (the port's
copy of forwardtacotron_tpu/duration/extractor.py, numpy and C++ only).

Re-design of reference duration_extraction/duration_extractor.py:11-130.
The reference builds an explicit sparse graph over (mel, text) nodes with
right/down/down-right edges weighted (1 - attention) and runs scipy
Dijkstra. Because that graph is a DAG with a fixed topological order, the
same shortest path falls out of an O(T*N) dynamic program — no graph
materialization, ~2 orders of magnitude faster on long utterances — so the
port extracts by the DP alone; the scipy-Dijkstra variant is kept only to
cross-check it (tests and chip_smoke.py call it).

Semantics preserved exactly:
  * silence prob shift: rows whose mel mean < silence_threshold get
    +shift on silent-phoneme columns and -shift elsewhere, then clamp [0,1]
    (:42-52) — this biases durations of pauses onto punctuation tokens.
  * a mel row traversed by several path nodes counts toward the LAST
    token visited in that row (:67-81).
  * att_score = mean attention prob over path nodes in non-silent rows.
"""

from typing import Tuple

import numpy as np

from forwardtacotron_torch.text.symbols import silent_phonemes_indices


class DurationExtractor:

    def __init__(self,
                 silence_threshold: float,
                 silence_prob_shift: float) -> None:
        self.silence_threshold = silence_threshold
        self.silence_prob_shift = silence_prob_shift

    def __call__(self,
                 x: np.ndarray,
                 mel: np.ndarray,
                 attention: np.ndarray) -> Tuple[np.ndarray, float]:
        """
        x: [N] token ids; mel: [n_mels, T] log-mel; attention: [T, N].
        Returns (durations [N] float, mean on-path attention prob).
        """
        x = np.asarray(x)
        attention, sil_mask = self.shifted_attention(x, mel, attention)
        path_probs = 1.0 - attention
        path = _shortest_monotonic_path_native(path_probs)
        if path is None:
            path = _shortest_monotonic_path_dp(path_probs)
        return durations_from_path(path, x.shape[0], attention, sil_mask)

    def shifted_attention(self, x: np.ndarray, mel: np.ndarray,
                          attention: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(attention [mel_len, N] in float64 with the silence shift on the
        silent rows, clamped to [0, 1]; the silent rows' mask). The path's
        node weights are 1 - attention."""
        mel = np.asarray(mel)
        mel_len = mel.shape[-1]
        attention = np.array(attention, dtype=np.float64, copy=True)
        attention = attention[:mel_len]
        sil_mask = mel.mean(axis=0) < self.silence_threshold
        if sil_mask.any():
            sil_tokens = np.isin(np.asarray(x), silent_phonemes_indices)
            shift = (sil_tokens.astype(np.float64) * 2.0 - 1.0) \
                * self.silence_prob_shift
            attention[sil_mask] += shift[None, :]
        return np.clip(attention, 0.0, 1.0), sil_mask


def durations_from_path(path, n_tokens: int, attention: np.ndarray,
                        sil_mask: np.ndarray) -> Tuple[np.ndarray, float]:
    """(durations [n_tokens], mean attention over the path's nodes in
    non-silent rows) of a path through the shifted attention. A row that
    several nodes traverse counts toward the last token visited in it."""
    durations = np.zeros(n_tokens, dtype=np.float32)
    row_to_token = {}
    att_scores = []
    for i, j in path:
        row_to_token[i] = j
        if not sil_mask[i]:
            att_scores.append(float(attention[i, j]))
    for j in row_to_token.values():
        durations[j] += 1.0
    att_score = float(np.mean(att_scores)) if att_scores else 0.0
    return durations, att_score


def _shortest_monotonic_path_native(w: np.ndarray):
    """C++ DP (native/duration_dp.cpp) via ctypes — identical algorithm and
    tie-breaking to _shortest_monotonic_path_dp, ~100x faster since the
    numpy version's rightward relaxation is a sequential Python loop.
    Returns None when the native library is unavailable."""
    import ctypes

    from forwardtacotron_torch.native import load_library

    lib = load_library('duration_dp')
    if lib is None:
        return None
    rows, cols = w.shape
    w64 = np.ascontiguousarray(w, dtype=np.float64)
    cap = rows + cols
    path_i = np.empty(cap, dtype=np.int32)
    path_j = np.empty(cap, dtype=np.int32)
    fn = lib.duration_dp_path
    fn.restype = ctypes.c_int
    n = fn(w64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
           ctypes.c_int64(rows), ctypes.c_int64(cols),
           path_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
           path_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n <= 0:
        return None
    return list(zip(path_i[:n].tolist(), path_j[:n].tolist()))


def _shortest_monotonic_path_dp(w: np.ndarray):
    """Min-cost path from (0,0) to (T-1,N-1) with moves right/down/diag;
    the cost of a step is the weight of the node entered. Vectorized over
    columns row-by-row; tie-breaking prefers diag, then down, then right
    (matching scipy Dijkstra's first-found order on this node numbering)."""
    rows, cols = w.shape
    dist = np.full((rows, cols), np.inf)
    move = np.zeros((rows, cols), dtype=np.int8)  # 0=right, 1=down, 2=diag
    dist[0, 0] = 0.0
    # first row: only rightward moves
    dist[0, 1:] = np.cumsum(w[0, 1:])
    for i in range(1, rows):
        down = dist[i - 1]                       # from (i-1, j)
        diag = np.concatenate(([np.inf], dist[i - 1, :-1]))  # from (i-1, j-1)
        best_prev = np.where(diag <= down, diag, down)
        move_row = np.where(diag <= down, 2, 1).astype(np.int8)
        # rightward moves within the row are a prefix-min scan
        d = best_prev + w[i]
        for j in range(1, cols):
            via_right = d[j - 1] + w[i, j]
            if via_right < d[j]:
                d[j] = via_right
                move_row[j] = 0
        dist[i] = d
        move[i] = move_row

    # backtrack
    path = []
    i, j = rows - 1, cols - 1
    while not (i == 0 and j == 0):
        path.append((i, j))
        m = move[i, j]
        if m == 0:
            j -= 1
        elif m == 1:
            i -= 1
        else:
            i -= 1
            j -= 1
    path.append((0, 0))
    path.reverse()
    return path


def _shortest_monotonic_path_dijkstra(w: np.ndarray):
    """Reference-equivalent scipy Dijkstra over the explicit DAG, used to
    cross-validate the DP (edge weights = entered node's weight)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    rows, cols = w.shape
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)

    src, dst, data = [], [], []
    # right edges
    src.append(idx[:, :-1].ravel())
    dst.append(idx[:, 1:].ravel())
    data.append(np.broadcast_to(w[:, 1:], (rows, cols - 1)).ravel())
    # down edges
    src.append(idx[:-1, :].ravel())
    dst.append(idx[1:, :].ravel())
    data.append(w[1:, :].ravel())
    # down-right edges
    src.append(idx[:-1, :-1].ravel())
    dst.append(idx[1:, 1:].ravel())
    data.append(w[1:, 1:].ravel())

    graph = coo_matrix((np.concatenate(data),
                        (np.concatenate(src), np.concatenate(dst))),
                       shape=(n, n)).tocsr()
    _, pred = dijkstra(csgraph=graph, directed=True, indices=0,
                       return_predecessors=True)
    path = []
    node = n - 1
    while node != 0 and node >= 0:
        path.append((node // cols, node % cols))
        node = pred[node]
    path.append((0, 0))
    path.reverse()
    return path
