"""Length regulation (duration-based token expansion).

Port of forwardtacotron_tpu/ops/length_regulator.py. The JAX package builds a
one-hot selection matrix for the MXU, and on the TPU ``length_regulator_auto``
sends every call to its Pallas kernel; here ``length_regulator`` sends every
call to the ``lr`` kernel wrapper (ops/hopper/lr.py), which launches the CUDA
gather for CUDA tensors and runs its plain twin for CPU tensors: frame t of
item b copies the token whose span [start, end) holds t, and frames at or
past the expanded length are zero.
"""

import torch

from forwardtacotron_torch.ops.hopper import lr


def round_durations(dur: torch.Tensor) -> torch.Tensor:
    """Negatives clamp to 0, then floor(d + 0.5) (half rounds up, unlike
    ``torch.round``, which rounds half to even)."""
    return torch.floor(torch.clamp(dur, min=0.0) + 0.5).to(torch.int64)


def duration_spans(dur: torch.Tensor):
    """[B, N] float durations -> (starts, ends) int64 frame spans."""
    reps = round_durations(dur)
    ends = torch.cumsum(reps, dim=1)
    return ends - reps, ends


def expanded_lengths(dur: torch.Tensor) -> torch.Tensor:
    """Total expanded frames per item: sum of rounded durations."""
    return round_durations(dur).sum(dim=1)


def length_regulator(x: torch.Tensor, dur: torch.Tensor,
                     max_len: int) -> torch.Tensor:
    """Expand [B, N, C] token features to [B, max_len, C] frames; one ``lr``
    kernel launch on the GPU. Differentiable in x (the gradient of a token
    sums its frames'), constant in the rounded durations."""
    _, ends = duration_spans(dur)
    return lr.length_regulator(x.contiguous(), ends.to(torch.int32), max_len)
