"""Length regulation (duration-based token expansion), gather form.

Port of forwardtacotron_tpu/ops/length_regulator.py. The JAX package builds a
one-hot selection matrix for the MXU; on a GPU the same expansion is a
gather: frame t of item b copies the token whose span [start, end) holds t,
and frames at or past the expanded length are zero.
"""

import torch


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
    """Expand [B, N, C] token features to [B, max_len, C] frames."""
    _, ends = duration_spans(dur)
    t = torch.arange(max_len, device=x.device)
    # token owning frame t = number of span ends <= t
    idx = torch.searchsorted(ends, t.expand(x.shape[0], max_len).contiguous(),
                             right=True)
    idx = idx.clamp(max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    valid = t[None, :] < ends[:, -1:]
    return out * valid[:, :, None].to(x.dtype)
