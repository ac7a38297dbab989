"""Training primitives shared by the trainers (the port's copy of
forwardtacotron_tpu/train/common.py): TTSSession (reference
trainer/common.py:8-27), Averager (:51-66), the masked L1 loss (:69-92),
the multispeaker models' pitch-condition cross-entropy and accuracy, a
steps/s timer and the float cast of the mixed-precision step.

In a data-parallel step (``parallel.mesh``) each loss divides this rank's
sum by the element count summed over the ranks, so the ranks' losses sum
to the loss of the concatenated global batch, as in the JAX package's
multi-process step; in one process the count is this rank's alone."""

import time
from typing import Any, Dict, Optional

import torch

from forwardtacotron_torch.models.layers import make_len_mask
from forwardtacotron_torch.parallel.mesh import global_sum


class TTSSession:
    """Per-schedule-row training context (reference trainer/common.py:8-27)."""

    def __init__(self, index: int, r: int, lr: float, max_step: int, bs: int,
                 train_set, val_set) -> None:
        self.index = index
        self.r = r
        self.lr = lr
        self.max_step = max_step
        self.bs = bs
        self.train_set = train_set
        self.val_set = val_set
        self.val_sample = next(iter(val_set))


class Averager:

    def __init__(self) -> None:
        self.count = 0
        self.val = 0.0

    def add(self, val: float) -> None:
        self.val += float(val)
        self.count += 1

    def reset(self) -> None:
        self.val = 0.0
        self.count = 0

    def get(self) -> float:
        return self.val / self.count if self.count > 0 else 0.0


def len_mask(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] -> [B, max_len] float32 mask, 1 inside the valid prefix."""
    return (~make_len_mask(lens, max_len)).float()


def masked_l1(x: torch.Tensor, target: torch.Tensor,
              lens: torch.Tensor) -> torch.Tensor:
    """Sum of |x - target| over the valid time prefix / number of masked
    elements (reference MaskedL1, trainer/common.py:69-78). Accepts [B, T]
    or [B, T, C]; the mask runs over axis 1."""
    if x.dim() == 2:
        x, target = x[:, :, None], target[:, :, None]
    mask = len_mask(lens, x.shape[1])[:, :, None].expand(x.shape)
    loss = torch.sum(torch.abs(x * mask - target * mask))
    return loss / torch.clamp(global_sum(torch.sum(mask)), min=1.0)


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_index: int = 0) -> torch.Tensor:
    """Token-level cross-entropy that skips the ``ignore_index`` class
    (reference trainer/multi_forward_trainer.py:34,
    ``CrossEntropyLoss(ignore_index=0)``): logits [B, N, K], targets
    [B, N]; the mean over the other tokens, 0 where there are none."""
    log_probs = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
    valid = (targets != ignore_index).float()
    return -torch.sum(picked * valid) / torch.clamp(
        global_sum(torch.sum(valid)), min=1.0)


def classification_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                            ignore_index: int = 0) -> torch.Tensor:
    """Share of the non-``ignore_index`` tokens whose argmax class is the
    target's."""
    valid = (targets != ignore_index).float()
    correct = (torch.argmax(logits, dim=-1) == targets).float() * valid
    return torch.sum(correct) / torch.clamp(global_sum(torch.sum(valid)),
                                            min=1.0)


class StepTimer:
    """Wall-clock steps/s tracker (the reference's inline timing,
    trainer/forward_trainer.py:70,106-112)."""

    def __init__(self) -> None:
        self._avg = Averager()
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.time()
        if self._last is not None:
            self._avg.add(now - self._last)
        self._last = now

    def steps_per_second(self) -> float:
        d = self._avg.get()
        return 1.0 / d if d > 0 else 0.0

    def reset(self) -> None:
        self._avg.reset()
        self._last = None


def cast_floats(tree: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Cast every floating-point tensor of a dict to ``dtype`` (integer
    tensors and non-tensors pass through). The mixed-precision train step
    casts the parameters and the batch to bf16 with it, and the outputs
    back to float32."""
    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in tree.items()}
