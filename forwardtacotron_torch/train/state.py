"""Train state (float32 master parameters and BatchNorm statistics in the
model, optimizer state, step) and the optimizer.

The port's counterpart of forwardtacotron_tpu/train/state.py. The optimizer
is the JAX package's optax chain, global-norm clipping followed by Adam
with an injected learning rate (``make_optimizer``), with optax's formulas:
the clip scales by max_norm / g_norm only when g_norm >= max_norm (no
``clip_grad_norm_``-style epsilon), Adam takes b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias corrections from the int32 step count, all
hyperparameters are float32 scalars as ``inject_hyperparams`` holds them
(so 1 - b2 is 0.0009999871, not 0.001), and a new learning rate keeps the
moments (the reference mutates the param groups in place,
trainer/forward_trainer.py:62-63).
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from forwardtacotron_torch.utils.checkpoints import tree_to


class Optimizer:
    """optax.chain(clip_by_global_norm(max_norm),
    inject_hyperparams(adam)(learning_rate)) on named float32 tensors."""

    def __init__(self, learning_rate: float,
                 clip_grad_norm: Optional[float] = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.max_norm = clip_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        device = next(iter(params.values())).device
        return {'count': torch.zeros((), dtype=torch.int32, device=device),
                'mu': {k: torch.zeros_like(p) for k, p in params.items()},
                'nu': {k: torch.zeros_like(p) for k, p in params.items()},
                'learning_rate': torch.tensor(self.learning_rate,
                                              dtype=torch.float32,
                                              device=device)}

    @torch.no_grad()
    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if not self.max_norm:
            return grads
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_norm
        return [torch.where(keep, g, (g / g_norm) * self.max_norm)
                for g in grads]

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]],
             state: Dict[str, Any]) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads`` (None
        for a parameter the loss does not reach: a zero gradient). Returns
        the global gradient norm before clipping."""
        names = list(params)
        raw = [torch.zeros_like(params[k]) if grads.get(k) is None
               else grads[k] for k in names]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in raw))
        clipped = self.clip(raw)
        state['count'] += 1
        count = state['count'].float()
        b1, b2, eps = (torch.tensor(v, dtype=torch.float32,
                                    device=count.device)
                       for v in (self.b1, self.b2, self.eps))
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        scale = -state['learning_rate']
        for k, g in zip(names, clipped):
            mu = (1 - b1) * g + b1 * state['mu'][k]
            nu = (1 - b2) * (g * g) + b2 * state['nu'][k]
            state['mu'][k], state['nu'][k] = mu, nu
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            params[k].add_(update * scale)
        return g_norm


def make_optimizer(learning_rate: float,
                   clip_grad_norm: Optional[float] = 1.0) -> Optimizer:
    return Optimizer(learning_rate, clip_grad_norm)


@dataclass
class TrainState:
    model: torch.nn.Module     # float32 parameters and BatchNorm statistics
    opt_state: Dict[str, Any]
    step: int

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: torch.nn.Module, tx: Optimizer,
                       step: int = 0) -> TrainState:
    return TrainState(model=model,
                      opt_state=tx.init(dict(model.named_parameters())),
                      step=int(step))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the injected learning rate, keeping the Adam moments."""
    state.opt_state['learning_rate'] = torch.tensor(
        lr, dtype=torch.float32, device=state.opt_state['count'].device)
    return state


def state_from_checkpoint(model: torch.nn.Module, tx: Optimizer,
                          checkpoint: Dict[str, Any]) -> TrainState:
    """The train state a checkpoint holds: its weights and statistics
    loaded into ``model``, its optimizer state moved to the model's device,
    its step."""
    model.load_state_dict(checkpoint['model'])
    state = create_train_state(
        model, tx, step=int(checkpoint['model']['step'].reshape(-1)[0]))
    if 'optim' in checkpoint:
        state.opt_state = tree_to(checkpoint['optim'],
                                  next(model.parameters()).device)
    return state
