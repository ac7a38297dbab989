"""Data parallelism: the process group, the serving devices and the batch
helpers (the port's copy of forwardtacotron_tpu/parallel/mesh.py).

Training runs one process per card (``torchrun --nproc_per_node N``), as
the JAX package runs N processes of one device each. The config's batch
size is per process and a step is the single-process step on the
concatenation of every rank's batch: the losses divide each rank's sums by
counts summed over the ranks, BatchNorm sums its statistics over the
ranks, and the gradients are summed over the ranks before the clip and
Adam. Every helper here is the identity when no process group exists or
its world is 1, so one process runs exactly as before; in a larger world
they are collectives, and every rank must reach them in the same order
(the trainers' steps, evaluation and the teacher-forced forward do). Work
that one rank does alone (rank 0's plots) runs under ``local()``, where
the helpers are the identity again.

Serving runs one process that holds a replica of the model on each device
of a "mesh", here a plain list of devices (``make_mesh``), and splits a
request batch over them (``TTSInference(mesh=)``).
"""

import contextlib
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# the environment that torchrun (python -m torch.distributed.run) sets
ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')
# a rank that waits this long in a collective fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(device: Union[str, torch.device] = 'cuda'
                           ) -> bool:
    """Join the process group that torchrun describes in the environment
    (``ENV``): NCCL with this rank on ``cuda:LOCAL_RANK`` when ``device``
    is CUDA, gloo when it is the CPU. Returns False and does nothing when
    the environment is absent; a second call is a no-op that returns True.
    Raises when CUDA is asked for and there is no card."""
    if dist.is_initialized():
        return True
    if any(k not in os.environ for k in ENV):
        return False
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    if torch.device(device).type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('a NCCL rank needs a CUDA device; pass '
                               "device='cpu' for gloo on the CPU")
        torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        backend = 'nccl'
    else:
        backend = 'gloo'
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return True


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA device in a
    process group, else ``device`` as it is."""
    device = torch.device(device)
    if device.type == 'cuda' and dist.is_initialized():
        return torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# how many ``local()`` blocks this process is in
_local_depth = 0


@contextlib.contextmanager
def local():
    """The block runs as if this process were alone: ``data_parallel()``
    is False in it, so the collective helpers are the identity and no
    rank waits for a collective that only this one reaches."""
    global _local_depth
    _local_depth += 1
    try:
        yield
    finally:
        _local_depth -= 1


def data_parallel() -> bool:
    """True in a process group of more than one rank, outside
    ``local()``."""
    return process_count() > 1 and not _local_depth


# --------------------------------------------------------------- serving


def visible_devices(device_type: str = 'cuda') -> List[torch.device]:
    """Every device of ``device_type`` this process sees: each CUDA card
    (raises without one), or the CPU as many times as torch counts it."""
    if device_type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('No CUDA device is available for the mesh')
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)] * torch.cpu.device_count()


def make_mesh(n_data: Optional[int] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Tuple[torch.device, ...]:
    """The serving devices, one replica each: the first ``n_data`` of
    ``devices`` (default: every visible card). A device may be listed
    twice: its replicas then share the card."""
    devices = [torch.device(d) for d in
               (visible_devices() if devices is None else devices)]
    n_data = len(devices) if n_data is None else n_data
    if not 1 <= n_data <= len(devices):
        raise ValueError(f'make_mesh: n_data {n_data} of {len(devices)} '
                         'devices')
    return tuple(devices[:n_data])


def pad_batch_to_devices(batch: Dict[str, Any],
                         mesh: Sequence) -> Dict[str, Any]:
    """Pad the batch dimension to a multiple of ``len(mesh)``: padded rows
    repeat row 0, with ``mel_len`` / ``x_len`` 0 so that they drop out of
    the masks; lists repeat their first entry (the JAX package's
    semantics)."""
    n_data = len(mesh)
    sizes = [v.shape[0] for v in batch.values() if isinstance(v, np.ndarray)]
    if not sizes or sizes[0] % n_data == 0:
        return batch
    pad = n_data - sizes[0] % n_data
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            reps = np.repeat(value[:1], pad, axis=0)
            if key in ('mel_len', 'x_len'):
                reps = np.zeros_like(reps)
            out[key] = np.concatenate([value, reps], axis=0)
        elif isinstance(value, list):
            out[key] = value + [value[0]] * pad
        else:
            out[key] = value
    return out


# -------------------------------------------------------------- training


def shard_batch(batch: Dict[str, Any],
                device: Union[str, torch.device]) -> Dict[str, Any]:
    """This rank's equal share of the rows of a global batch (padded with
    ``pad_batch_to_devices`` first), arrays as tensors on ``device``."""
    n, r = process_count(), process_index()
    out = {}
    for key, value in batch.items():
        if isinstance(value, (np.ndarray, list)):
            if len(value) % n:
                raise ValueError(f'shard_batch: {key} has {len(value)} rows '
                                 f'for {n} ranks')
            rows = len(value) // n
            value = value[r * rows:(r + 1) * rows]
            if isinstance(value, np.ndarray):
                value = torch.as_tensor(value, device=device)
        out[key] = value
    return out


def _collective_device() -> torch.device:
    """Where a collective's tensor lives: the rank's card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _flat_apply(tensors: Sequence[torch.Tensor], fn) -> None:
    """Run the collective ``fn`` on ``tensors`` in place, as one flat
    buffer for each (dtype, device)."""
    groups: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        fn(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, so that
    all begin identical (the JAX package's ``replicate_tree``)."""
    if data_parallel():
        _flat_apply([t for t in list(module.parameters())
                     + list(module.buffers())],
                    lambda flat: dist.broadcast(flat, src=0))
    return module


@torch.no_grad()
def sum_gradients(grads: Sequence[Optional[torch.Tensor]]
                  ) -> Sequence[Optional[torch.Tensor]]:
    """The gradients summed over the ranks, in place (None stays None:
    every rank runs the same graph)."""
    if data_parallel():
        _flat_apply([g for g in grads if g is not None], dist.all_reduce)
    return grads


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, outside autograd (counts, metrics)."""
    if not data_parallel():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def global_max(t: torch.Tensor) -> torch.Tensor:
    """``t``, the largest over the ranks (the teacher-forced forward's
    longest frame count of the global batch)."""
    if not data_parallel():
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def global_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable: its gradient is the
    incoming gradients summed over the ranks (BatchNorm's statistics)."""
    if not data_parallel():
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch: its
    sum over the element count of every rank (``torch.mean`` in one
    process); the shares sum to the mean."""
    if not data_parallel():
        return torch.mean(x)
    count = global_sum(torch.tensor(float(x.numel()), dtype=torch.float64,
                                    device=x.device))
    return torch.sum(x) / count.to(x.dtype)


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar metrics summed over the ranks in one collective (each rank's
    loss is its share of the global loss)."""
    if not data_parallel():
        return metrics
    keys = list(metrics)
    total = global_sum(torch.stack([metrics[k].detach().float()
                                    for k in keys]))
    return dict(zip(keys, total.unbind()))


def host_sum(values: Sequence[float]) -> List[float]:
    """Host numbers summed over the ranks."""
    if not data_parallel():
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=_collective_device())
    dist.all_reduce(t)
    return t.tolist()


def host_max(values: Sequence[int]) -> List[int]:
    """Host integers, the largest over the ranks (the common padded
    shape)."""
    return _host_reduce(values, dist.ReduceOp.MAX)


def host_min(values: Sequence[int]) -> List[int]:
    """Host integers, the smallest over the ranks (the common step
    count)."""
    return _host_reduce(values, dist.ReduceOp.MIN)


def _host_reduce(values: Sequence[int], op) -> List[int]:
    if not data_parallel():
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=_collective_device())
    dist.all_reduce(t, op=op)
    return t.tolist()
