"""JAX variables -> PyTorch state_dict: the inverse of the JAX package's
``convert_state_dict`` (forwardtacotron_tpu/utils/convert.py) for the
modules the port has.

  flax                                 torch
  ----                                 -----
  params/a/b/kernel (3D, [K, I, O])  -> a.b.weight [O, I, K]
  params/a/b/kernel (2D, [I, O])     -> a.b.weight [O, I]
  params/a/embedding/embedding       -> a.embedding.weight
  params/a/bnorm/{scale,bias}        -> a.bnorm.{weight,bias}
  batch_stats/a/bnorm/{mean,var}     -> a.bnorm.running_{mean,var}
                                        (+ num_batches_tracked = 0)
  params/a/rnn/{fwd,bwd}/{wi,wh}     -> a.rnn.weight_{ih,hh}_l0[_reverse], T
  params/a/rnn/{fwd,bwd}/{bi,bh}     -> a.rnn.bias_{ih,hh}_l0[_reverse]
  list entries 'xs_0'                -> 'xs.0'
"""

import re
from typing import Any, Dict

import numpy as np
import torch

_RNN = {'wi': 'weight_ih', 'wh': 'weight_hh', 'bi': 'bias_ih',
        'bh': 'bias_hh'}
_LIST_ITEM = re.compile(r'^(.*)_(\d+)$')


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _key(parts, leaf: str) -> str:
    out = []
    for p in parts:
        m = _LIST_ITEM.match(p)
        out.extend([m.group(1), m.group(2)] if m else [p])
    return '.'.join(out + [leaf])


def from_jax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} (numpy or JAX arrays) -> the
    port's state_dict entries (every key except the ``step`` buffer)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables.get('params', {})):
        leaf, parent = path[-1], path[:-1]
        if parent and parent[-1] in ('fwd', 'bwd') and leaf in _RNN:
            suffix = '_l0' if parent[-1] == 'fwd' else '_l0_reverse'
            key = _key(parent[:-1], _RNN[leaf] + suffix)
            val = arr.T if leaf in ('wi', 'wh') else arr
        elif leaf == 'kernel':
            key = _key(parent, 'weight')
            val = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
        elif leaf in ('embedding', 'scale'):
            key, val = _key(parent, 'weight'), arr
        elif leaf == 'bias':
            key, val = _key(parent, 'bias'), arr
        else:
            raise ValueError(f'Unrecognized parameter: {"/".join(path)}')
        sd[key] = torch.tensor(val, dtype=torch.float32)
    for path, arr in _flatten(variables.get('batch_stats', {})):
        leaf = path[-1]
        if leaf not in ('mean', 'var'):
            raise ValueError(f'Unrecognized batch stat: {"/".join(path)}')
        sd[_key(path[:-1], f'running_{leaf}')] = torch.tensor(
            arr, dtype=torch.float32)
        sd[_key(path[:-1], 'num_batches_tracked')] = torch.tensor(0)
    return sd
