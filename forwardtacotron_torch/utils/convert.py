"""Weights and BatchNorm statistics between the two packages' layouts, both
ways: ``from_jax_variables`` (JAX variables -> PyTorch state_dict, the
inverse of the JAX package's ``convert_state_dict``,
forwardtacotron_tpu/utils/convert.py) and ``to_jax_variables`` (its
inverse), for the modules the port has, so that a train step can start from
the same variables in both packages.

  flax                                 torch
  ----                                 -----
  params/a/b/kernel (3D, [K, I, O])  -> a.b.weight [O, I, K]
  params/a/b/kernel (2D, [I, O])     -> a.b.weight [O, I]
  params/a/embedding/embedding       -> a.embedding.weight (also the
                                        multispeaker predictors'
                                        pitch_cond_embedding and
                                        conditional_embedding)
  params/a/bnorm/{scale,bias}        -> a.bnorm.{weight,bias}
  params/a/norm1/{scale,bias}        -> a.norm1.{weight,bias} (LayerNorm)
  params/a/pos_encoder/scale         -> a.pos_encoder.scale
  params/a/{q,k,v}_proj/kernel [I, O] -> a.in_proj_weight [3O, I], rows
                                        q, k, v (biases: a.in_proj_bias)
  batch_stats/a/bnorm/{mean,var}     -> a.bnorm.running_{mean,var}
                                        (+ num_batches_tracked = 0)
  params/a/rnn/{fwd,bwd}/{wi,wh}     -> a.rnn.weight_{ih,hh}_l0[_reverse], T
  params/a/rnn/{fwd,bwd}/{bi,bh}     -> a.rnn.bias_{ih,hh}_l0[_reverse]
  params/a/cell/{wi,wh}              -> a.cell.weight_{ih,hh}, T (the
                                        teacher's GRU and LSTM cells)
  params/a/cell/{bi,bh}              -> a.cell.bias_{ih,hh}
  list entries 'xs_0'                -> 'xs.0'

The FastPitch ``pos_encoder.pe`` tables, like the ``step`` buffer and the
teacher's ``decoder.r`` and ``stop_threshold``, have no JAX counterpart:
the modules fill them.

``hifigan_from_jax_params`` carries the JAX HiFi-GAN generator's params into
the port's ``HiFiGANGenerator`` (models/vocoder.py).
"""

import re
from typing import Any, Dict

import numpy as np
import torch

_RNN = {'wi': 'weight_ih', 'wh': 'weight_hh', 'bi': 'bias_ih',
        'bh': 'bias_hh'}
_LIST_ITEM = re.compile(r'^(.*)_(\d+)$')
_RNN_LEAF = re.compile(
    r'^(weight_ih|weight_hh|bias_ih|bias_hh)(_l0(_reverse)?)?$')
# buffers of the port's modules that the JAX variables do not hold
_NO_JAX = ('step', 'num_batches_tracked', 'pe', 'r', 'stop_threshold')
_QKV = ('q_proj', 'k_proj', 'v_proj')
_IN_PROJ = {'kernel': 'in_proj_weight', 'bias': 'in_proj_bias'}


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
    port's state_dict entries (every key except the ``step`` buffer and
    the positional tables)."""
    sd: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for path, arr in _flatten(variables.get('params', {})):
        leaf, parent = path[-1], path[:-1]
        if parent and parent[-1] in _QKV and leaf in _IN_PROJ:
            # torch's joint in-projection: rows q, k, v
            qkv.setdefault(_key(parent[:-1], _IN_PROJ[leaf]), {})[
                parent[-1]] = arr.T if leaf == 'kernel' else arr
            continue
        if parent and parent[-1] in ('fwd', 'bwd') and leaf in _RNN:
            suffix = '_l0' if parent[-1] == 'fwd' else '_l0_reverse'
            key = _key(parent[:-1], _RNN[leaf] + suffix)
            val = arr.T if leaf in ('wi', 'wh') else arr
        elif leaf in _RNN:
            # a single cell (GRUCellP, LSTMCellP)
            key = _key(parent, _RNN[leaf])
            val = arr.T if leaf in ('wi', 'wh') else arr
        elif leaf == 'kernel':
            key = _key(parent, 'weight')
            val = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
        elif leaf == 'scale' and parent and parent[-1] == 'pos_encoder':
            key, val = _key(parent, 'scale'), arr
        elif leaf in ('embedding', 'scale'):
            key, val = _key(parent, 'weight'), arr
        elif leaf == 'bias':
            key, val = _key(parent, 'bias'), arr
        else:
            raise ValueError(f'Unrecognized parameter: {"/".join(path)}')
        sd[key] = torch.tensor(val, dtype=torch.float32)
    for key, parts in qkv.items():
        sd[key] = torch.tensor(np.concatenate([parts[n] for n in _QKV]),
                               dtype=torch.float32)
    for path, arr in _flatten(variables.get('batch_stats', {})):
        leaf = path[-1]
        if leaf not in ('mean', 'var'):
            raise ValueError(f'Unrecognized batch stat: {"/".join(path)}')
        sd[_key(path[:-1], f'running_{leaf}')] = torch.tensor(
            arr, dtype=torch.float32)
        sd[_key(path[:-1], 'num_batches_tracked')] = torch.tensor(0)
    return sd


def _set_path(tree: Dict[str, Any], path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def to_jax_variables(state_dict: Dict[str, torch.Tensor]
                     ) -> Dict[str, Dict[str, Any]]:
    """The port's state_dict -> {'params': ..., 'batch_stats': ...} as
    nested dicts of float32 numpy arrays (the buffers of ``_NO_JAX`` have
    no JAX counterpart)."""
    variables: Dict[str, Dict[str, Any]] = {'params': {}, 'batch_stats': {}}
    inverse = {v: k for k, v in _RNN.items()}
    for key, tensor in state_dict.items():
        parts = []
        for p in key.split('.'):
            if p.isdigit():
                parts[-1] += f'_{p}'
            else:
                parts.append(p)
        *mods, leaf = parts
        if leaf in _NO_JAX:
            continue
        arr = tensor.detach().cpu().float().numpy()
        rnn = _RNN_LEAF.match(leaf)
        in_proj = {v: k for k, v in _IN_PROJ.items()}.get(leaf)
        if in_proj:
            for name, part in zip(_QKV, np.split(arr, 3)):
                _set_path(variables['params'], mods + [name, in_proj],
                          part.T if in_proj == 'kernel' else part)
        elif rnn:
            name = inverse[rnn.group(1)]
            if rnn.group(2) is None:      # a single cell
                path = mods + [name]
            else:
                path = mods + ['bwd' if rnn.group(3) else 'fwd', name]
            _set_path(variables['params'], path,
                      arr.T if name in ('wi', 'wh') else arr)
        elif leaf in ('running_mean', 'running_var'):
            _set_path(variables['batch_stats'], mods + [leaf[len('running_'):]],
                      arr)
        elif leaf == 'scale' or (leaf == 'weight' and arr.ndim == 1):
            # BatchNorm / LayerNorm gains, the positional encoding's scale
            _set_path(variables['params'], mods + ['scale'], arr)
        elif leaf == 'weight' and mods[-1].endswith('embedding'):
            _set_path(variables['params'], mods + ['embedding'], arr)
        elif leaf == 'weight':
            _set_path(variables['params'], mods + ['kernel'],
                      arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T)
        elif leaf == 'bias':
            _set_path(variables['params'], mods + ['bias'], arr)
        else:
            raise ValueError(f'Unrecognized state_dict entry: {key}')
    return variables


def hifigan_from_jax_params(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's HiFi-GAN params tree -> the port's
    ``HiFiGANGenerator`` state_dict: the inverse of its
    ``convert_hifigan_state_dict`` (after weight-norm folding).

      conv_pre/conv/kernel [K, C_in, C_out] -> conv_pre.weight
                                               [C_out, C_in, K]
      ups_i/kernel [K, C_in, C_out], flipped -> ups.i.weight [C_in, C_out, K]
      resblocks_r/convs1_j/conv/{kernel,bias}
                                 -> resblocks.r.convs1.j.{weight,bias}
    """
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        leaf, parent = path[-1], [p for p in path[:-1] if p != 'conv']
        if leaf == 'kernel' and parent[0].startswith('ups_'):
            val = arr[::-1].transpose(1, 2, 0)
        elif leaf == 'kernel':
            val = arr.transpose(2, 1, 0)
        elif leaf == 'bias':
            val = arr
        else:
            raise ValueError(f'Unrecognized parameter: {"/".join(path)}')
        sd[_key(parent, 'weight' if leaf == 'kernel' else 'bias')] = \
            torch.tensor(np.ascontiguousarray(val), dtype=torch.float32)
    return sd
