"""Weights and BatchNorm statistics between the two packages' layouts, both
ways: ``from_jax_variables`` (JAX variables -> PyTorch state_dict) and
``convert_state_dict`` (its inverse, the port's copy of the JAX package's
forwardtacotron_tpu/utils/convert.py, with ``validate_against``), for the
modules the port has: a train step starts from the same variables in both
packages, and the port reads and writes the JAX package's ``.ckpt``
(``utils.checkpoints``).

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
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_RNN = {'wi': 'weight_ih', 'wh': 'weight_hh', 'bi': 'bias_ih',
        'bh': 'bias_hh'}
_LIST_ITEM = re.compile(r'^(.*)_(\d+)$')
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
    nested dicts of float32 numpy arrays (``convert_state_dict`` without
    the buffers that have no JAX counterpart)."""
    variables, _ = convert_state_dict(
        {k: v.detach().cpu().float() if v.is_floating_point() else v
         for k, v in state_dict.items()})
    variables.setdefault('batch_stats', {})
    return variables


# ------------------------------------------- the JAX package's converter
#
# A copy of forwardtacotron_tpu/utils/convert.py:35-169 (the torch -> flax
# direction and its tree check), on numpy.

RNN_SEQ_KEYS = {'weight_ih': 'wi', 'weight_hh': 'wh',
                'bias_ih': 'bi', 'bias_hh': 'bh'}


def _merge_digit_parts(parts: List[str]) -> List[str]:
    merged = []
    for p in parts:
        if p.isdigit() and merged:
            merged[-1] = f'{merged[-1]}_{p}'
        else:
            merged.append(p)
    return merged


def convert_state_dict(state_dict: Dict[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A (reference or port) state_dict -> ({'params': ...,
    'batch_stats': ...}, aux buffers): the JAX variable tree, with the
    ``step``, ``r`` and ``stop_threshold`` buffers in the aux dict by their
    state_dict keys (``num_batches_tracked`` and ``pe`` are dropped)."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    aux: Dict[str, np.ndarray] = {}

    for key, tensor in state_dict.items():
        arr = np.asarray(tensor.detach().cpu().numpy()
                         if hasattr(tensor, 'detach') else tensor)
        parts = _merge_digit_parts(key.split('.'))
        leaf = parts[-1]
        prefix = parts[:-1]

        if leaf in ('num_batches_tracked', 'pe'):
            continue
        if leaf in ('step', 'r', 'stop_threshold'):
            aux[key] = arr
            continue

        # sequence RNN: weight_ih_l0, bias_hh_l0_reverse, ...
        handled = False
        for torch_name, flax_name in RNN_SEQ_KEYS.items():
            if leaf.startswith(torch_name + '_l'):
                direction = 'bwd' if leaf.endswith('_reverse') else 'fwd'
                val = arr.T if flax_name in ('wi', 'wh') else arr
                _set_path(params, prefix + [direction, flax_name], val)
                handled = True
                break
            if leaf == torch_name:  # GRUCell / LSTMCell (no _l0 suffix)
                val = arr.T if flax_name in ('wi', 'wh') else arr
                _set_path(params, prefix + [flax_name], val)
                handled = True
                break
        if handled:
            continue

        if leaf == 'in_proj_weight':
            q, k, v = np.split(arr, 3, axis=0)
            for name, w in (('q_proj', q), ('k_proj', k), ('v_proj', v)):
                _set_path(params, prefix + [name, 'kernel'], w.T)
            continue
        if leaf == 'in_proj_bias':
            q, k, v = np.split(arr, 3, axis=0)
            for name, b in (('q_proj', q), ('k_proj', k), ('v_proj', v)):
                _set_path(params, prefix + [name, 'bias'], b)
            continue

        if leaf == 'running_mean':
            _set_path(batch_stats, prefix + ['mean'], arr)
            continue
        if leaf == 'running_var':
            _set_path(batch_stats, prefix + ['var'], arr)
            continue

        if leaf == 'weight':
            if arr.ndim == 3:        # Conv1d [O, I, K] -> [K, I, O]
                _set_path(params, prefix + ['kernel'], arr.transpose(2, 1, 0))
            elif arr.ndim == 2:
                if prefix and prefix[-1].endswith('embedding'):
                    _set_path(params, prefix + ['embedding'], arr)
                else:                # Linear [O, I] -> [I, O]
                    _set_path(params, prefix + ['kernel'], arr.T)
            else:                    # BatchNorm / LayerNorm gain
                _set_path(params, prefix + ['scale'], arr)
            continue
        if leaf == 'bias':
            _set_path(params, prefix + ['bias'], arr)
            continue
        if leaf == 'scale':          # PositionalEncoding learned scale
            _set_path(params, prefix + ['scale'], arr)
            continue

        raise ValueError(f'Unrecognized state_dict key: {key} '
                         f'(shape {arr.shape})')

    variables: Dict[str, Any] = {'params': params}
    if batch_stats:
        variables['batch_stats'] = batch_stats
    return variables, aux


def _tree_paths(tree: Dict, prefix=()) -> Dict[tuple, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def validate_against(variables: Dict[str, Any],
                     reference_variables: Dict[str, Any]) -> None:
    """Raise with a readable diff if a converted tree does not match a
    reference tree (a fresh JAX ``model.init``'s) in structure and
    shapes."""
    for col in reference_variables:
        got = _tree_paths(variables.get(col, {}))
        want = _tree_paths(_to_plain_dict(reference_variables[col]))
        missing = sorted(set(want) - set(got))
        unexpected = sorted(set(got) - set(want))
        mismatched = sorted(p for p in set(got) & set(want)
                            if got[p] != want[p])
        if missing or unexpected or mismatched:
            msg = [f'Converted tree mismatch in collection {col!r}:']
            for p in missing[:20]:
                msg.append(f'  missing:    {"/".join(p)} {want[p]}')
            for p in unexpected[:20]:
                msg.append(f'  unexpected: {"/".join(p)} {got[p]}')
            for p in mismatched[:20]:
                msg.append(f'  shape:      {"/".join(p)} got {got[p]} '
                           f'want {want[p]}')
            raise ValueError('\n'.join(msg))


def _to_plain_dict(tree) -> Dict:
    if hasattr(tree, 'items'):
        return {k: _to_plain_dict(v) for k, v in tree.items()}
    return tree


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
