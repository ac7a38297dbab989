"""Checkpoints in both of the project's formats.

- Reference-format ``.pt``: a torch file holding {'model': state_dict,
  'optim': optimizer state, 'config': dict, ...} (reference
  utils/checkpoints.py:13-34), with any meta (the multispeaker speaker
  table) at the top level. The port's trainers write these
  (``save_checkpoint``); the model's ``step`` buffer holds the step.
- The JAX package's native ``.ckpt`` (forwardtacotron_tpu/utils/
  checkpoints.py): one msgpack map {'config_yaml', 'meta', 'opt_state',
  'step', 'variables', 'version'} of the JAX variable tree, the optax
  state as flax's ``to_bytes`` lays it out and the config as YAML,
  written and read with the port's own codec (``utils.msgpack``).
  ``save_native_checkpoint`` writes the bytes the JAX package's
  ``save_checkpoint`` writes for the same state.

``load_checkpoint`` tells the two apart as the JAX package does (a torch
file starts as a zip archive or a pickle stream) and returns the port's
checkpoint dict for either. For a ``.ckpt``: the variables become a
state_dict of the config's model (the teacher, Tacotron, where the
variables hold its ``encoder_proj_query``); the buffers the JAX tree lacks
are set as the JAX trainers would have them (``step`` from the payload,
the teacher's ``decoder.r`` from its schedule row at that step, the
positional tables and ``stop_threshold`` from the model); the optax state
becomes the port's {'count', 'mu', 'nu', 'learning_rate'}
(``train.state.Optimizer``); and the meta moves to the top level, where
``gen_forward --speaker`` and ``MultiForwardTrainer`` read the speaker
table. Reference checkpoints pickle their config, so ``.pt`` files are for
trusted sources only.
"""

from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import yaml

from forwardtacotron_torch.models.registry import init_tts_model
from forwardtacotron_torch.utils.convert import (convert_state_dict,
                                                 from_jax_variables,
                                                 to_jax_variables)
from forwardtacotron_torch.utils.files import parse_schedule
from forwardtacotron_torch.utils.msgpack import (msgpack_restore,
                                                 msgpack_serialize)

CHECKPOINT_VERSION = 1
# state_dict buffers a JAX variable tree does not hold
_FILLED_BUFFERS = ('step', 'pe', 'r', 'stop_threshold')
# optax's adam defaults, as inject_hyperparams holds them (float32)
_ADAM = {'b1': 0.9, 'b2': 0.999, 'eps': 1e-8, 'eps_root': 0.0}


def _is_torch_checkpoint(head: bytes) -> bool:
    # torch.save writes a zip archive (PK..) or a pickle protocol 2 stream
    return head[:2] == b'PK' or head[:2] == b'\x80\x02'


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The checkpoint dict ('model', 'config', optional 'optim' and meta),
    on the CPU, from a reference-format ``.pt`` or a native ``.ckpt``."""
    with open(str(path), 'rb') as f:
        head = f.read(2)
    if _is_torch_checkpoint(head):
        return torch.load(str(path), map_location='cpu', weights_only=False)
    return _from_native(msgpack_restore(Path(path).read_bytes()))


def _is_teacher(variables: Dict[str, Any]) -> bool:
    return 'encoder_proj_query' in variables['params']


def _teacher_r(config: Dict[str, Any], step: int) -> int:
    """The reduction factor of the teacher's schedule row at ``step``: the
    first row the step has not finished, else the last."""
    rows = parse_schedule(config['tacotron']['training']['schedule'])
    return next((r for r, _, max_step, _ in rows if step < max_step),
                rows[-1][0])


def _writable(tree: Any) -> Any:
    """A decoded tree with its arrays copied out of the file's bytes."""
    if isinstance(tree, dict):
        return {k: _writable(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return np.array(tree)
    return tree


def _from_native(payload: Dict[str, Any]) -> Dict[str, Any]:
    from forwardtacotron_torch.models.tacotron import Tacotron

    config = yaml.load(payload['config_yaml'], Loader=yaml.FullLoader)
    step = int(payload['step'])
    variables = payload['variables']
    teacher = _is_teacher(variables)
    model = Tacotron.from_config(config) if teacher \
        else init_tts_model(config)
    missing, unexpected = model.load_state_dict(
        from_jax_variables(variables), strict=False)
    wrong = [k for k in missing if k.split('.')[-1] not in _FILLED_BUFFERS]
    if unexpected or wrong:
        raise ValueError(f'the checkpoint does not fit the config\'s model: '
                         f'missing {wrong}, unexpected {unexpected}')
    with torch.no_grad():
        model.step.fill_(step)
        if teacher:
            model.decoder.r.fill_(_teacher_r(config, step))
    checkpoint = {'model': model.state_dict(), 'config': config}
    if 'opt_state' in payload:
        checkpoint['optim'] = _optim_from_optax(
            msgpack_restore(payload['opt_state']),
            [name for name, _ in model.named_parameters()])
    checkpoint.update(_writable(payload.get('meta') or {}))
    return checkpoint


def _optim_from_optax(state: Dict[str, Any], names) -> Dict[str, Any]:
    """The state of ``chain([clip_by_global_norm,]
    inject_hyperparams(adam))`` as flax's ``to_state_dict`` lays it out
    ({'0': clip's empty state, '1': {'count', 'hyperparams',
    'hyperparams_states', 'inner_state': {'0': adam's {'count', 'mu',
    'nu'}, '1': {}}}}) -> the port's optimizer state for the parameters
    ``names``."""
    inject = next(s for s in state.values() if 'hyperparams' in s)
    adam = inject['inner_state']['0']

    def moments(tree):
        sd = from_jax_variables({'params': tree})
        return {k: sd[k] for k in names}
    return {'count': torch.tensor(int(adam['count']), dtype=torch.int32),
            'mu': moments(adam['mu']), 'nu': moments(adam['nu']),
            'learning_rate': torch.tensor(
                float(inject['hyperparams']['learning_rate']),
                dtype=torch.float32)}


def _optax_state(opt_state: Dict[str, Any], clip: bool) -> Dict[str, Any]:
    """The inverse of ``_optim_from_optax``: both of optax's counts are the
    port's count."""
    count = np.asarray(int(opt_state['count']), np.int32)

    def moments(tree):
        return convert_state_dict(tree)[0]['params']
    inject = {'count': count,
              'hyperparams': dict(
                  {k: np.asarray(v, np.float32) for k, v in _ADAM.items()},
                  learning_rate=np.asarray(
                      float(opt_state['learning_rate']), np.float32)),
              'hyperparams_states': {},
              'inner_state': {'0': {'count': count,
                                    'mu': moments(opt_state['mu']),
                                    'nu': moments(opt_state['nu'])},
                              '1': {}}}
    return {'0': {}, '1': inject} if clip else {'0': inject}


def _numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_native_checkpoint(path: Union[str, Path], model: torch.nn.Module,
                           config: Dict[str, Any], step: int,
                           opt_state: Optional[Dict[str, Any]] = None,
                           meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the JAX package's ``.ckpt`` of ``model`` (float32 variables),
    its optimizer state and ``meta`` atomically: what that package's
    ``save_checkpoint`` writes, which its ``load_checkpoint`` and
    ``restore_opt_state`` read."""
    variables = to_jax_variables(model.state_dict())
    payload = {'version': CHECKPOINT_VERSION, 'step': int(step),
               'config_yaml': yaml.dump(config, default_flow_style=False),
               'variables': variables}
    if opt_state is not None:
        section = 'tacotron' if _is_teacher(variables) \
            else config.get('tts_model', 'forward_tacotron')
        clip = config[section]['training'].get('clip_grad_norm', 1.0)
        payload['opt_state'] = msgpack_serialize(
            _optax_state(opt_state, bool(clip)))
    if meta:
        payload['meta'] = _numpy_tree(meta)
    path = Path(path)
    tmp = path.with_suffix(path.suffix + '.tmp')
    tmp.write_bytes(msgpack_serialize(payload))
    tmp.replace(path)  # a crash never leaves half a checkpoint


def init_tts_model_from_checkpoint(path: Union[str, Path]
                                   ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """(model with the checkpoint's weights, checkpoint) on the CPU, from a
    ``.pt`` or a ``.ckpt``; the caller moves the model where it runs
    (``TTSInference`` does)."""
    checkpoint = load_checkpoint(path)
    model = init_tts_model(checkpoint['config'])
    model.load_state_dict(checkpoint['model'])
    return model, checkpoint


def checkpoint_step(checkpoint: Dict[str, Any]) -> int:
    """Training step stored in a checkpoint's ``step`` buffer."""
    return int(checkpoint['model']['step'].reshape(-1)[0])


def tree_to(tree: Any, device: Union[str, torch.device]) -> Any:
    """Every tensor of a nested dict, detached, on ``device``."""
    if torch.is_tensor(tree):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree


def save_checkpoint(path: Union[str, Path], model: torch.nn.Module,
                    config: Dict[str, Any], step: int,
                    opt_state: Optional[Dict[str, Any]] = None,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a reference-format ``.pt`` atomically (a crash never leaves
    half a ``latest_model.pt``), with the model's ``step`` buffer set to
    ``step``."""
    with torch.no_grad():
        model.step.fill_(int(step))
    checkpoint = {'model': tree_to(model.state_dict(), 'cpu'),
                  'config': config}
    if opt_state is not None:
        checkpoint['optim'] = tree_to(opt_state, 'cpu')
    checkpoint.update(meta or {})
    path = Path(path)
    tmp = path.with_suffix(path.suffix + '.tmp')
    torch.save(checkpoint, str(tmp))
    tmp.replace(path)


def restore_checkpoint(checkpoint_dir: Union[str, Path],
                       name: str = 'latest_model.pt'
                       ) -> Optional[Dict[str, Any]]:
    """``name`` from ``checkpoint_dir`` if it is there, else the ``.ckpt``
    of the same name (a run the JAX package began continues here), else
    None (the reference's implicit resume, utils/checkpoints.py:26-34)."""
    path = Path(checkpoint_dir) / name
    for candidate in (path, path.with_suffix('.ckpt')):
        if candidate.is_file():
            return load_checkpoint(candidate)
    return None
