"""The port's training forward against the JAX package's, on one narrow
model with the same variables and batch (tests/torch_training_setup.py):
the teacher-forced forward in training mode (batch statistics, dropout 0)
gives the same outputs, the five losses, every parameter gradient and the
updated BatchNorm statistics as ``model.apply(train=True,
mutable=['batch_stats'])`` and ``jax.grad``; and the port's weights carry to
the JAX variables and back (``utils/convert.py``).

The recurrences are 128 wide (the prenet, pitch and postnet GRUs and the
bi-LSTM), so in bfloat16 both packages route them to their trainable
kernels: the JAX package's Pallas kernels in interpret mode, the port's
twins. Tolerances: float32, outputs, losses and gradients 1e-4 of each
tensor's scale max(1, max |JAX|) (max(1e-3, max |JAX|) for gradients;
other summation orders through the whole model). The batch is one on which
no ReLU pre-activation lies within float32 rounding of zero: there the two
packages may take either branch, and a single flipped unit moves every
gradient upstream of it by up to a few percent.

bfloat16: outputs, losses and BatchNorm statistics within 5e-2 of the scale
(the JAX package's bf16 tolerance). Each layer rounds where the JAX layer
does (Dense and Conv round the product before adding the bias, as flax
does): given the same bf16 input and cotangent, every layer's output and
gradients match the JAX layer's within 3e-2 relative L2
(``test_bf16_layers_match_jax``; measured at most 1.5e-2). The highway's
output and the bias gradients differ most: XLA on the CPU expands a bf16
sigmoid into bf16 steps where torch rounds once, and its bias gradients lie
about four times further from the float32 ones than the port's. Through the
whole model these differences compound, most where a BatchNorm's backward
subtracts means: the two packages' bf16 gradients differ by up to 20% per
tensor, and each is up to 60% away from the float32 gradient in the
postnet's conv bank. So each package's bf16 gradients are held to the
float32 gradients (the port's, which match the JAX package's to 1e-4): per
tensor the port's error may be at most 1.5 times the JAX package's plus
1e-2, over all parameters 1.25 times; and the three series predictors,
which the backward reaches through few layers (the pitch GRU through the
trainable kernels' twins), within 3e-2 of the JAX gradients per tensor.
"""

import copy

import numpy as np
import pytest
import torch

from forwardtacotron_torch.models.layers import conv1d
from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
from forwardtacotron_torch.utils.convert import from_jax_variables

from torch_training_setup import (  # noqa: F401 (jax_kernels: a fixture)
    LOSSES, both_models, jax_kernels, make_batch, narrow_config, paths_of,
    scaled_close)


@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
def test_train_forward_and_gradients_match_jax(jax_kernels, tmp_path,
                                               precision):
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.rnn import pallas_rnns
    from forwardtacotron_tpu.train.common import \
        cast_floats as jax_cast_floats
    from forwardtacotron_tpu.train.common import masked_l1 as jax_masked_l1

    config = narrow_config(precision, tmp_path)
    jmodel, variables, tmodel = both_models(config)
    batch = make_batch(seed=1)
    mp = precision == 'bfloat16'
    f32_tol = 5e-2 if mp else 1e-4
    # the float32 gradients the bf16 ones are held to (before any forward
    # moves the BatchNorm statistics of tmodel)
    model32 = copy.deepcopy(tmodel)
    w = config['forward_tacotron']['training']['dur_loss_factor']

    def jax_loss(params):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        apply_vars = {'params': jax_cast_floats(params, jnp.bfloat16)
                      if mp else params,
                      'batch_stats': variables['batch_stats']}
        apply_batch = jax_cast_floats(jb, jnp.bfloat16) if mp else jb
        with pallas_rnns('train' if mp else 'off'):
            out, mutated = jmodel.apply(
                apply_vars, apply_batch, train=True,
                rngs={'dropout': jax.random.PRNGKey(2)},
                mutable=['batch_stats'])
        out = jax_cast_floats(out, jnp.float32)
        losses = {
            'm1_loss': jax_masked_l1(out['mel'], jb['mel'], jb['mel_len']),
            'm2_loss': jax_masked_l1(out['mel_post'], jb['mel'],
                                     jb['mel_len']),
            'dur_loss': jax_masked_l1(out['dur'], jb['dur'], jb['x_len']),
            'pitch_loss': jax_masked_l1(out['pitch'], jb['pitch_target'],
                                        jb['x_len']),
            'energy_loss': jax_masked_l1(out['energy'], jb['energy_target'],
                                         jb['x_len'])}
        loss = (losses['m1_loss'] + losses['m2_loss']
                + w * (losses['dur_loss'] + losses['pitch_loss']
                       + losses['energy_loss']))
        return loss, (out, mutated, losses)

    params = jax.tree.map(jnp.asarray, variables['params'])
    grads, (ref_out, mutated, ref_losses) = jax.jit(jax.grad(
        jax_loss, has_aux=True))(params)

    trainer = ForwardTrainer(paths_of(config), None, config, device='cpu')
    tparams = dict(tmodel.named_parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, losses, out = trainer.loss_fn(tmodel.train(), tparams, tb)
    loss.backward()

    for key in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        scaled_close(out[key], ref_out[key], f32_tol, 1.0, key)
    for key in LOSSES:
        scaled_close(losses[key], ref_losses[key], f32_tol, 1.0, key)
    ref_grads = from_jax_variables({'params': grads})
    assert set(ref_grads) == set(tparams)
    if not mp:
        for name, p in tparams.items():
            scaled_close(p.grad, ref_grads[name], 1e-4, 1e-3, name)
    else:
        trainer32 = ForwardTrainer(paths_of(config), None,
                                   narrow_config('float32', tmp_path), 'cpu')
        params32 = dict(model32.named_parameters())
        trainer32.loss_fn(model32.train(), params32, tb)[0].backward()
        sq = np.zeros(3)
        for name, p in tparams.items():
            truth = params32[name].grad.numpy()
            ours = np.sum((p.grad.numpy() - truth) ** 2)
            theirs = np.sum((ref_grads[name].numpy() - truth) ** 2)
            norm = max(np.sum(truth ** 2), 1e-24)
            sq += (ours, theirs, np.sum(truth ** 2))
            assert np.sqrt(ours / norm) <= (1.5 * np.sqrt(theirs / norm)
                                            + 0.01), name
            if name.startswith(('dur_pred.', 'pitch_pred.', 'energy_pred.')):
                gap = p.grad.numpy() - ref_grads[name].numpy()
                assert np.sqrt(np.sum(gap ** 2) / norm) <= 3e-2, name
        assert np.sqrt(sq[0]) <= 1.25 * np.sqrt(sq[1]) + 0.01 * np.sqrt(sq[2])
    ref_stats = from_jax_variables({'batch_stats': mutated['batch_stats']})
    buffers = dict(tmodel.named_buffers())
    for name, want in ref_stats.items():
        if name.endswith(('running_mean', 'running_var')):
            scaled_close(buffers[name], want.numpy(), f32_tol, 1.0, name)


# (JAX method on the model, port module path, input shape, input scale)
BF16_LAYERS = {
    'highway': (lambda m, x: m.postnet.highways[1](x),
                'postnet.highways.1', (3, 32, 128), 1.0),
    'pre_highway': (lambda m, x: m.postnet.pre_highway(x),
                    'postnet.pre_highway', (3, 32, 16), 1.0),
    'bank_k1': (lambda m, x: m.postnet.conv1d_bank[0](x, train=True),
                'postnet.conv1d_bank.0', (3, 32, 16), 3.0),
    'bank_k4': (lambda m, x: m.postnet.conv1d_bank[3](x, train=True),
                'postnet.conv1d_bank.3', (3, 32, 16), 3.0),
    'proj1': (lambda m, x: m.postnet.conv_project1(x, train=True),
              'postnet.conv_project1', (3, 32, 512), 1.0),
    'proj2_linear': (lambda m, x: m.postnet.conv_project2(x, train=True),
                     'postnet.conv_project2', (3, 32, 128), 1.0),
    'mel_dense': (lambda m, x: m.lin(x), 'lin', (3, 32, 256), 1.0),
    'pitch_conv': (lambda m, x: m.pitch_proj(x), 'pitch_proj', (3, 16, 1),
                   1.0),
}


@pytest.mark.parametrize('layer', BF16_LAYERS)
def test_bf16_layers_match_jax(tmp_path, layer):
    """One layer of each kind in bf16 training mode, the same bf16 input and
    cotangent in both packages: the output and the gradients of the input
    and of every parameter within 3e-2 relative L2 of the JAX layer's."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.train.common import \
        cast_floats as jax_cast_floats

    method, path, shape, scale = BF16_LAYERS[layer]
    jmodel, variables, tmodel = both_models(narrow_config('bfloat16',
                                                          tmp_path))
    rs = np.random.RandomState(5)
    x = jnp.asarray(scale * rs.randn(*shape), jnp.bfloat16)

    def apply(params, x):
        return jmodel.apply({'params': params,
                             'batch_stats': variables['batch_stats']}, x,
                            method=method, mutable=['batch_stats'])[0]

    params = jax_cast_floats(variables['params'], jnp.bfloat16)
    y, vjp = jax.vjp(apply, params, x)
    ct = jnp.asarray(rs.randn(*y.shape), jnp.bfloat16)
    g_params, g_x = vjp(ct)
    want = {k[len(path) + 1:]: v for k, v in from_jax_variables(
        {'params': jax.tree.map(lambda a: a.astype(jnp.float32), g_params)}
    ).items() if k.startswith(path + '.')}

    mod = tmodel.get_submodule(path).to(torch.bfloat16).train()
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    out = conv1d(xt, mod) if layer == 'pitch_conv' else mod(xt)
    out.backward(torch.from_numpy(np.array(ct.astype(jnp.float32))).to(
        torch.bfloat16))
    got = {'out': out, 'x': xt.grad, **{n: p.grad for n, p in
                                        mod.named_parameters()}}
    want.update(out=y, x=g_x)
    assert set(got) == set(want)
    for name, g in got.items():
        g = g.detach().float().numpy()
        w = np.asarray(jnp.asarray(want[name], jnp.float32))
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 3e-2, f'{layer} {name}: {rel:.3e}'


def test_to_jax_variables_inverts_from_jax_variables(tmp_path):
    """The port's state_dict -> JAX variables, BatchNorm statistics
    included: the JAX tree the port's weights came from, exactly, and back
    again (``step`` and ``num_batches_tracked`` have no JAX counterpart)."""
    import jax

    from forwardtacotron_torch.utils.convert import to_jax_variables

    _, variables, tmodel = both_models(narrow_config('float32', tmp_path))
    got = to_jax_variables(tmodel.state_dict())
    want_leaves = jax.tree_util.tree_leaves_with_path(variables)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got_leaves) == len(want_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_array_equal(got_leaves[path], leaf, err_msg=str(path))
    back = from_jax_variables(got)
    for key, value in tmodel.state_dict().items():
        if key != 'step' and not key.endswith('num_batches_tracked'):
            assert torch.equal(back[key], value), key
