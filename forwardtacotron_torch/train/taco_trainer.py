"""Tacotron teacher trainer: schedule sessions, the train step, eval and
checkpoints.

Port of forwardtacotron_tpu/train/taco_trainer.py (reference
trainer/taco_trainer.py:34-187), on one device or data parallel over the
ranks of a process group as ``ForwardTrainer`` is (its module docstring
gives the rules; the plain L1 means are taken over the global batch,
``parallel.mesh.global_mean``). Each schedule row (r, lr,
max_step, batch size) is a session with its own loaders, whose mels are
padded to a multiple of its reduction factor r. The loss is the plain
(unmasked) L1 of the decoder's mel and of the postnet's output against the
target mel, summed (reference :76-78); Adam with global-norm clipping
(``train.state``). With ``precision: bfloat16`` the float32 master
parameters and the batch's floats are cast to bf16, the model runs on the
cast parameters through ``torch.func.functional_call``, and its outputs
are cast back so that the loss reduces in float32, as the JAX step does
(its decoder computes in float32 either way: ``models.tacotron``). The
PreNets' dropout and the zoneout draw from a ``torch.Generator`` on the
trainer's device seeded with ``seed`` + the session's first step; the
CBHGs' dropout from torch's default generator, seeded the same. The
attention's location and sharpness scores (``utils.metrics``) are written
with the losses, read with a one-step lag so that the host reads step
N-1's while step N runs. The log goes through ``make_writer`` at the
first write (TensorBoard, else ``metrics.csv``); every ``plot_every`` steps (default
1000) rank 0 writes the plots of the JAX package's ``generate_plots``
(``plot_outputs``: the teacher-forced eval forward of the first validation
item at the session's r, its attention, mel and target, Griffin-Lim audio
of its postnet output), as ``ForwardTrainer`` does.
"""

import sys
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from forwardtacotron_torch.data.dataset import get_taco_dataloaders
from forwardtacotron_torch.train.common import (Averager, StepTimer,
                                                TTSSession, cast_floats)
from forwardtacotron_torch.parallel.mesh import (global_mean, host_sum,
                                                 pad_batch_to_devices,
                                                 process_count,
                                                 process_index, shard_batch,
                                                 sum_gradients, sum_metrics)
from forwardtacotron_torch.train.forward_trainer import (RANK_SEED_STRIDE,
                                                         LazyWriter,
                                                         common_shape,
                                                         plotting,
                                                         steps_per_epoch,
                                                         write_plots)
from forwardtacotron_torch.train.state import (TrainState, create_train_state,
                                               make_optimizer,
                                               set_learning_rate)
from forwardtacotron_torch.utils.checkpoints import save_checkpoint
from forwardtacotron_torch.utils.device import resolve_device
from forwardtacotron_torch.utils.display import ignore_exception
from forwardtacotron_torch.utils.files import parse_schedule
from forwardtacotron_torch.utils.metrics import attention_score
from forwardtacotron_torch.utils.paths import Paths

# what the teacher and its losses read of a collated batch
BATCH_KEYS = ('x', 'mel', 'mel_len', 'x_len', 'speaker_emb')


def l1_losses(mel_out: torch.Tensor, linear: torch.Tensor,
              target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m1, m2): mean |mel_out - target| and mean |linear - target| over
    every element, padding included (the reference's plain L1); data
    parallel, this rank's shares of the global batch's means."""
    return (global_mean(torch.abs(mel_out - target)),
            global_mean(torch.abs(linear - target)))


class TacoTrainer(LazyWriter):

    def __init__(self, paths: Paths, dsp, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.paths = paths
        self.dsp = dsp
        self.config = config
        self.device = resolve_device(device)
        self.train_cfg = config['tacotron']['training']
        self.mixed_precision = \
            self.train_cfg.get('precision', 'float32') == 'bfloat16'
        self.log_dir = paths.taco_log
        first_lr = parse_schedule(self.train_cfg['schedule'])[0][1]
        self.tx = make_optimizer(first_lr,
                                 self.train_cfg.get('clip_grad_norm', 1.0))

    # --------------------------------------------------------------- training

    def train(self, model: torch.nn.Module,
              state: Optional[TrainState] = None,
              seed: int = 0) -> TrainState:
        """Run every schedule row the state has not finished; ``model``
        moves to the trainer's device."""
        model.to(self.device)
        if state is None:
            state = create_train_state(model, self.tx, step=0)
        for i, (r, lr, max_step, bs) in enumerate(
                parse_schedule(self.train_cfg['schedule']), 1):
            if state.step >= max_step:
                continue
            train_set, val_set = get_taco_dataloaders(
                paths=self.paths, batch_size=bs, r=r,
                bucket_multiple=self.train_cfg.get('bucket_multiple', 1) * r,
                process_index=process_index(),
                process_count=process_count(), **self.train_cfg['filter'])
            session = TTSSession(index=i, r=r, lr=lr, max_step=max_step,
                                 bs=bs, train_set=train_set, val_set=val_set)
            state = self.train_session(state, session, seed)
        return state

    def device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in BATCH_KEYS if k in batch}

    def train_session(self, state: TrainState, session: TTSSession,
                      seed: int = 0) -> TrainState:
        current_step = state.step
        training_steps = session.max_step - current_step
        total_iters = steps_per_epoch(session.train_set)
        epochs = training_steps // max(total_iters, 1) + 1
        show = process_index() == 0
        if show:
            print(f'| Steps: {training_steps // 1000}k | Batch Size: '
                  f'{session.bs} | Learning Rate: {session.lr} | Outputs/Step '
                  f'(r): {session.r} | Device: {self.device} | Ranks: '
                  f'{process_count()} |')
        state = set_learning_rate(state, session.lr)
        with torch.no_grad():
            state.model.decoder.r.fill_(session.r)
        # each rank draws its own dropout and zoneout
        rank_seed = seed + current_step + RANK_SEED_STRIDE * process_index()
        torch.manual_seed(rank_seed)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(rank_seed)
        loss_avg, timer = Averager(), StepTimer()

        # metrics are read with a one-step lag: reading step N's scalars
        # waits for the step, so step N-1's are read while N runs
        step = current_step
        pending = None

        def flush(p):
            p_step, m, attn, mel_len, p_e, p_i = p
            loss = float(m['loss'])
            loss_avg.add(loss)
            loc_score, sharp_score = attention_score(
                attn.float().cpu().numpy(), mel_len, r=session.r)
            # the scores' means over the global batch
            loc_sum, sharp_sum, n_items = host_sum(
                [loc_score.sum(), sharp_score.sum(), len(loc_score)])
            for tag, val in (('Attention_Score/loc', loc_sum / n_items),
                             ('Attention_Score/sharpness',
                              sharp_sum / n_items),
                             ('Loss/train', loss),
                             ('Params/batch_size', session.bs),
                             ('Params/reduction_factor', session.r),
                             ('Params/learning_rate', session.lr)):
                self.writer.add_scalar(tag, val, p_step)
            if show:
                sys.stdout.write(
                    f'\r| Epoch: {p_e}/{epochs} ({p_i}/{total_iters}) '
                    f'| Loss: {loss_avg.get():#.4} '
                    f'| {timer.steps_per_second():#.2} steps/s '
                    f'| Step: {p_step // 1000}k | ')
                sys.stdout.flush()

        for e in range(1, epochs + 1):
            for i, batch in enumerate(session.train_set, 1):
                if i > total_iters:
                    break
                batch = common_shape(batch)
                metrics, attn = self.train_step(
                    state, self.device_batch(batch), session.r, generator)
                step += 1
                if pending is not None:
                    flush(pending)
                pending = (step, metrics, attn, batch['mel_len'], e, i)
                timer.tick()

                if step % self.train_cfg.get('plot_every', 1000) == 0 \
                        and show:
                    self.generate_plots(state, session)
                if step % self.train_cfg['checkpoint_every'] == 0:
                    self._save(state, f'taco_step{step // 1000}k.pt')
                if step >= session.max_step:
                    break

            if pending is not None:
                flush(pending)
                pending = None
            val_loss = self.evaluate(state.model, session.val_set, session.r)
            self.writer.add_scalar('Loss/val', val_loss, state.step)
            self._save(state, 'latest_model.pt')
            loss_avg.reset()
            timer.reset()
            if show:
                print(' ')
            if state.step >= session.max_step:
                break
        return state

    # ------------------------------------------------------------------ steps

    def loss_fn(self, model: torch.nn.Module,
                params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], r: int,
                generator: Optional[torch.Generator] = None):
        """(loss, metrics, attention): the teacher-forced forward on
        ``params`` (cast to bf16 in mixed precision) in the module's mode,
        the outputs back in float32, m1 + m2 against the float32 mel."""
        mp = self.mixed_precision
        apply_params = cast_floats(params, torch.bfloat16) if mp else params
        apply_batch = cast_floats(batch, torch.bfloat16) if mp else batch
        mel_out, linear, attn = torch.func.functional_call(
            model, apply_params, (apply_batch, r), {'generator': generator})
        mel_out, linear, attn = (a.float() for a in (mel_out, linear, attn))
        m1, m2 = l1_losses(mel_out, linear, batch['mel'])
        loss = m1 + m2
        return loss, {'loss': loss, 'm1': m1, 'm2': m2}, attn

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   r: int, generator: Optional[torch.Generator] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One optimizer step; updates ``state`` in place and returns the
        step's metrics (device scalars, with the global gradient norm
        before clipping) and its attention [B, T // r, N]. Data parallel,
        the gradients and the metrics are summed over the ranks (each
        rank's loss is its share of the global loss)."""
        params = state.params()
        loss, metrics, attn = self.loss_fn(state.model.train(), params,
                                           batch, r, generator)
        grads = sum_gradients(torch.autograd.grad(
            loss, list(params.values()), allow_unused=True))
        metrics = sum_metrics({k: v.detach() for k, v in metrics.items()})
        metrics['grad_norm'] = self.tx.step(params, dict(zip(params, grads)),
                                            state.opt_state)
        state.step += 1
        return metrics, attn.detach()

    @torch.no_grad()
    def eval_loss(self, model: torch.nn.Module,
                  batch: Dict[str, torch.Tensor], r: int) -> torch.Tensor:
        """m1 + m2 of the float32 model in eval mode (the JAX package
        evaluates with the master variables in either precision)."""
        mel_out, linear, _ = model.eval()(batch, r)
        m1, m2 = l1_losses(mel_out, linear, batch['mel'])
        return m1 + m2

    def evaluate(self, model: torch.nn.Module, val_set, r: int) -> float:
        """The mean eval loss over the validation batches whose frames are
        a multiple of r; each batch is split over the ranks (the JAX
        package's padded, sharded batch)."""
        total, n = 0.0, 0
        for batch in val_set:
            if batch['mel'].shape[1] % r != 0:
                continue
            batch = pad_batch_to_devices(
                {k: batch[k] for k in BATCH_KEYS if k in batch},
                range(process_count()))
            total += float(sum_metrics({'loss': self.eval_loss(
                model, shard_batch(batch, self.device), r)})['loss'])
            n += 1
        return total / max(n, 1)

    # ------------------------------------------------------------- artifacts

    def plot_outputs(self, state: TrainState, session: TTSSession
                     ) -> Dict[str, Dict[str, np.ndarray]]:
        """The arrays of the JAX package's ``generate_plots`` at this step,
        {kind: {tag: array}}: the teacher-forced eval forward of the first
        validation item at the session's r, its attention [mel_len // r,
        N], mel and target [n_mels, mel_len], and Griffin-Lim audio of its
        postnet output when the trainer has a DSP. Errors go through."""
        sample = {k: v[:1] if isinstance(v, np.ndarray) else v
                  for k, v in session.val_sample.items()}
        mel_len = int(sample['mel_len'][0])
        with plotting(state.model, self.device) as model:
            mel_out, linear, attn = (
                a[0].float().cpu().numpy()
                for a in model(self.device_batch(sample), session.r))
            arrays = {'attention': {'Attention/teacher_forced':
                                    attn[:mel_len // session.r]},
                      'mel': {'Mel/teacher_forced': mel_out[:mel_len].T,
                              'Mel/target':
                                  np.asarray(sample['mel'])[0, :mel_len].T}}
            if self.dsp is not None:
                arrays['audio'] = {'Generated/teacher_forced_audio':
                                   self.dsp.griffinlim(linear[:mel_len].T)}
        return arrays

    @ignore_exception
    def generate_plots(self, state: TrainState, session: TTSSession) -> None:
        """``plot_outputs`` to the writer; an error is printed and
        training goes on."""
        write_plots(self.writer, self.plot_outputs(state, session),
                    state.step, getattr(self.dsp, 'sample_rate', None))

    def _save(self, state: TrainState, name: str) -> None:
        if process_index() != 0:
            return
        save_checkpoint(self.paths.taco_checkpoints / name, state.model,
                        self.config, step=state.step,
                        opt_state=state.opt_state)
