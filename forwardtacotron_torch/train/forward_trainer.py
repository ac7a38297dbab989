"""Forward-model trainer: schedule sessions, the train step, eval and
checkpoints.

Port of forwardtacotron_tpu/train/forward_trainer.py (``ForwardTrainer``
and ``MultiForwardTrainer``; reference trainer/forward_trainer.py:35-231
and trainer/multi_forward_trainer.py:42-243), on one device or data
parallel over the ranks of a process group (``parallel.mesh``). The trainer
reads the section of the config's ``tts_model`` (ForwardTacotron,
FastPitch or a multispeaker model); a multispeaker model's loss adds the
pitch-condition cross-entropy, and its checkpoints carry the speaker
table. The train step
mirrors the JAX package's: with ``precision: bfloat16`` the float32 master
parameters and the batch's floats are cast to bf16 (``cast_floats``), the
model runs on the cast parameters through ``torch.func.functional_call``,
its outputs are cast back and the losses reduced in float32; the gradients
arrive in float32 through the cast, BatchNorm statistics stay float32, and
``rnn_mode('train')`` sends the eligible recurrences to the differentiable
kernels (``train.pallas_rnn: false`` keeps the per-step loops). There is no
``torch.autocast``: its per-op choices are not the JAX package's. Metrics
are read with a one-step lag, so the host reads step N-1's scalars while
step N runs.

Data parallel (one process per card, ``torchrun``): each rank loads its
length-balanced share of the training items (``shard_for_host``) and
steps on its own batches; a step is the single-process step on the
concatenation of the ranks' batches. Before each step the ranks pad their
batches to a common shape (the largest token and frame counts over the
ranks), since BatchNorm's statistics cover padding; the losses and
BatchNorm reduce over the ranks and the gradients are summed before the
clip (``parallel.mesh``). Every rank takes the same number of steps an
epoch, the smallest batch count over the ranks, so none waits alone in a
collective. Evaluation splits each validation batch over the ranks
(padded to a multiple of them, as the JAX package pads for its devices).
The logged metrics are global; only rank 0 prints, writes the log and
saves checkpoints.

The log goes through ``make_writer``, at the first write: TensorBoard's
``SummaryWriter`` when torch can import it, else ``metrics.csv``
(``CsvWriter``, which drops figures and audio). Every ``plot_every`` steps rank 0 writes the plots of
the JAX package's ``generate_plots``: ``plot_outputs`` computes their
arrays (the teacher-forced, ground-truth-aligned mel of the first
validation item, the free-running generation's mel and pitch, a
multispeaker model's generations for the configured speakers, Griffin-Lim
audio of both mels) and lets any error through; ``generate_plots`` hands
them to the writer and, as the reference does, never stops training for
an error. A plot leaves training as it was: the model's mode is restored
and the random number generators are forked around it.
"""

import contextlib
import sys
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from forwardtacotron_torch.data.dataset import (get_forward_dataloaders,
                                                pad_to)
from forwardtacotron_torch.models.registry import is_multispeaker
from forwardtacotron_torch.models.synthesis import TTSInference
from forwardtacotron_torch.ops.hopper.rnn_train import rnn_mode
from forwardtacotron_torch.parallel.mesh import (host_max, host_min, local,
                                                 pad_batch_to_devices,
                                                 process_count,
                                                 process_index, shard_batch,
                                                 sum_gradients, sum_metrics)
from forwardtacotron_torch.train.common import (Averager, StepTimer,
                                                TTSSession, cast_floats,
                                                classification_accuracy,
                                                masked_cross_entropy,
                                                masked_l1)
from forwardtacotron_torch.train.state import (TrainState, create_train_state,
                                               make_optimizer,
                                               set_learning_rate)
from forwardtacotron_torch.utils.checkpoints import save_checkpoint
from forwardtacotron_torch.utils.device import resolve_device
from forwardtacotron_torch.utils.display import (ignore_exception,
                                                 plot_attention, plot_mel,
                                                 plot_pitch)
from forwardtacotron_torch.utils.files import parse_schedule, unpickle_binary
from forwardtacotron_torch.utils.paths import Paths

# the dropout and zoneout streams of rank r start from seed + r * this
RANK_SEED_STRIDE = 1000003
# what the forward models and their losses read of a collated batch
BATCH_KEYS = ('x', 'mel', 'dur', 'mel_len', 'x_len', 'pitch', 'energy',
              'pitch_target', 'energy_target', 'pitch_cond', 'speaker_emb')


class CsvWriter:
    """Scalars appended to ``metrics.csv`` as ``step,tag,value`` lines, by
    rank 0 alone; figures and audio are dropped."""

    def __init__(self, log_dir) -> None:
        self._path = log_dir / 'metrics.csv'

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if process_index() != 0:
            return
        with open(self._path, 'a') as f:
            f.write(f'{step},{tag},{float(value)}\n')

    def add_figure(self, *args, **kwargs) -> None:
        pass

    def add_audio(self, *args, **kwargs) -> None:
        pass


def make_writer(log_dir):
    """TensorBoard's ``SummaryWriter`` on rank 0 when torch can import it,
    else the CSV writer (the JAX package's ``make_writer``); other ranks
    write nothing."""
    if process_index() == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:     # no tensorboard package
            pass
        else:
            return SummaryWriter(log_dir=str(log_dir))
    return CsvWriter(log_dir)


class LazyWriter:
    """A trainer's ``writer``: ``make_writer(self.log_dir)`` at its first
    use, so a trainer that never logs (the GTA export, a step alone)
    imports no TensorBoard and writes no file."""

    _writer = None

    @property
    def writer(self):
        if self._writer is None:
            self._writer = make_writer(self.log_dir)
        return self._writer


PLOTTERS = {'mel': plot_mel, 'pitch': plot_pitch,
            'attention': plot_attention}


def write_plots(writer, arrays: Dict[str, Dict[str, np.ndarray]], step: int,
                sample_rate: Optional[int]) -> None:
    """A trainer's ``plot_outputs`` ({kind: {tag: array}}, kinds 'mel',
    'pitch', 'attention' and 'audio') as the writer's figures and audio;
    nothing for the CSV writer, which drops them (so no figure is drawn
    where matplotlib is missing)."""
    if isinstance(writer, CsvWriter):
        return
    for kind, plot in PLOTTERS.items():
        for tag, arr in arrays.get(kind, {}).items():
            writer.add_figure(tag, plot(arr), step)
    for tag, wav in arrays.get('audio', {}).items():
        writer.add_audio(tag, torch.tensor(wav)[None, :], step,
                         sample_rate=sample_rate)


@contextlib.contextmanager
def plotting(model: torch.nn.Module, device: torch.device):
    """The model in eval mode without autograd for a plot, with the random
    number generators of the CPU and of ``device`` forked and the model's
    mode restored after it: training goes on as if no plot were made.
    Only rank 0 plots, so the block runs ``local()``: its forward issues
    no collective that the other ranks would have to match."""
    was_training = model.training
    with torch.random.fork_rng(
            devices=[device] if device.type == 'cuda' else []), \
            torch.no_grad(), local():
        try:
            yield model.eval()
        finally:
            model.train(was_training)


def common_shape(batch: Dict[str, Any]) -> Dict[str, Any]:
    """``batch`` padded to the largest token and frame counts over the
    ranks (unchanged in one process)."""
    n_tok, n_frames = host_max([batch['x'].shape[1], batch['mel'].shape[1]])
    if (n_tok, n_frames) == (batch['x'].shape[1], batch['mel'].shape[1]):
        return batch
    return pad_to(batch, n_tok, n_frames)


def steps_per_epoch(train_set) -> int:
    """The batches every rank takes an epoch: the fewest over the ranks."""
    return host_min([len(train_set)])[0]


class ForwardTrainer(LazyWriter):

    def __init__(self, paths: Paths, dsp, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.paths = paths
        self.dsp = dsp
        self.config = config
        self.device = resolve_device(device)
        self.model_type = config.get('tts_model', 'forward_tacotron')
        self.train_cfg = config[self.model_type]['training']
        self.multispeaker = is_multispeaker(config)
        self.log_dir = paths.forward_log
        # extra top-level entries of every checkpoint (the speaker table)
        self.checkpoint_meta: Dict[str, Any] = {}
        first_lr = parse_schedule(self.train_cfg['schedule'])[0][0]
        self.tx = make_optimizer(first_lr,
                                 self.train_cfg.get('clip_grad_norm', 1.0))
        self.loss_fn, self.train_step = self._build_train_step()

    # --------------------------------------------------------------- training

    def train(self, model: torch.nn.Module,
              state: Optional[TrainState] = None,
              seed: int = 0) -> TrainState:
        """Run every schedule row the state has not finished; ``model``
        moves to the trainer's device."""
        model.to(self.device)
        if state is None:
            state = create_train_state(model, self.tx, step=0)
        for i, (lr, max_step, bs) in enumerate(
                parse_schedule(self.train_cfg['schedule']), 1):
            if state.step >= max_step:
                continue
            train_set, val_set = get_forward_dataloaders(
                paths=self.paths, batch_size=bs,
                bucket_multiple=self.train_cfg.get('bucket_multiple', 32),
                process_index=process_index(),
                process_count=process_count(), **self.train_cfg['filter'])
            session = TTSSession(index=i, r=1, lr=lr, max_step=max_step,
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
        rank = process_index()
        show = rank == 0
        if show:
            print(f'| Steps: {training_steps // 1000}k | Batch Size: '
                  f'{session.bs} | Learning Rate: {session.lr} | Device: '
                  f'{self.device} | Ranks: {process_count()} |')
        state = set_learning_rate(state, session.lr)
        # dropout draws from torch's generator (the JAX package's
        # jax.random bits cannot be reproduced), each rank its own stream
        torch.manual_seed(seed + current_step + RANK_SEED_STRIDE * rank)
        m_loss_avg, dur_loss_avg, pitch_loss_avg = (Averager(), Averager(),
                                                    Averager())
        timer = StepTimer()
        rs = np.random.RandomState(seed + RANK_SEED_STRIDE * rank)
        pitch_zoneout = self.train_cfg.get('pitch_zoneout', 0.0)
        energy_zoneout = self.train_cfg.get('energy_zoneout', 0.0)

        # metrics are read with a one-step lag: reading step N's scalars
        # waits for the step, so step N-1's are read while N runs
        step = current_step
        pending = None

        def flush(p):
            p_step, m, p_e, p_i = p
            m = {k: float(v) for k, v in m.items()}
            m_loss_avg.add(m['m1_loss'] + m['m2_loss'])
            dur_loss_avg.add(m['dur_loss'])
            pitch_loss_avg.add(m['pitch_loss'])
            if show:
                sys.stdout.write(
                    f'\r| Epoch: {p_e}/{epochs} ({p_i}/{total_iters}) '
                    f'| Mel Loss: {m_loss_avg.get():#.4} '
                    f'| Dur Loss: {dur_loss_avg.get():#.4} '
                    f'| Pitch Loss: {pitch_loss_avg.get():#.4} '
                    f'| {timer.steps_per_second():#.2} steps/s '
                    f'| Step: {p_step // 1000}k | ')
                sys.stdout.flush()
            for tag, val in (('Mel_Loss/train', m_loss_avg.get()),
                             ('Pitch_Loss/train', m['pitch_loss']),
                             ('Energy_Loss/train', m['energy_loss']),
                             ('Duration_Loss/train', m['dur_loss']),
                             ('Params/batch_size', session.bs),
                             ('Params/learning_rate', session.lr)):
                self.writer.add_scalar(tag, val, p_step)
            if 'pitch_cond_loss' in m:
                self.writer.add_scalar('Pitch_Cond_Loss/train',
                                       m['pitch_cond_loss'], p_step)

        for e in range(1, epochs + 1):
            for i, batch in enumerate(session.train_set, 1):
                if i > total_iters:
                    break
                batch = common_shape(dict(batch))
                # zoneout: mask the conditioning inputs, keep clean loss
                # targets (reference trainer/forward_trainer.py:73-79)
                batch['pitch_target'] = batch['pitch'].copy()
                batch['energy_target'] = batch['energy'].copy()
                if pitch_zoneout > 0:
                    mask = rs.rand(*batch['pitch'].shape) > pitch_zoneout
                    batch['pitch'] = batch['pitch'] * mask
                if energy_zoneout > 0:
                    mask = rs.rand(*batch['energy'].shape) > energy_zoneout
                    batch['energy'] = batch['energy'] * mask

                metrics = self.train_step(state, self.device_batch(batch))
                step += 1
                if pending is not None:
                    flush(pending)
                pending = (step, metrics, e, i)
                timer.tick()

                if step % self.train_cfg['checkpoint_every'] == 0:
                    self._save(state, f'forward_step{step // 1000}k.pt')
                if step % self.train_cfg['plot_every'] == 0 and show:
                    self.generate_plots(state, session)
                if step >= session.max_step:
                    break

            if pending is not None:
                flush(pending)
                pending = None
            for tag, val in self.evaluate(state.model,
                                          session.val_set).items():
                self.writer.add_scalar(f'{tag}/val', val, state.step)
            self._save(state, 'latest_model.pt')
            m_loss_avg.reset()
            pitch_loss_avg.reset()
            timer.reset()
            if show:
                print(' ')
            if state.step >= session.max_step:
                break
        return state

    # ------------------------------------------------------------------ steps

    def _build_train_step(self):
        """(loss_fn, train_step): loss_fn(model, params, batch) -> (loss,
        metrics, outputs) runs the model on ``params`` (cast to bf16 in
        mixed precision); train_step(state, batch) takes one optimizer
        step, updates ``state`` in place and returns the step's metrics as
        device scalars. Data parallel, ``loss_fn`` gives this rank's share
        of the global losses; train_step sums the gradients and the
        metrics over the ranks, so every rank takes the same update."""
        dur_w = self.train_cfg['dur_loss_factor']
        pitch_w = self.train_cfg['pitch_loss_factor']
        energy_w = self.train_cfg['energy_loss_factor']
        cond_w = self.train_cfg.get('pitch_cond_loss_factor', 0.1)
        multispeaker = self.multispeaker
        mp = self.train_cfg.get('precision', 'float32') == 'bfloat16'
        mode = 'train' if mp and self.train_cfg.get('pallas_rnn', True) \
            else 'off'
        tx = self.tx

        def loss_fn(model, params, batch):
            apply_params = cast_floats(params, torch.bfloat16) if mp \
                else params
            apply_batch = cast_floats(batch, torch.bfloat16) if mp else batch
            with rnn_mode(mode):
                out = torch.func.functional_call(model, apply_params,
                                                 (apply_batch,))
            if mp:  # losses and their targets reduce in float32
                out = cast_floats(out, torch.float32)
            m1 = masked_l1(out['mel'], batch['mel'], batch['mel_len'])
            m2 = masked_l1(out['mel_post'], batch['mel'], batch['mel_len'])
            dur_loss = masked_l1(out['dur'], batch['dur'], batch['x_len'])
            pitch_loss = masked_l1(out['pitch'], batch['pitch_target'],
                                   batch['x_len'])
            energy_loss = masked_l1(out['energy'], batch['energy_target'],
                                    batch['x_len'])
            loss = (m1 + m2 + dur_w * dur_loss + pitch_w * pitch_loss
                    + energy_w * energy_loss)
            metrics = {'m1_loss': m1, 'm2_loss': m2, 'dur_loss': dur_loss,
                       'pitch_loss': pitch_loss, 'energy_loss': energy_loss}
            if multispeaker:
                ce = masked_cross_entropy(out['pitch_cond'],
                                          batch['pitch_cond'])
                loss = loss + cond_w * ce
                metrics['pitch_cond_loss'] = ce
                metrics['pitch_cond_acc'] = classification_accuracy(
                    out['pitch_cond'], batch['pitch_cond'])
            metrics['loss'] = loss
            return loss, metrics, out

        def train_step(state: TrainState,
                       batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
            params = state.params()
            loss, metrics, _ = loss_fn(state.model.train(), params, batch)
            grads = sum_gradients(torch.autograd.grad(
                loss, list(params.values()), allow_unused=True))
            metrics = sum_metrics({k: v.detach() for k, v in metrics.items()})
            metrics['grad_norm'] = tx.step(params, dict(zip(params, grads)),
                                           state.opt_state)
            state.step += 1
            return metrics

        return loss_fn, train_step

    @torch.no_grad()
    def eval_step(self, model: torch.nn.Module,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = model.eval()(batch)
        return {
            'Mel_Loss': masked_l1(out['mel'], batch['mel'], batch['mel_len'])
            + masked_l1(out['mel_post'], batch['mel'], batch['mel_len']),
            'Duration_Loss': masked_l1(out['dur'], batch['dur'],
                                       batch['x_len']),
            'Pitch_Loss': masked_l1(out['pitch'], batch['pitch'],
                                    batch['x_len']),
            'Energy_Loss': masked_l1(out['energy'], batch['energy'],
                                     batch['x_len'])}

    def evaluate(self, model: torch.nn.Module, val_set) -> Dict[str, float]:
        """The mean over the validation batches of each eval loss; each
        batch is split over the ranks (the JAX package's padded, sharded
        batch)."""
        sums: Dict[str, float] = {}
        n = 0
        n_ranks = process_count()
        for batch in val_set:
            batch = dict(batch)
            batch['pitch_target'] = batch['pitch']
            batch['energy_target'] = batch['energy']
            batch = pad_batch_to_devices(
                {k: batch[k] for k in BATCH_KEYS if k in batch},
                range(n_ranks))
            metrics = sum_metrics(self.eval_step(
                model, shard_batch(batch, self.device)))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    # ------------------------------------------------------------- artifacts

    def plot_sample(self, session: TTSSession) -> Dict[str, Any]:
        """The first item of the session's first validation batch."""
        sample = {k: v[:1] if isinstance(v, np.ndarray) else v
                  for k, v in session.val_sample.items()}
        sample['pitch_target'] = sample['pitch']
        sample['energy_target'] = sample['energy']
        return sample

    def plot_outputs(self, state: TrainState, session: TTSSession
                     ) -> Dict[str, Dict[str, np.ndarray]]:
        """The arrays of the JAX package's ``generate_plots`` at this step,
        {kind: {tag: array}}: the ground-truth-aligned (teacher-forced,
        eval mode) mel of the first validation item beside its target,
        the free-running ``generate_cropped`` mel and pitch of its tokens
        (padding included, as the JAX package passes them) in float32,
        and Griffin-Lim audio of both mels when the trainer has a DSP.
        Errors go through."""
        sample = self.plot_sample(session)
        mel_len = int(sample['mel_len'][0])
        with plotting(state.model, self.device) as model:
            out = model(self.device_batch(sample))
            gta = out['mel_post'][0, :mel_len].T.float().cpu().numpy()
            kwargs = {}
            if self.multispeaker:
                kwargs['speaker_emb'] = sample['speaker_emb'][:1]
            gen = TTSInference(model, device=self.device).generate_cropped(
                sample['x'][0], **kwargs)
            arrays = {'mel': {'Ground_Truth_Aligned/generated': gta,
                              'Ground_Truth_Aligned/target':
                                  np.asarray(sample['mel'])[0, :mel_len].T,
                              'Generated/mel': gen['mel_post']},
                      'pitch': {'Generated/pitch': gen['pitch']}}
            if self.dsp is not None:
                arrays['audio'] = {
                    'Ground_Truth_Aligned/audio': self.dsp.griffinlim(gta),
                    'Generated/audio': self.dsp.griffinlim(gen['mel_post'])}
        return arrays

    @ignore_exception
    def generate_plots(self, state: TrainState, session: TTSSession) -> None:
        """``plot_outputs`` to the writer; an error is printed and
        training goes on (reference utils/decorators.py:6-15)."""
        write_plots(self.writer, self.plot_outputs(state, session),
                    state.step, getattr(self.dsp, 'sample_rate', None))

    def _save(self, state: TrainState, name: str) -> None:
        if process_index() != 0:
            return
        save_checkpoint(self.paths.forward_checkpoints / name, state.model,
                        self.config, step=state.step,
                        opt_state=state.opt_state,
                        meta=self.checkpoint_meta or None)


class MultiForwardTrainer(ForwardTrainer):
    """The multispeaker trainer (the JAX package's ``MultiForwardTrainer``,
    reference trainer/multi_forward_trainer.py:35-40,116-119): reads the
    speaker table and each speaker's mean embedding
    (``mean_speaker_emb/<speaker>.npy``) and writes them into every
    checkpoint as its top-level ``speaker_embeddings``, where
    ``gen_forward --speaker`` finds them. Its plots add a generation of the
    first validation item's tokens in the voice of each speaker of
    ``plot_speakers`` (reference trainer/multi_forward_trainer.py:
    217-243)."""

    def __init__(self, paths: Paths, dsp, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__(paths, dsp, config, device)
        try:
            speaker_dict = unpickle_binary(paths.speaker_dict)
        except FileNotFoundError:
            return
        embeddings = {}
        for speaker in sorted(set(speaker_dict.values())):
            emb_path = paths.mean_speaker_emb / f'{speaker}.npy'
            if emb_path.is_file():
                embeddings[speaker] = np.load(str(emb_path))
        self.checkpoint_meta = {'speaker_embeddings': embeddings}

    def plot_speakers(self) -> list:
        """The speakers of the plots, as the JAX package picks them: the
        training section's ``plot_speakers`` that the table holds, then
        the table's others while its stopping test lets them in (it
        compares the list with itself, so with ``plot_n_speakers`` > 0
        every speaker of the table)."""
        embeddings = self.checkpoint_meta.get('speaker_embeddings', {})
        wanted = list(self.train_cfg.get('plot_speakers', []))
        n_extra = int(self.train_cfg.get('plot_n_speakers', 0))
        for speaker in embeddings:
            if len(wanted) >= len(set(wanted)) + n_extra:
                break
            if speaker not in wanted:
                wanted.append(speaker)
        return [s for s in wanted if s in embeddings]

    def plot_outputs(self, state: TrainState, session: TTSSession
                     ) -> Dict[str, Dict[str, np.ndarray]]:
        arrays = super().plot_outputs(state, session)
        embeddings = self.checkpoint_meta.get('speaker_embeddings', {})
        x = self.plot_sample(session)['x'][0]
        with plotting(state.model, self.device) as model:
            inference = TTSInference(model, device=self.device)
            for speaker in self.plot_speakers():
                arrays['mel'][f'Generated_Speakers/{speaker}'] = \
                    inference.generate_cropped(
                        x, speaker_emb=np.asarray(embeddings[speaker]))[
                            'mel_post']
        return arrays
