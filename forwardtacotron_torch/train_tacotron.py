"""CLI: train the Tacotron teacher on the GPU and extract the forward
models' training targets from it.

Mirrors the repository's root ``train_tacotron.py`` (reference
train_tacotron.py:146-196) on the PyTorch port, on one device or, for
training, data parallel with one process per card:

    python -m forwardtacotron_torch.train_tacotron \\
        --config configs/singlespeaker.yaml [--device cpu] \\
        [--force_align | --force_gta | --extract_pitch]
    torchrun --nproc_per_node 4 -m forwardtacotron_torch.train_tacotron \\
        --config configs/singlespeaker.yaml

Under ``torchrun`` the default mode trains data parallel
(``train.taco_trainer``), then rank 0 alone extracts while the other
ranks stop; the extraction modes (``--force_align``, ``--extract_pitch``,
``--force_gta``) train nothing and are refused there.

It resumes from ``latest_model.pt`` in the config's teacher checkpoint
directory, or from the JAX package's ``latest_model.ckpt`` when only that
is there (weights, BatchNorm statistics, optimizer state and step; r from
the schedule row at that step), else starts from seeded random weights.
The trainer's plots get Griffin-Lim audio from the config's DSP. Modes:

- default: run the config's ``tacotron`` schedule (reference-format ``.pt``
  checkpoints), then extract as ``--force_align`` does;
- ``--force_align``: no training; the teacher's attention for every item
  (``att_pred/``, on the device, batches of equal token length), the
  durations from it (``alg/``, a process pool of
  ``duration_extraction.num_workers``), ``duration_stats.pkl``, then the
  pitch and energy targets;
- ``--extract_pitch``: only the targets, ``phon_pitch/`` and
  ``phon_energy/``, from ``alg/``, ``mel/`` and ``raw_pitch/``;
- ``--force_gta``: ``<data>/gta/<id>.npy`` for every item, the postnet's
  mel [n_mels, mel_len] of the teacher-forced eval forward at r = 1.
"""

import argparse

import numpy as np


def export_gta(model, paths, config, device) -> int:
    """Write the GTA mel of every train and val item; returns the number
    written."""
    import torch

    from forwardtacotron_torch.data.dataset import get_taco_dataloaders

    train_set, val_set = get_taco_dataloaders(
        paths=paths, batch_size=8, r=1,
        **config['tacotron']['training']['filter'])
    model.to(device).eval()
    written = 0
    with torch.inference_mode():
        for loader in (train_set, val_set):
            for batch in loader:
                _, linear, _ = model(
                    {k: torch.as_tensor(batch[k], device=device)
                     for k in ('x', 'mel', 'speaker_emb')}, r=1)
                linear = linear.float().cpu().numpy()
                for j, item_id in enumerate(batch['item_id']):
                    mel_len = int(batch['mel_len'][j])
                    np.save(str(paths.gta / f'{item_id}.npy'),
                            linear[j, :mel_len].T, allow_pickle=False)
                    written += 1
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description='Train Tacotron teacher')
    parser.add_argument('--config', default='configs/singlespeaker.yaml')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--seed', type=int, default=0,
                        help='seeds the initial weights, the dropout and '
                             'the zoneout')
    parser.add_argument('--force_align', action='store_true')
    parser.add_argument('--force_gta', action='store_true')
    parser.add_argument('--extract_pitch', action='store_true')
    args = parser.parse_args(argv)

    import torch

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.tacotron import Tacotron
    from forwardtacotron_torch.parallel.mesh import (initialize_distributed,
                                                     process_count,
                                                     process_index,
                                                     rank_device, replicate)
    from forwardtacotron_torch.train.state import (create_train_state,
                                                   state_from_checkpoint)
    from forwardtacotron_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_torch.utils.checkpoints import restore_checkpoint
    from forwardtacotron_torch.utils.files import read_config
    from forwardtacotron_torch.utils.paths import Paths

    distributed = initialize_distributed(args.device)
    if process_count() > 1 and (args.force_align or args.force_gta
                                or args.extract_pitch):
        torch.distributed.destroy_process_group()
        parser.error('--force_align, --force_gta and --extract_pitch run in '
                     'one process: start them without torchrun')
    config = read_config(args.config)
    paths = Paths.from_config(config)
    torch.manual_seed(args.seed)
    model = Tacotron.from_config(config)
    device = rank_device(args.device)
    trainer = TacoTrainer(paths, DSP.from_config(config, device=device),
                          config, device=device)
    model.to(trainer.device)
    ckpt = restore_checkpoint(paths.taco_checkpoints)
    if ckpt is not None:
        state = state_from_checkpoint(model, trainer.tx, ckpt)
        print(f'Restored checkpoint at step {state.step}')
    else:
        state = create_train_state(model, trainer.tx)

    if args.extract_pitch:
        extract_pitch(paths, config)
        return
    if args.force_gta:
        print('Exporting ground-truth-aligned features...')
        n = export_gta(model, paths, config, trainer.device)
        print(f'Wrote {n} GTA mels to {paths.gta}')
        return
    if not args.force_align:
        replicate(model)
        trainer.train(model, state=state, seed=args.seed)
    if distributed:
        # the extraction runs on rank 0 alone, outside the process group
        rank = process_index()
        torch.distributed.destroy_process_group()
        if rank != 0:
            return
    create_align_features(model, paths, config, trainer.device)
    extract_pitch(paths, config)


def create_align_features(model, paths, config, device) -> None:
    """The teacher's attentions, the durations from them and
    ``duration_stats.pkl`` (the JAX package's ``_create_align_features``)."""
    from forwardtacotron_torch.duration.extractor import DurationExtractor
    from forwardtacotron_torch.duration.pipeline import \
        DurationExtractionPipeline
    from forwardtacotron_torch.utils.files import pickle_binary

    cfg = config['duration_extraction']
    extractor = DurationExtractor(
        silence_threshold=cfg['silence_threshold'],
        silence_prob_shift=cfg['silence_prob_shift'])
    pipe = DurationExtractionPipeline(paths, config, extractor)
    print('Extracting attention matrices from tacotron...')
    score = pipe.extract_attentions(model,
                                    max_batch_size=cfg['max_batch_size'],
                                    device=device)
    print(f'Avg attention sharpness: {score:.4f}')
    n_workers = cfg.get('num_workers', 0)
    print(f'Extracting durations (num workers={n_workers})...')
    stats = pipe.extract_durations(num_workers=n_workers)
    pickle_binary(stats, paths.duration_stats)


def extract_pitch(paths, config) -> None:
    """The per-phoneme pitch and energy targets (``_extract_pitch``)."""
    from forwardtacotron_torch.duration.targets import extract_pitch_energy
    print('Extracting pitch/energy targets...')
    pre = config['preprocessing']
    extract_pitch_energy(paths, pitch_min_freq=pre['pitch_min_freq'],
                         pitch_max_freq=pre['pitch_max_freq'])

if __name__ == '__main__':
    main()
