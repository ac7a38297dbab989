"""CLI: train the Tacotron teacher on the GPU, or export its
ground-truth-aligned (GTA) mels.

Mirrors the repository's root ``train_tacotron.py`` on the PyTorch port,
for one device:

    python -m forwardtacotron_torch.train_tacotron \\
        --config configs/singlespeaker.yaml [--device cpu] [--force_gta]

It resumes from ``latest_model.pt`` in the config's teacher checkpoint
directory when one is there (weights, BatchNorm statistics, optimizer state
and step), else starts from seeded random weights. By default it runs the
config's ``tacotron`` schedule, writing reference-format ``.pt``
checkpoints; ``--force_gta`` instead writes ``<data>/gta/<id>.npy`` for
every item, the postnet's mel [n_mels, mel_len] of the teacher-forced eval
forward at r = 1 (the JAX package's ``_export_gta``).

The attention extraction that the JAX package runs after training, and
``--force_align`` and ``--extract_pitch``, need the duration pipeline
(ROADMAP.md Queue 1, item 10): until it is ported they raise
``NotImplementedError`` (after training, in the default mode).
"""

import argparse

import numpy as np

ITEM_10 = ('needs the duration and pitch pipeline, which the port does not '
           'have yet (ROADMAP.md Queue 1 item 10)')


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
    if args.extract_pitch:
        raise NotImplementedError(f'--extract_pitch {ITEM_10}')
    if args.force_align:
        raise NotImplementedError(f'--force_align {ITEM_10}')

    import torch

    from forwardtacotron_torch.models.tacotron import Tacotron
    from forwardtacotron_torch.train.state import (create_train_state,
                                                   state_from_checkpoint)
    from forwardtacotron_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_torch.utils.checkpoints import restore_checkpoint
    from forwardtacotron_torch.utils.files import read_config
    from forwardtacotron_torch.utils.paths import Paths

    config = read_config(args.config)
    paths = Paths.from_config(config)
    torch.manual_seed(args.seed)
    model = Tacotron.from_config(config)
    trainer = TacoTrainer(paths, None, config, device=args.device)
    model.to(trainer.device)
    ckpt = restore_checkpoint(paths.taco_checkpoints)
    if ckpt is not None:
        state = state_from_checkpoint(model, trainer.tx, ckpt)
        print(f'Restored checkpoint at step {state.step}')
    else:
        state = create_train_state(model, trainer.tx)

    if args.force_gta:
        print('Exporting ground-truth-aligned features...')
        n = export_gta(model, paths, config, trainer.device)
        print(f'Wrote {n} GTA mels to {paths.gta}')
        return
    trainer.train(model, state=state, seed=args.seed)
    raise NotImplementedError(
        f'Training finished (checkpoints in {paths.taco_checkpoints}); the '
        f'attention extraction that follows it {ITEM_10}')


if __name__ == '__main__':
    main()
