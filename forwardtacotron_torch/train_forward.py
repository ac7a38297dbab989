"""CLI: train a forward model (ForwardTacotron, FastPitch or a multispeaker
model) on the GPU, or export its ground-truth-aligned mels.

Mirrors the repository's root ``train_forward.py`` on the PyTorch port, on
one device or data parallel with one process per card:

    python -m forwardtacotron_torch.train_forward \\
        --config configs/singlespeaker.yaml [--device cpu] [--force_gta]
    torchrun --nproc_per_node 4 -m forwardtacotron_torch.train_forward \\
        --config configs/singlespeaker.yaml

Under ``torchrun`` (``python -m torch.distributed.run``) each rank joins
the process group (NCCL on ``cuda:LOCAL_RANK``; gloo with ``--device
cpu``), takes its share of the training items and steps on the global
batch (``train.forward_trainer``); the config's batch size is per rank.

It resumes from ``latest_model.pt`` in the config's forward checkpoint
directory, or from the JAX package's ``latest_model.ckpt`` when only that
is there (weights, BatchNorm statistics, optimizer state and step), else
starts from seeded random weights, and runs the config's schedule of the
config's ``tts_model`` section. Checkpoints are reference-format ``.pt``
files that ``python -m forwardtacotron_torch.gen_forward`` loads; a
multispeaker model's carry the speaker table (``MultiForwardTrainer``).
The trainer's plots get Griffin-Lim audio from the config's DSP.

``--force_gta`` trains nothing: it writes ``<data>/gta/<id>.npy``, the
postnet's mel [n_mels, mel_len] of the eval forward on the item's own
durations, pitch and energy, for every train and val item (the mels a
vocoder is fine-tuned on; reference train_forward.py:33-51). It runs in
one process: under ``torchrun`` it is refused, where the JAX package has
every process write the same files.
"""

import argparse

import numpy as np


def export_gta(model, paths, config, device) -> int:
    """Write the GTA mel of every train and val item, batches of 8 from the
    forward loaders, in float32 on ``device`` (CUDA unless the caller
    names the CPU); returns the number written."""
    import torch

    from forwardtacotron_torch.data.dataset import get_forward_dataloaders
    from forwardtacotron_torch.train.forward_trainer import BATCH_KEYS
    from forwardtacotron_torch.utils.device import resolve_device

    device = resolve_device(device)
    model_type = config.get('tts_model', 'forward_tacotron')
    train_set, val_set = get_forward_dataloaders(
        paths=paths, batch_size=8,
        **config[model_type]['training']['filter'])
    model.to(device, torch.float32).eval()
    written = 0
    with torch.inference_mode():
        for loader in (train_set, val_set):
            for batch in loader:
                out = model({k: torch.as_tensor(batch[k], device=device)
                             for k in BATCH_KEYS if k in batch})
                mel_post = out['mel_post'].float().cpu().numpy()
                for j, item_id in enumerate(batch['item_id']):
                    mel_len = int(batch['mel_len'][j])
                    np.save(str(paths.gta / f'{item_id}.npy'),
                            mel_post[j, :mel_len].T, allow_pickle=False)
                    written += 1
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description='Train forward TTS model')
    parser.add_argument('--config', default='configs/singlespeaker.yaml')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--seed', type=int, default=0,
                        help='seeds the initial weights and the dropout')
    parser.add_argument('--force_gta', action='store_true',
                        help='export ground-truth-aligned mels, no training')
    args = parser.parse_args(argv)

    import torch

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.registry import (init_tts_model,
                                                       is_multispeaker)
    from forwardtacotron_torch.parallel.mesh import (initialize_distributed,
                                                     process_count,
                                                     rank_device, replicate)
    from forwardtacotron_torch.train.forward_trainer import (
        ForwardTrainer, MultiForwardTrainer)
    from forwardtacotron_torch.train.state import (create_train_state,
                                                   state_from_checkpoint)
    from forwardtacotron_torch.utils.checkpoints import restore_checkpoint
    from forwardtacotron_torch.utils.files import read_config
    from forwardtacotron_torch.utils.paths import Paths

    distributed = initialize_distributed(args.device)
    if process_count() > 1 and args.force_gta:
        torch.distributed.destroy_process_group()
        parser.error('--force_gta runs in one process: start it without '
                     'torchrun')
    config = read_config(args.config)
    paths = Paths.from_config(config)
    assert any(paths.alg.glob('*.npy')), \
        f'No alignment files found in {paths.alg}. Run train_tacotron.py first!'

    torch.manual_seed(args.seed)
    model = init_tts_model(config)
    trainer_cls = MultiForwardTrainer if is_multispeaker(config) \
        else ForwardTrainer
    device = rank_device(args.device)
    trainer = trainer_cls(paths, DSP.from_config(config, device=device),
                          config, device=device)
    model.to(trainer.device)
    ckpt = restore_checkpoint(paths.forward_checkpoints)
    if ckpt is not None:
        state = state_from_checkpoint(model, trainer.tx, ckpt)
        print(f'Restored checkpoint at step {state.step}')
    else:
        state = create_train_state(model, trainer.tx)
    if args.force_gta:
        print('Exporting GTA features...')
        n = export_gta(model, paths, config, trainer.device)
        print(f'Wrote {n} GTA mels to {paths.gta}')
        return
    replicate(model)
    trainer.train(model, state=state, seed=args.seed)
    if distributed:
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
