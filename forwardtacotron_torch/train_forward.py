"""CLI: train a forward model (ForwardTacotron, FastPitch or a multispeaker
model) on the GPU.

Mirrors the repository's root ``train_forward.py`` on the PyTorch port, on
one device or data parallel with one process per card:

    python -m forwardtacotron_torch.train_forward \\
        --config configs/singlespeaker.yaml [--device cpu]
    torchrun --nproc_per_node 4 -m forwardtacotron_torch.train_forward \\
        --config configs/singlespeaker.yaml

Under ``torchrun`` (``python -m torch.distributed.run``) each rank joins
the process group (NCCL on ``cuda:LOCAL_RANK``; gloo with ``--device
cpu``), takes its share of the training items and steps on the global
batch (``train.forward_trainer``); the config's batch size is per rank.

It resumes from ``latest_model.pt`` in the config's forward checkpoint
directory when one is there (weights, BatchNorm statistics, optimizer state
and step), else starts from seeded random weights, and runs the config's
schedule of the config's ``tts_model`` section. Checkpoints are
reference-format ``.pt`` files that ``python -m
forwardtacotron_torch.gen_forward`` loads; a multispeaker model's carry
the speaker table (``MultiForwardTrainer``). ``--force_gta`` (GTA mel
export) is not ported yet.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description='Train forward TTS model')
    parser.add_argument('--config', default='configs/singlespeaker.yaml')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--seed', type=int, default=0,
                        help='seeds the initial weights and the dropout')
    args = parser.parse_args(argv)

    import torch

    from forwardtacotron_torch.models.registry import (init_tts_model,
                                                       is_multispeaker)
    from forwardtacotron_torch.parallel.mesh import (initialize_distributed,
                                                     rank_device, replicate)
    from forwardtacotron_torch.train.forward_trainer import (
        ForwardTrainer, MultiForwardTrainer)
    from forwardtacotron_torch.train.state import (create_train_state,
                                                   state_from_checkpoint)
    from forwardtacotron_torch.utils.checkpoints import restore_checkpoint
    from forwardtacotron_torch.utils.files import read_config
    from forwardtacotron_torch.utils.paths import Paths

    distributed = initialize_distributed(args.device)
    config = read_config(args.config)
    paths = Paths.from_config(config)
    assert any(paths.alg.glob('*.npy')), \
        f'No alignment files found in {paths.alg}. Run train_tacotron.py first!'

    torch.manual_seed(args.seed)
    model = init_tts_model(config)
    trainer_cls = MultiForwardTrainer if is_multispeaker(config) \
        else ForwardTrainer
    trainer = trainer_cls(paths, None, config,
                          device=rank_device(args.device))
    model.to(trainer.device)
    ckpt = restore_checkpoint(paths.forward_checkpoints)
    if ckpt is not None:
        state = state_from_checkpoint(model, trainer.tx, ckpt)
        print(f'Restored checkpoint at step {state.step}')
    else:
        state = create_train_state(model, trainer.tx)
    replicate(model)
    trainer.train(model, state=state, seed=args.seed)
    if distributed:
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
