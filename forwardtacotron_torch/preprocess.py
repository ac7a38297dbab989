"""CLI: dataset preprocessing on the GPU (mirrors the repository's root
``preprocess.py``, reference preprocess.py:101-229):

    python -m forwardtacotron_torch.preprocess --path /data/LJSpeech-1.1 \\
        --config configs/singlespeaker.yaml [--metafile metadata.csv] \\
        [--num_workers 4] [--device cpu]

Writes ``mel/``, ``raw_pitch/``, ``speaker_emb/``, ``mean_speaker_emb/`` and
the pickled text and speaker dicts and train/val splits under the config's
``data_path``: the mels and the speaker encoder on the device, the host
work of each file in ``--num_workers`` processes.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description='Preprocess a TTS dataset')
    parser.add_argument('--path', required=True,
                        help='directory containing wav files and metadata')
    parser.add_argument('--config', default='configs/singlespeaker.yaml')
    parser.add_argument('--metafile', default='metadata.csv')
    parser.add_argument('--num_workers', type=int, default=4)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from forwardtacotron_torch.data.preprocess import run_preprocessing
    from forwardtacotron_torch.utils.files import read_config

    run_preprocessing(read_config(args.config), dataset_path=args.path,
                      metafile=args.metafile, n_workers=args.num_workers,
                      device=args.device)


if __name__ == '__main__':
    main()
