"""CLI: synthesize wavs from text, on the GPU.

Mirrors the repository's root ``gen_forward.py`` on the PyTorch port:
float32 or bfloat16, one sentence at a time or, with ``--batched``, all
sentences as one length-routed batch; a ForwardTacotron or FastPitch
checkpoint, or a multispeaker one in the voice of ``--speaker`` (a name in
the checkpoint's ``speaker_embeddings``); vocoded with Griffin-Lim, or with a HiFi-GAN or MelGAN
generator checkpoint on the device (``hifigan|melgan
--vocoder_checkpoint``), or, without a checkpoint, exported as the
reference exports mels for an external vocoder (``.mel`` for melgan,
``.npy`` for hifigan):

    python -m forwardtacotron_torch.gen_forward --checkpoint model.pt \\
        --input_text "Hello world."
    python -m forwardtacotron_torch.gen_forward --checkpoint model.pt \\
        --dtype bfloat16 --batched
    python -m forwardtacotron_torch.gen_forward --checkpoint multi.pt \\
        --speaker p225
    python -m forwardtacotron_torch.gen_forward --checkpoint model.pt \\
        --vocoder_checkpoint g_02500000 --vocoder_config config.json hifigan
    python -m forwardtacotron_torch.gen_forward --checkpoint model.pt \\
        --dtype bfloat16 --batched --data_parallel

``--data_parallel`` splits each batch over every visible card, one
replica of the model each (``TTSInference(mesh=)``; with ``--device cpu``
the devices torch counts for the CPU, one).

``--checkpoint`` is a reference-format ``.pt`` or the JAX package's native
``.ckpt`` (its speaker table in the meta). Text is cleaned with the
checkpoint's cleaner; without an espeak phonemizer it is treated as
pre-phonemized.
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description='Generate speech from text')
    parser.add_argument('--checkpoint', required=True,
                        help='reference-format .pt or native .ckpt '
                             'checkpoint')
    parser.add_argument('--input_text', default=None)
    parser.add_argument('--text_file', default='sentences.txt')
    parser.add_argument('--output', default='model_output')
    parser.add_argument('--alpha', type=float, default=1.0,
                        help='duration scale (speech speed)')
    parser.add_argument('--amp', type=float, default=1.0,
                        help='pitch amplification factor')
    parser.add_argument('--speaker', default=None,
                        help='speaker name for multispeaker checkpoints')
    parser.add_argument('--batched', action='store_true',
                        help='synthesize all sentences as one padded batch')
    parser.add_argument('--dtype', default='float32',
                        choices=['float32', 'bfloat16'],
                        help='bfloat16 = the serving path with the '
                             'recurrent kernels')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--data_parallel', action='store_true',
                        help='shard the batch over all visible devices')
    parser.add_argument('vocoder', nargs='?', default='griffinlim',
                        choices=['griffinlim', 'melgan', 'hifigan'])
    parser.add_argument('--vocoder_checkpoint', default=None,
                        help='published HiFi-GAN or MelGAN generator '
                             'weights; when given, vocoding runs on the '
                             'device at --dtype and .wav files are written '
                             'instead of mel exports')
    parser.add_argument('--vocoder_config', default=None,
                        help='HiFi-GAN config.json for --vocoder_checkpoint '
                             '(v1 defaults if omitted)')
    args = parser.parse_args(argv)

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.synthesis import TTSInference, Vocoder
    from forwardtacotron_torch.parallel.mesh import make_mesh, visible_devices
    from forwardtacotron_torch.text.cleaners import Cleaner
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    from forwardtacotron_torch.utils.checkpoints import (
        checkpoint_step, init_tts_model_from_checkpoint)

    model, checkpoint = init_tts_model_from_checkpoint(args.checkpoint)
    config = checkpoint['config']
    mesh = None
    if args.data_parallel:
        mesh = make_mesh(devices=visible_devices(
            torch.device(args.device).type))
    inference = TTSInference(model, dtype=args.dtype, device=args.device,
                             mesh=mesh)
    speaker_emb = None
    if inference.multispeaker:
        # the reference keeps the speaker table at the checkpoint's top
        # level (the JAX package's meta)
        embeddings = checkpoint.get('speaker_embeddings', {})
        if args.speaker and args.speaker in embeddings:
            speaker_emb = np.asarray(embeddings[args.speaker], np.float32)
        elif embeddings:
            name, speaker_emb = next(iter(embeddings.items()))
            speaker_emb = np.asarray(speaker_emb, np.float32)
            print(f'No --speaker given; using "{name}"')
        else:
            speaker_emb = np.zeros(model.speaker_emb_dims, np.float32)
            print('No speaker embeddings in checkpoint; using zeros')
    dsp = DSP.from_config(config, device=args.device)

    if args.input_text:
        sentences = [args.input_text]
    else:
        with open(args.text_file, encoding='utf-8') as f:
            sentences = [line.strip() for line in f if line.strip()]

    try:
        cleaner = Cleaner.from_config(config)
    except RuntimeError:
        print('Phonemizer unavailable: treating input as pre-phonemized text')
        cleaner = Cleaner(config['preprocessing']['cleaner_name'],
                          use_phonemes=False,
                          lang=config['preprocessing']['language'])
    tokenizer = Tokenizer()
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    step_k = int(checkpoint_step(checkpoint) / 1000)

    vocoder = None
    if args.vocoder_checkpoint and args.vocoder != 'griffinlim':
        voc_config = None
        if args.vocoder == 'hifigan' and args.vocoder_config:
            voc_config = json.loads(Path(args.vocoder_config).read_text())
        vocoder = Vocoder.from_checkpoint(
            args.vocoder_checkpoint, vocoder_type=args.vocoder,
            config=voc_config, dtype=args.dtype, device=args.device)

    kwargs = dict(alpha=args.alpha, pitch_function=lambda p: p * args.amp)
    wavs = None
    if args.batched and len(sentences) > 1:
        token_lists = [tokenizer(cleaner(s)) for s in sentences]
        x = np.zeros((len(token_lists), max(map(len, token_lists))), np.int64)
        for i, toks in enumerate(token_lists):
            x[i, :len(toks)] = toks
        # routed: each sentence decodes (and neural-vocodes) at its own
        # frame bucket
        if speaker_emb is not None:   # one row per sentence of the batch
            kwargs['speaker_emb'] = np.tile(speaker_emb, (len(x), 1))
        out = inference.generate_routed(x, vocoder=vocoder, **kwargs)
        mels = [out['mel_post'][i, :int(out['mel_len'][i])].T.float().cpu()
                .numpy() for i in range(len(sentences))]
        if vocoder is not None:
            wavs = [out['wav'][i, :int(out['wav_len'][i])].float().cpu()
                    .numpy() for i in range(len(sentences))]
    else:
        if speaker_emb is not None:
            kwargs['speaker_emb'] = speaker_emb
        mels = [inference.generate_cropped(tokenizer(cleaner(s)),
                                           **kwargs)['mel_post']
                for s in sentences]
    for i, mel in enumerate(mels, 1):
        name = f'{i}_forward_{step_k}k_alpha{args.alpha}'
        if args.vocoder == 'griffinlim':
            dsp.save_wav(dsp.griffinlim(mel), out_dir / f'{name}.wav')
        elif vocoder is not None:
            wav = wavs[i - 1] if wavs is not None \
                else vocoder(mel.T[None])[0].float().cpu().numpy()
            dsp.save_wav(wav, out_dir / f'{name}.wav')
        elif args.vocoder == 'melgan':
            torch.save(torch.tensor(mel)[None, :, :], out_dir / f'{name}.mel')
        else:  # hifigan
            np.save(str(out_dir / f'{name}.npy'), mel, allow_pickle=False)
    print(f'Wrote {len(mels)} outputs to {out_dir}')


if __name__ == '__main__':
    main()
