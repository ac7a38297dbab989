"""CLI: synthesize wavs from text with Griffin-Lim, on the GPU.

Mirrors the default flow of the repository's root ``gen_forward.py`` (float32,
one sentence at a time, Griffin-Lim) on the PyTorch port:

    python -m forwardtacotron_torch.gen_forward --checkpoint model.pt \\
        --input_text "Hello world."

``--checkpoint`` is a reference-format ``.pt``. Text is cleaned with the
checkpoint's cleaner; without an espeak phonemizer it is treated as
pre-phonemized.
"""

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description='Generate speech from text')
    parser.add_argument('--checkpoint', required=True,
                        help='reference-format .pt checkpoint')
    parser.add_argument('--input_text', default=None)
    parser.add_argument('--text_file', default='sentences.txt')
    parser.add_argument('--output', default='model_output')
    parser.add_argument('--alpha', type=float, default=1.0,
                        help='duration scale (speech speed)')
    parser.add_argument('--amp', type=float, default=1.0,
                        help='pitch amplification factor')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.text.cleaners import Cleaner
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    from forwardtacotron_torch.utils.checkpoints import (
        checkpoint_step, init_tts_model_from_checkpoint)

    model, checkpoint = init_tts_model_from_checkpoint(args.checkpoint)
    config = checkpoint['config']
    inference = TTSInference(model, device=args.device)
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

    for i, sentence in enumerate(sentences, 1):
        x = tokenizer(cleaner(sentence))
        out = inference.generate_cropped(
            x, alpha=args.alpha, pitch_function=lambda p: p * args.amp)
        wav = dsp.griffinlim(out['mel_post'])
        dsp.save_wav(wav, out_dir / f'{i}_forward_{step_k}k_alpha{args.alpha}.wav')
    print(f'Wrote {len(sentences)} outputs to {out_dir}')


if __name__ == '__main__':
    main()
