"""The port's copies of the text pipeline give the JAX package's token ids
(exact: integer ids)."""

import pytest
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.text import symbols
from forwardtacotron_torch.text.cleaners import Cleaner
from forwardtacotron_torch.text.tokenizer import Tokenizer

EXTRA = ['Dr. Smith paid $3.50 on the 2nd of May, 1985.',
         'Mrs. Ødegaard — “quoted” café… 1,000,000 items!',
         'ˈhɛloʊ wˈɜːld']


def _sentences():
    with open('sentences.txt', encoding='utf-8') as f:
        return [line.strip() for line in f if line.strip()] + EXTRA


@pytest.mark.parametrize('cleaner_name', ['english_cleaners', 'no_cleaners'])
def test_cleaner_and_tokenizer_match_jax(cleaner_name):
    from forwardtacotron_tpu.text import symbols as jax_symbols
    from forwardtacotron_tpu.text.cleaners import Cleaner as JaxCleaner
    from forwardtacotron_tpu.text.tokenizer import Tokenizer as JaxTokenizer

    assert symbols.phonemes == jax_symbols.phonemes
    ours = Cleaner(cleaner_name, use_phonemes=False, lang='en-us')
    theirs = JaxCleaner(cleaner_name, use_phonemes=False, lang='en-us')
    tok, jtok = Tokenizer(), JaxTokenizer()
    for sentence in _sentences():
        cleaned = ours(sentence)
        assert cleaned == theirs(sentence)
        ids = tok(cleaned)
        assert ids == jtok(cleaned) and len(ids) > 0
        assert tok.decode(ids) == jtok.decode(ids)
