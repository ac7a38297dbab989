"""Phoneme symbol alphabet — the model's token ID space.

The ordering below is a *compatibility constant*: token IDs must match the
reference (utils/text/symbols.py:8-26, 135 symbols, pad='_' at index 0)
bit-for-bit, otherwise converted PyTorch checkpoints index the wrong
embedding rows. The groups are IPA vowels, non-pulmonic/pulmonic consonants,
suprasegmentals, other symbols, diacritics, plus a handful of extra symbols
seen in wiktionary IPA annotations.
"""

from typing import List

PAD = '_'
PUNCTUATION = "!'(),.:;? "
SPECIAL = '-'

_VOWELS = 'iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ'
_NON_PULMONIC = 'ʘɓǀɗǃʄǂɠǁʛ'
_PULMONIC = 'pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ'
_SUPRASEGMENTALS = 'ˈˌːˑ'
_OTHER = 'ʍwɥʜʢʡɕʑɺɧ'
_DIACRITICS = 'ɚ˞ɫ'
_EXTRAS = ['g', 'ɝ', '̃', '̍', '̥', '̩', '̯', '͡']

phonemes: List[str] = list(
    PAD + PUNCTUATION + SPECIAL + _VOWELS + _NON_PULMONIC + _PULMONIC
    + _SUPRASEGMENTALS + _OTHER + _DIACRITICS
) + _EXTRAS

phonemes_set = set(phonemes)

# pad + punctuation count as "silent" for duration extraction prob-shifting
silent_phonemes_indices = [i for i, p in enumerate(phonemes)
                           if p in PAD + PUNCTUATION]

NUM_CHARS = len(phonemes)
assert NUM_CHARS == 135, f'phoneme ID space must be 135 symbols, got {NUM_CHARS}'
