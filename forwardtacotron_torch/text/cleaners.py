"""Text cleaning pipeline: normalize -> (optional) phonemize -> filter.

Same pipeline contract as reference utils/text/cleaners.py:57-94. The espeak
phonemizer backend is optional in this build: when the ``phonemizer`` package
(and the espeak shared library) is unavailable, ``use_phonemes=True`` raises a
clear error unless pre-phonemized text is used — the supported no-dependency
path is ``use_phonemes=False`` with text already in phoneme (or grapheme)
space. ASCII transliteration falls back to a small built-in table when
``unidecode`` is missing.
"""

import re
import unicodedata
from typing import Any, Dict

from forwardtacotron_torch.text.numbers import normalize_numbers
from forwardtacotron_torch.text.symbols import phonemes_set

_whitespace_re = re.compile(r'\s+')

_ABBREVIATIONS = [
    ('mrs', 'misess'), ('mr', 'mister'), ('dr', 'doctor'), ('st', 'saint'),
    ('co', 'company'), ('jr', 'junior'), ('maj', 'major'), ('gen', 'general'),
    ('drs', 'doctors'), ('rev', 'reverend'), ('lt', 'lieutenant'),
    ('hon', 'honorable'), ('sgt', 'sergeant'), ('capt', 'captain'),
    ('esq', 'esquire'), ('ltd', 'limited'), ('col', 'colonel'), ('ft', 'fort'),
]
_abbrev_res = [(re.compile(rf'\b{abbr}\.', re.IGNORECASE), full)
               for abbr, full in _ABBREVIATIONS]

try:  # optional dependency
    from unidecode import unidecode as _unidecode
except ImportError:
    _unidecode = None

# minimal transliterations for characters NFKD cannot decompose
_TRANSLIT = {'æ': 'ae', 'Æ': 'AE', 'ø': 'o', 'Ø': 'O', 'ß': 'ss',
             'þ': 'th', 'Þ': 'Th', 'ð': 'd', 'Ð': 'D', 'œ': 'oe', 'Œ': 'OE',
             '–': '-', '—': '-', '‘': "'", '’': "'", '“': '"', '”': '"',
             '…': '...', '«': '"', '»': '"'}


def to_ascii(text: str) -> str:
    if _unidecode is not None:
        return _unidecode(text)
    text = ''.join(_TRANSLIT.get(c, c) for c in text)
    decomposed = unicodedata.normalize('NFKD', text)
    return ''.join(c for c in decomposed if ord(c) < 128)


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbrev_res:
        text = regex.sub(replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(' ', text)


def english_cleaners(text: str) -> str:
    text = to_ascii(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return text


def no_cleaners(text: str) -> str:
    return text


CLEANERS = {'english_cleaners': english_cleaners, 'no_cleaners': no_cleaners}


def _make_espeak_backend(lang: str):
    from phonemizer.backend import EspeakBackend
    return EspeakBackend(language=lang,
                         preserve_punctuation=True,
                         with_stress=False,
                         punctuation_marks=';:,.!?¡¿—…"«»“”()',
                         language_switch='remove-flags')


class Cleaner:

    def __init__(self,
                 cleaner_name: str,
                 use_phonemes: bool,
                 lang: str,
                 backend=None) -> None:
        """``backend``: an object with ``phonemize([text], strip=True) ->
        [str]`` used when ``use_phonemes=True``. Defaults to a live espeak
        EspeakBackend; injectable so the phonemize->filter->collapse path is
        testable (and swappable for another G2P) without the espeak shared
        library."""
        if cleaner_name not in CLEANERS:
            raise ValueError(f'Cleaner not supported: {cleaner_name}! '
                             f'Supported: {sorted(CLEANERS)}')
        self.clean_func = CLEANERS[cleaner_name]
        self.use_phonemes = use_phonemes
        self.lang = lang
        self.backend = backend
        if use_phonemes and backend is None:
            try:
                self.backend = _make_espeak_backend(lang)
            except Exception as e:  # phonemizer or espeak missing
                raise RuntimeError(
                    'use_phonemes=True requires the phonemizer package with an '
                    'espeak backend, which is not available in this environment. '
                    'Either install phonemizer+espeak, set use_phonemes=False '
                    'and provide pre-phonemized text, or pass a custom '
                    '``backend``.') from e

    def __call__(self, text: str) -> str:
        text = self.clean_func(text)
        if self.backend is not None:
            text = self.backend.phonemize([text], strip=True)[0]
            text = ''.join(p for p in text if p in phonemes_set)
        text = collapse_whitespace(text)
        return text.strip()

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'Cleaner':
        pre = config['preprocessing']
        return cls(cleaner_name=pre['cleaner_name'],
                   use_phonemes=pre['use_phonemes'],
                   lang=pre['language'])
