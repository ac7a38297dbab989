"""Phoneme string <-> token-ID conversion.

Same contract as reference utils/text/tokenizer.py:6-17: unknown characters
are silently dropped; decoding joins symbols back into a string.
"""

from typing import List

from forwardtacotron_torch.text.symbols import phonemes


class Tokenizer:

    def __init__(self) -> None:
        self.symbol_to_id = {s: i for i, s in enumerate(phonemes)}
        self.id_to_symbol = {i: s for i, s in enumerate(phonemes)}

    def __call__(self, text: str) -> List[int]:
        return [self.symbol_to_id[t] for t in text if t in self.symbol_to_id]

    def decode(self, sequence: List[int]) -> str:
        return ''.join(self.id_to_symbol[s] for s in sequence
                       if s in self.id_to_symbol)
