"""English number normalization, implemented from scratch (no inflect).

Behavior-compatible with the reference's keithito-style normalizer
(utils/text/numbers.py:64-71): strips digit-group commas, expands currency
(£/$), decimals ("1.5" -> "1 point 5"), ordinals ("2nd" -> "second"), and
cardinals, with year-style reading for 1000 < n < 3000
("1985" -> "nineteen eighty-five", "2007" -> "two thousand seven").
"""

import re

_UNITS = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven',
          'eight', 'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen',
          'fifteen', 'sixteen', 'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
         'eighty', 'ninety']
_SCALES = [(10 ** 18, 'quintillion'), (10 ** 15, 'quadrillion'),
           (10 ** 12, 'trillion'), (10 ** 9, 'billion'),
           (10 ** 6, 'million'), (10 ** 3, 'thousand')]

_ORDINAL_IRREGULAR = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth',
}


def _two_digits_to_words(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    tens, units = divmod(n, 10)
    word = _TENS[tens]
    return f'{word}-{_UNITS[units]}' if units else word


def _three_digits_to_words(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f'{_UNITS[hundreds]} hundred')
    if rest or not hundreds:
        parts.append(_two_digits_to_words(rest))
    return ' '.join(parts)


def number_to_words(n: int) -> str:
    """Cardinal English words for a non-negative integer."""
    if n < 0:
        return 'minus ' + number_to_words(-n)
    if n < 1000:
        return _three_digits_to_words(n)
    parts = []
    remainder = n
    for scale_value, scale_name in _SCALES:
        count, remainder = divmod(remainder, scale_value)
        if count:
            parts.append(f'{_three_digits_to_words(count)} {scale_name}')
    if remainder:
        parts.append(_three_digits_to_words(remainder))
    return ', '.join(parts)


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(' ') if ' ' in words else ('', '', words)
    if '-' in last:
        tens, _, unit = last.rpartition('-')
        last = f'{tens}-{_ordinalize_word(unit)}'
    else:
        last = _ordinalize_word(last)
    return f'{head} {last}'.strip()


def _ordinalize_word(word: str) -> str:
    if word in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[word]
    if word.endswith('y'):
        return word[:-1] + 'ieth'
    if word.endswith(('hundred', 'thousand', 'llion')):
        return word + 'th'
    return word + 'th'


def _year_to_words(n: int) -> str:
    """Year-style reading for 1000 < n < 3000 (reference utils/text/numbers.py:50-60)."""
    if n == 2000:
        return 'two thousand'
    if 2000 < n < 2010:
        return 'two thousand ' + _UNITS[n % 100]
    if n % 100 == 0:
        return _two_digits_to_words(n // 100) + ' hundred'
    high, low = divmod(n, 100)
    low_words = 'oh ' + _UNITS[low] if low < 10 else _two_digits_to_words(low)
    return f'{_two_digits_to_words(high)} {low_words}'


_comma_number_re = re.compile(r'([0-9][0-9\,]+[0-9])')
_decimal_number_re = re.compile(r'([0-9]+\.[0-9]+)')
_pounds_re = re.compile(r'£([0-9\,]*[0-9]+)')
_dollars_re = re.compile(r'\$([0-9\.\,]*[0-9]+)')
_ordinal_re = re.compile(r'[0-9]+(st|nd|rd|th)')
_number_re = re.compile(r'[0-9]+')


def _expand_dollars(m: re.Match) -> str:
    amount = m.group(1)
    parts = amount.split('.')
    if len(parts) > 2:
        return amount + ' dollars'
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    dollar_unit = 'dollar' if dollars == 1 else 'dollars'
    cent_unit = 'cent' if cents == 1 else 'cents'
    if dollars and cents:
        return f'{dollars} {dollar_unit}, {cents} {cent_unit}'
    if dollars:
        return f'{dollars} {dollar_unit}'
    if cents:
        return f'{cents} {cent_unit}'
    return 'zero dollars'


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        return _year_to_words(num)
    return number_to_words(num).replace(', ', ' ')


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(',', ''), text)
    text = _pounds_re.sub(r'\1 pounds', text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(lambda m: m.group(1).replace('.', ' point '), text)
    text = _ordinal_re.sub(lambda m: number_to_ordinal_words(int(m.group(0)[:-2])), text)
    text = _number_re.sub(_expand_number, text)
    return text
