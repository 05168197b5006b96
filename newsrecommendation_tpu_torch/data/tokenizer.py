"""NLTK-faithful Treebank word tokenizer (dependency-free).

The port's own copy of the JAX package's ``data/tokenizer.py``: titles are
tokenized as nltk's ``word_tokenize(title.lower())`` of the 3.4-3.6 era,
which the upstream vocabulary (and so real-MIND accuracy parity) depends
on. Treebank rules apply to the whole title without Punkt sentence
splitting: news titles are single sentences essentially always.
"""

from __future__ import annotations

import re
from typing import List

# Rule set of nltk.tokenize.TreebankWordTokenizer (3.4-3.6), applied in the
# same order as its tokenize() method.

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"`` "),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # sentence-final period (kept attached elsewhere: abbreviations)
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")

_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")

_ENDING_QUOTES = [
    (re.compile(r'"'), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS2 = [
    re.compile(r"(?i)\b(can)(?#X)(not)\b"),
    re.compile(r"(?i)\b(d)(?#X)('ye)\b"),
    re.compile(r"(?i)\b(gim)(?#X)(me)\b"),
    re.compile(r"(?i)\b(gon)(?#X)(na)\b"),
    re.compile(r"(?i)\b(got)(?#X)(ta)\b"),
    re.compile(r"(?i)\b(lem)(?#X)(me)\b"),
    re.compile(r"(?i)\b(mor)(?#X)('n)\b"),
    re.compile(r"(?i)\b(wan)(?#X)(na)\s"),
]

_CONTRACTIONS3 = [
    re.compile(r"(?i) ('t)(?#X)(is)\b"),
    re.compile(r"(?i) ('t)(?#X)(was)\b"),
]


def treebank_word_tokenize(text: str) -> List[str]:
    """nltk TreebankWordTokenizer.tokenize(), rule-for-rule."""
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)

    for regexp, substitution in _PUNCTUATION:
        text = regexp.sub(substitution, text)

    regexp, substitution = _PARENS_BRACKETS
    text = regexp.sub(substitution, text)

    regexp, substitution = _DOUBLE_DASHES
    text = regexp.sub(substitution, text)

    text = " " + text + " "

    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)

    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)

    return text.split()
