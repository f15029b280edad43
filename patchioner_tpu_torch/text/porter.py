"""Porter stemmer (Porter, 1980, "An algorithm for suffix stripping").

Twin of `patchioner_tpu/text/porter.py`, which the port may not
import; the code is the same.

Implemented from the published algorithm to give the METEOR scorer a
stem-match stage (the reference scores METEOR with the Java METEOR-1.5
jar via speaksee, whose English config matches exact then stem —
eval-*-captioning pipelines in the reference tree). Pure Python, no
dependencies; operates on lowercase ASCII words.
"""

from __future__ import annotations

__all__ = ["stem"]

_VOWELS = "aeiou"


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(w: str) -> int:
    """Number of VC sequences: [C](VC)^m[V]."""
    m = 0
    prev_vowel = False
    for i in range(len(w)):
        if _is_cons(w, i):
            if prev_vowel:
                m += 1
            prev_vowel = False
        else:
            prev_vowel = True
    return m


def _has_vowel(w: str) -> bool:
    return any(not _is_cons(w, i) for i in range(len(w)))


def _ends_double_cons(w: str) -> bool:
    return (
        len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)
    )


def _cvc(w: str) -> bool:
    """*o: ends consonant-vowel-consonant where the final consonant is
    not w, x or y."""
    if len(w) < 3:
        return False
    return (
        _is_cons(w, len(w) - 3)
        and not _is_cons(w, len(w) - 2)
        and _is_cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


_STEP2 = [
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
    ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
    ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
    ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
]

_STEP3 = [
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
]

_STEP4 = [
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
]


def stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # Step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        hit = None
        if w.endswith("ed") and _has_vowel(w[:-2]):
            hit = w = w[:-2]
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            hit = w = w[:-3]
        if hit is not None:
            if w.endswith(("at", "bl", "iz")):
                w = w + "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w = w + "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    for suf, rep in _STEP2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 3
    for suf, rep in _STEP3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 4
    for suf in _STEP4:
        if w.endswith(suf):
            stem_part = w[: -len(suf)]
            if _measure(stem_part) > 1:
                if suf == "ion" and (not stem_part or stem_part[-1] not in "st"):
                    pass
                else:
                    w = stem_part
            break

    # Step 5a
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _cvc(w[:-1])):
            w = w[:-1]

    # Step 5b
    if w.endswith("ll") and _measure(w) > 1:
        w = w[:-1]

    return w
