"""SPICE — semantic propositional caption scoring (lexicon variant).

Twin of `patchioner_tpu/eval/spice.py`, which the port may not
import; the code is the same.

The reference computes SPICE through speaksee's Java scorer
(eval-trace-captioning/compute_scores.py:330-332), which parses captions
into scene graphs with the Stanford dependency parser + SPICE's rule set
(Anderson et al., ECCV 2016) and scores tuple-set F1 between candidate and
merged-reference graphs.

A JVM + Stanford-parser pipeline is out of scope here, so this module
implements the same *metric* (scene-graph tuple F1, per-category breakdown,
WordNet-style synonym matching) over a LEXICON-BASED parser built on the
Visual-Genome resources that ship with the framework
(`data/viecap_vocabulary/` — the same files MeaCap's concept extractor
uses):

  * object mentions: longest-match against the curated clipped VG-SGG
    labels (1,594) + COCO categories (80), with plural lemmatization;
  * attributes: pre-nominal or predicative words matched against the VG/GQA
    joint attribute mentions (position makes the noisy set safe);
  * relations: the span between two object mentions matched against the 50
    VG-SGG predicates + 21,619 joint relationship phrases.

Scores therefore track Java-SPICE's ordering on caption-domain text but are
NOT numerically identical to it; results CSVs carry the variant marker (see
`trace_captioning.compute_scores`).

Per-instance results mirror pycocoevalcap's structure:
{"All": {"p","r","f"}, "Object": ..., "Attribute": ..., "Relation": ...}.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["SpiceLexicon", "parse_scene_graph", "spice"]

_VOCAB_DIR = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "data", "viecap_vocabulary"
)
_DATA = os.path.join(_VOCAB_DIR, "all_objects_attributes_relationships.pickle")
_SGG_DICTS = os.path.join(_VOCAB_DIR, "VG-SGG-dicts-vgoi6-clipped.json")
_COCO_CATS = os.path.join(_VOCAB_DIR, "coco_categories.json")

# Words that never begin/equal an object mention.
_STOP = frozenset(
    "a an the this that these those there is are was were be been being "
    "with of in on at to from by for and or it its his her their as i you "
    "he she we they".split()
)
_ARTICLES = frozenset({"a", "an", "the"})
_COPULAS = ("is", "are")

_IRREGULAR = {
    "people": "person",
    "men": "man",
    "women": "woman",
    "children": "child",
    "feet": "foot",
    "teeth": "tooth",
    "geese": "goose",
    "mice": "mouse",
    "leaves": "leaf",
    "shelves": "shelf",
    "knives": "knife",
    "wolves": "wolf",
}


def _singular_candidates(w: str) -> list:
    """Candidate singulars, most likely first — the CALLER picks the first
    one present in its lexicon. Surface form alone cannot decide
    '-es'-vs-'-s' stripping ('horses' -> horse by -s, 'buses' -> bus by
    -es); SPICE's WordNet lemmatizer resolves this with dictionary lookups,
    so the lexicon stands in for the dictionary here. (A fixed-rule
    predecessor mapped horses/houses/noses -> hors/hous/nos and silently
    dropped those objects.)"""
    if w in _IRREGULAR:
        return [_IRREGULAR[w]]
    out = []
    if len(w) > 3 and w.endswith("ies"):
        out.append(w[:-3] + "y")
    if len(w) > 4 and w.endswith(("sses", "ches", "shes", "xes", "zes")):
        out.append(w[:-2])
    if len(w) > 2 and w.endswith("s") and not w.endswith("ss"):
        out.append(w[:-1])          # horses -> horse
        if len(w) > 3 and w.endswith("es"):
            out.append(w[:-2])      # buses -> bus
    seen = set()
    res = [c for c in out if not (c in seen or seen.add(c))]
    return res or [w]


class SpiceLexicon:
    """Object/attribute/relation phrase sets, normalized for matching."""

    def __init__(self, objects, attributes, relations, max_phrase: int = 4):
        self.max_phrase = max_phrase
        self.objects = self._clean(objects)
        self.attributes = self._clean(attributes)
        # relations keep stopwords ("on top of") so they skip _clean's
        # stopword filter, but DO get its lowercase + whitespace collapse —
        # the vendored VG relationship phrases include double-spaced entries
        # ("putting  down") that could otherwise never match a candidate
        # built by " ".join(tokens)
        self.relations = {
            r for r in (" ".join(str(s).lower().split()) for s in relations)
            if r
        }

    @staticmethod
    def _clean(phrases) -> Set[str]:
        """Normalize and drop noisy entries: VG mention strings include full
        clauses ("man pouring wine", "with a face on it"); any multi-word
        phrase containing a stopword is rejected, keeping noun-phrase-like
        entries ("traffic light", "wooden table")."""
        out = set()
        for p in phrases:
            p = " ".join(str(p).lower().split())
            if not p:
                continue
            words = p.split()
            if any(w in _STOP for w in words):
                continue
            out.add(p)
        return out

    @classmethod
    @functools.lru_cache(maxsize=1)
    def vendored(cls) -> "SpiceLexicon":
        """Default lexicon from the vendored VG resources.

        Objects come from the CURATED clipped VG-SGG labels + COCO
        categories — the raw VG/GQA "joint" mention sets are far too noisy
        for the object decision (every common word appears in all three
        categories). Attributes use the joint attribute mentions and
        relations the joint relationship phrases + SGG predicates: both are
        matched only in syntactic positions (pre-nominal / between two
        objects), which makes the noisy sets safe."""
        with open(_SGG_DICTS) as f:
            sgg = json.load(f)
        with open(_COCO_CATS) as f:
            coco = json.load(f)
        with open(_DATA, "rb") as f:
            joint = pickle.load(f)
        objects = set(sgg["idx_to_label"].values()) | {
            c.lower() for c in coco
        }
        attributes = (
            set(sgg["idx_to_attribute"].values())
            | joint["attributes"]["joint"]
        )
        relations = (
            set(sgg["idx_to_predicate"].values())
            | joint["relationships"]["joint"]
        )
        return cls(objects, attributes, relations)

    def object_match(self, words: Sequence[str]) -> Optional[str]:
        """Exact or plural-lemmatized lookup; returns the canonical
        (singularized) phrase."""
        phrase = " ".join(words)
        if phrase in self.objects:
            return phrase
        for cand in _singular_candidates(words[-1]):
            lemma = " ".join([*words[:-1], cand])
            if lemma in self.objects:
                return lemma
        return None


def parse_scene_graph(
    tokens: Sequence[str], lex: Optional[SpiceLexicon] = None
) -> Set[Tuple[str, ...]]:
    """Tokens -> a set of scene-graph tuples.

    * objects: greedy longest-match (up to `lex.max_phrase` words) against
      the object lexicon with plural lemmatization; tuples carry the
      singularized phrase. A single-word match that is also an attribute
      directly modifying a following object ("a black dog") is read as an
      attribute instead.
    * attributes: up to two uncovered words immediately before an object
      mention (no articles) in the attribute lexicon -> ("obj", "attr");
      plus the predicative pattern "<obj> is/are <attr>"; plus
      attribute-fused lexicon entries decomposed ("black dog" -> dog +
      (dog, black)).
    * relations: the span between two consecutive object mentions with
      articles and claimed attribute words removed, when it appears in the
      relation lexicon -> ("subj", "rel", "obj").
    """
    lex = lex or SpiceLexicon.vendored()
    toks = [t.lower() for t in tokens]
    n = len(toks)
    mentions: List[Tuple[int, int, str]] = []  # (start, end_exclusive, head)
    extra_attrs: List[Tuple[str, str]] = []
    # predicative attrs are recorded by MENTION INDEX and resolved after
    # the fused-label decomposition pass: "the black dog is tall" must emit
    # ('dog', 'tall'), not ('black dog', 'tall'), so it can match a
    # reference "the dog is tall"
    pred_attrs: List[Tuple[int, str]] = []
    i = 0
    while i < n:
        w = toks[i]
        if w in _STOP:
            i += 1
            continue
        # predicative attribute: "<obj> is/are (very) tall"
        prev = toks[i - 1] if i > 0 else ""
        if (
            w in lex.attributes
            and prev in _COPULAS
            and mentions
            and lex.object_match([w]) is None
        ):
            pred_attrs.append((len(mentions) - 1, w))
            i += 1
            continue
        match = None
        for ln in range(min(lex.max_phrase, n - i), 0, -1):
            head = lex.object_match(toks[i : i + ln])
            if head is not None:
                match = (i, i + ln, head)
                break
        if match is None:
            i += 1
            continue
        # attribute-preference: "black" in "a black dog" modifies the
        # following object rather than standing alone.
        if (
            match[1] - match[0] == 1
            and toks[i] in lex.attributes
            and i + 1 < n
        ):
            for ln in range(min(lex.max_phrase, n - i - 1), 0, -1):
                if lex.object_match(toks[i + 1 : i + 1 + ln]) is not None:
                    match = None
                    break
        if match is None:
            i += 1
            continue
        mentions.append(match)
        i = match[1]

    # Decompose attribute-fused lexicon entries ("black dog" is itself a VG
    # label): emit the bare head + modifier edges, as SPICE's parser would.
    decomposed: List[Tuple[int, int, str]] = []
    for s, e, head in mentions:
        words = head.split()
        while len(words) >= 2:
            suffix = " ".join(words[1:])
            if words[0] in lex.attributes and suffix in lex.objects:
                extra_attrs.append((suffix, words[0]))
                words = words[1:]
                head = suffix
            else:
                break
        decomposed.append((s, e, head))
    mentions = decomposed
    extra_attrs.extend((mentions[mi][2], a) for mi, a in pred_attrs)

    covered = [False] * n
    for s, e, _ in mentions:
        for k in range(s, e):
            covered[k] = True
    claimed_attr = [False] * n

    tuples: Set[Tuple[str, ...]] = set()
    for head, a in extra_attrs:
        tuples.add((head, a))

    for s, e, head in mentions:
        tuples.add((head,))
        # pre-nominal attribute: up to two uncovered preceding words
        for ln in (2, 1):
            if s - ln < 0:
                continue
            if any(covered[k] or claimed_attr[k] for k in range(s - ln, s)):
                continue
            span = toks[s - ln : s]
            if any(w in _ARTICLES for w in span):
                continue
            cand = " ".join(span)
            if cand in lex.attributes:
                tuples.add((head, cand))
                for k in range(s - ln, s):
                    claimed_attr[k] = True
                break

    for (s1, e1, h1), (s2, e2, h2) in zip(mentions, mentions[1:]):
        between = [
            toks[k]
            for k in range(e1, s2)
            if toks[k] not in _ARTICLES and not claimed_attr[k]
        ]
        if not between or len(between) > lex.max_phrase:
            continue
        rel = " ".join(between)
        if rel in lex.relations:
            tuples.add((h1, rel, h2))
    return tuples


def _match(
    a: Tuple[str, ...],
    b: Tuple[str, ...],
    syn: Optional[Callable[[str], frozenset]],
) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x == y:
            continue
        if syn is None or not (syn(x) & syn(y)):
            return False
    return True


def _prf(cand: Set[tuple], ref: Set[tuple], syn) -> Dict[str, float]:
    if not cand or not ref:
        return {"p": 0.0, "r": 0.0, "f": 0.0}
    matched = 0
    used: Set[tuple] = set()
    # sorted iteration: greedy matching over raw set order would make scores
    # depend on PYTHONHASHSEED when synonym matching creates many-to-many
    # match options (same captions, different SPICE across processes)
    for t in sorted(cand):
        for r in sorted(ref):
            if r not in used and _match(t, r, syn):
                used.add(r)
                matched += 1
                break
    p = matched / len(cand)
    r = matched / len(ref)
    f = 2 * p * r / (p + r) if (p + r) else 0.0
    return {"p": p, "r": r, "f": f}


def spice(
    candidates: Sequence[List[str]],
    references: Sequence[List[List[str]]],
    *,
    lexicon: Optional[SpiceLexicon] = None,
    synonyms: Optional[Callable[[str], frozenset]] = None,
) -> Tuple[float, List[dict]]:
    """Tuple-F1 over candidate vs MERGED reference scene graphs.

    `synonyms`: optional word -> frozenset-of-group-ids callable; tuple
    elements match when groups intersect (SPICE's WordNet synset matching).
    Returns (mean All-F over instances, per-instance category dicts).
    """
    lex = lexicon or SpiceLexicon.vendored()
    per: List[dict] = []
    for cand, refs in zip(candidates, references):
        ct = parse_scene_graph(cand, lex)
        rt: Set[tuple] = set()
        for r in refs:
            rt |= parse_scene_graph(r, lex)
        entry = {"All": _prf(ct, rt, synonyms)}
        for name, ln in (("Object", 1), ("Attribute", 2), ("Relation", 3)):
            entry[name] = _prf(
                {t for t in ct if len(t) == ln},
                {t for t in rt if len(t) == ln},
                synonyms,
            )
        per.append(entry)
    corpus = sum(e["All"]["f"] for e in per) / len(per) if per else 0.0
    return corpus, per
