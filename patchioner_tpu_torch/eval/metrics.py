"""Caption metrics: BLEU-1..4, METEOR (4-stage), ROUGE-L, CIDEr-D, SPICE.

Twin of `patchioner_tpu/eval/metrics.py`, which the port may not
import; the code is the same.

The reference scores through `speaksee` (Java PTBTokenizer + the
pycocoevalcap scorer family, eval-trace-captioning/compute_scores.py:287-332).
This is a dependency-free reimplementation of those scorers' published
algorithms:

  * `ptb_tokenize` approximates Stanford PTBTokenizer's caption behavior
    (lowercase, strip punctuation, split) — identical on the alphanumeric
    captions these benchmarks use.
  * BLEU: corpus-level with closest-reference brevity penalty.
  * ROUGE-L: F_beta (beta=1.2) of the LCS, max over references, averaged.
  * CIDEr-D: tf-idf n-gram cosine (n=1..4) with length-gaussian damping
    (sigma=6) and the min-count clipping, x10 — the pycocoevalcap formulation.
  * METEOR implements all four METEOR-1.5 English stages (exact / stem /
    synonym / paraphrase at weights 1.0/0.6/0.8/0.6; alpha=0.9, gamma=0.5,
    beta=3 fragmentation penalty) with a greedy aligner. Synonym and
    paraphrase stages take pluggable resource tables (`load_wordnet_synonyms`
    when nltk corpora exist) and are inert without them.
  * SPICE: scene-graph tuple F1 (lexicon-parser variant, `eval/spice.py`).

All scorers return (corpus_score, per_instance_scores).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "ptb_tokenize",
    "bleu",
    "rouge_l",
    "cider_d",
    "meteor",
    "load_wordnet_synonyms",
    "compute_all_metrics",
    "variant_markers",
]

_PUNCT = re.compile(r"[^\w\s]")
_WS = re.compile(r"\s+")


def ptb_tokenize(text: str) -> List[str]:
    text = _PUNCT.sub(" ", text.lower())
    return _WS.sub(" ", text).strip().split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# -------------------------------------------------------------------- BLEU


def bleu(
    candidates: Sequence[List[str]],
    references: Sequence[List[List[str]]],
    max_n: int = 4,
) -> Tuple[List[float], List[List[float]]]:
    """Corpus BLEU-1..4. Returns ([bleu1..bleu4], per-instance sentence bleu
    computed with the same formula per image)."""

    # The reference scores through speaksee's vendored pycocoevalcap
    # bleu_scorer (eval_image_captioning_compute_scores.py:59): every
    # precision ratio is smoothed as (correct + tiny)/(guess + small) with
    # tiny=1e-15, small=1e-9 (so a zero-match order yields a tiny-positive
    # score, not a hard 0), and brevity applies whenever
    # (testlen + tiny)/(reflen + small) < 1 — which INCLUDES testlen ==
    # reflen. Both quirks reproduced literally; 'closest' reflen option.
    tiny, small = 1e-15, 1e-9

    def stats(cand, refs):
        clipped = []
        totals = []
        for n in range(1, max_n + 1):
            cg = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                rg = _ngrams(r, n)
                for g, c in rg.items():
                    max_ref[g] = max(max_ref[g], c)
            clipped.append(sum(min(c, max_ref[g]) for g, c in cg.items()))
            totals.append(max(sum(cg.values()), 0))
        # closest reference length
        lc = len(cand)
        lr = min((abs(len(r) - lc), len(r)) for r in refs)[1] if refs else 0
        return clipped, totals, lc, lr

    def smoothed(correct, guess, testlen, reflen):
        out = []
        b = 1.0
        for n in range(max_n):
            b *= (correct[n] + tiny) / (guess[n] + small)
            out.append(b ** (1.0 / (n + 1)))
        ratio = (testlen + tiny) / (reflen + small)
        if ratio < 1:
            out = [v * math.exp(1 - 1 / ratio) for v in out]
        return out

    agg_c = [0] * max_n
    agg_t = [0] * max_n
    agg_lc = agg_lr = 0
    per_instance: List[List[float]] = []
    for cand, refs in zip(candidates, references):
        c, t, lc, lr = stats(cand, refs)
        for n in range(max_n):
            agg_c[n] += c[n]
            agg_t[n] += t[n]
        agg_lc += lc
        agg_lr += lr
        per_instance.append(smoothed(c, t, lc, lr))

    return smoothed(agg_c, agg_t, agg_lc, agg_lr), per_instance


# ----------------------------------------------------------------- ROUGE-L


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(
    candidates: Sequence[List[str]],
    references: Sequence[List[List[str]]],
    beta: float = 1.2,
) -> Tuple[float, List[float]]:
    """pycocoevalcap ROUGE-L (rouge.py calc_score): the max LCS precision
    and max LCS recall are taken SEPARATELY over the references (possibly
    from different references) and then combined into F_beta — not the max
    per-reference F. Pinned against a literal transcription of that formula
    in tests/test_metric_reference_parity.py (a round-2 version of this
    scorer used max-F and deviated)."""
    scores = []
    for cand, refs in zip(candidates, references):
        prec_max = rec_max = 0.0
        for r in refs:
            lcs = _lcs_len(cand, r)
            if lcs == 0:
                continue
            prec_max = max(prec_max, lcs / len(cand) if cand else 0.0)
            rec_max = max(rec_max, lcs / len(r) if r else 0.0)
        if prec_max and rec_max:
            f = ((1 + beta**2) * prec_max * rec_max) / (
                rec_max + beta**2 * prec_max
            )
        else:
            f = 0.0
        scores.append(f)
    return (sum(scores) / len(scores) if scores else 0.0), scores


# ----------------------------------------------------------------- CIDEr-D


def cider_d(
    candidates: Sequence[List[str]],
    references: Sequence[List[List[str]]],
    n_max: int = 4,
    sigma: float = 6.0,
) -> Tuple[float, List[float]]:
    """pycocoevalcap CIDEr-D: per-n tf-idf vectors, min-clipped dot with the
    reference vector, length-gaussian damping, averaged over refs and n, x10."""
    num_images = len(references)
    doc_freq: Dict[tuple, int] = defaultdict(int)
    ref_counts = []
    for refs in references:
        seen = set()
        per_ref = []
        for r in refs:
            cnts = Counter()
            for n in range(1, n_max + 1):
                cnts.update(_ngrams(r, n))
            per_ref.append(cnts)
            seen |= set(cnts)
        ref_counts.append(per_ref)
        for g in seen:
            doc_freq[g] += 1
    log_n = math.log(max(num_images, 1))

    def to_vec(cnts: Counter):
        vec = [defaultdict(float) for _ in range(n_max)]
        norm = [0.0] * n_max
        length = 0
        for g, tf in cnts.items():
            idf = log_n - math.log(max(1.0, doc_freq[g]))
            n = len(g) - 1
            vec[n][g] = tf * idf
            norm[n] += vec[n][g] ** 2
            if n == 0:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    scores = []
    for cand, per_ref in zip(candidates, ref_counts):
        c_cnts = Counter()
        for n in range(1, n_max + 1):
            c_cnts.update(_ngrams(cand, n))
        cv, cn, cl = to_vec(c_cnts)
        img_score = 0.0
        for r_cnts in per_ref:
            rv, rn, rl = to_vec(r_cnts)
            delta = float(cl - rl)
            sim_total = 0.0
            for n in range(n_max):
                num = sum(min(cv[n][g], rv[n][g]) * rv[n][g] for g in cv[n])
                if cn[n] and rn[n]:
                    val = num / (cn[n] * rn[n])
                else:
                    val = 0.0
                val *= math.exp(-(delta**2) / (2 * sigma**2))
                sim_total += val
            img_score += sim_total / n_max
        scores.append(10.0 * img_score / max(len(per_ref), 1))
    return (sum(scores) / len(scores) if scores else 0.0), scores


# ------------------------------------------------------------------ METEOR


def load_wordnet_synonyms():
    """Word -> frozenset(synset names) via nltk WordNet, or None when the
    corpus data is not installed (nltk's code without its corpora gives
    None too). Pass the result as `meteor(..., synonyms=...)` /
    `spice(..., synonyms=...)`."""
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("test")  # force corpus load
    except Exception:
        return None

    @lru_cache(maxsize=65536)
    def groups(word: str) -> frozenset:
        return frozenset(s.name() for s in wordnet.synsets(word))

    return groups


def meteor(
    candidates: Sequence[List[str]],
    references: Sequence[List[List[str]]],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
    stem_weight: float = 0.6,
    synonyms=None,
    synonym_weight: float = 0.8,
    paraphrases=None,
    paraphrase_weight: float = 0.6,
    max_paraphrase_len: int = 4,
) -> Tuple[float, List[float]]:
    """METEOR-1.5 scoring with all four English match stages.

    The reference scores METEOR with the Java METEOR-1.5 jar (speaksee,
    used by its eval-*-captioning pipelines), whose English config runs
    exact, stem, synonym and paraphrase modules with weights
    (1.0, 0.6, 0.8, 0.6). The aligner here follows METEOR-1.5's own
    procedure: a beam search over match selections with the lexicographic
    objective (maximize covered words, then minimize chunks, then minimize
    the total |i-j| distance between match start positions — the Java
    aligner's published tie-break — then maximize weighted match mass for
    determinism); tests pin it against an exhaustive-search oracle of the
    same objective (tests/test_metric_reference_parity.py — a round-2
    greedy aligner under-scored vs this objective).

      * exact / stem (Porter) / synonym: word-level. `synonyms` is a
        word -> frozenset-of-group-ids callable (see
        `load_wordnet_synonyms`); words match when groups intersect. A
        word pair matching several modules scores the FIRST module in
        METEOR's stage order (exact > stem > synonym) — the Java scorer
        applies matchers sequentially, each matching only what earlier
        stages left, so a pair that both stems equal and shares a synset
        scores stem_weight (0.6), not synonym_weight (0.8).
      * paraphrase: span-level over contiguous spans up to
        `max_paraphrase_len` words. `paraphrases` maps a phrase string to a
        frozenset of group ids; spans match when groups intersect.

    Synonym/paraphrase stages are inert when their tables are None (the
    resource files are external data this environment lacks) — scores then
    equal the exact+stem configuration.

    Precision/recall use the weighted match mass per side; the
    fragmentation penalty uses unweighted matched-word counts, as in
    METEOR-1.5.
    """
    from patchioner_tpu_torch.text.porter import stem as _stem

    beam_width = 64

    def align(cand, ref):
        # ---- match candidates: i -> [(lc, j, lr, weight)] --------------
        options: Dict[int, list] = defaultdict(dict)
        cs = [_stem(w) for w in cand] if stem_weight > 0.0 else None
        rs = [_stem(r) for r in ref] if stem_weight > 0.0 else None
        sc = ([synonyms(w) or None for w in cand]
              if synonyms is not None and synonym_weight > 0.0 else None)
        sr = ([synonyms(r) or None for r in ref]
              if synonyms is not None and synonym_weight > 0.0 else None)
        for i in range(len(cand)):
            for j in range(len(ref)):
                w = 0.0
                if cand[i] == ref[j]:
                    w = 1.0
                elif cs is not None and cs[i] == rs[j]:
                    w = stem_weight
                elif (sc is not None and sc[i] is not None
                      and sr[j] is not None and (sc[i] & sr[j])):
                    w = synonym_weight
                if w > 0.0:
                    options[i][(1, j, 1)] = w
        if paraphrases is not None and paraphrase_weight > 0.0:
            for i in range(len(cand)):
                for lc in range(1, min(max_paraphrase_len,
                                       len(cand) - i) + 1):
                    gc = paraphrases(" ".join(cand[i : i + lc]))
                    if not gc:
                        continue
                    for j in range(len(ref)):
                        for lr in range(1, min(max_paraphrase_len,
                                               len(ref) - j) + 1):
                            gr = paraphrases(" ".join(ref[j : j + lr]))
                            if gr and (gc & gr):
                                key = (lc, j, lr)
                                if options[i].get(key, 0.0) < paraphrase_weight:
                                    options[i][key] = paraphrase_weight

        # ---- beam search over candidate positions ----------------------
        # state: (next_i, covered, -chunks, -total |i-j| match-start
        #         distance, wmass_c, wmass_r, covered_r, ref_used frozenset,
        #         last match end (i_end, j_end))
        states = [(0, 0, 0, 0, 0.0, 0.0, 0, frozenset(), None)]
        final = []
        while states:
            new = []
            for st in states:
                ni, cov, nch, nd, wc, wr, covr, used, last = st
                if ni >= len(cand):
                    final.append(st)
                    continue
                # skip position ni
                new.append((ni + 1, cov, nch, nd, wc, wr, covr, used, last))
                for (lc, j, lr), w in options.get(ni, {}).items():
                    span = frozenset(range(j, j + lr))
                    if used & span:
                        continue
                    contiguous = last is not None and last == (ni, j)
                    new.append((
                        ni + lc,
                        cov + lc,
                        nch - (0 if contiguous else 1),
                        nd - abs(ni - j),
                        wc + w * lc,
                        wr + w * lr,
                        covr + lr,
                        used | span,
                        (ni + lc, j + lr),
                    ))
            # prune — METEOR's alignment objective: max covered words, min
            # chunks, min total match-start distance (the Java aligner's
            # published tie-break), then weighted mass for determinism
            new.sort(key=lambda s: (s[1], s[2], s[3], s[4]), reverse=True)
            states = new[:beam_width]
            if all(s[0] >= len(cand) for s in states):
                final.extend(states)
                break
        if not final:
            return 0.0
        best = max(final, key=lambda s: (s[1], s[2], s[3], s[4]))
        _, cov, nch, nd, wc, wr, covr, _, _ = best
        if cov == 0:
            return 0.0
        chunks = -nch
        p = wc / len(cand)
        r = wr / len(ref)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        # METEOR-1.5 fragmentation divides chunks by the AVERAGE of matched
        # words on the two sides (Meteor Stats: (testMatches+refMatches)/2)
        # — with exact/stem stages every match is 1:1 (cov == covr), but a
        # paraphrase span match of unequal lengths makes the sides differ.
        penalty = gamma * (chunks / ((cov + covr) / 2.0)) ** beta
        return fmean * (1 - penalty)

    scores = []
    for cand, refs in zip(candidates, references):
        scores.append(max((align(cand, r) for r in refs), default=0.0))
    return (sum(scores) / len(scores) if scores else 0.0), scores


# ------------------------------------------------------------------- suite


def compute_all_metrics(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    *,
    spice: bool = True,
    synonyms="auto",
    paraphrases=None,
) -> dict:
    """Tokenize and run the full scorer family. Returns
    {metric: (corpus, per_instance)} using the reference results-CSV metric
    names (compute_scores.py:308-357): Bleu_1..Bleu_4, METEOR, ROUGE_L,
    CIDEr, SPICE.

    `spice=True` scores the lexicon-variant SPICE (see `eval/spice.py` —
    same tuple-F1 metric, lexicon parser instead of the Java/Stanford
    pipeline; per-instance values here are the All-F floats).
    `synonyms="auto"` picks up nltk WordNet when its corpus is installed
    (absent without nltk corpora -> the METEOR synonym stage is inert and
    SPICE matches exactly)."""
    cand_t = [ptb_tokenize(c) for c in candidates]
    refs_t = [[ptb_tokenize(r) for r in refs] for refs in references]
    if synonyms == "auto":
        synonyms = load_wordnet_synonyms()
    b, b_inst = bleu(cand_t, refs_t)
    r, r_inst = rouge_l(cand_t, refs_t)
    c, c_inst = cider_d(cand_t, refs_t)
    m, m_inst = meteor(cand_t, refs_t, synonyms=synonyms,
                       paraphrases=paraphrases)
    out = {
        "Bleu_1": (b[0], [x[0] for x in b_inst]),
        "Bleu_2": (b[1], [x[1] for x in b_inst]),
        "Bleu_3": (b[2], [x[2] for x in b_inst]),
        "Bleu_4": (b[3], [x[3] for x in b_inst]),
        "ROUGE_L": (r, r_inst),
        "CIDEr": (c, c_inst),
        "METEOR": (m, m_inst),
    }
    if spice:
        from patchioner_tpu_torch.eval import spice as spice_mod

        s, s_inst = spice_mod.spice(cand_t, refs_t, synonyms=synonyms)
        out["SPICE"] = (s, [e["All"]["f"] for e in s_inst])
    return out


def variant_markers(synonyms="auto") -> dict:
    """CSV markers naming the METEOR/SPICE variant that `compute_all_metrics`
    actually ran — "auto" silently changes values when an nltk WordNet corpus
    is installed, so result rows from different machines must carry these to
    stay comparable (SPICE is additionally the lexicon-parser variant, not
    the Java/Stanford scorer — see eval/spice.py)."""
    if synonyms == "auto":
        synonyms = load_wordnet_synonyms()
    stage = "exact+stem" if synonyms is None else "exact+stem+synonym"
    return {"METEOR_variant": stage, "SPICE_variant": f"lexicon/{stage}"}
