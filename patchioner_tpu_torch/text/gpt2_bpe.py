"""GPT-2 byte-level BPE tokenizer, host side.

Twin of `patchioner_tpu/text/gpt2_bpe.py`: ViECap (and later MeaCap and
ClipCap) encode their hard prompts and decode their captions with GPT-2's
50,257-token vocabulary. The vocabulary is learned data (`vocab.json` +
`merges.txt`) that the repository does not hold, so this module holds the
algorithm (the byte -> unicode table, GPT-2's pre-tokenisation pattern,
the lowest-rank merge loop, the byte-join decode) and loads the two files
from explicit paths (`Gpt2Tokenizer.from_files`), from `$GPT2_BPE_DIR`,
or from the Hugging Face cache layout (`load_gpt2_tokenizer`). Over the
same files it gives the ids of the JAX package's tokenizer
(tests/test_torch_gpt2_bpe.py).

The pre-tokeniser uses the `regex` module's unicode classes when it is
installed and ASCII classes otherwise; the two split ASCII text the same.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterable, List, Optional, Sequence

from patchioner_tpu_torch.text.clip_bpe import _byte_unicode_table

try:  # full unicode classes when the `regex` module is present
    import regex as _re

    _WORD_PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
        r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
except ImportError:  # pragma: no cover - ASCII classes, the same on English
    import re as _re

    _WORD_PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+|"""
        r""" ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+""")

__all__ = ["Gpt2Tokenizer", "load_gpt2_tokenizer", "ENDOFTEXT"]

ENDOFTEXT = "<|endoftext|>"


class Gpt2Tokenizer:
    """encode / decode with GPT-2's byte-level BPE over a vocabulary and its
    merges."""

    pad_token_id = None

    def __init__(self, vocab: dict, merges: Sequence[tuple]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self._ranks = {tuple(m): i for i, m in enumerate(merges)}
        self._b2u = _byte_unicode_table()
        self._u2b = {u: b for b, u in self._b2u.items()}
        self._cache: dict = {}
        self.eos_token_id = self.encoder.get(ENDOFTEXT)
        self.vocab_size = len(self.encoder)

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "Gpt2Tokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#version") and len(line.split()) == 2]
        return cls(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        """Merge the lowest-ranked adjacent pair until none is ranked."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            best = min(zip(parts[:-1], parts[1:]),
                       key=lambda p: self._ranks.get(p, 1 << 30))
            if best not in self._ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _WORD_PAT.findall(text):
            mapped = "".join(self._b2u[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytes(self._u2b[c] for c in text if c in self._u2b)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}


def _hf_cache_candidates() -> List[str]:
    """Snapshot directories of the Hugging Face cache's GPT-2, under the
    legacy repo id `gpt2` and the canonical `openai-community/gpt2`."""
    home = os.path.expanduser("~")
    roots = [os.environ.get("HF_HOME", os.path.join(home, ".cache", "huggingface")),
             os.path.join(home, ".cache", "huggingface")]
    dirs = []
    for root in roots:
        for repo in ("models--gpt2", "models--openai-community--gpt2"):
            dirs.extend(glob.glob(os.path.join(root, "hub", repo, "snapshots", "*")))
    return dirs


def load_gpt2_tokenizer(directory: Optional[str] = None) -> Optional[Gpt2Tokenizer]:
    """The tokenizer of the first of `directory`, `$GPT2_BPE_DIR` and the
    Hugging Face cache that holds vocab.json + merges.txt (Hugging Face's
    names) or encoder.json + vocab.bpe (OpenAI's); None when none does."""
    search = [directory] if directory else []
    if os.environ.get("GPT2_BPE_DIR"):
        search.append(os.environ["GPT2_BPE_DIR"])
    search.extend(_hf_cache_candidates())
    for d in search:
        for vocab_name, merges_name in (("vocab.json", "merges.txt"),
                                        ("encoder.json", "vocab.bpe")):
            v, m = os.path.join(d, vocab_name), os.path.join(d, merges_name)
            if os.path.exists(v) and os.path.exists(m):
                return Gpt2Tokenizer.from_files(v, m)
    return None
