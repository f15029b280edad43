"""The port's GPT-2 byte-level BPE (`patchioner_tpu_torch.text.gpt2_bpe`)
against the JAX package's and against transformers' GPT-2 tokenizer, over
one synthetic vocabulary trained with the `tokenizers` library (the real
50,257-token files are not in the repository): ids equal, decodes equal,
the loader's search order equal. The ASCII pre-tokenisation pattern, which
a machine without the `regex` module takes, splits ASCII text as the
unicode one does."""

import json
import os
import re

import pytest

from patchioner_tpu.text import gpt2_bpe as jbpe
from patchioner_tpu_torch.text import gpt2_bpe

SAMPLES = [
    "Hello world!",
    "The quick brown fox jumps over 1234 lazy dogs.",
    "it's they're we'll I'd you've can't",
    "  leading spaces and   multiple   gaps ",
    "naïve café — emoji 🙂 and CJK 汉字 mix",
    "newline\nand\ttab",
    "There are person, dog, surfboard in image.",
    "",
    "a",
    " .",
]
ASCII = [s for s in SAMPLES if s.isascii()] + [
    "There are something in image.", "a man riding a wave on top of a surfboard .",
    "x1,y2;z3 -- (paren) [bracket] 99% $5 #tag @at ~tilde"]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    from tokenizers import ByteLevelBPETokenizer

    corpus = ["the quick brown fox jumps over the lazy dog",
              "there are person, dog, cat in image.",
              "they're running over 1234 fields with naïve café charm",
              "a photo of a dog sitting on a wooden table 🙂 汉字"] * 50
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(corpus, vocab_size=600, min_frequency=1,
                            special_tokens=["<|endoftext|>"])
    d = tmp_path_factory.mktemp("gpt2bpe")
    tok.save_model(str(d))
    return str(d)


@pytest.fixture(scope="module")
def pair(vocab_dir):
    files = (os.path.join(vocab_dir, "vocab.json"), os.path.join(vocab_dir, "merges.txt"))
    return gpt2_bpe.Gpt2Tokenizer.from_files(*files), jbpe.Gpt2Tokenizer.from_files(*files)


@pytest.mark.parametrize("text", SAMPLES)
def test_encode_and_decode_equal_jax(pair, text):
    port, ref = pair
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.decode(ids) == ref.decode(ids) == text
    assert port(text) == {"input_ids": ids}


def test_ids_equal_transformers_gpt2_tokenizer(pair, vocab_dir):
    from transformers import GPT2TokenizerFast

    hf = GPT2TokenizerFast(vocab_file=os.path.join(vocab_dir, "vocab.json"),
                           merges_file=os.path.join(vocab_dir, "merges.txt"))
    port, _ = pair
    for text in SAMPLES:
        assert port.encode(text) == hf(text)["input_ids"], text


def test_vocabulary_attributes_equal_jax(pair):
    port, ref = pair
    assert port.eos_token_id == ref.eos_token_id == port.encoder[gpt2_bpe.ENDOFTEXT]
    assert port.vocab_size == ref.vocab_size and port.pad_token_id is None


def test_ascii_pattern_splits_ascii_text_as_the_unicode_one():
    ascii_pat = re.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+|"""
                           r""" ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+""")
    for text in ASCII:
        assert ascii_pat.findall(text) == gpt2_bpe._WORD_PAT.findall(text), text


def _write(directory, tok, names):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, names[0]), "w", encoding="utf-8") as f:
        json.dump(tok.encoder, f)
    merges = sorted(tok._ranks.items(), key=lambda kv: kv[1])
    with open(os.path.join(directory, names[1]), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for (a, b), _ in merges))


@pytest.mark.parametrize("where", ["argument", "GPT2_BPE_DIR", "hf cache", "openai names"])
def test_loader_finds_the_files_as_jax_does(pair, tmp_path, monkeypatch, where):
    port, _ = pair
    monkeypatch.delenv("GPT2_BPE_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    names = ("encoder.json", "vocab.bpe") if where == "openai names" else (
        "vocab.json", "merges.txt")
    d = str(tmp_path / "files")
    if where == "hf cache":
        d = str(tmp_path / "hf" / "hub" / "models--openai-community--gpt2" / "snapshots" / "abc")
    _write(d, port, names)
    arg = d if where in ("argument", "openai names") else None
    if where == "GPT2_BPE_DIR":
        monkeypatch.setenv("GPT2_BPE_DIR", d)
    got, want = gpt2_bpe.load_gpt2_tokenizer(arg), jbpe.load_gpt2_tokenizer(arg)
    assert got is not None and want is not None
    for text in SAMPLES:
        assert got.encode(text) == want.encode(text) == port.encode(text)


def test_loader_returns_none_without_files(tmp_path, monkeypatch):
    monkeypatch.delenv("GPT2_BPE_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert gpt2_bpe.load_gpt2_tokenizer() is None
    assert gpt2_bpe.load_gpt2_tokenizer(str(tmp_path)) is None
