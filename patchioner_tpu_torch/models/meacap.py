"""MeaCap: ViECap with a hard prompt from a caption memory, in PyTorch.

Twin of `patchioner_tpu/models/meacap.py` (reference
src/meacap/entrypoint.py). The decode is ViECap's (the mapping network's
soft prompt, the hard prompt, GPT-2 greedy or beam search); the hard
prompt's concepts come from memory retrieval instead of an entity
vocabulary: the cosine of the image feature against the memory's caption
embeddings picks the top `memory_caption_num` (5) captions
(clip_utils.py:129-143), and a concept extractor distills them into at
most 4 concepts (detect_utils.py:20-43).

The retrieval runs on the model's device and copies the (B, k) indices
to the host once a batch; the concepts are host Python behind a
pluggable `concept_extractor`:
- `build_concept_extractor(parse_fn, encode_fn)`: the reference's merge
  (`models.meacap_concepts`) behind any parser and sentence encoder;
- `hf_concept_extractor`: that merge behind flan-T5 and SentenceBERT read
  from local files only (`transformers`, `sentence_transformers`);
- `frequency_concept_extractor`, the default: the most frequent words of
  the captions. It is not the reference's extractor; it keeps the model
  runnable without either checkpoint.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from patchioner_tpu_torch.models import meacap_concepts, viecap

__all__ = ["retrieve_memory_captions", "frequency_concept_extractor",
           "build_concept_extractor", "hf_concept_extractor", "MeaCap"]

_STOPWORDS = frozenset("""a an the of in on at to with and or is are was were be been being
    it its this that these those there here his her their our your my some any each for from
    by as into over under above below between during before after""".split())


@torch.no_grad()
def retrieve_memory_captions(image_features: torch.Tensor, memory_clip_embeddings: torch.Tensor,
                             k: int) -> np.ndarray:
    """(B, k) indices of the memory rows of highest cosine with each
    feature, both sides normalised, equal scores to the lower index first
    as `jax.lax.top_k` gives them (JAX meacap.py:52; reference
    entrypoint.py:151-163, whose logit scale does not change the order).
    One copy to the host."""
    sim = viecap._l2(image_features.float()) @ viecap._l2(memory_clip_embeddings.float()).T
    return viecap._top_k(sim, k)[1].cpu().numpy()


def frequency_concept_extractor(captions: Sequence[str], image_embeds=None,
                                max_concepts: int = 4) -> List[str]:
    """The most frequent words of the captions, stopwords and words under 3
    letters left out, ties in order of first appearance (JAX meacap.py:68).
    Not the reference's extractor: `hf_concept_extractor` is."""
    words = [w for cap in captions for w in re.findall(r"[a-z]+", cap.lower())
             if w not in _STOPWORDS and len(w) >= 3]
    counts = Counter(words)  # keys in order of first appearance
    return sorted(counts, key=lambda w: -counts[w])[:max_concepts]


def build_concept_extractor(parse_fn: Callable[[Sequence[str]], List[str]],
                            encode_fn: Callable[[Sequence[str]], np.ndarray],
                            max_concepts: int = 4) -> Callable:
    """A per-sample concept extractor over the reference's merge
    (`meacap_concepts.retrieve_concepts`; JAX meacap.py:86):
    `parse_fn(captions)` gives a scene-graph string a caption,
    `encode_fn(texts)` (N, D) sentence embeddings."""

    def extract(captions: Sequence[str], image_embeds=None) -> List[str]:
        return meacap_concepts.retrieve_concepts(captions, parse_fn, encode_fn, max_concepts)

    return extract


def _format_graph(text: str) -> str:
    """A parser output as the merge reads it: the prompt stripped, parens
    and commas spaced apart (parse_tool.py:255-292 `format_scene_graph`)."""
    text = text.replace("Generate Scene Graph:", "").strip()
    for mark in "(),":
        text = text.replace(mark, f" {mark} ")
    return " ".join(text.split())


def hf_concept_extractor(parser_checkpoint: str, wte_model_path: str, device: str = "cpu",
                         max_concepts: int = 4) -> Callable:
    """The reference's concept pipeline (detect_utils.py:20-43; JAX
    meacap.py:105): a flan-T5 scene-graph parser and a SentenceBERT encoder,
    read from local files only, in front of the merge. Without
    `transformers` or `sentence_transformers` it raises ImportError; it
    never falls back to another extractor."""
    from transformers import AutoModelForSeq2SeqLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(parser_checkpoint, local_files_only=True)
    # the parser on the inputs' device (src/meacap/viecap_inference.py:49)
    parser = AutoModelForSeq2SeqLM.from_pretrained(
        parser_checkpoint, local_files_only=True).eval().to(device)
    from sentence_transformers import SentenceTransformer

    wte = SentenceTransformer(wte_model_path, device=device)

    def parse_fn(captions: Sequence[str]) -> List[str]:
        enc = tok(["Generate Scene Graph: " + c for c in captions], max_length=128,
                  truncation=True, padding=True, return_tensors="pt")
        with torch.no_grad():
            out = parser.generate(enc["input_ids"].to(device),
                                  attention_mask=enc["attention_mask"].to(device),
                                  use_cache=True, decoder_start_token_id=tok.pad_token_id,
                                  num_beams=1, max_length=128, early_stopping=True)
        texts = tok.batch_decode(out, skip_special_tokens=True,
                                 clean_up_tokenization_spaces=True)
        return [_format_graph(t) for t in texts]

    def encode_fn(texts: Sequence[str]) -> np.ndarray:
        e = wte.encode(texts, convert_to_numpy=True)
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    return build_concept_extractor(parse_fn, encode_fn, max_concepts)


class MeaCap(viecap.VieCap):
    """ViECap whose hard prompt comes from the caption memory (JAX
    meacap.py:167; reference entrypoint.py:24-218): no entity vocabulary
    (a (1, 1) zero embedding), the memory's (N, D) caption embeddings on
    `device`."""

    def __init__(self, cfg: viecap.ViecapConfig, gpt2_cfg, gpt2_params: dict,
                 mapping_params: dict, memory_captions: Sequence[str], memory_clip_embeddings,
                 tokenizer, device, *, memory_caption_num: int = 5,
                 concept_extractor: Optional[Callable] = None):
        super().__init__(cfg, gpt2_cfg, gpt2_params, mapping_params, entities=[],
                         texts_embeddings=np.zeros((1, 1), np.float32), tokenizer=tokenizer,
                         device=device)
        self.memory_captions = list(memory_captions)
        self.memory_clip_embeddings = torch.as_tensor(memory_clip_embeddings).to(
            self.device, torch.float32)
        self.memory_caption_num = memory_caption_num
        self.concept_extractor = concept_extractor or frequency_concept_extractor

    def to(self, device) -> "MeaCap":
        """A copy on `device`: a MeaCap still (VieCap.to would build a
        VieCap, which retrieves entities)."""
        return MeaCap(self.cfg, self.gpt2_cfg, self.gpt2_params, self.mapping_params,
                      self.memory_captions, self.memory_clip_embeddings, self.tokenizer,
                      device, memory_caption_num=self.memory_caption_num,
                      concept_extractor=self.concept_extractor)

    @staticmethod
    def build_memory(captions: Sequence[str], clip_encode_fn, out_dir: str, *,
                     project_fn=None, wte_encode_fn=None, batch_size: int = 128) -> np.ndarray:
        """Write the files `load_memory` reads (JAX meacap.py:194; reference
        prepare_embeddings.py:60-133): `memory_captions.json` and
        `memory_clip_embeddings.pt`, the captions encoded by
        `clip_encode_fn(texts) -> (B, D)` `batch_size` at a time and mapped
        by `project_fn` where given (the reference's --use_t2d); with
        `wte_encode_fn` also `memory_wte_embeddings.pt`, each row
        normalised. Returns the (N, D) f32 embeddings."""
        captions = list(captions)
        clip_rows, wte_rows = [], []
        for lo in range(0, len(captions), batch_size):
            texts = captions[lo:lo + batch_size]
            emb = np.asarray(clip_encode_fn(texts), np.float32)
            clip_rows.append(emb if project_fn is None
                             else np.asarray(project_fn(emb), np.float32))
            if wte_encode_fn is not None:
                w = np.asarray(wte_encode_fn(texts), np.float32)
                wte_rows.append(w / np.linalg.norm(w, axis=-1, keepdims=True))
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "memory_captions.json"), "w") as f:
            json.dump(captions, f)
        clip_emb = np.concatenate(clip_rows, axis=0)
        torch.save(torch.from_numpy(clip_emb), os.path.join(out_dir, "memory_clip_embeddings.pt"))
        if wte_rows:
            torch.save(torch.from_numpy(np.concatenate(wte_rows, axis=0)),
                       os.path.join(out_dir, "memory_wte_embeddings.pt"))
        return clip_emb

    @classmethod
    def load_memory(cls, memory_base_path: str, memory_id: str):
        """(captions, (N, D) f32 CPU embeddings) from
        `{memory_base_path}/memory/{memory_id}/` (JAX meacap.py:244)."""
        base = os.path.join(memory_base_path, "memory", memory_id)
        with open(os.path.join(base, "memory_captions.json")) as f:
            captions = json.load(f)
        emb = torch.load(os.path.join(base, "memory_clip_embeddings.pt"), map_location="cpu",
                         weights_only=True)
        return captions, emb.float()

    def _hard_prompt_token_rows(self, f: torch.Tensor) -> List[List[int]]:
        """Each image's hard-prompt ids from the concepts of its retrieved
        captions (entrypoint.py:120-180); the extractor gets the image's own
        feature row."""
        idx = retrieve_memory_captions(f, self.memory_clip_embeddings, self.memory_caption_num)
        rows = []
        for i, row in enumerate(idx):
            concepts = self.concept_extractor([self.memory_captions[j] for j in row],
                                              image_embeds=f[i])
            rows.append(self.tokenizer.encode(viecap.compose_discrete_prompt(concepts)))
        return rows
