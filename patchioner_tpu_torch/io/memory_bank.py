"""Support-memory bank files: HDF5 load and save, the filename scheme, and
bank building.

Twin of `patchioner_tpu/io/memory_bank.py`, format-compatible with the
reference's Im2TxtProjector banks (src/decap/im2txtprojection/
im2txtprojection.py): an HDF5 file with `{dataset}-embeddings` (f32 (M, D))
and `{dataset}-text` (utf-8 strings), named by the reference's
configuration-keyed scheme (:83-175, :320-323), so a bank file either
package writes loads in the other. DINO.txt banks keep columns [1024:]
(:405-406). h5py is imported only inside the functions that read or write
a file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["MemoryBank", "bank_filename", "load_bank", "save_bank", "build_bank",
           "load_caption_corpus", "PROJECTION_DATASETS"]

# ProjectionType enum values (reference :18-24) -> dataset names
PROJECTION_DATASETS = {
    "coco": "coco_captions",
    "coco_captions": "coco_captions",
    "msmarco": "ms_marco_queries_a",
    "ms_marco_queries_a": "ms_marco_queries_a",
    "blip": "cc3m_blip_captions",
    "cc3m_blip_captions": "cc3m_blip_captions",
    "vg": "vg_captions",
    "vg_captions": "vg_captions",
    "vg-test": "vg_dense_captions_test",
    "vg_dense_captions_test": "vg_dense_captions_test",
    "online_texts": "online_texts",
}


@dataclasses.dataclass
class MemoryBank:
    embeddings: np.ndarray  # (M, D) float32
    texts: list  # M strings

    def __len__(self):
        return len(self.embeddings)


def _dataset_name(projection_type: str) -> str:
    if projection_type in PROJECTION_DATASETS:
        return PROJECTION_DATASETS[projection_type]
    if os.path.exists(str(projection_type)):  # a caption corpus file
        base = os.path.basename(str(projection_type)).lower()
        for frag, name in (("karpathy", "coco_captions"), ("coco", "coco_captions"),
                           ("vg", "vg_captions"), ("marco", "ms_marco_queries_a")):
            if frag in base:
                return name
        return "coco_captions"
    return str(projection_type)


def bank_filename(projection_type: str, clip_modelname: Optional[str] = None,
                  support_memory_size: int = 500000, *, use_talk2dino: bool = True,
                  linear_talk2dino: bool = False, talk2dino_attn_type: str = "qkv",
                  use_open_clip: bool = False) -> tuple[str, str]:
    """The reference's bank filename and dataset name. `clip_modelname=None`
    resolves as the reference does (im2txtprojection.py:284-295):
    'ViT-B/16' under Talk2DINO, else 'ViT-B/32'."""
    if clip_modelname is None:
        clip_modelname = "ViT-B/16" if use_talk2dino else "ViT-B/32"
    if use_talk2dino:
        prefix = ""
        postfix = "-B16" if use_talk2dino is True else str(use_talk2dino)
        if linear_talk2dino:
            postfix += "-linear"
    else:
        prefix, postfix = "clip-", ""
    if use_open_clip:
        postfix += "-open_clip"
    attn = f"_{talk2dino_attn_type}" if talk2dino_attn_type != "qkv" else ""
    dataset = _dataset_name(projection_type)
    filename = (f"{prefix}{dataset}_text_embeddings{attn}{postfix}-"
                f"{clip_modelname.replace('/', '.')}-{support_memory_size}.h5")
    return filename, dataset


def load_bank(path: str, dataset: Optional[str] = None, *,
              dinotxt_slice: bool = False) -> Optional[MemoryBank]:
    """`{dataset}-embeddings` and `{dataset}-text` of an HDF5 bank;
    `dataset=None` finds the file's embeddings / text pair.

    None only for a missing file: a file without the bank's keys raises
    KeyError naming the keys it has. Zero-norm rows are dropped with their
    texts, as the reference drops them at load (im2txtprojection.py:345);
    the texts stay aligned with the rows."""
    import h5py

    if not os.path.exists(path):
        return None
    with h5py.File(path, "r") as hf:
        if dataset is None:
            cands = sorted(k[: -len("-embeddings")] for k in hf.keys()
                           if k.endswith("-embeddings")
                           and f"{k[: -len('-embeddings')]}-text" in hf)
            if not cands:
                raise KeyError(f"{path!r} exists but contains no "
                               f"'<dataset>-embeddings'/'<dataset>-text' pair "
                               f"(keys: {sorted(hf.keys())}): not a memory bank file")
            dataset = cands[0]
        ek, tk = f"{dataset}-embeddings", f"{dataset}-text"
        if ek not in hf or tk not in hf:
            raise KeyError(f"{path!r} has no {ek!r}/{tk!r} datasets "
                           f"(keys: {sorted(hf.keys())}); pass the matching dataset "
                           f"name or dataset=None to find it")
        emb = hf[ek][:]
        texts = [t.decode() if isinstance(t, bytes) else str(t) for t in hf[tk][:]]
    if dinotxt_slice:
        emb = emb[:, 1024:]
    emb = np.asarray(emb, np.float32)
    keep = np.linalg.norm(emb, axis=-1) != 0
    if not keep.all():
        emb = emb[keep]
        texts = [t for t, k in zip(texts, keep) if k]
    return MemoryBank(emb, texts)


def save_bank(path: str, dataset: str, bank: MemoryBank) -> None:
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as hf:
        hf.create_dataset(f"{dataset}-embeddings",
                          data=np.asarray(bank.embeddings, np.float32))
        hf.create_dataset(f"{dataset}-text", data=[t.encode("utf-8") for t in bank.texts],
                          dtype=h5py.string_dtype(encoding="utf-8"))


def load_caption_corpus(annotations_path: str, size: int, *, sample: bool = True,
                        seed: Optional[int] = None) -> list:
    """A COCO-format annotation JSON's captions: `size` of them drawn with
    `random.sample` (seeded by `seed`) as the reference does (:456), or the
    first `size` with `sample=False` (the VG corpora, :462, :469)."""
    with open(annotations_path) as f:
        data = json.load(f)
    anns = data["annotations"] if isinstance(data, dict) else data
    captions = [a["caption"] for a in anns]
    if size >= len(captions):
        return captions
    if sample:
        import random

        return random.Random(seed).sample(captions, k=size)
    return captions[:size]


def build_bank(texts: Sequence[str], encode_fn: Callable[[Sequence[str]], object], *,
               batch_size: int = 1000) -> MemoryBank:
    """Encode a caption corpus into a bank, `batch_size` texts a call of
    `encode_fn` (a CLIP text tower, then `talk2dino.project_clip_txt`),
    which returns an array or a tensor on any device."""
    chunks = []
    for i in range(0, len(texts), batch_size):
        out = encode_fn(list(texts[i: i + batch_size]))
        if hasattr(out, "detach"):
            out = out.detach().float().cpu().numpy()
        chunks.append(np.asarray(out))
    emb = np.concatenate(chunks, axis=0).astype(np.float32)
    if len(emb) != len(texts):
        raise ValueError(f"encode_fn gave {len(emb)} rows for {len(texts)} texts")
    return MemoryBank(emb, list(texts))
