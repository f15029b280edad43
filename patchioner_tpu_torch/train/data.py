"""Text-only training datasets for decoder training.

Twin of `patchioner_tpu/train/data.py` (reference src/dataset.py,
ClipCocoDataset, and src/datasetMix.py, ClipCocoDatasetMix), in numpy.
Captions are CLIP-BPE tokenized with the port's `text/clip_bpe.py`; the
"Mix" variant pairs a caption's tokens with the embedding of another
caption of the same image. The same corpus and seed give the same token
arrays, batch order and mix indices as the JAX module.
"""

from __future__ import annotations

import json
import random
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from patchioner_tpu_torch.text import clip_bpe

__all__ = ["CaptionDataset", "load_coco_captions", "batch_iterator",
           "caption_lengths"]


def load_coco_captions(path: str) -> Tuple[List[str], List[int]]:
    """COCO caption JSON -> (captions, image_ids). Also accepts a plain
    JSON list whose entries are annotation dicts or bare caption strings."""
    with open(path) as f:
        data = json.load(f)
    anns = data["annotations"] if isinstance(data, dict) else data
    captions, image_ids = [], []
    for i, a in enumerate(anns):
        if isinstance(a, str):
            captions.append(a)
            image_ids.append(i)
        else:
            captions.append(a["caption"])
            image_ids.append(a.get("image_id", i))
    return captions, image_ids


def caption_lengths(tokens) -> np.ndarray:
    """True per-row token counts: first EOT position + 1 when present, else
    the full row (a truncated caption whose EOT was cut), 0 for an empty
    row. A nonzero count would miscount a caption holding the genuine
    token id 0 (CLIP BPE '!' without </w>)."""
    tokens = np.asarray(tokens)
    is_eot = tokens == clip_bpe.EOT_TOKEN
    has_eot = is_eot.any(axis=1)
    nonempty = (tokens != 0).any(axis=1)
    return np.where(
        has_eot, np.argmax(is_eot, axis=1) + 1,
        np.where(nonempty, tokens.shape[1], 0),
    ).astype(np.int64)


class CaptionDataset:
    """Pre-tokenized caption corpus.

    tokens: (N, T) int32, [SOT] ids [EOT] 0-padded (padding id 0 is the CE
    ignore_index, as in the reference loss).
    """

    def __init__(
        self,
        captions: Sequence[str],
        image_ids: Optional[Sequence[int]] = None,
        max_len: int = 20,
        tokenizer=None,
    ):
        """max_len defaults to the reference's max_seq_len, 20. A caption is
        tokenized at the native 77 and its first max_len columns kept, as
        pad_tokens slices (dataset.py:22-24): a too-long caption keeps its
        max_len-th token and gets no EOT."""
        self.captions = list(captions)
        self.image_ids = list(image_ids) if image_ids is not None else list(
            range(len(captions))
        )
        full_len = max(int(max_len), 77)
        tokenizer = tokenizer or clip_bpe.get_tokenizer()
        self.tokens = np.asarray(tokenizer.tokenize(self.captions, full_len))[:, :max_len]
        self._by_image: dict = {}
        for i, img in enumerate(self.image_ids):
            self._by_image.setdefault(img, []).append(i)

    def __len__(self):
        return len(self.captions)

    def mix_indices(self, rng: random.Random) -> np.ndarray:
        """For each caption, the index of a caption of the same image drawn
        uniformly, itself included (src/datasetMix.py:49)."""
        out = np.arange(len(self.captions))
        for img, idxs in self._by_image.items():
            for i in idxs:
                out[i] = rng.choice(idxs)
        return out


def batch_iterator(
    n: int,
    batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
) -> Iterator[np.ndarray]:
    """Index batches with optional sharding (DistributedSampler's
    semantics, reference decoderTraining.py:259-260): shards are padded by
    wrapping to equal length."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if shuffle else np.arange(n)
    if num_shards > 1:
        total = -(-len(order) // num_shards) * num_shards
        order = np.resize(order, total)
        order = order[shard_index::num_shards]
    end = (len(order) // batch_size) * batch_size if drop_remainder else len(order)
    for i in range(0, end, batch_size):
        yield order[i : i + batch_size]
