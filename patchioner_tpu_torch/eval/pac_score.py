"""CLIP-S / PAC-S / RefPAC-S on the port's CLIP towers.

Twin of `patchioner_tpu/eval/pac_score.py` (reference
pacsMetric/pac_score.py). PAC-S = w * max(0, cos(image, candidate)) with a
PAC-finetuned CLIP ViT-B/32 (w = 2.0); CLIP-S is the same formula with
stock CLIP and w = 2.5 (compute_scores.py:166-256); RefPAC-S is each
candidate's largest cosine against its reference captions. Every caption
encoded, candidate and reference alike, carries the prompt
'A photo depicts ' (pac_score.py:11-15).

`ClipScorer` runs `clip.clip_text_forward` and `clip.clip_visual_forward`
on its device (the card unless asked for the CPU), its towers' weights
cast there to f32; the scores are numpy arithmetic on the host, as in the
JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models import clip, vit
from patchioner_tpu_torch.text import clip_bpe

__all__ = ["ClipScorer", "pac_score", "ref_pac_score", "cached_image_features", "PAC_PROMPT"]

PAC_PROMPT = "A photo depicts "


def _norm(x: np.ndarray) -> np.ndarray:
    return x / np.sqrt(np.sum(x ** 2, axis=-1, keepdims=True))


class ClipScorer:
    """Batched text and image features from the port's CLIP towers on
    `device`, as numpy f32 arrays."""

    def __init__(self, vision_params: dict, text_params: dict,
                 vision_cfg: clip.ClipVisionConfig, text_cfg: clip.ClipTextConfig,
                 tokenizer=None, device="cuda"):
        self.device = entry.resolve_device(device)
        self.vision_params = vit.cast_params(vision_params, torch.float32, self.device)
        self.text_params = vit.cast_params(text_params, torch.float32, self.device)
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg
        self.tokenizer = tokenizer or clip_bpe.get_tokenizer()

    def encode_texts(self, texts: Sequence[str], batch_size: int = 256,
                     prompt: str = "") -> np.ndarray:
        """(N, proj) features of `prompt + text`, tokenized at context 77."""
        out = []
        for i in range(0, len(texts), batch_size):
            toks = self.tokenizer.tokenize([prompt + t for t in texts[i:i + batch_size]], 77)
            out.append(clip.clip_text_forward(self.text_params, torch.from_numpy(toks),
                                              self.text_cfg).float().cpu().numpy())
        return np.concatenate(out, axis=0)

    def encode_images(self, pixels, batch_size: int = 64) -> np.ndarray:
        """(N, H, W, 3) normalised pixels -> (N, proj) projected CLS tokens."""
        out = []
        for i in range(0, len(pixels), batch_size):
            chunk = torch.as_tensor(np.asarray(pixels[i:i + batch_size])).to(self.device)
            feats = clip.clip_visual_forward(self.vision_params, chunk,
                                             self.vision_cfg)["x_norm_clstoken"]
            out.append(feats.float().cpu().numpy())
        return np.concatenate(out, axis=0)


def pac_score(scorer: Optional[ClipScorer], image_features: np.ndarray,
              candidates: Sequence[str], w: float = 2.0, prompt: str = PAC_PROMPT,
              candidate_features: Optional[np.ndarray] = None):
    """w * max(0, cos) per candidate (pac_score.py:77-92): (the mean, the
    per-candidate scores, the unit candidate features, each candidate's
    word count). The candidates are encoded by `scorer` unless their
    features are given."""
    if candidate_features is None:
        candidate_features = scorer.encode_texts(list(candidates), prompt=prompt)
    img = _norm(np.asarray(image_features))
    cand = _norm(candidate_features)
    per = w * np.clip(np.sum(img * cand, axis=1), 0, None)
    return float(np.mean(per)), per, cand, [len(c.split()) for c in candidates]


def ref_pac_score(scorer: Optional[ClipScorer], references: Sequence[Sequence[str]],
                  candidate_features: np.ndarray, prompt: str = PAC_PROMPT):
    """Each candidate's largest cosine against its own references
    (pac_score.py:175-210), 0 for a candidate without references: (the
    mean, the per-candidate scores)."""
    flat: List[str] = []
    idxs: List[int] = []
    for i, refs in enumerate(references):
        flat.extend(refs)
        idxs.extend([i] * len(refs))
    ref_feats = _norm(scorer.encode_texts(flat, prompt=prompt))
    cand = _norm(np.asarray(candidate_features))
    idx_arr = np.asarray(idxs, np.int64)
    sims = np.sum(ref_feats * cand[idx_arr], axis=1)
    per = np.full(len(candidate_features), -np.inf)
    np.maximum.at(per, idx_arr, sims)  # the segment max, one pass
    per[~np.isfinite(per)] = 0.0
    return float(np.mean(per)), per


def cached_image_features(scorer: ClipScorer, image_ids: Sequence[str], load_pixels,
                          cache_path: Optional[str] = None, batch_size: int = 64) -> np.ndarray:
    """Image features with an HDF5 cache keyed by image id (the reference
    extracts CLIP-S image features once, compute_scores.py:166-256).
    `load_pixels(ids) -> (B, H, W, 3)` runs for the misses only. Without
    `cache_path`, or when the cache cannot be used (no h5py, a corrupt or
    locked file), everything is computed in memory with a RuntimeWarning."""
    ids = [str(i) for i in image_ids]
    feats: dict = {}
    h5 = None
    if cache_path is not None:
        try:
            import h5py

            h5 = h5py.File(cache_path, "a")
            for k in ids:
                if k in h5:
                    feats[k] = np.asarray(h5[k])
        except Exception as e:  # the cache is an optimisation, never a reason to stop
            import warnings

            warnings.warn(f"image-feature cache {cache_path} unusable ({type(e).__name__}: {e}); "
                          "computing in memory", RuntimeWarning, stacklevel=2)
            if h5 is not None:
                try:
                    h5.close()
                except Exception:
                    pass
            h5 = None
    try:
        missing = [k for k in ids if k not in feats]
        for i in range(0, len(missing), batch_size):
            chunk = missing[i:i + batch_size]
            for k, f in zip(chunk, scorer.encode_images(load_pixels(chunk),
                                                        batch_size=batch_size)):
                feats[k] = f
                if h5 is not None and k not in h5:
                    h5.create_dataset(k, data=f)
    finally:
        if h5 is not None:
            h5.close()
    return np.stack([feats[k] for k in ids])
