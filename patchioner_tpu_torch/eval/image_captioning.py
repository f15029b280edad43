"""Whole-image captioning evaluation (COCO-Karpathy / Flickr30k test).

Twin of `patchioner_tpu/eval/image_captioning.py`. Reference: eval-image-captioning/eval_image_captioning.py. COCO-format
annotations; `caption_from` selects the query embedding: 'cls',
'avg_self_attn', or 'patches' (Gaussian-weighted whole-grid mean,
:288-319). References for scoring are each image's caption annotations.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from patchioner_tpu_torch.eval import harness
from patchioner_tpu_torch.io.coco import CocoAnnotations
from patchioner_tpu_torch.utils import transforms

__all__ = ["evaluate", "compute_scores"]

_OUT_KEYS = {
    "cls": "cls_capt",
    "avg_self_attn": "avg_self_attn_capt",
    "patches": "avg_patch_capt",
}


def evaluate(
    model,
    annotations_path: str,
    image_roots,
    *,
    batch_size: int = 16,
    caption_from: str = "cls",
    use_gaussian_weighting: bool = False,
    gaussian_variance: float = 1.0,
    limit: Optional[int] = None,
    out_path: Optional[str] = None,
    loader=None,
) -> dict:
    if caption_from not in _OUT_KEYS:
        raise ValueError(f"caption_from must be one of {sorted(_OUT_KEYS)}")
    coco = CocoAnnotations(annotations_path)
    image_ids = coco.image_ids
    if limit:
        image_ids = image_ids[:limit]
    if isinstance(image_roots, str):
        image_roots = [image_roots]

    if loader is None:
        from PIL import Image

        def _load_one(info):
            path = harness.resolve_image_path(image_roots, info["file_name"])
            # uint8 to the device (4x less link traffic); the model
            # normalizes on the device (Patchioner._pixels)
            return transforms.preprocess_pil_uint8(
                Image.open(path), model.resize_dim, model.crop_dim
            )

        loader = harness.parallel_image_loader(_load_one)

    timer = harness.PhaseTimer()
    records = []
    batches = list(harness.batched(image_ids, batch_size))
    def _load_batch(b):
        # one source of truth for the batch's metadata: the prefetch fn
        # returns (infos, imgs) so the loop body doesn't re-look-up infos
        infos = coco.load_imgs(list(b[1]))
        return infos, loader(infos)

    loaded = harness.prefetch(batches, _load_batch, depth=2)
    for bi, batch_ids in batches:
        with timer.phase("preprocessing"):
            # with prefetch this measures pipeline stall, not decode work
            infos, imgs = next(loaded)
        with timer.phase("inference"):
            if (caption_from in ("cls", "avg_self_attn", "patches")
                    and hasattr(model, "supports_fused_trace_path")
                    and model.supports_fused_trace_path()):
                # fused fast path — same captions as forward, one step
                capts = model.caption_images_fused(
                    imgs, caption_from=caption_from,
                    gaussian_img_variance=gaussian_variance,
                )
            else:
                outs = model.forward(
                    imgs,
                    get_cls_capt=caption_from == "cls",
                    get_avg_self_attn_capt=caption_from == "avg_self_attn",
                    get_avg_patch_capt=caption_from == "patches",
                    gaussian_avg=use_gaussian_weighting,
                    gaussian_img_variance=gaussian_variance,
                )
                capts = outs[_OUT_KEYS[caption_from]]
        for info, capt in zip(infos, capts):
            refs = [a["caption"] for a in coco.img_to_anns[info["id"]]]
            records.append(
                {
                    "image_id": info["id"],
                    "file_name": info["file_name"],
                    "pred": capt.strip(" ."),
                    "refs": refs,
                }
            )
    result = {
        "predictions": records,
        "timing": harness.timing_summary(timer, len(records)),
    }
    if out_path:
        harness.write_predictions(out_path, records)
    return result


def compute_scores(result: dict, *, csv_path=None, config_row=None) -> dict:
    cands = [r["pred"] for r in result["predictions"]]
    refs = [r["refs"] for r in result["predictions"]]
    return harness.score_and_log(
        cands, refs, csv_path=csv_path, config_row=config_row
    )
