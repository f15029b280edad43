"""Region-set captioning evaluation (COCO / Flickr30k Entities).

Twin of `patchioner_tpu/eval/region_set_captioning.py`. Reference: eval-region-set-captioning/eval_region_set_captioning.py.
Annotation schema: ``{image_id: {caption: [xyxy boxes...]}}`` — one caption
per *set* of regions (:200-229, boxes converted xyxy -> xywh). Pads region
sets with ``[-1, -1, -1, -1]`` dummies (:267-269 — detected and skipped by
the controllable-captioning merge), and captions each set with
``get_controllable_capts=True``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from patchioner_tpu_torch.eval import harness
from patchioner_tpu_torch.utils import geometry, transforms

__all__ = ["load_region_set_dataset", "evaluate", "compute_scores"]

DUMMY_BOX = [-1, -1, -1, -1]


def load_region_set_dataset(annotations_path: str, image_roots) -> dict:
    with open(annotations_path) as f:
        test_set = json.load(f)
    if isinstance(image_roots, str):
        image_roots = [image_roots]
    samples = {"gt_captions": [], "img_paths": [], "bboxes": []}
    for img_id, obj in test_set.items():
        if "coco" in os.path.basename(annotations_path):
            img_id = img_id.zfill(12)
        path = harness.resolve_image_path(image_roots, f"{img_id}.jpg")
        for caption, boxes in obj.items():
            xywh = [[b[0], b[1], b[2] - b[0], b[3] - b[1]] for b in boxes]
            samples["gt_captions"].append(caption)
            samples["img_paths"].append(path)
            samples["bboxes"].append(xywh)
    return samples


def evaluate(
    model,
    annotations_path: str,
    image_roots,
    *,
    batch_size: int = 8,
    use_gaussian_weighting: bool = False,
    gaussian_variance: float = 0.5,
    keep_img_ratio: bool = True,
    use_attn_map_for_bboxes: bool = False,
    caption_from: str = "patches",
    limit: Optional[int] = None,
    out_path: Optional[str] = None,
    loader=None,
) -> dict:
    # The reference supports exactly two values: 'patches' (controllable
    # region-set caption) and 'cls' (whole-image baseline) — anything else
    # sets get_cls_capt=False yet reads outs['cls_capt'], a latent KeyError
    # (eval_region_set_captioning.py:287,345). Validate up front so the
    # fused and fallback paths can't diverge on an unsupported value.
    if caption_from not in ("patches", "cls"):
        raise ValueError(
            f"caption_from must be 'patches' or 'cls', got {caption_from!r}"
        )
    samples = load_region_set_dataset(annotations_path, image_roots)
    n = len(samples["img_paths"])
    if limit:
        n = min(n, limit)
    timer = harness.PhaseTimer()
    preds = []

    if loader is None:
        from PIL import Image

        def _load_one(p):
            img = Image.open(p).convert("RGB")
            return (
                # uint8 to the device (4x less link traffic); normalized
                # on the device (Patchioner._pixels)
                transforms.preprocess_pil_uint8(
                    img, model.resize_dim, model.crop_dim,
                    crop=keep_img_ratio,
                ),
                img.size,
            )

        loader = harness.parallel_image_loader(
            _load_one,
            collate=lambda items: (np.stack([i[0] for i in items]),
                                   [i[1] for i in items]),
        )

    batches = list(harness.batched(list(range(n)), batch_size))
    loaded = harness.prefetch(
        batches,
        lambda b: loader([samples["img_paths"][i] for i in b[1]]),
        depth=2,
    )
    # fused path: pad every batch's box sets to the RUN max, so that every
    # batch has the same shapes
    run_max_boxes = (
        max((len(samples["bboxes"][i]) for i in range(n)), default=1) or 1
        if (hasattr(model, "supports_fused_trace_path")
            and model.supports_fused_trace_path())
        else None
    )
    for bi, batch_idx in batches:
        with timer.phase("preprocessing"):
            imgs, sizes = next(loaded)
            box_sets = [samples["bboxes"][i] for i in batch_idx]
            n_max = run_max_boxes or max(map(len, box_sets))
            adjusted = []
            for boxes, (w, h) in zip(box_sets, sizes):
                if keep_img_ratio:
                    adj = [
                        geometry.adjust_bbox_for_transform(
                            w, h, b, model.resize_dim, model.crop_dim
                        )
                        for b in boxes
                    ]
                else:
                    adj = [
                        geometry.adjust_bbox_for_transform_no_scale(
                            w, h, b, model.resize_dim, model.resize_dim
                        )
                        for b in boxes
                    ]
                adj += [DUMMY_BOX] * (n_max - len(adj))
                adjusted.append(adj)
        with timer.phase("inference"):
            # caption_from != 'patches' is the reference's cls baseline: the
            # whole-image caption stands in for the region-set caption
            # (eval_region_set_captioning.py:323,345).
            fused_ok = (hasattr(model, "supports_fused_trace_path")
                        and model.supports_fused_trace_path())
            if caption_from == "patches" and fused_ok:
                # fused fast path — same captions as forward, one step
                preds.extend(model.caption_region_sets_fused(
                    imgs, np.asarray(adjusted, np.float32),
                    gaussian_avg=use_gaussian_weighting,
                    gaussian_bbox_variance=gaussian_variance,
                    use_attn_map_for_bboxes=use_attn_map_for_bboxes,
                ))
            elif caption_from != "patches" and fused_ok:
                preds.extend(model.caption_images_fused(
                    imgs, caption_from="cls"
                ))
            else:
                outs = model.forward(
                    imgs,
                    get_cls_capt=caption_from == "cls",
                    bboxes=np.asarray(adjusted, np.float32),
                    gaussian_avg=use_gaussian_weighting,
                    gaussian_bbox_variance=gaussian_variance,
                    get_controllable_capts=True,
                    use_attn_map_for_bboxes=use_attn_map_for_bboxes,
                )
                preds.extend(
                    outs["set_controllable_capts"]
                    if caption_from == "patches" else outs["cls_capt"]
                )

    records = [
        {
            "img_path": samples["img_paths"][i],
            "gt": samples["gt_captions"][i],
            "pred": preds[i].strip(" ."),
            "bboxes": samples["bboxes"][i],
        }
        for i in range(len(preds))
    ]
    result = {
        "predictions": records,
        "timing": harness.timing_summary(timer, len(records)),
    }
    if out_path:
        harness.write_predictions(out_path, records)
    return result


def compute_scores(result: dict, *, csv_path=None, config_row=None) -> dict:
    cands = [r["pred"] for r in result["predictions"]]
    refs = [[r["gt"]] for r in result["predictions"]]
    return harness.score_and_log(
        cands, refs, csv_path=csv_path, config_row=config_row
    )
