"""Dense (bbox) captioning evaluation — VG1.2 / VG-COCO / RefCOCOg style.

Twin of `patchioner_tpu/eval/dense_captioning.py`. Reference: eval-dense-captioning/eval_densecap.py. COCO-format annotations
whose `bbox` field is stored xyxy (converted to xywh at :303-310, degenerate
boxes widened by one pixel); per-image box lists padded with dummy
``[0, 0, 1, 1]`` boxes to the batch max (:327-333); captions come from
patch aggregation (default), cls/avg-self-attn of crops, or crop-captioning;
predictions emit COCO format with per-annotation captions + scores
(:467-486). Dense-cap mAP (METEOR x IoU) is computed by
`eval/densecap_map.py` over the matched boxes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from patchioner_tpu_torch.eval import harness
from patchioner_tpu_torch.io.coco import CocoAnnotations
from patchioner_tpu_torch.utils import geometry, transforms

__all__ = ["evaluate"]

DUMMY_BOX = [0, 0, 1, 1]


def _normalize_xyxy(bbox, image_id):
    """Stored-xyxy -> xywh with the reference's degenerate handling
    (eval_densecap.py:302-310): zero-extent boxes widened by one pixel,
    inverted boxes are an error — both eval variants must score the
    identical annotation set."""
    x1, y1, x2, y2 = bbox
    if x1 == x2:
        x2 += 1
    if y1 == y2:
        y2 += 1
    if x2 - x1 <= 0 or y2 - y1 <= 0:
        raise ValueError(
            f"Invalid bounding box {bbox} for image {image_id}"
        )
    return [x1, y1, x2 - x1, y2 - y1]


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
    compute_scores: bool = False,
    caption_bboxes_type: Optional[str] = None,
    caption_from: str = "patches",
    limit: Optional[int] = None,
    out_path: Optional[str] = None,
    loader=None,
    pil_loader=None,
) -> dict:
    coco = CocoAnnotations(annotations_path)
    image_ids = coco.image_ids
    if limit:
        image_ids = image_ids[:limit]
    if isinstance(image_roots, str):
        image_roots = [image_roots]

    timer = harness.PhaseTimer()
    predictions = {
        "images": [],
        "annotations": [],
        "categories": [{"id": 1, "name": "dense_caption"}],
    }
    seen_image_ids: set = set()  # O(1) image-record dedup (VG is ~90k images)
    annotation_id = 1

    def open_rgb(info):
        from PIL import Image

        path = harness.resolve_image_path(image_roots, info["file_name"])
        img = Image.open(path)
        return img.convert("RGB") if img.mode != "RGB" else img

    def _load_one(info):
        img = open_rgb(info)
        return (
            # uint8 to the device (4x less link traffic); normalized on
            # the device (Patchioner._pixels)
            transforms.preprocess_pil_uint8(
                img, model.resize_dim, model.crop_dim, crop=keep_img_ratio
            ),
            img.size,
        )

    loader = loader or harness.parallel_image_loader(
        _load_one,
        collate=lambda items: (np.stack([i[0] for i in items]),
                               [i[1] for i in items]),
    )
    pil_loader = pil_loader or (lambda infos: [open_rgb(i) for i in infos])

    use_fused = (
        caption_bboxes_type is None
        and caption_from not in ("cls", "avg_self_attn")
        and not compute_scores
        and hasattr(model, "supports_fused_trace_path")
        and model.supports_fused_trace_path()
    )
    # fused path: pad every batch's box list to the RUN max, so that every
    # batch projects and decodes the same row count (one decode graph on
    # the card, as the reference pads to keep one compiled program)
    run_max_boxes = max(
        (len(coco.img_to_anns[i]) for i in image_ids), default=1
    ) or 1

    for bi, batch_ids in harness.batched(image_ids, batch_size):
        with timer.phase("preprocessing"):
            infos = coco.load_imgs(list(batch_ids))
            imgs, sizes = loader(infos)
            adjusted, raw_anns = [], []
            for info, (w, h) in zip(infos, sizes):
                per_img, anns = [], []
                for ann in coco.img_to_anns[info["id"]]:
                    # stored xyxy (:303)
                    bbox = _normalize_xyxy(ann["bbox"], info["id"])
                    if keep_img_ratio:
                        adj = geometry.adjust_bbox_for_transform(
                            w, h, bbox, model.resize_dim, model.crop_dim
                        )
                    else:
                        adj = geometry.adjust_bbox_for_transform_no_scale(
                            w, h, bbox, model.resize_dim, model.resize_dim
                        )
                    per_img.append(adj)
                    anns.append(ann)
                adjusted.append(per_img)
                raw_anns.append(anns)
                if info["id"] not in seen_image_ids:
                    seen_image_ids.add(info["id"])
                    predictions["images"].append(
                        {"id": info["id"], "file_name": info["file_name"]}
                    )
            # max(..., 1): a batch whose images ALL have zero annotations
            # would otherwise collapse np.asarray to shape (B, 0) — the box
            # dim vanishes and forward's (B, NB, 4) indexing crashes; one
            # dummy box keeps the rank, emitting no annotation rows
            max_len = run_max_boxes if use_fused else max(
                (len(b) for b in adjusted), default=0
            ) or 1
            for b in adjusted:
                b.extend([DUMMY_BOX] * (max_len - len(b)))
            bboxes = np.asarray(adjusted, np.float32)

        with timer.phase("inference"):
            if caption_bboxes_type is not None:
                # crop-and-caption baseline (reference eval_densecap.py:429
                # "Variant B" -> src/model.py:1356-1390): PIL-crop each RAW
                # box from the original image, caption the crops with
                # cls/avg-self-attn. Raw xywh boxes — crops come from the
                # untransformed image, so no coordinate remap.
                raw_boxes = [
                    [_normalize_xyxy(a["bbox"], a["image_id"])
                     for a in anns_i]
                    for anns_i in raw_anns
                ]
                # `or 1`: same (B, 0) rank-collapse guard as above
                max_raw = max((len(b) for b in raw_boxes), default=0) or 1
                for b in raw_boxes:
                    b.extend([[0, 0, 1, 1]] * (max_raw - len(b)))
                outs = model.caption_bboxes(
                    pil_loader(infos), np.asarray(raw_boxes, np.float32),
                    capt_type=caption_bboxes_type, crop_boxes=True,
                    compute_scores=compute_scores,
                )
            elif caption_from in ("cls", "avg_self_attn"):
                # whole-image caption assigned to every box — the reference's
                # cls/avg-self-attn dense baseline (eval_densecap.py:431-435)
                w_outs = model.forward(
                    imgs,
                    get_cls_capt=caption_from == "cls",
                    get_avg_self_attn_capt=caption_from == "avg_self_attn",
                    compute_scores=compute_scores,
                )
                key = f"{caption_from}_capt"
                n_b = bboxes.shape[1]
                outs = {"bbox_capts": [[c] * n_b for c in w_outs[key]]}
                if compute_scores:
                    outs["bbox_scores"] = [
                        [s] * n_b for s in w_outs[f"{key}_scores"]
                    ]
            elif use_fused:
                # Fused fast path: the whole bbox-caption math as one step
                # (Patchioner.caption_bboxes_fused) — identical captions to
                # forward(bboxes=...), one projection and one decode of the
                # B * NB rows per batch (NB fixed across the run).
                outs = {"bbox_capts": model.caption_bboxes_fused(
                    imgs, bboxes,
                    gaussian_avg=use_gaussian_weighting,
                    gaussian_bbox_variance=gaussian_variance,
                    use_attn_map_for_bboxes=use_attn_map_for_bboxes,
                )}
            else:
                outs = model.forward(
                    imgs,
                    get_cls_capt=False,
                    bboxes=bboxes,
                    gaussian_avg=use_gaussian_weighting,
                    gaussian_bbox_variance=gaussian_variance,
                    use_attn_map_for_bboxes=use_attn_map_for_bboxes,
                    compute_scores=compute_scores,
                )

        for i, anns in enumerate(raw_anns):
            capts = outs["bbox_capts"][i]
            scores = outs["bbox_scores"][i] if compute_scores else None
            for j, ann in enumerate(anns):  # padded tail ignored
                predictions["annotations"].append(
                    {
                        "id": annotation_id,
                        "image_id": ann["image_id"],
                        # COCO records are xywh (the reference converts its
                        # stored-xyxy at eval_densecap.py:303-310); the mAP
                        # evaluator (densecap_map.iou_xywh) expects xywh too
                        "bbox": _normalize_xyxy(ann["bbox"], ann["image_id"]),
                        "caption": capts[j].strip(" ."),
                        "score": float(scores[j]) if scores else 1.0,
                        "category_id": 1,
                        "gt_caption": ann.get("caption"),
                    }
                )
                annotation_id += 1

    result = {
        "predictions": predictions,
        "timing": harness.timing_summary(timer, len(predictions["annotations"])),
    }
    if out_path:
        harness.write_predictions(out_path, predictions)
    return result
