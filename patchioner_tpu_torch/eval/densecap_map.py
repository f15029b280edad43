"""Dense-captioning mAP (METEOR x IoU thresholds).

Twin of `patchioner_tpu/eval/densecap_map.py`, which the port may not
import; the code is the same.

The reference delegates to an external `DenseCapEvaluator` module that is not
in its tree (eval-dense-captioning/eval_densecap_score_computation.py:39;
SURVEY §2.5). This implements the standard dense-captioning AP of
Johnson et al. (CVPR16): a prediction is a true positive at (iou_t, met_t)
when its box overlaps a ground-truth box with IoU > iou_t AND its caption's
METEOR against that ground truth exceeds met_t; AP is averaged over the
threshold grid.
"""

from __future__ import annotations

from typing import List, Sequence

from patchioner_tpu_torch.eval import metrics

__all__ = ["iou_xywh", "densecap_map"]

IOU_THRESHOLDS = (0.3, 0.4, 0.5, 0.6, 0.7)
METEOR_THRESHOLDS = (0.0, 0.05, 0.1, 0.15, 0.2, 0.25)


def iou_xywh(a: Sequence[float], b: Sequence[float]) -> float:
    ax1, ay1, aw, ah = a
    bx1, by1, bw, bh = b
    ax2, ay2 = ax1 + aw, ay1 + ah
    bx2, by2 = bx1 + bw, by1 + bh
    ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    iy = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = ix * iy
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def _average_precision(tp_flags: List[bool], num_gt: int) -> float:
    """AP over score-ranked predictions (standard 11-point-free integral)."""
    tp = 0
    precisions = []
    for i, flag in enumerate(tp_flags, 1):
        if flag:
            tp += 1
            precisions.append(tp / i)
    if num_gt == 0:
        return 0.0
    return sum(precisions) / num_gt


def densecap_map(
    predictions: Sequence[dict],
    ground_truths: Sequence[dict],
    *,
    iou_thresholds=IOU_THRESHOLDS,
    meteor_thresholds=METEOR_THRESHOLDS,
) -> dict:
    """Compute dense-cap mAP.

    predictions: [{image_id, bbox (xywh), caption, score}]
    ground_truths: [{image_id, bbox (xywh), caption}]
    """
    by_image_gt: dict = {}
    for gt in ground_truths:
        by_image_gt.setdefault(gt["image_id"], []).append(gt)

    ranked = sorted(predictions, key=lambda p: -p.get("score", 0.0))
    # Precompute per-prediction best-IoU gt and the METEOR against it.
    pred_info = []
    for p in ranked:
        gts = by_image_gt.get(p["image_id"], [])
        best_iou, best_gt = 0.0, None
        for g in gts:
            v = iou_xywh(p["bbox"], g["bbox"])
            if v > best_iou:
                best_iou, best_gt = v, g
        if best_gt is not None:
            _, per = metrics.meteor(
                [metrics.ptb_tokenize(p["caption"])],
                [[metrics.ptb_tokenize(best_gt["caption"])]],
            )
            met = per[0]
        else:
            met = 0.0
        pred_info.append((p, best_iou, best_gt, met))

    num_gt = len(ground_truths)
    aps = []
    ap_table = {}
    for iou_t in iou_thresholds:
        for met_t in meteor_thresholds:
            used = set()
            flags = []
            for p, best_iou, best_gt, met in pred_info:
                ok = (
                    best_gt is not None
                    and best_iou > iou_t
                    and met > met_t
                    and id(best_gt) not in used
                )
                if ok:
                    used.add(id(best_gt))
                flags.append(ok)
            ap = _average_precision(flags, num_gt)
            aps.append(ap)
            ap_table[(iou_t, met_t)] = ap
    return {"map": sum(aps) / len(aps) if aps else 0.0, "ap_table": ap_table}
