"""Trace-captioning evaluation (Localized Narratives style).

Twin of `patchioner_tpu/eval/trace_captioning.py` (reference
eval-trace-captioning/eval_trace_captioning.py). Annotation schema:
``{image_id: {"captions": [...], "traces": [...]}}`` where each trace is a
flat list of ``{"x", "y"}`` points in [0, 1] (:187-211). Each (caption,
trace) pair is one sample; the model captions the trace-conditioned patch
aggregate; scores come from the caption-metric family plus CLIP-S/PAC-S.

The prefetch worker stages each batch on the model's device
(`harness.stage_to_device`: pinned memory, a side stream, waited for)
before handing it over, so the upload stays out of the timed inference
phase; a staging failure raises.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

from patchioner_tpu_torch.eval import harness
from patchioner_tpu_torch.models.patchioner import trace_arrays
from patchioner_tpu_torch.utils import transforms

__all__ = ["merge_annotation_parts", "load_trace_dataset", "evaluate",
           "compute_scores"]


def merge_annotation_parts(part_paths, out_path: Optional[str] = None) -> dict:
    """Merge split annotation JSONs ({image_id: {...}} dicts) into one.

    The reference ships the LN-COCO trace annotations as two parts (GitHub
    file-size limit) and merges them with a throwaway script
    (eval-trace-captioning/coco_data_merge_parts.py: {**part1, **part2} ->
    trace_capt_coco_test.json). Later parts win on duplicate image ids,
    matching dict-merge semantics. Writes `out_path` when given."""
    merged: dict = {}
    for p in part_paths:
        with open(p) as f:
            merged.update(json.load(f))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged


def load_trace_dataset(annotations_path, image_roots) -> dict:
    """-> {'gt_captions': [...], 'img_paths': [...], 'traces': [...]}

    `annotations_path` may be a list/tuple of part files (merged via
    `merge_annotation_parts`)."""
    if isinstance(annotations_path, (list, tuple)):
        test_set = merge_annotation_parts(annotations_path)
        annotations_path = annotations_path[0]
    else:
        with open(annotations_path) as f:
            test_set = json.load(f)
    if isinstance(image_roots, str):
        image_roots = [image_roots]
    samples = {"gt_captions": [], "img_paths": [], "traces": []}
    for img_id, obj in test_set.items():
        if "coco" in os.path.basename(annotations_path):
            img_id = img_id.zfill(12)
        path = harness.resolve_image_path(image_roots, f"{img_id}.jpg")
        for capt, trace in zip(obj["captions"], obj["traces"]):
            samples["gt_captions"].append(capt)
            samples["img_paths"].append(path)
            samples["traces"].append(trace)
    return samples


def evaluate(
    model,
    annotations_path: str,
    image_roots,
    *,
    batch_size: int = 16,
    caption_from: str = "trace",  # 'trace' | 'cls'
    use_attention_weighting: bool = False,
    use_gaussian_weighting: bool = False,
    gaussian_variance: float = 1.0,
    limit: Optional[int] = None,
    out_path: Optional[str] = None,
    measure_flops: bool = False,
    loader=None,
) -> dict:
    """Run the model over every (image, trace) sample.

    `loader(paths) -> (B, H, W, 3) array` overrides image loading (tests
    inject synthetic pixels)."""
    if caption_from == "patches":
        # the reference spells the trace-conditioned mode 'patches'
        # (eval_trace_captioning.py:123,144: anything != 'patches' is the
        # CLS baseline) — the shipped grids use that spelling
        caption_from = "trace"
    samples = load_trace_dataset(annotations_path, image_roots)
    n = len(samples["img_paths"])
    if limit is not None:
        n = min(n, limit)
    timer = harness.PhaseTimer()
    preds = []
    flops = None

    if loader is None:
        from PIL import Image

        # uint8 to the device (4x less link traffic), normalized on the
        # device (Patchioner._pixels handles uint8 batches)
        loader = harness.parallel_image_loader(
            lambda p: transforms.preprocess_pil_uint8(
                Image.open(p), model.resize_dim, model.crop_dim
            )
        )
    idxs = list(range(n))

    # Fused fast path: the whole trace-caption math as one step
    # (Patchioner.caption_traces_fused) instead of forward's several —
    # identical tokens. Every batch's traces are padded to the dataset max,
    # so every batch has the same shapes.
    use_fused = (
        caption_from == "trace"
        and not use_gaussian_weighting
        and hasattr(model, "supports_fused_trace_path")
        and model.supports_fused_trace_path()
    )
    max_pts = max((len(samples["traces"][i]) for i in idxs), default=1) or 1

    def load_batch(batch):
        _, batch_idx = batch
        imgs = loader([samples["img_paths"][i] for i in batch_idx])
        traces = [samples["traces"][i] for i in batch_idx]
        extra = trace_arrays(traces, max_points=max_pts) if use_fused else None
        # upload IN THE PREFETCH WORKER, so that it overlaps the previous
        # batch's compute and lands outside the timed inference phase;
        # stage_to_device waits for it, and raises when it fails
        staged = harness.stage_to_device([imgs] + list(extra or ()), model.device)
        return staged[0], traces, (tuple(staged[1:]) if use_fused else None)

    batches = list(harness.batched(idxs, batch_size))
    # two workers: a batch's decode and the previous batch's upload overlap
    loaded = harness.prefetch(batches, load_batch, depth=3, workers=2)
    for bi, batch_idx in batches:
        with timer.phase("preprocessing"):
            # with prefetch, this measures pipeline STALL (host behind
            # device), not total host decode work
            imgs, traces, extra = next(loaded)
        with timer.phase("inference"):
            if use_fused:
                pts, valid = extra
                preds.extend(model.caption_traces_fused(
                    imgs, pts, valid,
                    use_attention_tracing=use_attention_weighting,
                ))
            else:
                outs = model.forward(
                    imgs,
                    get_cls_capt=caption_from == "cls",
                    traces=traces if caption_from == "trace" else None,
                    use_attention_tracing=use_attention_weighting,
                    gaussian_avg=use_gaussian_weighting,
                    gaussian_img_variance=gaussian_variance,
                )
                preds.extend(
                    outs["cls_capt"] if caption_from == "cls"
                    else outs["trace_capts"]
                )
        if measure_flops and bi == 0:
            # the encoder's products on the plain path (a kernel launched
            # through ctypes is invisible to torch's counter)
            flops = harness.encoder_flops(model, imgs)

    result = {
        "predictions": [
            {
                "img_path": samples["img_paths"][i],
                "gt": samples["gt_captions"][i],
                "pred": preds[i].strip(" ."),  # :466 postprocessing
            }
            for i in range(len(preds))
        ],
        "timing": harness.timing_summary(timer, len(preds)),
        "flops_per_image": flops,
    }
    if out_path:
        harness.write_predictions(out_path, result["predictions"])
        with open(out_path.replace(".json", "_enhanced.pkl"), "wb") as f:
            pickle.dump(result["timing"], f)
    return result


def compute_scores(
    result: dict,
    *,
    csv_path: Optional[str] = None,
    config_row: Optional[dict] = None,
    pac_scorer=None,
    image_features=None,
) -> dict:
    """Caption metrics (+ optional CLIP-S/PAC-S/RefPAC-S when a scorer and
    image features are supplied); appends a config-keyed CSV row.

    For reference parity, `image_features` should come from images with
    the trace points drawn on them (`utils.drawing.draw_trace_points`;
    reference compute_scores.py:24-49 renders before feature extraction).
    """
    cands = [p["pred"] for p in result["predictions"]]
    refs = [[p["gt"]] for p in result["predictions"]]
    extra_scores = {}
    if pac_scorer is not None and image_features is not None:
        from patchioner_tpu_torch.eval import pac_score as ps

        mean_pac, _, cand_feats, lens = ps.pac_score(
            pac_scorer, image_features, cands, w=2.0
        )
        extra_scores["PAC-S"] = mean_pac
        mean_ref, _ = ps.ref_pac_score(pac_scorer, refs, cand_feats)
        extra_scores["RefPAC-S"] = mean_ref
    timing = result.get("timing") or {}
    extra_row = {}
    if timing.get("images_per_sec_inference"):
        extra_row["images_per_sec_inference"] = (
            f"{timing['images_per_sec_inference']:.3f}"
        )
    return harness.score_and_log(
        cands, refs, csv_path=csv_path, config_row=config_row,
        extra_scores=extra_scores, extra_row=extra_row,
    )
