"""Annotation rendering for CLIP-S/PAC-S reference images.

Twin of `patchioner_tpu/utils/drawing.py`, which the port may not
import; the code is the same.

The reference scores trace and region-set captioning against images with
the query annotations drawn on them: semi-transparent trace dots
(eval-trace-captioning/compute_scores.py:24-49) and red bounding boxes
(src/bbox_utils.py:253-298, used via
eval-region-set-captioning/compute_scores.py:165-168). These are the
host-side equivalents; feed the rendered images to
`eval.pac_score.PacScorer.encode_images`.
"""

from __future__ import annotations

import itertools
from typing import Sequence

__all__ = ["draw_trace_points", "draw_bounding_boxes"]


def _point_xy(p):
    if isinstance(p, dict):
        return float(p["x"]), float(p["y"])
    return float(p[0]), float(p[1])


def draw_trace_points(
    img,
    traces: Sequence,
    point_color=(255, 0, 0),
    point_size: int = 3,
    alpha: int = 122,
):
    """Composite semi-transparent dots at normalized trace points.

    Matches the reference renderer (compute_scores.py:24-49): points are
    {'x','y'} dicts (bare pairs accepted) in [0, 1]; out-of-range points
    are skipped; dots are alpha-composited ellipses of `point_size` px
    radius. Returns a new RGB PIL image.
    """
    from PIL import Image, ImageDraw

    base = img.convert("RGBA")
    overlay = Image.new("RGBA", base.size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(overlay)
    width, height = base.size
    rgba = tuple(point_color) + (alpha,)
    for p in traces:
        x, y = _point_xy(p)
        if 0 <= x <= 1 and 0 <= y <= 1:
            ax, ay = int(x * width), int(y * height)
            draw.ellipse(
                (ax - point_size, ay - point_size,
                 ax + point_size, ay + point_size),
                fill=rgba, outline=rgba,
            )
    return Image.alpha_composite(base, overlay).convert("RGB")


def draw_bounding_boxes(
    img,
    bounding_boxes: Sequence,
    captions: Sequence[str] = ("",),
    color: str = "red",
    width: int = 2,
    text_background: bool = True,
):
    """Draw pixel-space xyxy boxes (+ optional caption labels).

    Matches src/bbox_utils.py:253-298: rectangles of `width` px in
    `color`; non-empty captions are drawn at the box corner over a white
    background when `text_background`. Returns a new PIL image (the
    input is not modified).
    """
    from PIL import ImageDraw

    out = img.copy()
    draw = ImageDraw.Draw(out)
    for bbox, cap in itertools.zip_longest(bounding_boxes, captions,
                                           fillvalue=""):
        if bbox == "":
            continue
        x1, y1, x2, y2 = [float(v) for v in bbox]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=width)
        if cap:
            if text_background:
                l, t, r, b = draw.multiline_textbbox((x1, y1), cap)
                draw.rectangle((l - 5, t - 5, r + 5, b + 5), fill="white")
            draw.multiline_text((x1, y1), cap, fill=color)
    return out
