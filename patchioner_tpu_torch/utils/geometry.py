"""Host-side bbox coordinate remapping for the eval pipelines.

Twin of `patchioner_tpu/utils/geometry.py`, which the port may not
import; the code is the same.

Reference: src/bbox_utils.py:170-250 — maps annotation-space boxes
[x1, y1, w, h] into the model's resized(+center-cropped) pixel space.
"""

from __future__ import annotations

__all__ = ["adjust_bbox_for_transform", "adjust_bbox_for_transform_no_scale"]


def adjust_bbox_for_transform(orig_width, orig_height, bbox, resize_dim, crop_dim):
    """Resize-shorter-side + center-crop remap (src/bbox_utils.py:170-218),
    including its exact clamping behavior."""
    x1, y1, w, h = bbox
    if orig_width < orig_height:
        scale_w = resize_dim / orig_width
        scale_h = (resize_dim * orig_height) / orig_width / orig_height
    else:
        scale_h = resize_dim / orig_height
        scale_w = (resize_dim * orig_width) / orig_height / orig_width

    new_width = int(orig_width * scale_w)
    new_height = int(orig_height * scale_h)

    x1 *= scale_w
    y1 *= scale_h
    w *= scale_w
    h *= scale_h

    crop_x_offset = max(0, (new_width - crop_dim) // 2)
    crop_y_offset = max(0, (new_height - crop_dim) // 2)
    x1 -= crop_x_offset
    y1 -= crop_y_offset

    x1 = max(0, min(x1, crop_dim - 1))
    y1 = max(0, min(y1, crop_dim - 1))
    w = max(0, min(w, crop_dim - x1))
    h = max(0, min(h, crop_dim - y1))
    return [x1, y1, w, h]


def adjust_bbox_for_transform_no_scale(orig_width, orig_height, bbox,
                                       target_width, target_height):
    """Plain stretch resize remap (src/bbox_utils.py:222-250)."""
    x1, y1, w, h = bbox
    sw = target_width / orig_width
    sh = target_height / orig_height
    return [x1 * sw, y1 * sh, w * sw, h * sh]
