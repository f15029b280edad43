"""Minimal COCO-annotation reader (pycocotools-free).

Twin of `patchioner_tpu/io/coco.py`, which the port may not
import; the code is the same.

The eval pipelines consume COCO-format JSON (images + annotations); this
covers the subset of the pycocotools.COCO API they use (imgs, imgToAnns,
loadImgs — reference eval_densecap.py:186+, eval_image_captioning.py:186).
"""

from __future__ import annotations

import json
from collections import defaultdict

__all__ = ["CocoAnnotations"]


class CocoAnnotations:
    def __init__(self, annotations_path: str):
        with open(annotations_path) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.anns = {a["id"]: a for a in data.get("annotations", [])}
        self.img_to_anns = defaultdict(list)
        for a in data.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)

    def load_imgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    @property
    def image_ids(self):
        return list(self.imgs.keys())
