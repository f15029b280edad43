"""Tiny .env loader (no python-dotenv dependency).

Twin of `patchioner_tpu/utils/env.py`, which the port may not
import; the code is the same.

The reference uses dotenv for data roots — IM2TXT_MEMORY_PATH
(im2txtprojection.py:47), DENSE_CAPTIONING_ANNOTATIONS_FOLDER
(eval_densecap.py:40), etc. Same semantics: KEY=VALUE lines, '#' comments,
existing environment wins.
"""

from __future__ import annotations

import os

__all__ = ["load_dotenv"]


def load_dotenv(path: str = ".env", override: bool = False) -> dict:
    loaded = {}
    if not os.path.exists(path):
        return loaded
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            if line.startswith("export "):
                # python-dotenv accepts shell-style 'export KEY=V' lines;
                # without this the var would be set under the literal name
                # 'export KEY'
                line = line[len("export "):].lstrip()
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if value[:1] in ("'", '"') and value.find(value[0], 1) != -1:
                # quoted value: interior verbatim (including '#'); anything
                # after the closing quote — e.g. an inline comment — drops
                # ('KEY="v" # note' must yield v, not '"v"')
                value = value[1 : value.find(value[0], 1)]
            else:
                # unquoted value: python-dotenv strips inline ' # comment'
                value = value.split(" #", 1)[0].rstrip()
                if value.startswith("#"):
                    value = ""
            loaded[key] = value
            if override or key not in os.environ:
                os.environ[key] = value
    return loaded
