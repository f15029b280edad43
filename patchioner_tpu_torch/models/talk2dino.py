"""Talk2DINO's projection (CLIP text -> DINO space) and its inversion.

Twin of `patchioner_tpu/models/talk2dino.py`: `project_clip_txt`, the
linear layer and the optional hidden layers, each after the activation
(reference src/talk2dino/talk2dino.py:6-97), which builds a bank's rows;
`talk2dino_config_from_yaml`; and `build_inversion` /
`revert_transformation` (reference src/embedding_utils.py:3-25), the SVD
pseudo-inverse of the first linear layer applied as (x - b) @ A_pinv.T,
which takes a DINO-space prefix back to CLIP space. Plain PyTorch; the
parameters are `io.torch_port.port_talk2dino`'s tree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["project_clip_txt", "build_inversion", "revert_transformation",
           "talk2dino_config_from_yaml"]

_ACTS = {None: None, "tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid}


def talk2dino_config_from_yaml(path_or_dict) -> dict:
    """A Talk2DINO config (configs_talk2dino/*.yaml: a top-level `model:`
    block) as {act, hidden_layer, dino_embed_dim, clip_embed_dim}. A path
    needs PyYAML; a dict is the `model:` block itself."""
    if isinstance(path_or_dict, str):
        import yaml

        with open(path_or_dict) as f:
            cfg = yaml.safe_load(f)["model"]
    else:
        cfg = dict(path_or_dict)
    act = cfg.get("act")
    if act not in _ACTS:
        raise ValueError(f"unknown activation: {act}")
    return {"act": act, "hidden_layer": cfg.get("hidden_layer", False),
            "dino_embed_dim": cfg.get("dino_embed_dim", 1024),
            "clip_embed_dim": cfg.get("clip_embed_dim", 512)}


def project_clip_txt(params: dict, x: torch.Tensor,
                     act: Optional[str] = "tanh") -> torch.Tensor:
    """CLIP text embeddings (N, clip) -> DINO space (N, dino) in f32: the
    linear layer, then for each hidden layer the activation and the layer
    (talk2dino.py:78-81)."""
    x = x.float() @ params["linear"]["w"] + params["linear"]["b"]
    fn = _ACTS[act]
    for h in params.get("hidden", []):
        if fn is not None:
            x = fn(x)
        x = x @ h["w"] + h["b"]
    return x


def build_inversion(params: dict, device="cpu") -> dict:
    """`params['linear']` = {'w': (clip, dino) = torch W.T, 'b': (dino,)};
    the pseudo-inverse is taken in float64 with singular values <= 1e-10
    dropped, as the reference does."""
    w = np.asarray(params["linear"]["w"], np.float64).T  # torch (out, in)
    u, s, vh = np.linalg.svd(w, full_matrices=False)
    s_pinv = np.where(s > 1e-10, 1.0 / np.where(s > 1e-10, s, 1.0), 0.0)
    a_pinv = (vh.T * s_pinv) @ u.T  # (clip, dino)
    return {
        "A_pinv": torch.as_tensor(a_pinv, dtype=torch.float32, device=device),
        "b": torch.as_tensor(np.asarray(params["linear"]["b"]),
                             dtype=torch.float32, device=device),
    }


def revert_transformation(features: torch.Tensor, inv: dict) -> torch.Tensor:
    return (features.float() - inv["b"]) @ inv["A_pinv"].T
