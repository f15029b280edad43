"""DINOv2-style ViT encoder in PyTorch.

Twin of `patchioner_tpu/models/vit.py` for the DINO trace path: the config
(`ViTConfig`, `VARIANTS`, `config_for`), random init in the reference's
parameter layout, `interpolate_pos_embed`, `vit_forward` and
`process_self_attention`. Parameters are a nested dict of tensors in the
JAX package's layout (dense weights stored (in, out)); `io.bridge` converts
a JAX tree.

Each block runs LN + qkv (kernel A), then the attention half that
`attn_impl` selects, as the reference's `_block` / `_attention` do
(vit.py:376-471, 543-672), then the FFN half: LN + MLP (kernel C), or for
`ffn="swiglu"` (ViT-g) LN + SwiGLU (kernel G), the reference's `mlp_fused`
path:

- 'xla', 'fusedqkv': attention on the fused qkv (kernel B), then the
  out-projection, layerscale and residual as a plain matmul (plain XLA in
  the reference) or, with `proj_fused`, as kernel E;
- 'fusedqkv_proj': attention, out-projection, layerscale and residual in
  kernel F (B's attention, then one GEMM with the rest in its epilogue);
- 'flash', 'flash1p', 'flash_builtin': q, k and v split into (B, H, N, hd)
  for kernel K, kernel J or torch's `scaled_dot_product_attention` (the
  port's counterpart of jax's bundled kernel), merged back, then the plain
  out-projection.

`softmax_f32=False` under 'xla' keeps the logits and the softmax in the
compute type, as the reference's plain XLA attention does (vit.py:449-467):
no TPU kernel computes that function, so it runs as plain torch between
kernels A and C; every other `attn_impl` raises ValueError on it, as in the
reference. The token axis is not padded, so no key is masked.

`reorder_qkv_params` rewires the last block's fused qkv for an
`attention_type` such as 'kkv' (a weight permutation: the block runs the
same kernels), and `last_block_rerun` re-runs the last block over a
key-masked token set, the double-DINO box features' encoder
(vit.py:821-874): A for LN + qkv, key-masked attention in plain torch
(kernel B masks only keys past one count a call), the plain out-projection,
then C (G on a SwiGLU block). `last_block_rerun_plain` is its plain twin.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from patchioner_tpu_torch.ops import attention
from patchioner_tpu_torch.ops.mlp import (dense_residual_plain, fused_dense_residual,
                                          fused_ln_dense, fused_ln_mlp, fused_ln_swiglu,
                                          ln_dense_plain, ln_mlp_plain, ln_rows,
                                          ln_swiglu_plain)

__all__ = ["ViTConfig", "VARIANTS", "config_for", "init_vit", "param_template",
           "cast_params", "interpolate_pos_embed", "patch_embed", "vit_forward",
           "process_self_attention", "reorder_qkv_params", "last_block_rerun",
           "last_block_rerun_plain", "RERUN_CHUNK"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ffn: str = "mlp"  # or 'swiglu' (giant)
    num_registers: int = 4
    layerscale: bool = True
    ln_eps: float = 1e-6
    pos_grid: Optional[int] = None  # grid the stored pos-embed was trained at
    # the reference's extraction quirk: 16 heads and scale 0.125 for every
    # non-small model, whatever the true head count (vit.py:85-90)
    extract_heads: int = 16
    extract_scale: float = 0.125
    # the attention half of each block (module note); 'xla' and 'fusedqkv'
    # both run kernel B here
    attn_impl: str = "xla"
    # out-projection + layerscale + residual as kernel E ('fusedqkv' only)
    proj_fused: bool = False
    # tanh GELU in kernel C, a numerics change opted into by config
    gelu_approx: bool = False
    # f32 attention softmax; False keeps it in the compute type ('xla' only)
    softmax_f32: bool = True
    dtype: torch.dtype = torch.float32

    ATTN_IMPLS = ("xla", "fusedqkv", "fusedqkv_proj", "flash", "flash1p",
                  "flash_builtin")

    def __post_init__(self):
        if self.attn_impl not in self.ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r} is not one of "
                             f"{self.ATTN_IMPLS}")

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def num_global_tokens(self) -> int:
        return 1 + self.num_registers

    @property
    def num_tokens(self) -> int:
        return self.num_global_tokens + self.num_patches

    @property
    def stored_pos_grid(self) -> int:
        return self.pos_grid if self.pos_grid is not None else self.grid_size

    @property
    def ffn_hidden(self) -> int:
        """Hidden width of the FFN; SwiGLU shrinks the nominal 4x by 2/3,
        rounded up to a multiple of 8 (1536 * 4 -> 4096 for giant), as the
        reference's ViTConfig.ffn_hidden does."""
        h = int(self.embed_dim * self.mlp_ratio)
        if self.ffn == "swiglu":
            h = (int(h * 2 / 3) + 7) // 8 * 8
        return h


VARIANTS = {
    "dinov2_vits14": dict(embed_dim=384, depth=12, num_heads=6, num_registers=0,
                          extract_heads=6),
    "dinov2_vitb14": dict(embed_dim=768, depth=12, num_heads=12, num_registers=0),
    "dinov2_vitl14": dict(embed_dim=1024, depth=24, num_heads=16, num_registers=0),
    "dinov2_vits14_reg": dict(embed_dim=384, depth=12, num_heads=6,
                              num_registers=4, extract_heads=6),
    "dinov2_vitb14_reg": dict(embed_dim=768, depth=12, num_heads=12, num_registers=4),
    "dinov2_vitl14_reg": dict(embed_dim=1024, depth=24, num_heads=16, num_registers=4),
    "dinov2_vitg14": dict(embed_dim=1536, depth=40, num_heads=24, num_registers=0,
                          ffn="swiglu"),
    "dinov2_vitg14_reg": dict(embed_dim=1536, depth=40, num_heads=24,
                              num_registers=4, ffn="swiglu"),
}


def config_for(dino_model: str, img_size: int = 518, **overrides) -> ViTConfig:
    if dino_model not in VARIANTS:
        raise ValueError(f"unknown DINOv2 variant: {dino_model}")
    kw = dict(VARIANTS[dino_model])
    kw.update(overrides)
    kw.setdefault("pos_grid", 37)  # DINOv2 checkpoints store the 37x37 grid
    return ViTConfig(img_size=img_size, **kw)


def init_vit(cfg: ViTConfig, generator: torch.Generator,
             device="cpu") -> dict:
    """Seeded random f32 weights with init_vit's layout and distributions."""
    d, h = cfg.embed_dim, cfg.ffn_hidden

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    def dense(fan_in, fan_out):
        return {"w": randn(fan_in, fan_out) / math.sqrt(fan_in),
                "b": torch.zeros(fan_out, device=device)}

    def ln():
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}

    params = {
        "patch_embed": dense(cfg.patch_size ** 2 * 3, d),
        "cls_token": randn(1, 1, d) * 0.02,
        "pos_embed": randn(1, 1 + cfg.stored_pos_grid ** 2, d) * 0.02,
        "norm": ln(),
        "blocks": [],
    }
    if cfg.num_registers:
        params["register_tokens"] = randn(1, cfg.num_registers, d) * 0.02
    for _ in range(cfg.depth):
        blk = {"norm1": ln(), "qkv": dense(d, 3 * d), "proj": dense(d, d),
               "norm2": ln()}
        if cfg.ffn == "swiglu":
            blk.update(w12=dense(d, 2 * h), w3=dense(h, d))
        else:
            blk.update(fc1=dense(d, h), fc2=dense(h, d))
        if cfg.layerscale:
            blk["ls1"] = torch.full((d,), 1e-5, device=device)
            blk["ls2"] = torch.full((d,), 1e-5, device=device)
        params["blocks"].append(blk)
    return params


def param_template(cfg: ViTConfig) -> dict:
    """`init_vit`'s tree as empty meta tensors of its shapes, for checking a
    loaded tree against the config (no meta operation runs: those import
    half of torch the first time)."""
    d, h = cfg.embed_dim, cfg.ffn_hidden

    def empty(*shape):
        return torch.empty(shape, device="meta")

    def dense(fan_in, fan_out):
        return {"w": empty(fan_in, fan_out), "b": empty(fan_out)}

    def ln():
        return {"scale": empty(d), "bias": empty(d)}

    tree = {"patch_embed": dense(cfg.patch_size ** 2 * 3, d), "cls_token": empty(1, 1, d),
            "pos_embed": empty(1, 1 + cfg.stored_pos_grid ** 2, d), "norm": ln(),
            "blocks": []}
    if cfg.num_registers:
        tree["register_tokens"] = empty(1, cfg.num_registers, d)
    for _ in range(cfg.depth):
        blk = {"norm1": ln(), "qkv": dense(d, 3 * d), "proj": dense(d, d), "norm2": ln()}
        if cfg.ffn == "swiglu":
            blk.update(w12=dense(d, 2 * h), w3=dense(h, d))
        else:
            blk.update(fc1=dense(d, h), fc2=dense(h, d))
        if cfg.layerscale:
            blk.update(ls1=empty(d), ls2=empty(d))
        tree["blocks"].append(blk)
    return tree


def cast_params(tree, dtype: torch.dtype, device=None):
    """Every floating tensor of a nested dict/list cast to `dtype` (and moved
    to `device`), contiguous; None leaves (a linear without a bias) stay."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_params(v, dtype, device) for v in tree)
    t = tree.to(device=device) if device is not None else tree
    if t.is_floating_point():
        t = t.to(dtype)
    return t.contiguous()


def interpolate_pos_embed(pos_embed: torch.Tensor, src_grid: int, dst_grid: int,
                          *, interpolate_offset: float = 0.1) -> torch.Tensor:
    """dinov2's interpolate_pos_encoding: the patch grid resized in f32 with
    torch's bicubic upsampling, called with scale_factor=(dst + offset)/src
    (its small-offset quirk), or size=(dst, dst) when the offset is 0."""
    if src_grid == dst_grid:
        return pos_embed
    cls_pos = pos_embed[:, :1]
    d = pos_embed.shape[-1]
    grid = pos_embed[:, 1:].float().reshape(1, src_grid, src_grid, d)
    grid = grid.permute(0, 3, 1, 2)
    if interpolate_offset:
        sf = (dst_grid + interpolate_offset) / src_grid
        grid = F.interpolate(grid, scale_factor=(sf, sf), mode="bicubic",
                             align_corners=False)
    else:
        grid = F.interpolate(grid, size=(dst_grid, dst_grid), mode="bicubic",
                             align_corners=False)
    if tuple(grid.shape[-2:]) != (dst_grid, dst_grid):
        raise ValueError(f"pos-embed resize gave {tuple(grid.shape[-2:])}")
    grid = grid.permute(0, 2, 3, 1).reshape(1, dst_grid * dst_grid, d)
    return torch.cat([cls_pos, grid.to(pos_embed.dtype)], dim=1)


def _softmax_f32_refused(cfg: ViTConfig) -> None:
    """`softmax_f32=False` names a compute-type softmax, which only the
    'xla' impl has: every kernel runs an f32 softmax (the reference's
    messages, vit.py:355-359, 388-396, 553-557)."""
    if cfg.softmax_f32 or cfg.attn_impl == "xla":
        return
    if cfg.attn_impl == "fusedqkv_proj":
        raise ValueError("attn_impl='fusedqkv_proj' always runs an f32 softmax in-kernel; "
                         "use attn_impl='xla' for a compute-dtype softmax")
    raise ValueError(f"attn_impl={cfg.attn_impl!r} always runs an f32 softmax in-kernel; "
                     "softmax_f32=False has no effect there — use attn_impl='xla' for a "
                     "compute-dtype softmax")


def _compute_type_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The reference's 'xla' attention under softmax_f32=False
    (vit.py:449-467): q scaled and the logits, the softmax and its product
    with v all in qkv's type."""
    q, k, v = attention.split_heads(qkv, num_heads)
    logits = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return attention.merge_heads(torch.matmul(e / e.sum(dim=-1, keepdim=True), v))


def _merged_attention(qkv: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """The merged (B, N, D) attention output of every impl but fusedqkv_proj."""
    nh = cfg.num_heads
    scale = (qkv.shape[-1] // 3 // nh) ** -0.5
    if not cfg.softmax_f32:
        return _compute_type_attention(qkv, nh)
    if cfg.attn_impl in ("xla", "fusedqkv"):
        return attention.fused_qkv_attention(qkv, num_heads=nh, scale=scale)
    q, k, v = attention.split_heads(qkv, nh)
    if cfg.attn_impl == "flash":
        o = attention.flash_attention(q, k, v, scale=scale)
    elif cfg.attn_impl == "flash1p":
        o = attention.flash_attention_1pass(q, k, v, scale=scale)
    else:  # flash_builtin: torch's fused attention, as jax's bundled kernel
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return attention.merge_heads(o)


def _block(x: torch.Tensor, blk: dict, cfg: ViTConfig):
    _softmax_f32_refused(cfg)
    d = x.shape[-1]
    qkv = fused_ln_dense(x, blk["norm1"]["scale"], blk["norm1"]["bias"],
                         blk["qkv"]["w"], blk["qkv"]["b"], eps=cfg.ln_eps)
    ls1 = blk["ls1"] if cfg.layerscale else torch.ones_like(blk["proj"]["b"])
    proj = (blk["proj"]["w"], blk["proj"]["b"], ls1)
    if cfg.attn_impl == "fusedqkv_proj":
        x = attention.fused_qkv_attention_proj(
            qkv, x, *proj, num_heads=cfg.num_heads,
            scale=(d // cfg.num_heads) ** -0.5)
    else:
        merged = _merged_attention(qkv, cfg)
        if cfg.proj_fused and cfg.attn_impl == "fusedqkv":
            x = fused_dense_residual(merged, x, *proj)
        else:
            if cfg.proj_fused:
                warnings.warn(
                    f"proj_fused requested but unusable here (attn_impl="
                    f"{cfg.attn_impl!r} (needs 'fusedqkv')); falling back to the "
                    "plain out-projection", stacklevel=3)
            x = dense_residual_plain(merged, x, *proj)
    ls2 = blk["ls2"] if cfg.layerscale else torch.ones_like(blk["norm2"]["bias"])
    return _ffn(x, blk, ls2, cfg, fused_ln_mlp, fused_ln_swiglu), qkv


def _ffn(x: torch.Tensor, blk: dict, ls2: torch.Tensor, cfg: ViTConfig, ln_mlp,
         ln_swiglu) -> torch.Tensor:
    """The FFN half, `x + ls2 * FFN(LN(x))`: `ln_swiglu` on a SwiGLU block
    (w12, w3), else `ln_mlp` with the config's GELU."""
    norm = (blk["norm2"]["scale"], blk["norm2"]["bias"])
    if "w12" in blk:
        return ln_swiglu(x, *norm, blk["w12"]["w"], blk["w12"]["b"], blk["w3"]["w"],
                         blk["w3"]["b"], ls2, eps=cfg.ln_eps)
    return ln_mlp(x, *norm, blk["fc1"]["w"], blk["fc1"]["b"], blk["fc2"]["w"],
                  blk["fc2"]["b"], ls2, eps=cfg.ln_eps, gelu_approx=cfg.gelu_approx)


def patch_embed(params: dict, pixels: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The p x p, stride p patch conv as one matmul: (B, H, W, 3) NHWC
    pixels -> (B, G * G, D), each patch's pixels flattened row-major,
    channel last, the order `io.torch_port` lays a conv kernel out in."""
    b, hh, _, _ = pixels.shape
    p = patch_size
    g = hh // p
    x = pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, -1)
    return torch.matmul(x, params["w"]) + params["b"]


def vit_forward(params: dict, pixels: torch.Tensor, cfg: ViTConfig,
                return_block_input: bool = False) -> dict:
    """(B, H, W, 3) normalised NHWC pixels -> dict of x_norm_clstoken (B, D),
    x_norm_regtokens (B, R, D), x_norm_patchtokens (B, G*G, D), x_prenorm
    (B, T, D) and qkv_last (B, T, 3D), the last block's fused qkv; with
    `return_block_input` also last_block_input (B, T, D), the stream the
    last block took in."""
    params = cast_params(params, cfg.dtype)
    b, hh, _, _ = pixels.shape
    g = hh // cfg.patch_size
    x = patch_embed(params["patch_embed"], pixels.to(cfg.dtype), cfg.patch_size)
    cls = params["cls_token"].expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embed(params["pos_embed"], cfg.stored_pos_grid, g)
    if cfg.num_registers:
        regs = params["register_tokens"].expand(b, cfg.num_registers, x.shape[-1])
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
    x = x.contiguous()

    qkv = last_input = None
    for blk in params["blocks"]:
        last_input = x
        x, qkv = _block(x, blk, cfg)

    x_norm = ln_rows(x, params["norm"]["scale"], params["norm"]["bias"], cfg.ln_eps)
    ng = cfg.num_global_tokens
    out = {
        "x_norm_clstoken": x_norm[:, 0],
        "x_norm_regtokens": x_norm[:, 1:ng],
        "x_norm_patchtokens": x_norm[:, ng:],
        "x_prenorm": x,
        "qkv_last": qkv,
    }
    if return_block_input:
        out["last_block_input"] = last_input
    return out


# rows of a last-block re-run whose attention runs at once: its f32 logits
# take rows x H x T^2 x 4 bytes, 1.45 GB at 16 rows of the flagship's 12
# heads over 1374 tokens (11.6 GB for a box batch's 128 rows at once)
RERUN_CHUNK = 16


def _masked_attention(qkv: torch.Tensor, key_mask: torch.Tensor, num_heads: int,
                      chunk: int) -> torch.Tensor:
    """(B', T, 3D) fused qkv -> the merged (B', T, D) attention output with
    the keys outside `key_mask` (B', T) masked, `chunk` rows at a time: the
    logits of q scaled by hd^-0.5 in qkv's type, then in f32 with masked keys
    at -1e30 (a row with every key masked gets the uniform softmax over all
    T keys, as in the reference, not NaN), the weights back in qkv's type
    before their product with v (vit.py:857-860)."""
    b, n, three_d = qkv.shape
    out = qkv.new_empty(b, n, three_d // 3)
    for s in range(0, b, chunk):
        q, k, v = attention.split_heads(qkv[s:s + chunk], num_heads)
        logits = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2)).float()
        logits.masked_fill_(~key_mask[s:s + chunk, None, None, :], -1e30)
        w = torch.softmax(logits, dim=-1).to(qkv.dtype)
        del logits
        out[s:s + chunk] = attention.merge_heads(torch.matmul(w, v))
    return out


def _rerun(params: dict, tokens: torch.Tensor, key_mask: torch.Tensor, cfg: ViTConfig,
           chunk: int, ln_dense, ln_mlp, ln_swiglu) -> torch.Tensor:
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be at least 1")
    blk = cast_params(params["blocks"][-1], tokens.dtype)
    ones = torch.ones_like(blk["norm1"]["bias"])
    qkv = ln_dense(tokens, blk["norm1"]["scale"], blk["norm1"]["bias"], blk["qkv"]["w"],
                   blk["qkv"]["b"], eps=cfg.ln_eps)
    merged = _masked_attention(qkv, key_mask.to(device=tokens.device, dtype=torch.bool),
                               cfg.num_heads, chunk)
    del qkv
    x = dense_residual_plain(merged, tokens, blk["proj"]["w"], blk["proj"]["b"],
                             blk["ls1"] if cfg.layerscale else ones)
    return _ffn(x, blk, blk["ls2"] if cfg.layerscale else ones, cfg, ln_mlp, ln_swiglu)


def last_block_rerun(params: dict, tokens: torch.Tensor, key_mask: torch.Tensor,
                     cfg: ViTConfig, *, chunk: int = RERUN_CHUNK) -> torch.Tensor:
    """The last block re-run over a key-masked token set, twin of
    `vit.py:821 last_block_rerun` (double-DINO box features): tokens
    (B', T, D), key_mask (B', T) bool -> (B', T, D). Attention over the
    keys a row's mask keeps equals the reference's block over that row's
    compacted token list (attention is permutation-equivariant over keys);
    the masked positions' outputs are garbage the caller does not read.
    LN + qkv in kernel A, the key-masked attention `chunk` rows at a time
    (the output does not depend on it), the out-projection, layerscale and
    residual plain, then the FFN half in kernel C (G on a SwiGLU block, as
    the reference dispatches on `w12`). On CUDA tensors a kernel that does
    not build or launch raises."""
    return _rerun(params, tokens, key_mask, cfg, chunk, fused_ln_dense, fused_ln_mlp,
                  fused_ln_swiglu)


def last_block_rerun_plain(params: dict, tokens: torch.Tensor, key_mask: torch.Tensor,
                           cfg: ViTConfig, *, chunk: int = RERUN_CHUNK) -> torch.Tensor:
    """`last_block_rerun` through the kernels' plain versions on any device."""
    return _rerun(params, tokens, key_mask, cfg, chunk, ln_dense_plain, ln_mlp_plain,
                  ln_swiglu_plain)


def process_self_attention(qkv: torch.Tensor, *, num_heads: int,
                           num_global_tokens: int, scale: float = 0.125,
                           num_real_k: Optional[int] = None):
    """CLS->patch attention from the last block's fused qkv with the
    reference's quirks (src/dino_extraction.py:24-34): the configured head
    count (16 at ViT-B, not 12), the fixed scale, the mean over heads taken
    before the softmax. Returns (self_attn (B, P), maps (B, H, P))."""
    b, n, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    qkv = qkv.reshape(b, n, 3, num_heads, hd)
    q_cls = qkv[:, 0, 0].float() * scale  # (B, H, hd)
    k = qkv[:, :, 1].float()              # (B, N, H, hd)
    attn = torch.einsum("bhd,bnhd->bhn", q_cls, k)
    if num_real_k is not None and num_real_k < n:
        attn = attn[:, :, :num_real_k]
    maps = attn[:, :, num_global_tokens:]
    return torch.softmax(maps.mean(dim=1), dim=-1), maps


def reorder_qkv_params(params: dict, attention_type: str) -> dict:
    """KKV-style rewiring (reference src/model.py:569-582): the last block's
    fused qkv rebuilt in the order `attention_type` names, e.g. 'kkv' takes
    the keys as queries. 'qkv' returns `params` itself; anything but three
    letters of q, k and v raises ValueError. A shallow copy: the caller's
    tree is left as it was. Twin of `vit.py:915`."""
    if attention_type == "qkv":
        return params
    if (not isinstance(attention_type, str) or len(attention_type) != 3
            or any(c not in "qkv" for c in attention_type)):
        raise ValueError(f"invalid attention_type: {attention_type!r}")
    blk = params["blocks"][-1]
    w, bias = blk["qkv"]["w"], blk["qkv"]["b"]  # (D, 3D), (3D,)
    d = w.shape[0]
    w3, b3 = w.reshape(d, 3, d), bias.reshape(3, d)
    part = {"q": 0, "k": 1, "v": 2}
    new_blk = dict(blk, qkv={
        "w": torch.cat([w3[:, part[c]] for c in attention_type], dim=-1),
        "b": torch.cat([b3[part[c]] for c in attention_type], dim=-1)})
    return dict(params, blocks=[*params["blocks"][:-1], new_blk])
