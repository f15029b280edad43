"""ClipCap: a prefix mapper and GPT-2 base with nucleus sampling, in PyTorch.

Twin of `patchioner_tpu/models/clipcap.py` (reference
src/clipcap/entrypoint.py). A backbone feature is mapped to
`prefix_length` GPT-2 input embeddings by a tanh MLP (D -> 768 L / 2 ->
768 L, entrypoint.py:433-435) or by the transformer mapper that ViECap
uses (`viecap.mapping_network_forward`); GPT-2 then samples
`entry_length` tokens with top-p filtering (top_p 0.8, temperature 1.0,
entry_length 67, stop at '.').

Plain PyTorch on the model's device, as in the reference (the JAX package
has no kernel here either): one prefill, then one KV-cached `gpt2_step`
a token, nothing read back until the loop ends. The semantics the JAX
functions pin, kept here:
- the top-p filter keeps every logit at or above the smallest kept sorted
  logit (`nucleus_filter`), so ties at the threshold stay on both sides;
- a step divides by the temperature, filters, clips to +-1e9, and a row
  whose maximum is then not finite (only NaN, after the clip) takes the
  stop id (JAX clipcap.py:160-170);
- a token is the first argmax of the filtered logits plus Gumbel noise,
  which is what `jax.random.categorical` computes; the sampler takes the
  noise as an argument, (entry_length, B, V), and `ClipCap` draws it from
  its own `torch.Generator` once a `forward`, as the JAX model splits its
  key once a call;
- rows go on sampling after the stop token; a caption is the text before
  its first stop token, with the stop token put back (JAX :201-206).
Scores are 1 / perplexity, 1.0 where that fails or is NaN, not ViECap's
raw perplexity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from patchioner_tpu_torch.io import torch_port
from patchioner_tpu_torch.models import gpt2, viecap
from patchioner_tpu_torch.models.vit import cast_params

__all__ = ["ClipCapConfig", "init_mlp_mapper", "mlp_template", "mlp_mapper_forward",
           "mapper_config", "port_clipcap", "nucleus_filter", "gumbel_noise",
           "sample_tokens", "generate_batched", "ClipCap", "feature_width"]


@dataclasses.dataclass(frozen=True)
class ClipCapConfig:
    # the reference's defaults: entrypoint.py:438-456
    prefix_length: int = 10
    clip_length: int = 10
    num_layers: int = 8
    mapping_type: str = "mlp"  # 'mlp' | 'transformer'
    temperature: float = 1.0
    top_p: float = 0.8
    entry_length: int = 67
    stop_token: str = "."
    normalize_prefix: bool = False
    num_heads: int = 8
    mlp_ratio: float = 2.0


# ------------------------------------------------------------------ mapper


def init_mlp_mapper(prefix_size: int, prefix_length: int, d_model: int,
                    generator: torch.Generator, device) -> dict:
    """The tanh MLP (D, d_model L / 2, d_model L) with nn.Linear's default
    init, weights and biases U(+-1/sqrt(fan_in)) (JAX clipcap.py:61)."""
    hidden = d_model * prefix_length // 2

    def dense(fi, fo):
        bound = 1.0 / math.sqrt(fi)

        def uniform(*shape):
            return torch.rand(*shape, generator=generator, device=device) * (2 * bound) - bound

        return {"w": uniform(fi, fo), "b": uniform(fo)}

    return {"fc1": dense(prefix_size, hidden), "fc2": dense(hidden, d_model * prefix_length)}


def mlp_template(prefix_size: int, prefix_length: int, d_model: int) -> dict:
    """`init_mlp_mapper`'s tree as empty meta tensors, for checking a
    loaded tree."""
    hidden = d_model * prefix_length // 2

    def dense(fi, fo):
        return {"w": torch.empty(fi, fo, device="meta"), "b": torch.empty(fo, device="meta")}

    return {"fc1": dense(prefix_size, hidden), "fc2": dense(hidden, d_model * prefix_length)}


def mlp_mapper_forward(params: dict, x: torch.Tensor, prefix_length: int,
                       d_model: int) -> torch.Tensor:
    """(B, D) -> (B, prefix_length, d_model) (JAX clipcap.py:90)."""
    h = torch.tanh(torch.matmul(x, params["fc1"]["w"]) + params["fc1"]["b"])
    h = torch.matmul(h, params["fc2"]["w"]) + params["fc2"]["b"]
    return h.reshape(-1, prefix_length, d_model)


def mapper_config(cfg: ClipCapConfig, prefix_size: int) -> viecap.ViecapConfig:
    """The transformer mapper's geometry as ViECap's mapping network takes
    it (JAX clipcap.py:230-246)."""
    return viecap.ViecapConfig(continuous_prompt_length=cfg.prefix_length,
                               clip_project_length=cfg.clip_length,
                               clip_hidden_size=prefix_size, num_layers=cfg.num_layers,
                               num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio)


def port_clipcap(sd, cfg: ClipCapConfig, n_layer: int = 12) -> dict:
    """A ClipCap checkpoint as the port's trees (JAX clipcap.py:97):
    {'mapper'} from clip_project.model.{0,2}.* (MLP) or clip_project.*
    (transformer), and {'gpt2'} from gpt.* when the file carries GPT-2."""
    if cfg.mapping_type == "mlp":
        def lin(i):
            return {"w": torch_port._t(sd[f"clip_project.model.{i}.weight"]).t().contiguous(),
                    "b": torch_port._t(sd[f"clip_project.model.{i}.bias"])}

        out = {"mapper": {"fc1": lin(0), "fc2": lin(2)}}
    else:
        out = {"mapper": viecap.port_mapping_network(sd, prefix="clip_project.",
                                                     num_layers=cfg.num_layers)}
    if any(k.startswith("gpt.") for k in sd):
        out["gpt2"] = torch_port.port_hf_gpt2_lmhead(sd, n_layer, prefix="gpt.")
    return out


# -------------------------------------------------------------- generation


def nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """The top-p filter of JAX clipcap.py:132 (reference
    entrypoint.py:247-262): the descending cumulative softmax, a token
    dropped once the mass before it exceeds `top_p` (the argmax always
    kept); every logit below the smallest kept one becomes -inf."""
    ordered = torch.sort(logits, dim=-1, descending=True).values
    mass = torch.cumsum(torch.softmax(ordered, dim=-1), dim=-1)
    drop = torch.zeros_like(mass, dtype=torch.bool)
    drop[..., 1:] = mass[..., :-1] > top_p
    floor = ordered.masked_fill(drop, math.inf).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < floor, -math.inf)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform clamped to [tiny, 1),
    drawn in place from `generator` (the form of `jax.random.gumbel`)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u.clamp_(min=torch.finfo(torch.float32).tiny).log_().neg_().log_().neg_()


@torch.no_grad()
def sample_tokens(gpt2_params: dict, prefix_embeds: torch.Tensor, noise: torch.Tensor,
                  cfg: gpt2.GPT2Config, stop_id: int, top_p: float,
                  temperature: float) -> torch.Tensor:
    """(B, T, D) prefixes -> (B, entry_length) sampled tokens on the device,
    entry_length = noise.shape[0]; the twin of JAX `_sample_tokens`
    (clipcap.py:148) given `jax.random.gumbel` of its split keys as
    `noise`."""
    params = gpt2._cast(gpt2_params, cfg.dtype)
    steps = noise.shape[0]
    logits, cache = gpt2.gpt2_prefill(params, prefix_embeds, cfg,
                                      prefix_embeds.shape[1] + steps)
    stop = torch.tensor(stop_id, device=prefix_embeds.device)
    toks = []
    for i in range(steps):
        filt = nucleus_filter(logits / temperature, top_p).clamp(-1e9, 1e9)
        bad = ~torch.isfinite(filt.amax(dim=-1))
        tok = torch.where(bad, stop, torch.argmax(filt + noise[i], dim=-1))
        toks.append(tok)
        if i + 1 < steps:  # the last step's logits are never read
            logits, cache = gpt2.gpt2_step(params, params["wte"][tok], cache, cfg)
    return torch.stack(toks, dim=1)


def generate_batched(gpt2_params: dict, prefix_embeds: torch.Tensor, cfg: gpt2.GPT2Config,
                     tokenizer, noise: torch.Tensor, *, top_p: float = 0.8,
                     temperature: float = 1.0, stop_token: str = ".") -> List[str]:
    """Sampled captions of (B, T, D) prefixes given the (entry_length, B, V)
    noise (JAX clipcap.py:180): the stop id is the first id of `stop_token`,
    and a caption is its row's text before the first stop token, the token
    put back (:201-206)."""
    stop_id = tokenizer.encode(stop_token)[0]
    toks = sample_tokens(gpt2_params, prefix_embeds, noise, cfg, stop_id, top_p, temperature)
    return [tokenizer.decode(row.tolist()).split(stop_token)[0] + stop_token
            for row in toks.cpu().numpy()]


# ------------------------------------------------------------------ model


class ClipCap:
    """The ClipCap decoder family (JAX clipcap.py:210; reference
    entrypoint.py:381-580). `prefix_size` is the feature width the mapper
    takes; every tensor lives on `device`, and the noise comes from a
    generator there seeded with 0, as the JAX model's key is
    `PRNGKey(0)`."""

    def __init__(self, cfg: ClipCapConfig, gpt2_cfg: gpt2.GPT2Config, gpt2_params: dict,
                 mapper_params: dict, tokenizer, prefix_size: int, device):
        self.cfg = cfg
        self.gpt2_cfg = gpt2_cfg
        self.device = torch.device(device)
        self.gpt2_params = cast_params(gpt2_params, gpt2_cfg.dtype, self.device)
        self.mapper_params = cast_params(mapper_params, torch.float32, self.device)
        self.tokenizer = tokenizer
        self.prefix_size = prefix_size
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    def to(self, device) -> "ClipCap":
        """A copy on `device`; its generator starts again from the seed."""
        return ClipCap(self.cfg, self.gpt2_cfg, self.gpt2_params, self.mapper_params,
                       self.tokenizer, self.prefix_size, device)

    @torch.no_grad()
    def project(self, features) -> torch.Tensor:
        """(B, prefix_size) features -> the (B, prefix_length, n_embd) prefix
        (JAX `_project`, after `normalize_prefix`)."""
        f = torch.as_tensor(features).to(self.device).float()
        if self.cfg.normalize_prefix:
            f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        if self.cfg.mapping_type == "mlp":
            return mlp_mapper_forward(self.mapper_params, f, self.cfg.prefix_length,
                                      self.gpt2_cfg.n_embd)
        return viecap.mapping_network_forward(self.mapper_params, f,
                                              mapper_config(self.cfg, self.prefix_size),
                                              self.gpt2_cfg.n_embd)

    def noise(self, rows: int) -> torch.Tensor:
        """One forward's (entry_length, rows, V) Gumbel noise."""
        return gumbel_noise((self.cfg.entry_length, rows, self.gpt2_cfg.vocab_size),
                            self.generator, self.device)

    def forward(self, features, compute_scores: bool = False):
        """Sampled captions of (B, prefix_size) features; with
        `compute_scores` also each caption's 1 / perplexity."""
        prefix = self.project(features)
        captions = generate_batched(
            self.gpt2_params, prefix, self.gpt2_cfg, self.tokenizer,
            self.noise(prefix.shape[0]), top_p=self.cfg.top_p,
            temperature=self.cfg.temperature, stop_token=self.cfg.stop_token)
        if compute_scores:
            return captions, self.compute_perplexity_scores(captions)
        return captions

    __call__ = forward

    def compute_perplexity_scores(self, sentences: List[str]) -> List[float]:
        """1 / perplexity of each sentence, 1.0 where tokenising or the
        forward fails or the perplexity is NaN (a sentence of fewer than 2
        tokens; reference entrypoint.py:554-592)."""
        out = []
        for s in sentences:
            try:
                pp = viecap.sentence_perplexity(self.gpt2_params, self.gpt2_cfg,
                                                self.tokenizer.encode(s))
            except Exception:
                out.append(1.0)
                continue
            out.append(1.0 / pp if pp > 0 else 1.0)
        return out


def feature_width(dino_model: Optional[str], prefix_size: int) -> int:
    """The width ClipCap's mapper takes: the DINOv2 backbone's, matched by
    substring, else `prefix_size` (JAX patchioner.py:979-990; reference
    src/model.py:119-127)."""
    for frag, dim in (("dinov2_vits14", 384), ("dinov2_vitb14", 768),
                      ("dinov2_vitl14", 1024), ("dinov2_vitg14", 1536)):
        if dino_model is not None and frag in dino_model:
            return dim
    return prefix_size
