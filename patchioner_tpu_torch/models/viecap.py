"""ViECap: entity-aware prefix captioning over a full GPT-2, in PyTorch.

Twin of `patchioner_tpu/models/viecap.py` (reference src/viecap/:
entrypoint.py, ClipCap.py, search.py, retrieval_categories.py, utils.py).
An image feature is (a) mapped to `continuous_prompt_length` soft-prompt
embeddings by a transformer mapping network and (b) matched against an
entity-text embedding vocabulary to build the hard prompt "There are
{entities} in image."; the two are concatenated (`soft_prompt_first`,
`only_hard_prompt`) and decoded by GPT-2 with greedy, beam or contrastive
search.

Plain PyTorch, as in the reference (no kernel of the JAX package runs
here). The searches are loops of torch ops on the model's device over the
port's `gpt2_prefill`, `gpt2_step`, `gpt2_candidates_step` and
`commit_candidate`; they read nothing back until the loop ends. They keep
the reference's semantics, which the JAX functions pin:
- every search generates `max_len` tokens, then cuts each row at its first
  end-of-sentence token and keeps it (greedy and beam stop on the last id
  of "." and of " .", contrastive on the first id of ".");
- beam search ranks length-normalised sums, gives a stopped beam only
  token 0 at no cost, grows a beam's length before reordering by
  `src = flat // V`, and returns the beams best first;
- ties in a top-k go to the lower index, as `jax.lax.top_k` gives them
  (a stable descending sort; `torch.topk` promises no order), and an
  argmax takes the first maximum in both frameworks.
`beam_search_batched` runs every image's W beams as one (B * W)-row batch
over one cache; each image's result equals `beam_search`'s.

The GPT-2 text tokenizer is any object with `encode` / `decode`
(`text.gpt2_bpe.Gpt2Tokenizer` over the real vocabulary, or the
whitespace fallback of `models.patchioner`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch

from patchioner_tpu_torch.io import torch_port
from patchioner_tpu_torch.models import gpt2
from patchioner_tpu_torch.models.vit import cast_params

__all__ = [
    "ViecapConfig", "VOCAB_DIR", "init_mapping_network", "mapping_template",
    "port_mapping_network", "mapping_network_forward", "load_entities_text",
    "PROMPT_ENSEMBLE_TEMPLATES", "build_entity_embeddings", "retrieve_entities",
    "compose_discrete_prompt", "greedy_search", "beam_search", "beam_search_batched",
    "contrastive_search", "assemble_prompt_embeds", "run_search", "sentence_perplexity",
    "VieCap",
]

VOCAB_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                         "viecap_vocabulary")


@dataclasses.dataclass(frozen=True)
class ViecapConfig:
    # the reference's defaults: src/viecap/entrypoint.py:61-80
    continuous_prompt_length: int = 10
    clip_project_length: int = 10
    clip_hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 8
    mlp_ratio: float = 2.0
    temperature: float = 0.01
    top_k: int = 3
    threshold: float = 0.2
    using_hard_prompt: bool = False
    soft_prompt_first: bool = False
    only_hard_prompt: bool = False
    using_greedy_search: bool = False
    beam_width: int = 5
    max_len: int = 64
    name_of_entities_text: str = "vinvl_vgoi_entities"
    prompt_ensemble: bool = False
    ln_eps: float = 1e-5


# ------------------------------------------------------- mapping network


def init_mapping_network(cfg: ViecapConfig, d_model: int, generator: torch.Generator,
                         device="cpu") -> dict:
    """nn.Linear's default init for every linear (weights and biases
    U(+-1/sqrt(fan_in))), prefix_const standard normal (ClipCap.py:52-155);
    the attention's query and key-value linears have no bias."""

    def dense(fi, fo, bias=True):
        bound = 1.0 / math.sqrt(fi)

        def uniform(*shape):
            return torch.rand(*shape, generator=generator, device=device) * (2 * bound) - bound

        w = uniform(fi, fo)
        return {"w": w, "b": uniform(fo) if bias else None}

    hidden = int(d_model * cfg.mlp_ratio)
    params = {"linear": dense(cfg.clip_hidden_size, cfg.clip_project_length * d_model),
              "prefix_const": torch.randn(cfg.continuous_prompt_length, d_model,
                                          generator=generator, device=device),
              "layers": []}
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "norm1": {"scale": torch.ones(d_model, device=device),
                      "bias": torch.zeros(d_model, device=device)},
            "to_queries": dense(d_model, d_model, bias=False),
            "to_keys_values": dense(d_model, 2 * d_model, bias=False),
            "project": dense(d_model, d_model),
            "norm2": {"scale": torch.ones(d_model, device=device),
                      "bias": torch.zeros(d_model, device=device)},
            "fc1": dense(d_model, hidden),
            "fc2": dense(hidden, d_model),
        })
    return params


def mapping_template(cfg: ViecapConfig, d_model: int) -> dict:
    """`init_mapping_network`'s tree as empty meta tensors of its shapes
    (None for the missing biases), for checking a loaded tree."""

    def empty(*shape):
        return torch.empty(shape, device="meta")

    def dense(fi, fo, bias=True):
        return {"w": empty(fi, fo), "b": empty(fo) if bias else None}

    def ln():
        return {"scale": empty(d_model), "bias": empty(d_model)}

    hidden = int(d_model * cfg.mlp_ratio)
    return {"linear": dense(cfg.clip_hidden_size, cfg.clip_project_length * d_model),
            "prefix_const": empty(cfg.continuous_prompt_length, d_model),
            "layers": [{"norm1": ln(), "to_queries": dense(d_model, d_model, False),
                        "to_keys_values": dense(d_model, 2 * d_model, False),
                        "project": dense(d_model, d_model), "norm2": ln(),
                        "fc1": dense(d_model, hidden), "fc2": dense(hidden, d_model)}
                       for _ in range(cfg.num_layers)]}


def port_mapping_network(sd, prefix: str = "mapping_network.", num_layers: int = 8) -> dict:
    """A torch MappingNetwork state dict (ClipCap.py:122-155) as the port's
    tree: each nn.Linear transposed to (in, out); the attention's
    `to_queries` and `to_keys_values` have no bias (ClipCap.py:78)."""

    def lin(name, bias=True):
        return {"w": torch_port._t(sd[f"{prefix}{name}.weight"]).t().contiguous(),
                "b": torch_port._t(sd[f"{prefix}{name}.bias"]) if bias else None}

    def ln(name):
        return {"scale": torch_port._t(sd[f"{prefix}{name}.weight"]),
                "bias": torch_port._t(sd[f"{prefix}{name}.bias"])}

    params = {"linear": lin("linear"),
              "prefix_const": torch_port._t(sd[f"{prefix}prefix_const"]), "layers": []}
    for i in range(num_layers):
        q = f"transformer.layers.{i}"
        params["layers"].append({
            "norm1": ln(f"{q}.norm1"),
            "to_queries": lin(f"{q}.attn.to_queries", bias=False),
            "to_keys_values": lin(f"{q}.attn.to_keys_values", bias=False),
            "project": lin(f"{q}.attn.project"),
            "norm2": ln(f"{q}.norm2"),
            "fc1": lin(f"{q}.mlp.fc1"),
            "fc2": lin(f"{q}.mlp.fc2"),
        })
    return params


def _lin(x, p):
    y = torch.matmul(x, p["w"])
    return y if p["b"] is None else y + p["b"]


def _ln(x, p, eps):
    """LayerNorm over the population variance."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def mapping_network_forward(params: dict, x: torch.Tensor, cfg: ViecapConfig,
                            d_model: int) -> torch.Tensor:
    """(B, clip_hidden) -> (B, continuous_prompt_length, d_model): the
    projected feature tokens and the learned prefix through the
    self-attention layers (ReLU MLP); the prefix positions are kept
    (ClipCap.py:141-153). Keys and values come from the same normed input
    as the queries (ClipCap.py:93), and the softmax runs over the keys."""
    b = x.shape[0]
    proj = _lin(x, params["linear"]).reshape(b, cfg.clip_project_length, d_model)
    prefix = params["prefix_const"][None].expand(b, cfg.continuous_prompt_length, d_model)
    h = torch.cat([proj, prefix], dim=1)
    nh = cfg.num_heads
    hd = d_model // nh
    for layer in params["layers"]:
        q_in = _ln(h, layer["norm1"], cfg.ln_eps)
        qs = _lin(q_in, layer["to_queries"]).reshape(b, -1, nh, hd)
        kv = _lin(q_in, layer["to_keys_values"]).reshape(b, -1, 2, nh, hd)
        ks, vs = kv[:, :, 0], kv[:, :, 1]
        attn = torch.einsum("bnhd,bmhd->bnmh", qs, ks) * hd ** -0.5
        attn = torch.softmax(attn, dim=2)
        out = torch.einsum("bnmh,bmhd->bnhd", attn, vs).reshape(b, -1, d_model)
        h = h + _lin(out, layer["project"])
        h = h + _lin(torch.relu(_lin(_ln(h, layer["norm2"], cfg.ln_eps), layer["fc1"])),
                     layer["fc2"])
    return h[:, cfg.clip_project_length:]


# -------------------------------------------------------- entity retrieval


def _finish_entities(raw, all_entities: bool) -> List[str]:
    """Lower-case and strip, keep single words unless `all_entities`, then
    sort: the vocabulary's embedding rows follow the sorted order
    (load_annotations.py:84-149)."""
    ents = [str(e).lower().strip() for e in raw]
    if not all_entities:
        ents = [e for e in ents if len(e.split()) == 1]
    ents.sort()
    return ents


def load_entities_text(name: str, path: str, all_entities: bool = True) -> List[str]:
    """An entity vocabulary (reference src/viecap/load_annotations.py):
    coco_entities (a json list), vinvl_vgoi_entities (a json class2ind
    dict), visual_genome_entities (a pickle, its 'joint' object set),
    open_image_entities (a csv's DisplayName column) or vinvl_vg_entities
    (a json's object_count keys). A missing file raises FileNotFoundError
    naming it."""
    if name == "coco_entities":
        with open(path) as f:
            return _finish_entities(json.load(f), all_entities)
    if name == "vinvl_vgoi_entities":
        with open(path) as f:
            return _finish_entities(json.load(f).keys(), all_entities)
    if name == "visual_genome_entities":
        with open(path, "rb") as f:
            data = pickle.load(f)
        ents = data["objects"] if isinstance(data, dict) and "objects" in data else data
        if isinstance(ents, dict):
            ents = ents["joint"]
        return _finish_entities(ents, all_entities)
    if name == "open_image_entities":
        import csv

        with open(path) as f:
            rows = list(csv.reader(f))
        # a "(...)" qualifier is dropped only where the name ends with ")"
        # (load_annotations.py:111-115)
        names = []
        for r in rows[1:]:
            n = r[1].lower().strip()
            if n and n[-1] == ")":
                n = n[: n.find("(")].strip()
            names.append(n)
        return _finish_entities(names, all_entities)
    if name == "vinvl_vg_entities":
        with open(path) as f:
            return _finish_entities(json.load(f)["object_count"].keys(), all_entities)
    raise ValueError(f"unknown entity vocabulary: {name}")


# the seven CLIP prompt templates of the reference's ensemble
# (src/viecap/training/generating_prompt_ensemble.py:57-65)
PROMPT_ENSEMBLE_TEMPLATES = (
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@torch.no_grad()
def build_entity_embeddings(entities: Sequence[str], encode_fn, *,
                            templates: Sequence[str] = PROMPT_ENSEMBLE_TEMPLATES,
                            project_fn=None, out_path: Optional[str] = None,
                            batch_entities: int = 256) -> np.ndarray:
    """The prompt-ensemble entity embeddings
    (generating_prompt_ensemble.py:12-52): each entity's templates encoded
    by `encode_fn(texts) -> (len(texts), D)`, optionally mapped by
    `project_fn` (CLIP -> DINO space for the `_t2d_` vocabularies), each
    L2-normalised, averaged over the templates and normalised again.
    (N, D) f32; pickled to `out_path` when given."""
    t = len(templates)
    rows = []
    for lo in range(0, len(entities), batch_entities):
        chunk = entities[lo:lo + batch_entities]
        emb = torch.as_tensor(np.asarray(encode_fn(
            [tpl.format(e) for e in chunk for tpl in templates])), dtype=torch.float32)
        if project_fn is not None:
            emb = torch.as_tensor(np.asarray(project_fn(emb)), dtype=torch.float32)
        rows.append(_l2(_l2(emb).reshape(len(chunk), t, -1).mean(dim=1)))
    out = torch.cat(rows).numpy().astype(np.float32)
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    return out


def _top_k(x: torch.Tensor, k: int):
    """The k largest of the last axis, ties to the lower index, as
    `jax.lax.top_k` orders them: (values, indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def retrieve_entities(image_features: torch.Tensor, texts_embeddings: torch.Tensor,
                      entities: Sequence[str], *, top_k: int = 3, threshold: float = 0.2,
                      temperature: float = 0.01) -> List[List[str]]:
    """Softmax-similarity retrieval (retrieval_categories.py:61-114): both
    sides normalised, softmax(sim / T), the top k, cut at the first
    probability below `threshold`. One copy to the host."""
    logits = torch.softmax(_l2(image_features) @ _l2(texts_embeddings).T / temperature, -1)
    probs, idx = (t.cpu().numpy() for t in _top_k(logits, top_k))
    out = []
    for p_row, i_row in zip(probs, idx):
        row = []
        for p, i in zip(p_row, i_row):
            if p < threshold:
                break
            row.append(entities[i])
        out.append(row)
    return out


def compose_discrete_prompt(entities: List[str]) -> str:
    """'There are person, dog in image.' (utils.py:55-74); no entity gives
    'There are something in image.'."""
    if not entities:
        return "There are something in image."
    return "There are " + ", ".join(entities) + " in image."


# ---------------------------------------------------------------- search


def _cut_at(rows: np.ndarray, eos: Sequence[int]) -> List[list]:
    """Each row up to and with its first token in `eos`, or whole."""
    out = []
    for row in rows:
        hit = np.flatnonzero(np.isin(row, eos))
        out.append(row[: hit[0] + 1 if hit.size else len(row)].tolist())
    return out


@torch.no_grad()
def greedy_tokens(params: dict, embeds: torch.Tensor, cfg: gpt2.GPT2Config,
                  max_len: int) -> torch.Tensor:
    """(B, T, D) prompts -> (B, max_len) greedy tokens on the device."""
    params = gpt2._cast(params, cfg.dtype)
    logits, cache = gpt2.gpt2_prefill(params, embeds, cfg, embeds.shape[1] + max_len)
    toks = []
    for i in range(max_len):
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        if i + 1 < max_len:  # the last step's logits are never read
            logits, cache = gpt2.gpt2_step(params, params["wte"][tok], cache, cfg)
    return torch.stack(toks, dim=1)


def greedy_search(params: dict, embeds: torch.Tensor, cfg: gpt2.GPT2Config, tokenizer, *,
                  max_len: int = 64,
                  end_of_sentences: Sequence[str] = (".", " .")) -> List[str]:
    """KV-cached greedy decoding (search.py:107-191): `max_len` tokens,
    each row cut at its first end-of-sentence token."""
    eos = [tokenizer.encode(e)[-1] for e in end_of_sentences]
    toks = greedy_tokens(params, embeds, cfg, max_len).cpu().numpy()
    return [tokenizer.decode(row) for row in _cut_at(toks, eos)]


def _is_eos(tok: torch.Tensor, eos: torch.Tensor) -> torch.Tensor:
    return (tok == eos[0]) | (tok == eos[1])


@torch.no_grad()
def beam_tokens(params: dict, embeds: torch.Tensor, eos: torch.Tensor,
                cfg: gpt2.GPT2Config, max_len: int, beam_width: int):
    """Beam search of each of the (B, T, D) prompts, all B * W beams as one
    batch over one cache (search.py:193-285): (tokens (B, W, max_len),
    seq_lengths (B, W), length-normalised scores (B, W)), on the device.
    `eos` holds the two end-of-sentence ids."""
    params = gpt2._cast(params, cfg.dtype)
    b, t0, _ = embeds.shape
    w = beam_width
    logits0, cache = gpt2.gpt2_prefill(params, embeds, cfg, t0 + max_len)
    scores, prev = _top_k(torch.log_softmax(logits0, dim=-1), w)  # (B, W)
    cache = gpt2.KVCache(cache.k.repeat_interleave(w, dim=1),
                         cache.v.repeat_interleave(w, dim=1), cache.length)
    dev = embeds.device
    tokens = torch.zeros(b, w, max_len, dtype=torch.int64, device=dev)
    tokens[:, :, 0] = prev
    seq_lengths = torch.ones(b, w, device=dev)
    is_stopped = _is_eos(prev, eos)
    rows = (torch.arange(b, device=dev) * w)[:, None]
    # a stopped beam takes only token 0, at no cost (search.py:259-260)
    stop_row = torch.full((params["wte"].shape[0],), -math.inf, device=dev)
    stop_row[0] = 0.0
    for i in range(1, max_len):
        logits, cache = gpt2.gpt2_step(params, params["wte"][prev.reshape(-1)], cache, cfg)
        logp = torch.log_softmax(logits, dim=-1).reshape(b, w, -1)
        v = logp.shape[-1]
        logp = torch.where(is_stopped[..., None], stop_row, logp)
        seq_lengths = seq_lengths + (~is_stopped).float()
        avg = (scores[..., None] + logp) / seq_lengths[..., None]
        top_avg, flat = _top_k(avg.reshape(b, w * v), w)
        src = torch.div(flat, v, rounding_mode="trunc")
        prev = flat % v
        seq_lengths = seq_lengths.gather(1, src)
        tokens = tokens.gather(1, src[..., None].expand(b, w, max_len))
        tokens[:, :, i] = prev
        scores = top_avg * seq_lengths
        is_stopped = is_stopped.gather(1, src) | _is_eos(prev, eos)
        beams = (rows + src).reshape(-1)
        cache = gpt2.KVCache(cache.k[:, beams], cache.v[:, beams], cache.length)
    return tokens, seq_lengths, scores / seq_lengths


def _eos_pair(tokenizer, end_of_sentences, device) -> torch.Tensor:
    return torch.tensor([tokenizer.encode(e)[-1] for e in end_of_sentences], device=device)


def beam_search(params: dict, embeds: torch.Tensor, cfg: gpt2.GPT2Config, tokenizer, *,
                beam_width: int = 5, max_len: int = 64,
                end_of_sentences: Sequence[str] = (".", " .")) -> List[str]:
    """Beam search of one prompt (1, T, D): the W beams' texts, best first
    (search.py:193-285), each cut at its length."""
    eos = _eos_pair(tokenizer, end_of_sentences, embeds.device)
    toks, lengths, norm = (t[0].cpu().numpy() for t in
                           beam_tokens(params, embeds, eos, cfg, max_len, beam_width))
    return [tokenizer.decode(toks[i, : int(lengths[i])].tolist())
            for i in np.argsort(-norm)]


def beam_search_batched(params: dict, embeds: torch.Tensor, cfg: gpt2.GPT2Config,
                        tokenizer, *, beam_width: int = 5, max_len: int = 64,
                        end_of_sentences: Sequence[str] = (".", " .")) -> List[str]:
    """The best beam of each of the (B, T, D) prompts, all images' beams
    in one batch: each equals `beam_search(...)[0]` of that image alone
    (the reference loops over the images, entrypoint.py:149-161)."""
    eos = _eos_pair(tokenizer, end_of_sentences, embeds.device)
    toks, lengths, norm = (t.cpu().numpy() for t in
                           beam_tokens(params, embeds, eos, cfg, max_len, beam_width))
    outs = []
    for b in range(toks.shape[0]):
        best = int(np.argsort(-norm[b])[0])
        outs.append(tokenizer.decode(toks[b, best, : int(lengths[b, best])].tolist()))
    return outs


@torch.no_grad()
def contrastive_tokens(params: dict, embeds: torch.Tensor, cfg: gpt2.GPT2Config,
                       max_len: int, top_k: int, alpha: float) -> torch.Tensor:
    """Contrastive search (search.py:294-405): each step scores the model's
    top-k candidates by (1 - alpha) p(candidate) - alpha max cos(candidate's
    hidden state, the context's), and commits the best. The candidates run
    against the shared cache (`gpt2_candidates_step`); the context's hidden
    states live in an f32 (B, T0 + max_len, D) buffer, positions from
    T0 + i on masked. (B, max_len) tokens on the device."""
    params = gpt2._cast(params, cfg.dtype)
    b, t0, d = embeds.shape
    logits, cache, hidden0 = gpt2.gpt2_prefill(params, embeds, cfg, t0 + max_len,
                                               return_hidden=True)
    hidden = torch.zeros(b, t0 + max_len, d, device=embeds.device)
    hidden[:, :t0] = hidden0
    ar = torch.arange(b, device=embeds.device)
    pos = torch.arange(t0 + max_len, device=embeds.device)
    toks = []
    for i in range(max_len):
        probs = torch.softmax(logits, dim=-1)
        _, top_idx = _top_k(logits, top_k)  # (B, K)
        top_probs = probs.gather(1, top_idx)
        cand_logits, cand_hidden, ck, cv = gpt2.gpt2_candidates_step(
            params, params["wte"][top_idx], cache, cfg)
        # the degeneration penalty: the largest cosine against the context;
        # the context's norms are clamped, the candidate's are not
        ctx = hidden / torch.clamp(torch.linalg.vector_norm(hidden, dim=-1, keepdim=True),
                                   min=1e-12)
        cos = torch.einsum("bkd,btd->bkt", _l2(cand_hidden), ctx)
        cos = cos.masked_fill(pos >= t0 + i, -math.inf)
        score = (1.0 - alpha) * top_probs - alpha * cos.amax(dim=-1)
        sel = torch.argmax(score, dim=-1)
        toks.append(top_idx[ar, sel])
        logits = cand_logits[ar, sel]
        cache = gpt2.commit_candidate(cache, ck, cv, sel)
        hidden[:, t0 + i] = cand_hidden[ar, sel]
    return torch.stack(toks, dim=1)


def contrastive_search(params: dict, embeds: torch.Tensor, cfg: gpt2.GPT2Config, tokenizer,
                       *, alpha: float = 0.1, top_k: int = 48, max_len: int = 64,
                       end_of_sentence: str = ".") -> List[str]:
    """Contrastive search with the reference's stop (search.py:294-405): the
    end of sentence is the FIRST id of `end_of_sentence`'s encoding. One
    string a row (the reference returns a bare string for one row)."""
    eos = tokenizer.encode(end_of_sentence)[0]
    toks = contrastive_tokens(params, embeds, cfg, max_len, top_k, alpha).cpu().numpy()
    return [tokenizer.decode(row) for row in _cut_at(toks, [eos])]


# ------------------------------------------------------------------ model


def assemble_prompt_embeds(soft: torch.Tensor, token_rows: List[List[int]],
                           gpt2_params: dict, pad_id: int, cfg: ViecapConfig) -> torch.Tensor:
    """The hard-prompt rows padded with `pad_id` to the longest, embedded by
    wte, and ordered [hard || soft], [soft || hard] under
    `soft_prompt_first`, or hard alone under `only_hard_prompt`
    (entrypoint.py:137-147). Pad tokens are attended: there is no mask."""
    maxlen = max(len(r) for r in token_rows)
    padded = np.full((len(token_rows), maxlen), pad_id, np.int64)
    for i, r in enumerate(token_rows):
        padded[i, : len(r)] = r
    wte = gpt2_params["wte"]
    hard = wte[torch.from_numpy(padded).to(wte.device)]
    if cfg.only_hard_prompt:
        return hard
    if cfg.soft_prompt_first:
        return torch.cat([soft, hard], dim=1)
    return torch.cat([hard, soft], dim=1)


def run_search(gpt2_params: dict, embeds: torch.Tensor, gpt2_cfg: gpt2.GPT2Config,
               tokenizer, cfg: ViecapConfig) -> List[str]:
    """Greedy under `using_greedy_search`, else the batched beam search
    (entrypoint.py:149-163)."""
    if cfg.using_greedy_search:
        return greedy_search(gpt2_params, embeds, gpt2_cfg, tokenizer, max_len=cfg.max_len)
    return beam_search_batched(gpt2_params, embeds, gpt2_cfg, tokenizer,
                               beam_width=cfg.beam_width, max_len=cfg.max_len)


@torch.no_grad()
def sentence_perplexity(gpt2_params: dict, gpt2_cfg: gpt2.GPT2Config, ids) -> float:
    """exp of the mean shifted cross-entropy of one tokenised sentence
    (HF `model(input_ids, labels=input_ids)`, entrypoint.py:164-177);
    fewer than 2 tokens leave no target, which torch makes NaN."""
    if len(ids) < 2:
        return float("nan")
    wte = gpt2_params["wte"]
    ids = torch.as_tensor([ids], dtype=torch.int64, device=wte.device)
    logits = gpt2.gpt2_forward(gpt2_params, wte[ids], gpt2_cfg)
    lp = torch.log_softmax(logits[0, :-1], dim=-1)
    nll = -lp.gather(1, ids[0, 1:, None]).mean()
    return float(torch.exp(nll))


class VieCap:
    """The ViECap decoder family (src/viecap/entrypoint.py): built from
    explicit trees (tests) or from the captioner's `viecap:` config block
    (`models.patchioner`). Every tensor lives on `device`."""

    def __init__(self, cfg: ViecapConfig, gpt2_cfg: gpt2.GPT2Config, gpt2_params: dict,
                 mapping_params: dict, entities: Sequence[str], texts_embeddings,
                 tokenizer, device):
        self.cfg = cfg
        self.gpt2_cfg = gpt2_cfg
        self.device = torch.device(device)
        self.gpt2_params = cast_params(gpt2_params, gpt2_cfg.dtype, self.device)
        self.mapping_params = cast_params(mapping_params, torch.float32, self.device)
        self.entities = list(entities)
        if not torch.is_tensor(texts_embeddings):
            texts_embeddings = torch.from_numpy(np.asarray(texts_embeddings, np.float32))
        self.texts_embeddings = texts_embeddings.to(self.device, torch.float32)
        self.tokenizer = tokenizer
        self._pad_id = getattr(tokenizer, "pad_token_id", None) or 0

    def to(self, device) -> "VieCap":
        return VieCap(self.cfg, self.gpt2_cfg, self.gpt2_params, self.mapping_params,
                      self.entities, self.texts_embeddings, self.tokenizer, device)

    def _hard_prompt_token_rows(self, f: torch.Tensor) -> List[List[int]]:
        """Each image's hard-prompt ids from its retrieved entities
        (entrypoint.py:120-147)."""
        per_image = retrieve_entities(f, self.texts_embeddings, self.entities,
                                      top_k=self.cfg.top_k, threshold=self.cfg.threshold,
                                      temperature=self.cfg.temperature)
        return [self.tokenizer.encode(compose_discrete_prompt(e)) for e in per_image]

    @torch.no_grad()
    def prompt_embeds(self, image_features) -> torch.Tensor:
        """(B, clip_hidden) features -> the (B, T, n_embd) prompts the search
        decodes. The features are L2-normalised here and again in the
        retrieval, as in the reference."""
        f = torch.as_tensor(image_features).to(self.device)
        f = (f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)).float()
        soft = mapping_network_forward(self.mapping_params, f, self.cfg, self.gpt2_cfg.n_embd)
        if not self.cfg.using_hard_prompt:
            return soft
        return assemble_prompt_embeds(soft, self._hard_prompt_token_rows(f),
                                      self.gpt2_params, self._pad_id, self.cfg)

    def forward(self, image_features, compute_scores: bool = False):
        """Captions of (B, clip_hidden) features; with `compute_scores` also
        each caption's GPT-2 perplexity."""
        embeds = self.prompt_embeds(image_features)
        sentences = run_search(self.gpt2_params, embeds, self.gpt2_cfg, self.tokenizer,
                               self.cfg)
        if compute_scores:
            return sentences, self.compute_perplexity(sentences)
        return sentences

    __call__ = forward

    def compute_perplexity(self, sentences: List[str]) -> List[float]:
        return [sentence_perplexity(self.gpt2_params, self.gpt2_cfg, self.tokenizer.encode(s))
                for s in sentences]
