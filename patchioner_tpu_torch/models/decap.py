"""DeCap decoder: linear prefix mapper + GPT-2, KV-cached greedy decode.

Twin of `patchioner_tpu/models/decap.py` (reference decoding_batched,
src/decap/decap.py:116-183): exactly `n_steps` greedy steps for every
sequence with no early stop (truncation at EOT happens at detokenisation),
and the score exp(sum of the chosen tokens' log-probs).

`greedy_decode` is the eager loop, the decode's plain version.
`GreedyDecoder` owns the decoder's weights, cast once, and on the card
replays the whole loop as one CUDA graph: the port's counterpart of the
JAX package's single compiled `lax.scan`.
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple

import torch

from patchioner_tpu_torch.models import gpt2

__all__ = ["ENTRY_LENGTH", "DecapParams", "init_decap", "decap_project_prefix",
           "greedy_decode", "row_bucket", "GreedyDecoder"]

ENTRY_LENGTH = 30  # reference: src/decap/decap.py:127


class DecapParams(NamedTuple):
    gpt2: dict
    clip_project: dict  # one linear layer: prefix_size -> n_embd


def init_decap(cfg: gpt2.GPT2Config, prefix_size: int,
               generator: torch.Generator, device="cpu") -> DecapParams:
    """GPT-2 by the HF scheme; the prefix linear by nn.Linear's default
    U(+-1/sqrt(fan_in)) (init_decap)."""
    bound = 1.0 / math.sqrt(prefix_size)

    def uniform(*shape):
        u = torch.rand(*shape, generator=generator, device=device)
        return u * (2 * bound) - bound

    return DecapParams(
        gpt2=gpt2.init_gpt2(cfg, generator, device),
        clip_project={"w": uniform(prefix_size, cfg.n_embd),
                      "b": uniform(cfg.n_embd)},
    )


def decap_project_prefix(params: DecapParams, features: torch.Tensor) -> torch.Tensor:
    return torch.matmul(features, params.clip_project["w"]) + params.clip_project["b"]


def _decode(params: DecapParams, prefix: torch.Tensor, cfg: gpt2.GPT2Config,
            n_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The greedy loop over `params.gpt2` already in cfg.dtype. Every shape
    and index is fixed on the host and nothing waits for the device, so a
    CUDA graph can capture it whole; the cache is zeroed inside it."""
    g = params.gpt2
    emb = decap_project_prefix(params, prefix)
    cache = gpt2.init_kv_cache(cfg, prefix.shape[0], n_steps + 1,
                               device=prefix.device)
    tokens, lps = [], []
    for _ in range(n_steps):
        logits, cache = gpt2.gpt2_step(g, emb, cache, cfg)
        tok = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
        tokens.append(tok)
        lps.append(lp)
        emb = g["wte"][tok]
    return torch.stack(tokens, 1), torch.exp(torch.stack(lps, 0).sum(0))


@torch.no_grad()
def greedy_decode(params: DecapParams, prefix: torch.Tensor, cfg: gpt2.GPT2Config,
                  n_steps: int = ENTRY_LENGTH) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, prefix_size) prefix -> tokens (B, n_steps) int64 and scores (B,);
    the GPT-2 weights are cast to cfg.dtype on every call."""
    from patchioner_tpu_torch.models.vit import cast_params

    return _decode(params._replace(gpt2=cast_params(params.gpt2, cfg.dtype)),
                   prefix, cfg, n_steps)


def row_bucket(rows: int) -> int:
    """The rows a decode graph is captured for: the power of two at or
    above `rows`."""
    return 1 << max(rows - 1, 0).bit_length()


class GreedyDecoder:
    """`greedy_decode` with its weights cast once, at construction: the
    GPT-2 tree in cfg.dtype, the prefix linear in f32, on the weights'
    device.

    `decoder(prefix) -> (tokens, scores)` follows the kernels' device rule.
    On CPU tensors it runs the eager loop. On CUDA tensors it replays a
    CUDA graph of all `n_steps` steps, captured on first use for each
    (row bucket, prefix dtype, TF32 setting): cuBLAS keeps the GEMM kernels
    a graph was captured with, so a TF32 flip needs a graph of its own.
    The row bucket is the power of two at or above the row count
    (`row_bucket`): the graphs are never dropped, so one a distinct count
    would grow the card's memory with every new box total `forward` sees,
    while buckets keep at most one graph per power of two. The prefix is
    copied into the graph's static input before each replay, the rows
    past it zeroed (rows decode independently: a real row gets the eager
    loop's tokens on the padded batch, though in bf16 the GEMMs of another
    row count may round a near-tie the other way), and the real rows'
    tokens and scores are cloned out after it. A capture or a replay that fails raises; nothing falls
    back to the eager loop on the card.

    The graphs share one memory pool: they never run at once, since every
    replay holds the object's lock and waits for the previous one, and a
    graph's outputs are cloned before any other graph replays. Capture on
    the thread that will replay (a server's worker, through its `warmup`):
    CUDA libraries keep some state per thread. `captures` and `replays`
    count what the card did.
    """

    def __init__(self, params: DecapParams, cfg: gpt2.GPT2Config,
                 n_steps: int = ENTRY_LENGTH):
        from patchioner_tpu_torch.models.vit import cast_params

        self.cfg, self.n_steps = cfg, n_steps
        self.params = DecapParams(cast_params(params.gpt2, cfg.dtype),
                                  cast_params(params.clip_project, torch.float32))
        self.device = self.params.clip_project["w"].device
        self.captures = self.replays = 0
        self._graphs = {}
        self._pool = None
        self._lock = threading.Lock()
        self._done = None  # recorded after the last replay's outputs were cloned

    @torch.no_grad()
    def __call__(self, prefix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if prefix.device.type != "cuda":
            return _decode(self.params, prefix, self.cfg, self.n_steps)
        if prefix.device != self.device:
            raise ValueError(f"prefix on {prefix.device}, decoder on {self.device}")
        rows = prefix.shape[0]
        key = (row_bucket(rows), prefix.dtype, torch.backends.cuda.matmul.allow_tf32)
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            graph, static_in, tokens, scores = (self._graphs.get(key)
                                                or self._capture(key, prefix))
            static_in[:rows].copy_(prefix)
            static_in[rows:].zero_()
            graph.replay()
            self.replays += 1
            out = tokens[:rows].clone(), scores[:rows].clone()
            self._done = torch.cuda.Event()
            self._done.record(stream)
        return out

    def _capture(self, key, prefix: torch.Tensor):
        static_in = prefix.new_zeros((key[0], prefix.shape[1]))
        # one eager run on a side stream first, so that cuBLAS has its handle
        # and workspace before the capture
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            _decode(self.params, static_in, self.cfg, self.n_steps)
        main.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            tokens, scores = _decode(self.params, static_in, self.cfg, self.n_steps)
        self.captures += 1
        self._graphs[key] = graph, static_in, tokens, scores
        return self._graphs[key]
