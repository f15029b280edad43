"""The port's own caption server, tokenizer and image preprocessing against
the JAX package's framework-free originals (`patchioner_tpu.serve`,
`patchioner_tpu.text.clip_bpe`, `patchioner_tpu.utils.transforms`), on the
same requests, texts and token ids."""

import threading

import numpy as np
import pytest
from PIL import Image

from patchioner_tpu import serve as jserve
from patchioner_tpu.text import clip_bpe as jclip_bpe
from patchioner_tpu.utils import transforms as jtransforms
from patchioner_tpu_torch import serve
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.text import clip_bpe
from patchioner_tpu_torch.utils import transforms

SERVERS = [serve.CaptionServer, jserve.CaptionServer]
OVERLOADED = {serve.CaptionServer: serve.ServerOverloaded,
              jserve.CaptionServer: jserve.ServerOverloaded}


class _EchoModel:
    """Captions that spell out what the server handed the model: the batch
    size and pixel type, and each row's trace length and first point."""

    crop_dim = resize_dim = 28

    def __init__(self, gate=None):
        self.gate = gate
        self.entered = threading.Event()  # the worker has left its queue

    def supports_fused_trace_path(self):
        return True

    def caption_traces_fused(self, imgs, pts, valid):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=30)
        return [f"{len(imgs)}-{imgs.dtype}-{int(v.sum())}-{p[0, 0]:.3f},{p[0, 1]:.3f}"
                for p, v in zip(pts, valid)]


def _requests(seed=0, n=7):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(n)]
    imgs[2] = imgs[2].astype(np.float32) / 255  # a pre-normalised float row
    imgs[4] = Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
    traces = [rng.uniform(0, 1, (int(rng.integers(1, 12)), 2)).tolist() for _ in range(n)]
    traces[3] = [{"x": x, "y": y} for x, y in traces[3]]  # the reference's format
    return imgs, traces


@pytest.mark.parametrize("max_batch", [1, 3, 4, 6, 8])
def test_server_batches_and_pads_as_the_reference(max_batch):
    # the first request holds the worker in the model while the rest queue
    # up, so the batches that follow are the same on every run
    imgs, traces = _requests()
    outs = []
    for cls in SERVERS:
        model = _EchoModel(threading.Event())
        with cls(model, max_batch=max_batch, max_delay_ms=20.0,
                 trace_points=8) as server:
            futs = [server.submit(imgs[0], traces[0])]
            assert model.entered.wait(timeout=30)
            futs += [server.submit(im, tr) for im, tr in zip(imgs[1:], traces[1:])]
            model.gate.set()
            caps = [f.result(timeout=30) for f in futs]
            snap = server.snapshot()
            outs.append((server.buckets, caps, snap["completed"], snap["batches"]))
    assert outs[0] == outs[1]
    assert outs[0][2] == len(imgs)


def test_port_model_captions_identically_behind_both_servers():
    cfg = {"dino_model": "dinov2_vits14_reg", "crop_dim": 28, "prefix_size": 64,
           "support_memory_size": 16,
           "dino_geometry": {"embed_dim": 64, "depth": 1, "num_heads": 1,
                             "extract_heads": 1},
           "decap_arch": {"n_layer": 1, "n_embd": 64, "n_head": 1, "vocab_size": 49408}}
    model = Patchioner.from_config(cfg, allow_missing_weights=True, rng_seed=3,
                                   device="cpu")
    imgs, traces = _requests(1, n=5)
    caps = []
    for cls in SERVERS:
        with cls(model, max_batch=4, max_delay_ms=50.0) as server:
            caps.append(server.caption(imgs, traces, timeout=120))
    assert caps[0] == caps[1] and all(isinstance(c, str) for c in caps[0])


@pytest.mark.parametrize("cls", SERVERS)
def test_server_rejects_malformed_requests_at_admission(cls):
    with cls(_EchoModel()) as server:
        with pytest.raises(ValueError, match="at least one point"):
            server.submit(np.zeros((28, 28, 3), np.uint8), [])
        with pytest.raises(ValueError, match="pixels must be"):
            server.submit(np.zeros((27, 28, 3), np.uint8), [(0.5, 0.5)])


@pytest.mark.parametrize("kw", [{"trace": None},
                                {"trace": None, "bboxes": [(0, 0, 1, 1)]},
                                {"trace": None, "bboxes": [(0, 0, 1, 1)], "region_set": True}])
def test_port_server_refuses_requests_it_does_not_port(kw):
    with serve.CaptionServer(_EchoModel()) as server:
        with pytest.raises(NotImplementedError):
            server.submit(np.zeros((28, 28, 3), np.uint8), **kw)


@pytest.mark.parametrize("cls", SERVERS)
def test_server_sheds_load_at_max_queue(cls):
    model = _EchoModel(threading.Event())
    img = np.zeros((28, 28, 3), np.uint8)
    with cls(model, max_batch=1, max_delay_ms=0.0, max_queue=1) as server:
        first = server.submit(img, [(0.5, 0.5)])  # taken by the worker, blocked
        assert model.entered.wait(timeout=30)
        queued = server.submit(img, [(0.5, 0.5)])
        with pytest.raises(OVERLOADED[cls]):
            server.submit(img, [(0.5, 0.5)])
        model.gate.set()
        assert first.result(timeout=30) and queued.result(timeout=30)
        assert server.snapshot()["rejected"] == 1


TEXTS = ["A man riding a wave on top of a surfboard.",
         "Two dogs &amp; a cat   on   the  sofa!!",
         "café, naïve résumé — 3 ducks' 42nd pond",
         "<|startoftext|>it's what we'll do<|endoftext|>",
         "word " * 100]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_encodes_as_the_reference(text):
    tok, ref = clip_bpe.get_tokenizer(), jclip_bpe.get_tokenizer()
    assert tok.encode(text) == ref.encode(text)
    np.testing.assert_array_equal(tok.tokenize([text, text[:5]]),
                                  ref.tokenize([text, text[:5]]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokenizer_decodes_captions_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, clip_bpe.VOCAB_SIZE, (4, 30))
    rows[0, 7] = clip_bpe.EOT_TOKEN
    rows[1, 0] = clip_bpe.SOT_TOKEN
    tok, ref = clip_bpe.get_tokenizer(), jclip_bpe.get_tokenizer()
    for row in rows:
        assert tok.decode(row) == ref.decode(row)
        assert tok.decode_caption(row) == ref.decode_caption(row)


@pytest.mark.parametrize("size,crop", [((40, 30), True), ((30, 52), True), ((33, 33), False)])
def test_pil_preprocessing_matches_the_reference(size, crop):
    rng = np.random.default_rng(4)
    img = Image.fromarray(rng.integers(0, 256, size[::-1] + (3,), dtype=np.uint8)).convert("L")
    got = transforms.preprocess_pil_uint8(img, 32, 28, crop=crop)
    want = jtransforms.preprocess_pil_uint8(img, 32, 28, crop=crop)
    assert got.dtype == np.uint8 and got.shape == ((28, 28, 3) if crop else (32, 32, 3))
    np.testing.assert_array_equal(got, want)
