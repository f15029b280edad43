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
    size and pixel type, and each row's trace length and first point, box
    or box set. `calls` records every call: its path, each image row's pixel
    sum (padding rows repeat row 0) and the arrays, padding included."""

    crop_dim = resize_dim = 28

    def __init__(self, gate=None):
        self.gate = gate
        self.entered = threading.Event()  # the worker has left its queue
        self.calls = []

    def supports_fused_trace_path(self):
        return True

    def _enter(self, path, imgs, *arrays):
        self.calls.append((path, str(imgs.dtype),
                           imgs.reshape(len(imgs), -1).astype(np.float64).sum(1).tolist(),
                           [np.asarray(a).tolist() for a in arrays]))
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=30)

    def caption_traces_fused(self, imgs, pts, valid):
        self._enter("trace", imgs, pts, valid)
        return [f"{len(imgs)}-{imgs.dtype}-{int(v.sum())}-{p[0, 0]:.3f},{p[0, 1]:.3f}"
                for p, v in zip(pts, valid)]

    def caption_bboxes_fused(self, imgs, bboxes):
        self._enter("bbox", imgs, bboxes)
        return [[f"{len(imgs)}-{imgs.dtype}-{i}-{j}-" + ",".join(f"{v:.3f}" for v in box)
                 for j, box in enumerate(row)] for i, row in enumerate(bboxes)]

    def caption_region_sets_fused(self, imgs, bboxes):
        self._enter("region_set", imgs, bboxes)
        return [f"{len(imgs)}-{imgs.dtype}-" + ";".join(
            ",".join(f"{v:.3f}" for v in box) for box in row) for row in bboxes]

    def caption_images_fused(self, imgs):
        self._enter("cls", imgs)
        return [f"{len(imgs)}-{imgs.dtype}-{float(im.astype(np.float64).mean()):.4f}"
                for im in imgs]


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


def _mixed_requests(seed, kinds):
    """Requests of the given kinds in turn, as (image, submit keywords):
    box requests with 1-5 normalised xyxy boxes, region sets of 1-3, whole
    images and traces; every third image a pre-normalised float one."""
    rng = np.random.default_rng(seed)
    out = []
    for i, kind in enumerate(kinds * 3):
        img = rng.integers(0, 256, (28, 28, 3), dtype=np.uint8)
        if i % 3 == 2:
            img = img.astype(np.float32) / 255
        lo = rng.uniform(0, 0.5, (5, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0, 0.5, (5, 2))], -1).tolist()
        kw = {"bbox": {"bboxes": boxes[: int(rng.integers(1, 6))]},
              "region_set": {"bboxes": boxes[: int(rng.integers(1, 4))], "region_set": True},
              "cls": {},
              "trace": {"trace": rng.uniform(0, 1, (4, 2)).tolist()}}[kind]
        out.append((img, kw))
    return out


@pytest.mark.parametrize("kinds", [["bbox"], ["region_set"], ["cls"],
                                   ["bbox", "region_set", "cls", "trace"]],
                         ids=lambda k: "+".join(k))
def test_servers_hand_the_model_the_same_arrays_for_every_kind(kinds):
    # the first request holds the worker while the rest queue up; both
    # servers must then make the same calls (padding rows, [0, 0, 1, 1]
    # padding boxes, [-1] * 4 region-set rows, pixel xywh boxes) and cut
    # the same rows back to each request
    reqs = _mixed_requests(len(kinds), kinds)
    outs = []
    for cls in SERVERS:
        model = _EchoModel(threading.Event())
        with cls(model, max_batch=4, max_delay_ms=20.0, trace_points=8,
                 max_boxes=6) as server:
            futs = [server.submit(*reqs[0][:1], **reqs[0][1])]
            assert model.entered.wait(timeout=30)
            futs += [server.submit(im, **kw) for im, kw in reqs[1:]]
            model.gate.set()
            caps = [f.result(timeout=30) for f in futs]
            outs.append((caps, model.calls, server.snapshot()["batches"]))
    assert outs[0] == outs[1]
    caps, calls, _ = outs[0]
    for (_, kw), cap in zip(reqs, caps):  # box requests: one caption a box
        if "bboxes" in kw and not kw.get("region_set"):
            assert isinstance(cap, list) and len(cap) == len(kw["bboxes"])
        else:
            assert isinstance(cap, str)
    assert {c[0] for c in calls} == set(kinds)


ADMISSION_ERRORS = {
    "trace_and_boxes": (dict(trace=[(0.5, 0.5)], bboxes=[(0, 0, 1, 1)]), "not both"),
    "region_set_without_boxes": (dict(region_set=True), "non-empty bboxes"),
    "empty_region_set": (dict(bboxes=[], region_set=True), "non-empty bboxes"),
    "too_many_boxes": (dict(bboxes=[(0, 0, 1, 1)] * 5), "max_boxes=4"),
    "inverted_box": (dict(bboxes=[(0.2, 0.1, 0.6, 0.5), (0.5, 0.5, 0.2, 0.9)]),
                     "inverted bbox"),
}


@pytest.mark.parametrize("case", ADMISSION_ERRORS)
@pytest.mark.parametrize("cls", SERVERS)
def test_servers_refuse_malformed_box_requests_alike(cls, case):
    kw, message = ADMISSION_ERRORS[case]
    model = _EchoModel()
    with cls(model, max_boxes=4) as server:
        with pytest.raises(ValueError, match=message):
            server.submit(np.zeros((28, 28, 3), np.uint8), **kw)
        assert server.snapshot()["requests"] == 0 and model.calls == []


@pytest.mark.parametrize("kw,expected", [
    (dict(), [("trace", 1), ("trace", 2), ("trace", 4)]),
    (dict(trace=False, cls=True, bbox=True, region_set=True, buckets=[1, 4],
          pixel_dtype=np.float32),
     [("cls", 1), ("bbox", 1), ("region_set", 1), ("cls", 4), ("bbox", 4),
      ("region_set", 4)])], ids=["default", "every_kind"])
@pytest.mark.parametrize("cls", SERVERS)
def test_warmup_runs_each_bucket_and_leaves_stats_untouched(cls, kw, expected):
    model = _EchoModel()
    with cls(model, max_batch=4, max_boxes=3) as server:
        before = server.snapshot()
        server.warmup(**kw)
        after = server.snapshot()
    for key in ("requests", "completed", "batches", "errors", "mean_batch_size"):
        assert after[key] == before[key] == 0
    assert [(c[0], len(c[2])) for c in model.calls] == expected
    dtype = str(np.dtype(kw.get("pixel_dtype", np.uint8)))
    assert all(c[1] == dtype for c in model.calls)
    pad = {"bbox": [0.0, 0.0, 1.0, 1.0], "region_set": [-1.0] * 4}
    for path, _, _, arrays in model.calls:
        for row in arrays[0] if path in pad else []:
            # one dummy box over 0.1-0.9 of the 28 px crop, then padding
            assert np.allclose(row[0], [2.8, 2.8, 22.4, 22.4])
            assert row[1:] == [pad[path]] * 2


@pytest.fixture(scope="module")
def tiny_port_model():
    cfg = {"dino_model": "dinov2_vits14_reg", "crop_dim": 28, "prefix_size": 64,
           "support_memory_size": 16,
           "dino_geometry": {"embed_dim": 64, "depth": 1, "num_heads": 1,
                             "extract_heads": 1},
           "decap_arch": {"n_layer": 1, "n_embd": 64, "n_head": 1, "vocab_size": 49408}}
    return Patchioner.from_config(cfg, allow_missing_weights=True, rng_seed=5,
                                  device="cpu")


@pytest.mark.parametrize("cls", SERVERS)
def test_each_request_kind_serves_as_its_direct_fused_call(cls, tiny_port_model):
    model = tiny_port_model
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (4, 28, 28, 3), dtype=np.uint8)
    trace = rng.uniform(0, 1, (5, 2)).tolist()
    boxes = [(0.0, 0.0, 0.5, 0.5), (0.25, 0.3, 1.0, 0.9)]
    pixel = np.asarray([[x1 * 28, y1 * 28, (x2 - x1) * 28, (y2 - y1) * 28]
                        for x1, y1, x2, y2 in boxes], np.float32)[None]
    with cls(model, max_batch=4, max_delay_ms=50.0, max_boxes=4) as server:
        server.warmup(trace=False, cls=True, bbox=True, region_set=True, buckets=[1])
        futs = [server.submit(imgs[0], trace), server.submit(imgs[1], bboxes=boxes),
                server.submit(imgs[2], bboxes=boxes, region_set=True),
                server.submit(imgs[3])]
        got = [f.result(timeout=300) for f in futs]
        assert server.caption(imgs[3:], timeout=300) == [got[3]]
        assert server.snapshot()["requests"] == 5
    pts = np.zeros((1, 64, 2), np.float32)
    pts[0, :5] = trace
    valid = (np.arange(64) < 5).astype(np.float32)[None]
    assert got == [model.caption_traces_fused(imgs[:1], pts, valid)[0],
                   model.caption_bboxes_fused(imgs[1:2], pixel)[0],
                   model.caption_region_sets_fused(imgs[2:3], pixel)[0],
                   model.caption_images_fused(imgs[3:])[0]]


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
