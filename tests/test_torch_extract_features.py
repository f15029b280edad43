"""The port's feature extraction and the training CLIs' text flags against
the JAX package's, on the CPU, on files written from numpy seeds (the text
tower of `test_torch_text_tower.py`'s small geometry):

- `extract_features text` with and without Talk2DINO: the .npy equal to
  the JAX package's on the same files within 1e-5;
- `extract_features bank` under the reference filename and under `--out`:
  each file read back by both packages' `load_bank`, the rows equal to the
  JAX package's bank within 1e-5 and the texts equal;
- `extract_features image`, the three selections, on the goldens' reduced
  encoder (140 px crop, a 256-row bank, two blocks) from one hub file: equal
  to the JAX package's within 1e-5 * max(1, max|ref|);
- `train.cli --encode_on_the_fly` in each of the five spaces: the features
  equal to the JAX space's within 1e-5, `--prefix_size` corrected with the
  JAX message, one step run; Talk2DINO with `--im_proj`, and DINO.txt with
  `--im_proj` over a 2048-wide bank read through its patch-aligned half;
- `prefix_cli --allow_random` without `--features`: the seeded `clip` space.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from patchioner_tpu.io import memory_bank as jmb
from patchioner_tpu.train import extract_features as jef
from patchioner_tpu.train import text_spaces as jts
from patchioner_tpu_torch.io import checkpoints, memory_bank
from patchioner_tpu_torch.train import cli, extract_features, prefix_cli

from test_torch_text_tower import SPACE_PREFIXES, TINY, tiny_openai_text_sd

CAPS = [f"a photo of object {i} on a table" for i in range(10)]
CLI_GEOM = ["--n_layer", "1", "--n_head", "2", "--n_embd", "32", "--vocab_size", "50257",
            "--max_seq_len", "12", "--epochs", "1", "--bs", "8", "--limit_steps", "1",
            "--device", "cpu"]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A caption corpus, a `clip` text tower, a Talk2DINO projection
    (128 -> 48, one hidden layer) and a 48-wide bank, written once."""
    tmp = tmp_path_factory.mktemp("extract")
    out = {"data": str(tmp / "corpus.json"), "clip": str(tmp / "clip.pt"),
           "t2d": str(tmp / "t2d.pth"), "bank48": str(tmp / "bank48.h5")}
    with open(out["data"], "w") as f:
        json.dump({"annotations": [{"caption": c, "image_id": i // 2}
                                   for i, c in enumerate(CAPS)]}, f)
    torch.save(tiny_openai_text_sd(seed=11), out["clip"])
    g = torch.Generator().manual_seed(12)
    torch.save({"linear_layer.weight": torch.randn(48, TINY["proj"], generator=g) * 0.1,
                "linear_layer.bias": torch.randn(48, generator=g) * 0.1,
                "hidden_layers.0.weight": torch.randn(48, 48, generator=g) * 0.1,
                "hidden_layers.0.bias": torch.randn(48, generator=g) * 0.1}, out["t2d"])
    emb = np.random.default_rng(13).standard_normal((32, 48)).astype(np.float32)
    jmb.save_bank(out["bank48"], "coco_captions",
                  jmb.MemoryBank(emb, [f"bank caption {i}" for i in range(32)]))
    return out


@pytest.mark.parametrize("talk2dino", [False, True])
def test_text_mode_equals_jax(files, tmp_path, talk2dino):
    argv = ["text", "--data", files["data"], "--text-weights", files["clip"], "--bs", "4"]
    if talk2dino:
        argv += ["--talk2dino", files["t2d"]]
    jef.main(argv + ["--out", str(tmp_path / "jax.npy")])
    got = extract_features.main(argv + ["--out", str(tmp_path / "port.npy"), "--device", "cpu"])
    want = np.load(tmp_path / "jax.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got)
    assert got.shape == (len(CAPS), 48 if talk2dino else TINY["proj"]) and got.dtype == np.float32
    assert _rel(got, want) <= 1e-5
    with pytest.raises(FileNotFoundError, match="nothing.pth"):
        extract_features.main(argv[:7] + ["--talk2dino", str(tmp_path / "nothing.pth"),
                                          "--out", str(tmp_path / "x.npy"), "--device", "cpu"])
    with pytest.raises(SystemExit):  # no weights and no --allow-random
        extract_features.main(["text", "--data", files["data"], "--out",
                               str(tmp_path / "x.npy"), "--device", "cpu"])


def test_bank_mode_files_read_by_both_packages(files, tmp_path):
    base = ["bank", "--data", files["data"], "--size", "8", "--seed", "0",
            "--text-weights", files["clip"], "--bs", "3"]
    fname, dataset = memory_bank.bank_filename("coco", support_memory_size=8,
                                               use_talk2dino=False)
    assert fname.startswith("clip-")
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    path = extract_features.main(base + ["--bank-dir", str(port_dir), "--device", "cpu"])
    jef.main(base + ["--bank-dir", str(jax_dir)])
    assert path == os.path.join(str(port_dir), fname)
    want = jmb.load_bank(os.path.join(str(jax_dir), fname), dataset)
    for loaded in (memory_bank.load_bank(path, dataset), jmb.load_bank(path, dataset)):
        assert loaded.texts == want.texts == jmb.load_caption_corpus(files["data"], 8, seed=0)
        assert loaded.embeddings.shape == (8, TINY["proj"])
        assert _rel(loaded.embeddings, want.embeddings) <= 1e-5
    # --out, a head slice, Talk2DINO-projected
    out = str(tmp_path / "mybank.h5")
    argv = ["bank", "--data", files["data"], "--size", "6", "--no-sample",
            "--text-weights", files["clip"], "--talk2dino", files["t2d"], "--bs", "4"]
    extract_features.main(argv + ["--out", out, "--device", "cpu"])
    jef.main(argv + ["--out", str(tmp_path / "jbank.h5")])
    want = jmb.load_bank(str(tmp_path / "jbank.h5"), "coco_captions")
    for loaded in (memory_bank.load_bank(out, "coco_captions"), jmb.load_bank(out)):
        assert loaded.texts == CAPS[:6] and loaded.embeddings.shape == (6, 48)
        assert _rel(loaded.embeddings, want.embeddings) <= 1e-5


def test_bank_encoder_times_its_parts(files):
    from patchioner_tpu_torch.train import text_spaces

    space = text_spaces.build_text_space("clip", files["clip"], device="cpu")
    enc = extract_features.BankEncoder(space, extract_features.talk2dino_projection(
        files["t2d"], "cpu"))
    bank = memory_bank.build_bank(CAPS, enc, batch_size=4)
    assert bank.embeddings.shape == (10, 48) and bank.texts == CAPS
    assert enc.seconds["tokenizer"] > 0 and enc.seconds["tower"] > 0


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """An image folder, and a model config (the goldens' 140 px crop and
    256-row bank, ViT-B/14-reg cut to two blocks) with its hub DINOv2 file,
    as YAML for the JAX package and JSON for the port."""
    import yaml
    from PIL import Image

    from patchioner_tpu_torch.models import vit
    from test_torch_checkpoints import _chip_smoke_module

    tmp = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(14)
    folder = tmp / "imgs"
    folder.mkdir()
    for name in ("b.jpg", "a.png", "c.jpeg", "d.png"):
        Image.fromarray(rng.integers(0, 255, (150, 170, 3), dtype=np.uint8)).save(folder / name)
    geometry = {"depth": 2}
    tree = vit.init_vit(vit.config_for("dinov2_vitb14_reg", img_size=140, **geometry),
                        torch.Generator().manual_seed(15))
    for blk in tree["blocks"]:
        blk["ls1"], blk["ls2"] = 1 + 0.1 * torch.randn(2, 768, generator=torch.Generator()
                                                       .manual_seed(16))
    dino = str(tmp / "dinov2.pth")
    torch.save(_chip_smoke_module().hub_state_dict(tree), dino)
    config = {"dino_model": "dinov2_vitb14_reg", "crop_dim": 140, "prefix_size": 768,
              "support_memory_size": 256, "normalize": True, "projection_type": "coco",
              "dino_weights": dino, "dino_geometry": geometry,
              "decap_arch": {"n_layer": 1, "n_head": 2, "n_embd": 32, "vocab_size": 50257}}
    (tmp / "model.yaml").write_text(yaml.safe_dump(config))
    (tmp / "model.json").write_text(json.dumps(config))
    return {"folder": str(folder), "yaml": str(tmp / "model.yaml"),
            "json": str(tmp / "model.json")}


@pytest.mark.parametrize("select", ["cls", "avg_self_attn", "avg_patch"])
def test_image_mode_equals_jax(images, tmp_path, select):
    argv = ["image", "--images", images["folder"], "--select", select, "--bs", "4",
            "--allow-random"]
    jef.main(argv + ["--config", images["yaml"], "--out", str(tmp_path / "jax.npy")])
    out = str(tmp_path / "port.npy")
    got = extract_features.main(argv + ["--config", images["json"], "--out", out,
                                        "--device", "cpu"])
    assert got.shape == (4, 768) and np.isfinite(got).all()
    assert _rel(got, np.load(tmp_path / "jax.npy")) <= 1e-5
    with open(out + ".names.json") as f:
        assert json.load(f) == ["a.png", "b.jpg", "c.jpeg", "d.png"]


def _cli_corpus(tmp_path, n=16):
    path = tmp_path / "caps.json"
    path.write_text(json.dumps({"annotations": [
        {"image_id": i // 2, "caption": f"caption {i} about a cat"} for i in range(n)]}))
    return str(path), [f"caption {i} about a cat" for i in range(n)]


@pytest.mark.parametrize("name", list(SPACE_PREFIXES))
def test_cli_encodes_on_the_fly_in_each_space(name, tmp_path, capsys):
    data, captions = _cli_corpus(tmp_path)
    weights = str(tmp_path / f"{name}.pth")
    torch.save(tiny_openai_text_sd(SPACE_PREFIXES[name], seed=17), weights)
    flags = ["--text_encoder", name, "--text_weights", weights]
    args = cli.build_argparser().parse_args(["--data", data, *flags, "--device", "cpu"])
    got = cli.encode_captions(args, captions, torch.device("cpu"))
    space = jts.build_text_space(name, weights)
    want = np.concatenate([np.asarray(space.encode_tokens(space.tokenize(captions[i:i + 256])))
                           for i in range(0, len(captions), 256)])
    assert got.shape == want.shape and _rel(got, want) <= 1e-5
    out = tmp_path / "ckpt"
    cli.main(["--data", data, "--encode_on_the_fly", *flags, "--out_dir", str(out),
              "--prefix_size", "16", *CLI_GEOM])
    assert (f"Updating prefix_size from 16 to {got.shape[1]} ({name} space)"
            in capsys.readouterr().out)
    assert checkpoints.CheckpointManager(str(out)).latest_step() == 1


def test_cli_talk2dino_and_dinotxt_banks(files, tmp_path):
    data, captions = _cli_corpus(tmp_path)
    out = tmp_path / "t2d"
    cli.main(["--data", data, "--encode_on_the_fly", "--text_weights", files["clip"],
              "--talk2dino_weights", files["t2d"], "--im_proj", "--bank", files["bank48"],
              "--out_dir", str(out), *CLI_GEOM])
    trained = checkpoints.CheckpointManager(str(out)).restore()
    assert trained["params"]["clip_project"]["w"].shape[0] == 48
    # DINO.txt: a 2048-wide tower; the bank keeps 2048 columns, read [:, 1024:]
    weights = str(tmp_path / "dinotxt.pth")
    torch.save(tiny_openai_text_sd("text_model.", seed=18, proj=2048), weights)
    bank = str(tmp_path / "bank2048.h5")
    memory_bank.save_bank(bank, "coco_captions", memory_bank.MemoryBank(
        np.random.default_rng(19).standard_normal((32, 2048)).astype(np.float32),
        [f"t {i}" for i in range(32)]))
    out = tmp_path / "dinotxt"
    cli.main(["--data", data, "--encode_on_the_fly", "--text_encoder", "dinotxt",
              "--text_weights", weights, "--im_proj", "--bank", bank, "--out_dir", str(out),
              *CLI_GEOM])
    trained = checkpoints.CheckpointManager(str(out)).restore()
    assert trained["params"]["clip_project"]["w"].shape[0] == 1024
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        cli.main(["--data", data, "--encode_on_the_fly", "--talk2dino_weights",
                  str(tmp_path / "missing.pth"), "--out_dir", str(tmp_path / "o"), *CLI_GEOM])


def test_prefix_cli_allow_random_encodes_the_captions(tmp_path, capsys):
    data, _ = _cli_corpus(tmp_path, n=8)
    out = tmp_path / "viecap"
    prefix_cli.main(["--model", "viecap", "--data", data, "--out_dir", str(out), "--bs", "4",
                     "--max_seq_len", "12", "--n_layer", "1", "--n_head", "2", "--n_embd", "32",
                     "--num_layers", "1", "--limit_steps", "1", "--allow_random",
                     "--device", "cpu"])
    assert "[!] no text weights — seeded random clip encoder" in capsys.readouterr().out
    with open(out / "mapper_meta.json") as f:
        assert json.load(f)["clip_hidden_size"] == 512
    assert checkpoints.CheckpointManager(str(out)).latest_step() == 1
    assert isinstance(prefix_cli.build_argparser(), argparse.ArgumentParser)
