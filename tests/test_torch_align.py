"""The port's contrastive alignment (`patchioner_tpu_torch/train/align.py`),
the backwards of kernels A, B and C, and the optimizer pieces it adds,
against the JAX package on the CPU, at the convergence proof's TEST
geometry (ViT 128 wide, 2 layers, 4 heads, 56 px; text tower 128 wide, 2
layers, 4 heads, context 16).

The JAX `init_align` is carried across by `bridge.align_from_jax`, so both
packages start from one init; batches are rendered with numpy.

Tolerances (f32 on both sides, only the order of f32 sums differs):
- the prefix gate of chip_smoke, max |port - JAX| <= 1e-4 * max(1, max
  |JAX|), on embeddings, the loss, the accuracy, every gradient leaf and
  the params after 3 steps;
- each `*_backward` against autograd of its plain version: max |got -
  ref| <= 1e-5 * max |ref| (both in f32 torch on the same inputs);
- the cosine schedule: within 2^-22 * lr of optax's, one or two f32 ulps
  of lr (XLA's cos and numpy's differ in the last bit);
- `OptState` with b2 = 0.98 against `optax.adamw` over 3 steps: 1e-6 *
  max(1, max |JAX leaf|).
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from patchioner_tpu.models import clip as jclip
from patchioner_tpu.models import vit as jvit
from patchioner_tpu.text import clip_bpe as jbpe
from patchioner_tpu.train import align as jalign
from patchioner_tpu.train import synthetic as jsynth
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.io.checkpoints import flatten_tree
from patchioner_tpu_torch.models import clip, vit
from patchioner_tpu_torch.ops import attention, mlp
from patchioner_tpu_torch.train import align, decoder_train, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE, BACKWARD_TOL = 1e-4, 1e-5
# a gradient entry below this share of its leaf's largest |gradient| is f32
# rounding noise: the key biases' (zero in exact arithmetic) measure 1e-8 to
# 1.1e-7 at TEST geometry
F32_NOISE = 1e-6
VIT_GEOMETRY = dict(embed_dim=128, depth=2, num_heads=4, num_registers=0, pos_grid=4,
                    extract_heads=4)
TEXT = dict(context_length=16, width=128, depth=2, heads=4, proj_dim=128)
BATCH = 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # beside the suite's other parallel workers, intra-op threads only wait
    # on busy cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    j = jalign.AlignConfig(
        vit=jvit.config_for("dinov2_vits14", img_size=56, **VIT_GEOMETRY),
        text=jclip.ClipTextConfig(**TEXT), **kw)
    p = align.AlignConfig(
        vit=vit.config_for("dinov2_vits14", img_size=56, **VIT_GEOMETRY),
        text=clip.ClipTextConfig(**TEXT), **kw)
    return j, p


@pytest.fixture(scope="module")
def world():
    combos = jsynth.all_combos(("red", "green", "blue", "yellow"),
                               ("square", "circle", "cross"), None)
    train, _ = jsynth.split_combos(combos, 6, seed=0)
    return train


@pytest.fixture(scope="module")
def jinit():
    jcfg, _ = _cfgs(steps=3, batch=BATCH)
    return jax.jit(lambda k: jalign.init_align(k, jcfg))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def batch(world):
    rng = np.random.default_rng(5)
    idx = rng.permutation(len(world))[:BATCH]
    combos = [world[i] for i in idx]
    pixels = jsynth.render_training_batch(combos, rng, 56)
    masks = np.stack([jsynth.patch_mask_for(c, 4) for c in combos])
    tokens = np.asarray(jbpe.get_tokenizer().tokenize([c.caption for c in combos], 16),
                        np.int32)
    return pixels, masks, tokens


def _port_params(jtree):
    _, pcfg = _cfgs()
    return bridge.align_from_jax(jtree, pcfg)


def _gate(got, ref, what):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= GATE * max(1.0, float(np.abs(ref).max())), f"{what}: {err}"


def _gate_trees(port_leaves: dict, jax_tree, what):
    """The gate on every leaf; port_leaves is {keystr path: tensor}."""
    jleaves = dict(flatten_tree(jax.tree.map(np.asarray, jax_tree)))
    pleaves = dict(port_leaves)
    assert pleaves.keys() == jleaves.keys()
    for name, leaf in pleaves.items():
        _gate(leaf, jleaves[name], f"{what} {name}")


def test_align_config_rejects_mismatched_spaces():
    with pytest.raises(ValueError, match="share one space"):
        align.AlignConfig(vit=vit.config_for("dinov2_vits14", img_size=56, **VIT_GEOMETRY),
                          text=clip.ClipTextConfig(**dict(TEXT, proj_dim=96)))


def test_bridge_refuses_a_foreign_tree(jinit):
    _, pcfg = _cfgs()
    with pytest.raises(ValueError, match="alignment tree"):
        bridge.align_from_jax({"vit": jinit["vit"]}, pcfg)


def test_init_align_layout_matches_jax(jinit):
    _, pcfg = _cfgs()
    port = align.init_align(pcfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = {k: np.shape(v) for k, v in flatten_tree(jax.tree.map(np.asarray, jinit))}
    assert {k: tuple(v.shape) for k, v in flatten_tree(port)} == jshapes
    assert float(port["logit_scale"]) == pytest.approx(2.6593)


def test_image_and_text_embed_match_jax(jinit, batch):
    jcfg, pcfg = _cfgs()
    pixels, masks, tokens = batch
    params = _port_params(jinit)
    with torch.no_grad():
        img = align.image_embed(params["vit"], torch.from_numpy(pixels), pcfg.vit,
                                torch.from_numpy(masks))
        txt = align.text_embed(params["text"], torch.from_numpy(tokens), pcfg.text)
    _gate(img, jalign.image_embed(jinit["vit"], jnp.asarray(pixels), jcfg.vit,
                                  jnp.asarray(masks)), "image_embed")
    _gate(txt, jalign.text_embed(jinit["text"], jnp.asarray(tokens), jcfg.text),
          "text_embed")


def _capture():
    """An optax transform whose state after an update is the gradient
    itself, and whose update is zero: the JAX step's gradients, exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_align_step_loss_accuracy_and_every_gradient_match_jax(jinit, batch):
    jcfg, pcfg = _cfgs()
    pixels, masks, tokens = batch
    tx = _capture()
    jparams = jax.tree.map(jnp.array, jinit)
    _, jgrads, jm = jalign.make_align_step(jcfg, tx)(
        jparams, tx.init(jparams), jnp.asarray(pixels), jnp.asarray(masks),
        jnp.asarray(tokens))
    params = _port_params(jinit)
    opt_state = align.make_optimizer(pcfg).init(params)  # every leaf requires grad
    loss, acc = align.align_loss(params, torch.from_numpy(pixels), torch.from_numpy(masks),
                                 torch.from_numpy(tokens), pcfg)
    loss.backward()
    _gate(loss, jm["loss"], "loss")
    _gate(acc, jm["acc"], "accuracy")
    grads = {name: leaf.grad for name, leaf in flatten_tree(params)}
    assert all(g is not None for g in grads.values())
    assert len(grads) == len(opt_state.leaves)
    _gate_trees(grads, jgrads, "gradient")
    for side in ({name: g.numpy() for name, g in grads.items()},
                 dict(flatten_tree(jax.tree.map(np.asarray, jgrads)))):
        assert _key_bias_share(side) <= F32_NOISE


def _key_bias(name: str, leaf):
    """The key slice of a fused qkv bias leaf, else None. Its gradient is
    zero in exact arithmetic: a key bias adds q . b_k to every logit of a
    row, and softmax is shift-invariant along a row."""
    if not name.endswith("['qkv']['b']"):
        return None
    d = leaf.shape[-1] // 3
    return leaf[..., d:2 * d]


def _key_bias_share(grads: dict) -> float:
    """The largest |key-bias gradient| relative to its qkv bias leaf's
    largest |gradient|, over every qkv bias leaf of `grads`."""
    shares = [float(np.abs(np.asarray(k)).max() / np.abs(np.asarray(g)).max())
              for name, g in grads.items() if (k := _key_bias(name, g)) is not None]
    assert len(shares) == VIT_GEOMETRY["depth"] + TEXT["depth"], sorted(grads)
    return max(shares)


def _three_steps_by_hand(pcfg, world, params):
    """`train_align`'s loop written out (the host generator seeded 1, a
    permutation and a render a step) with the port's step and optimizer;
    each step's gradients as {path: array}."""
    step = align.make_align_step(pcfg)
    opt_state = align.make_optimizer(pcfg).init(params)
    tokens, masks = align.tokens_and_masks(pcfg, world, 4)
    rng = np.random.default_rng(1)
    grads = []
    for _ in range(pcfg.steps):
        idx = rng.permutation(len(world))[:pcfg.batch]
        pixels = synthetic.render_training_batch([world[i] for i in idx], rng, 56)
        step(params, opt_state, torch.from_numpy(pixels), torch.from_numpy(masks[idx]),
             torch.from_numpy(tokens[idx]))
        grads.append({name: leaf.grad.numpy().copy() for name, leaf in flatten_tree(params)})
    return grads


def _jax_step_gradients(jcfg, world, jinit):
    """The JAX trainer's loop (its optimizer behind a transform that keeps
    the gradient as its state) from `jinit`: each step's gradients as
    {path: array}."""
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, optax.adamw(optax.cosine_decay_schedule(jcfg.lr, jcfg.steps),
                                       b1=0.9, b2=0.98, weight_decay=jcfg.weight_decay))
    step = jalign.make_align_step(jcfg, tx)
    params = jax.tree.map(jnp.array, jinit)
    state = tx.init(params)
    tokens = np.asarray(jbpe.get_tokenizer().tokenize([c.caption for c in world], 16),
                        np.int32)
    masks = np.stack([jsynth.patch_mask_for(c, 4) for c in world])
    rng = np.random.default_rng(1)
    grads = []
    for _ in range(jcfg.steps):
        idx = rng.permutation(len(world))[:jcfg.batch]
        pixels = jsynth.render_training_batch([world[i] for i in idx], rng, 56)
        params, state, _ = step(params, state, jnp.asarray(pixels), jnp.asarray(masks[idx]),
                                jnp.asarray(tokens[idx]))
        grads.append(dict(flatten_tree(jax.tree.map(np.asarray, state[0]))))
    return grads


def test_three_steps_of_train_align_match_jax(jinit, world, monkeypatch):
    """`train_align` from JAX's init: the host generator's permutations and
    renders, the cosine schedule and AdamW (b2 0.98) over 3 steps, then
    `retrieval_accuracy` on the trained towers.

    Adam divides a gradient by its own magnitude, so an entry whose
    gradient is f32 rounding noise at some step (below `F32_NOISE` of its
    leaf's largest) takes an update set by that noise, which differs
    between the packages. These are the attention key biases (`_key_bias`:
    zero in exact arithmetic, asserted to be noise on both sides at every
    step) and the few entries near zero by chance at a step on either
    side (each package's gradients read at every step; at most 2e-4 of
    the entries that had a gradient, 66 at this seed). Those are held to
    what two Adam trajectories of opposite signs can reach, 2 x the sum
    of the step sizes; every other entry to the gate."""
    jcfg, pcfg = _cfgs(steps=3, batch=BATCH)
    jparams, jinfo = jalign.train_align(jcfg, world, seed=0, log_every=1, verbose=False)
    # the same init on both sides: JAX's, carried across
    monkeypatch.setattr(align, "init_align", lambda cfg, gen, device: _port_params(jinit))
    params, info = align.train_align(pcfg, world, seed=0, log_every=1, verbose=False,
                                     device="cpu")
    by_hand = _port_params(jinit)
    steps = _three_steps_by_hand(pcfg, world, by_hand) + _jax_step_gradients(jcfg, world,
                                                                              jinit)
    for grads in steps:
        assert _key_bias_share(grads) <= F32_NOISE
    for (name, a), (_, b) in zip(flatten_tree(params), flatten_tree(by_hand)):
        assert torch.equal(a, b), f"train_align's loop differs from it by hand at {name}"
    assert [h["step"] for h in info["history"]] == [1, 2, 3]
    for got, ref in zip(info["history"], jinfo["history"]):
        _gate(np.float32(got["loss"]), ref["loss"], f"loss at step {ref['step']}")
        _gate(np.float32(got["acc"]), ref["acc"], f"accuracy at step {ref['step']}")
    schedule = decoder_train.cosine_decay(pcfg.lr, pcfg.steps)
    reach = 2.0 * sum(schedule(c) for c in range(pcfg.steps)) * 1.01
    jleaves = dict(flatten_tree(jax.tree.map(np.asarray, jparams)))
    noisy = seen = 0
    for name, leaf in flatten_tree(params):
        got, ref = leaf.detach().numpy(), jleaves[name]
        assert got.shape == ref.shape, name
        err = np.abs(got - ref)
        tol = GATE * max(1.0, float(np.abs(ref).max()))
        noise = np.zeros(got.shape, bool)
        for g in (grads[name] for grads in steps):
            noise |= np.abs(g) < F32_NOISE * np.abs(g).max()
        had = np.any([grads[name] != 0 for grads in steps], axis=0)
        key = _key_bias(name, noise)
        if key is not None:
            key[...] = True
        assert (err[~noise] <= tol).all(), f"params after 3 steps {name}: {err[~noise].max()}"
        assert (err[noise] <= reach).all(), f"noise entries of {name}: {err[noise].max()}"
        if key is not None:
            key[...] = False
        noisy, seen = noisy + int((noise & had).sum()), seen + int(had.sum())
    assert noisy <= 2e-4 * seen, (noisy, seen)
    got = align.retrieval_accuracy(params, pcfg, world, seed=9)
    assert got == jalign.retrieval_accuracy(jparams, jcfg, world, seed=9)


@pytest.mark.parametrize("steps", [1, 7, 250])
def test_cosine_decay_matches_optax(steps):
    lr = 1e-3
    ours = decoder_train.cosine_decay(lr, steps)
    ref = optax.cosine_decay_schedule(lr, steps)
    for count in range(steps + 2):
        assert abs(ours(count) - float(ref(np.int32(count)))) <= 2.0 ** -22 * lr, count


def test_adamw_betas_match_optax_over_three_steps():
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((8, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "s": np.float32(2.5)}
    grads = [jax.tree.map(lambda a, i=i: np.random.default_rng(10 + i).standard_normal(
        np.shape(a)).astype(np.float32), tree) for i in range(3)]
    tx = optax.adamw(optax.cosine_decay_schedule(1e-2, 3), b1=0.9, b2=0.98,
                     weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, tree)
    js = tx.init(jp)
    params = {k: torch.tensor(v) for k, v in tree.items()}
    opt = decoder_train.AdamW(decoder_train.cosine_decay(1e-2, 3), 0.05,
                              betas=(0.9, 0.98)).init(params)
    assert opt.opt.param_groups[0]["betas"] == (0.9, 0.98)
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for name, leaf in params.items():
            leaf.grad = torch.tensor(g[name])
        opt.apply()
    for name, leaf in params.items():
        ref = np.asarray(jp[name])
        err = np.abs(leaf.detach().numpy() - ref).max()
        assert err <= 1e-6 * max(1.0, float(np.abs(ref).max())), name


# --------------------------------------------------- backwards of A, B, C


def _rand(rng, *shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale,
                        requires_grad=True)


def _hold(got, ref, what):
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == r.dtype and a.shape == r.shape, (what, i)
        err = (a - r).abs().max().item()
        assert err <= BACKWARD_TOL * r.abs().max().item(), (what, i, err)


def _ln_dense_args(rng, d=128, o=384, n=17):
    return (_rand(rng, 3, n, d), _rand(rng, d, scale=0.1) + 1.0, _rand(rng, d, scale=0.1),
            _rand(rng, d, o, scale=d ** -0.5), _rand(rng, o, scale=0.1))


def _ln_mlp_args(rng, d=128, h=512, n=17):
    return (_rand(rng, 3, n, d), _rand(rng, d, scale=0.1) + 1.0, _rand(rng, d, scale=0.1),
            _rand(rng, d, h, scale=d ** -0.5), _rand(rng, h, scale=0.1),
            _rand(rng, h, d, scale=h ** -0.5), _rand(rng, d, scale=0.1),
            _rand(rng, d, scale=0.5))


def _leaves(args):
    return tuple(a.detach().requires_grad_() for a in args)


def test_ln_dense_backward_matches_autograd_of_its_plain_version():
    rng = np.random.default_rng(0)
    args = _leaves(_ln_dense_args(rng))
    out = mlp.ln_dense_plain(*args, eps=1e-6)
    g = torch.tensor(rng.standard_normal(out.shape).astype(np.float32))
    ref = torch.autograd.grad(out, args, g)
    _hold(mlp.ln_dense_backward(g, *(a.detach() for a in args[:4]), eps=1e-6), ref, "A")


@pytest.mark.parametrize("gelu_approx", [False, True])
def test_ln_mlp_backward_matches_autograd_of_its_plain_version(gelu_approx):
    rng = np.random.default_rng(1)
    args = _leaves(_ln_mlp_args(rng))
    out = mlp.ln_mlp_plain(*args, eps=1e-6, gelu_approx=gelu_approx)
    g = torch.tensor(rng.standard_normal(out.shape).astype(np.float32))
    ref = torch.autograd.grad(out, args, g)
    got = mlp.ln_mlp_backward(g, *(a.detach() for a in args), eps=1e-6,
                              gelu_approx=gelu_approx)
    _hold(got, ref, "C")


@pytest.mark.parametrize("head_dim,num_real_k", [(64, None), (32, None), (64, 11), (32, 5)])
def test_qkv_attention_backward_matches_autograd_of_its_plain_version(head_dim, num_real_k):
    rng = np.random.default_rng(2)
    heads = 3
    qkv = _rand(rng, 2, 17, 3 * heads * head_dim)
    kw = dict(num_heads=heads, scale=head_dim ** -0.5, num_real_k=num_real_k)
    out = attention.qkv_attention_plain(qkv, **kw)
    g = torch.tensor(rng.standard_normal(out.shape).astype(np.float32))
    ref, = torch.autograd.grad(out, (qkv,), g)
    got = attention.qkv_attention_backward(g, qkv.detach(), **kw)
    _hold((got,), (ref,), "B")
    if num_real_k is not None:
        k_grad = got.reshape(2, 17, 3, heads, head_dim)[:, num_real_k:, 1:]
        assert not k_grad.any(), "masked keys' k and v must get a zero gradient"


def _plain_launch(plain):
    """A stand-in for a kernel launch on the CPU: the plain version,
    outside autograd, as the kernel's ctypes call is."""
    def launch(*args):
        with torch.no_grad():
            return plain(*args)
    return launch


@pytest.mark.parametrize("which", ["A", "B", "C", "C tanh"])
def test_each_autograd_function_routes_its_backward(monkeypatch, which):
    """The Functions the CUDA wrappers use, with the launch replaced by
    the plain version (the CPU has no kernel): their gradients equal
    autograd of the plain version, and the output carries their node."""
    rng = np.random.default_rng(4)
    if which == "A":
        args = _leaves(_ln_dense_args(rng))
        monkeypatch.setattr(mlp, "_ln_dense_kernel", _plain_launch(
            lambda *a: mlp.ln_dense_plain(*a[:5], eps=a[5])))
        out = mlp._LnDense.apply(*args, 1e-6)
        ref_out = mlp.ln_dense_plain(*args, eps=1e-6)
    elif which == "B":
        args = (_rand(rng, 2, 17, 3 * 2 * 64),)
        kw = dict(num_heads=2, scale=0.125, num_real_k=13)
        monkeypatch.setattr(attention, "_qkv_attention_kernel", _plain_launch(
            lambda q, h, s, n: attention.qkv_attention_plain(q, num_heads=h, scale=s,
                                                             num_real_k=n)))
        out = attention._QkvAttention.apply(*args, 2, 0.125, 13)
        ref_out = attention.qkv_attention_plain(*args, **kw)
    else:
        approx = which == "C tanh"
        args = _leaves(_ln_mlp_args(rng))
        monkeypatch.setattr(mlp, "_ln_mlp_kernel", _plain_launch(
            lambda *a: mlp.ln_mlp_plain(*a[:8], eps=a[8], gelu_approx=a[9])))
        out = mlp._LnMlp.apply(*args, 1e-6, approx)
        ref_out = mlp.ln_mlp_plain(*args, eps=1e-6, gelu_approx=approx)
    assert type(out.grad_fn).__name__.startswith(("_LnDense", "_QkvAttention", "_LnMlp"))
    g = torch.tensor(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, args, g)
    _hold(got, torch.autograd.grad(ref_out, args, g), which)


def test_refuse_grad_and_wants_grad():
    from patchioner_tpu_torch import kernels

    x = torch.ones(2, requires_grad=True)
    assert kernels.wants_grad(x, None) and not kernels.wants_grad(torch.ones(2))
    with torch.no_grad():
        assert not kernels.wants_grad(x)
        kernels.refuse_grad("E", x)
    with pytest.raises(NotImplementedError, match="backward is not ported"):
        kernels.refuse_grad("E", x)
    with pytest.raises(NotImplementedError, match="float32 only"):
        kernels.check_grad_dtype("A", x.to(torch.bfloat16))


# ------------------------------------------------------------- imports

NEW_FILES = ["patchioner_tpu_torch/train/align.py", "patchioner_tpu_torch/train/synthetic.py",
             "scripts/convergence_proof_torch.py"]


@pytest.mark.parametrize("path", NEW_FILES)
def test_new_files_import_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "patchioner_tpu",
                                                        "optax")], names


def test_importing_the_proof_loads_no_jax():
    code = ("import sys; import scripts.convergence_proof_torch as cp; "
            "import patchioner_tpu_torch.train.align, patchioner_tpu_torch.train.synthetic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'patchioner_tpu')]; assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
