"""The port's training path against the JAX package (CPU, float32, TINY).

* The trainable set: at TINY the same parameters as JAX's
  ``partition_params``; at FULL, on the meta device, the JAX package's
  28,591,297 trainable parameters (``tests/test_factory.py``).
* The optimizer against optax: AdamW with the no-decay rule, the step
  schedule and optax's global-norm clip.
* The mapper and the loader against the JAX package's on the same
  ``RandomState``.
* The backbone's slide training (two overlapping 128-px crops of a
  128x192 image, one at a time, each checkpointed), one whole CategoryODISE step and one whole CaptionODISE step against
  ``make_category_train_step`` / ``make_caption_train_step``: losses,
  trainable gradients and the parameters after AdamW; and the port's
  ``accum_steps=2`` against the mean of its micro-batches' gradients, as
  ``tests/test_accum.py`` checks the JAX step.

Compiling a whole JAX train step takes minutes on a CPU, so the JAX side
of the backbone and whole-step cases is computed once by this module run
as a script,

    JAX_PLATFORMS=cpu python -m tests.test_torch_train

which writes ``tests/data/torch_train_reference.npz`` from the JAX package
on the inputs below (every input is made here from a seed; the parameters
from the JAX model's shapes, kept in the file, by ``perturbed_params``).
The tests recompute JAX's random draws from the same keys. The file keeps a
fingerprint of every input it was made from and the versions of the JAX
packages that made it; loading it checks both, and
``test_reference_file_comes_from_jax`` runs JAX's criterion live on the
JAX forward's outputs kept in the file and must reproduce the step's losses.
"""

import hashlib

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_torch.model_zoo.from_jax import flax_leaf_to_torch, flax_to_torch_name  # noqa: E402
from odise_torch.model_zoo.from_jax import load_flax_params  # noqa: E402

from .test_torch_losses import inject, jax_criterion_draws  # noqa: E402
from .test_torch_towers import perturbed_params  # noqa: E402
from .torch_threads import train_threads  # noqa: F401,E402

REF = Path(__file__).with_name("data") / "torch_train_reference.npz"
LABELS = (("thing a",), ("thing b",), ("stuff c",))
# 128-px images: at 64 px the TINY UNet's last level is 1x1 and its
# GroupNorm amplifies rounding noise some 300x (tests/test_torch_model.py)
SIZE, B, T, WORDS = 128, 2, 3, 3
# enough points that every target is sampled where its mask is: with none,
# two targets of the caption step's one class would cost the same and the
# auction's choice between them would follow float32 noise
CRIT = dict(num_points=128)
OPT = dict(lr=1e-3, weight_decay=0.05)
CLIP = 0.01
STEP_KEY = 11
PARAM_SEED = {"category": 21, "caption": 22}  # the perturbed parameters' seeds
CAPTIONER = ("alpha_cond", "alpha_cond_time_embed", "clip_project", "time_embed_project")


def step_batch(caption: bool, n: int = B, seed: int = 0):
    """A seeded batch: images, three targets per image (one invalid in the
    second image), rectangles as masks; caption words for the caption step."""
    from odise_torch.models.clip.tokenizer import tokenize

    rng = np.random.RandomState(seed + caption)
    batch = {"image": rng.rand(n, SIZE, SIZE, 3).astype(np.float32),
             "gt_labels": rng.randint(0, 3, (n, T)).astype(np.int32),
             "gt_masks": np.zeros((n, T, SIZE, SIZE), bool),
             "gt_valid": np.ones((n, T), bool)}
    for b in range(n):
        for t in range(T):
            y, x = rng.randint(0, SIZE - 56, 2)
            batch["gt_masks"][b, t, y:y + rng.randint(24, 56), x:x + rng.randint(24, 56)] = True
    batch["gt_valid"][1::2, 2] = False
    if caption:
        words = [["a cat", "grass", ""], ["a dog", "", ""]] * (n // 2)
        batch["word_tokens"] = np.stack([tokenize(w) for w in words]).astype(np.int32)
        batch["word_valid"] = np.array([[bool(x) for x in w] for w in words])
    return batch


def text_embed_raw():
    return np.random.RandomState(7).randn(len(LABELS), 16).astype(np.float32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_versions():
    import flax
    import jaxlib
    import optax

    return (f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
            f"flax {flax.__version__}, optax {optax.__version__}")


def fingerprint(shapes):
    """sha256 of every input a reference is made from: the constants above,
    both step batches, the text embedding, the backbone case and the
    perturbed parameters of ``shapes`` (tag -> flax shape tree)."""
    h = hashlib.sha256(repr((LABELS, SIZE, B, T, WORDS, CRIT, OPT, CLIP, STEP_KEY,
                             PARAM_SEED, CAPTIONER)).encode())

    def add(name, x):
        x = np.ascontiguousarray(x)
        h.update(f"{name} {x.dtype} {x.shape}".encode())
        h.update(x.tobytes())

    for caption in (False, True):
        for k, v in sorted(step_batch(caption).items()):
            add(f"batch {caption} {k}", v)
    add("text", text_embed_raw())
    img, cot = backbone_inputs()
    add("backbone image", img)
    for k, v in sorted(cot.items()):
        add(f"backbone cotangent {k}", v)
    for tag in sorted(shapes):
        params = perturbed_params(shapes[tag], seed=PARAM_SEED[tag])["params"]
        for path, v in sorted(_flat(params)):
            add(f"{tag} " + "/".join(path), v)
    return h.hexdigest()


def _nest(pairs):
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


# ---------------------------------------------------------------------------
# the JAX side, run once as a script


def _jax_models():
    from odise_tpu.model_zoo.factory import build_caption_odise, build_category_odise

    kw = dict(train_labels=LABELS, with_clip_head=False, use_checkpoint=False,
              slide_training=False, backbone_in_size=(SIZE, SIZE))
    return build_category_odise("tiny", **kw), build_caption_odise("tiny", **kw)


def _jax_step(model, caption, params, batch, key):
    """losses, trainable gradients and the parameters after one step of the
    JAX package's train step."""
    from odise_tpu.engine.optimizer import make_optimizer
    from odise_tpu.engine.train_loop import (TrainState, make_caption_train_step,
                                             make_category_train_step, merge_param_trees,
                                             partition_params)
    from odise_tpu.losses import CriterionConfig, GroundingConfig, set_criterion
    from odise_tpu.losses import mask_grounding_criterion

    trainable, frozen = partition_params(params)
    tx = make_optimizer(trainable, **OPT, grad_clip=CLIP)
    cfg = CriterionConfig(num_classes=1 if caption else len(LABELS), **CRIT)
    gcfg = GroundingConfig(collect_mode=None)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    text = jnp.asarray(text_embed_raw())
    if caption:
        step = make_caption_train_step(model, tx, cfg, gcfg, frozen_params=frozen,
                                       grad_clip=CLIP, donate=False)
    else:
        step = make_category_train_step(model, tx, cfg, text, LABELS, frozen_params=frozen,
                                        grad_clip=CLIP, donate=False)
    state, metrics = step(TrainState(0, trainable, tx.init(trainable)), jb, key)

    def loss_fn(p):  # the train step's own loss
        merged = merge_param_trees(frozen, p)
        if caption:
            outs = model.apply({"params": merged}, jb["image"], jb["word_tokens"],
                               method=type(model).forward_train)
            labels = jnp.zeros_like(jb["gt_labels"])
        else:
            outs = model.apply({"params": merged}, jb["image"], text, LABELS,
                               method=type(model).forward_train)
            labels = jb["gt_labels"]
        losses = set_criterion(outs, {"labels": labels, "masks": jb["gt_masks"],
                                      "valid": jb["gt_valid"]}, key, cfg)
        if caption:
            losses.update(mask_grounding_criterion(outs, jb["word_valid"], gcfg))
        return sum(losses.values())

    grads = jax.jit(jax.grad(loss_fn))(trainable)
    return metrics, grads, state.params


def _jax_backbone(model, params, img, cot):
    """Slide-training features of the backbone (two 128-px crops of a
    128x192 image) and the gradients of sum(features * cot) for the
    captioner's trainable parameters."""
    from odise_tpu.model_zoo.factory import build_category_odise

    slide = build_category_odise("tiny", train_labels=LABELS, with_clip_head=False,
                                 use_checkpoint=True, slide_training=True,
                                 slide_serial=True, backbone_in_size=(SIZE, SIZE))
    fx = params["backbone"]["feature_extractor"]
    names = sorted(cot)

    def feats(sub):
        p = dict(params, backbone=dict(params["backbone"],
                                       feature_extractor=dict(fx, **sub)))
        return slide.apply({"params": p}, jnp.asarray(img), True,
                           method=lambda m, x, t: m.backbone(x, training=t))

    def loss(sub):
        f = feats(sub)
        return sum(jnp.sum(f[k] * cot[k]) for k in names), f

    grads, f = jax.jit(jax.grad(loss, has_aux=True))({k: fx[k] for k in CAPTIONER})
    return {k: np.asarray(v) for k, v in f.items()}, grads


def _jax_outputs(model, params, batch):
    """The JAX forward's training outputs on the category step's batch."""
    outs = jax.jit(lambda p, x, t: model.apply({"params": p}, x, t, LABELS,
                                                method=type(model).forward_train))(
        params, jnp.asarray(batch["image"]), jnp.asarray(text_embed_raw()))
    layers = [outs] + list(outs["aux_outputs"])
    return {f"{i}/{k}": np.asarray(l[k]) for i, l in enumerate(layers)
            for k in ("pred_logits", "pred_masks")}


def write_reference():
    cat, cap = _jax_models()
    out = {}
    shape_trees = {}
    key = jax.random.PRNGKey(STEP_KEY)
    for tag, model, caption in (("category", cat, False), ("caption", cap, True)):
        batch = step_batch(caption)
        aux = (jnp.asarray(batch["word_tokens"][:1]) if caption
               else jnp.asarray(text_embed_raw()))
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), aux,
            method=type(model).init_full))
        for path, s in _flat(shapes["params"]):
            out[f"{tag}/shape/" + "/".join(path)] = np.asarray(s.shape, np.int64)
        shape_trees[tag] = shapes
        params = perturbed_params(shapes, seed=PARAM_SEED[tag])["params"]
        metrics, grads, new = _jax_step(model, caption, params, batch, key)
        for k, v in metrics.items():
            out[f"{tag}/metric/{k}"] = np.asarray(v)
        for path, v in _flat(grads):
            out[f"{tag}/grad/" + "/".join(path)] = np.asarray(v)
        for path, v in _flat(new):
            out[f"{tag}/new/" + "/".join(path)] = np.asarray(v)
        print(tag, {k: float(v) for k, v in metrics.items()}, flush=True)
        if not caption:
            for k, v in _jax_outputs(model, params, batch).items():
                out[f"category/output/{k}"] = v
            img, cot = backbone_inputs()
            feats, bgrads = _jax_backbone(model, params, img, cot)
            for k, v in feats.items():
                out[f"backbone/feature/{k}"] = v
            for path, v in _flat(bgrads):
                out["backbone/grad/" + "/".join(path)] = np.asarray(v)
    out["meta/fingerprint"] = np.asarray(fingerprint(shape_trees))
    out["meta/versions"] = np.asarray(jax_versions())
    REF.parent.mkdir(exist_ok=True)
    np.savez_compressed(REF, **out)
    print(f"wrote {REF} ({REF.stat().st_size / 1e6:.2f} MB)")


# ---------------------------------------------------------------------------
# the port against it


@pytest.fixture(scope="module")
def ref():
    """The reference file, checked: made by the JAX packages installed here
    from exactly the inputs this module makes."""
    with np.load(REF) as f:
        ref = {k: f[k] for k in f.files}
    assert str(ref["meta/versions"]) == jax_versions(), (
        f"{REF.name} was made with {ref['meta/versions']}; rerun "
        "`python -m tests.test_torch_train`")
    shapes = {tag: _shapes(ref, tag) for tag in PARAM_SEED}
    assert str(ref["meta/fingerprint"]) == fingerprint(shapes), (
        f"{REF.name} was made from other inputs; rerun `python -m tests.test_torch_train`")
    return ref


def _shapes(ref, tag):
    prefix = f"{tag}/shape/"
    return {"params": _nest((tuple(k[len(prefix):].split("/")),
                             jax.ShapeDtypeStruct(tuple(int(d) for d in v), jnp.float32))
                            for k, v in ref.items() if k.startswith(prefix))}


def _tree(ref, prefix):
    return {tuple(k[len(prefix):].split("/")): v for k, v in ref.items()
            if k.startswith(prefix)}


def _port_model(ref, tag, **kw):
    """The TINY port model with the JAX reference's perturbed parameters."""
    from odise_torch.model_zoo.factory import build_caption_odise, build_category_odise

    build = build_caption_odise if tag == "caption" else build_category_odise
    opts = dict(use_checkpoint=False, slide_training=False, backbone_in_size=(SIZE, SIZE))
    opts.update(kw)
    model = build("tiny", train_labels=LABELS, with_clip_head=False, device="cpu", **opts)
    load_flax_params(model, perturbed_params(_shapes(ref, tag), seed=PARAM_SEED[tag]))
    return model


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("gt_labels", "word_tokens"):
        if k in out:
            out[k] = out[k].long()
    return out


def _port_name(path):
    return flax_to_torch_name(path)


def _close_tree(got, want, rel, what, floor=0.0):
    """Each leaf within ``rel`` of its largest reference entry, or within
    ``floor`` times the largest entry of the whole tree."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g = got[_port_name(path)]
        w = flax_leaf_to_torch(path, w)
        atol = max(rel * float(np.abs(w).max()), floor * top) + 1e-12
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


def test_trainable_set_matches_jax_partition_at_tiny(ref):
    """``partition_params`` leaves trainable exactly the tensors JAX's
    ``partition_params`` keeps (by flax path), holds them in float32 and
    freezes the rest; the CLIP head, when built, is frozen whole."""
    from odise_tpu.engine.train_loop import partition_params as j_partition
    from odise_torch.engine import partition_params
    from odise_torch.model_zoo.factory import build_category_odise

    j_train, j_frozen = j_partition(_shapes(ref, "category")["params"])
    want = {_port_name(p): int(np.prod(s.shape)) for p, s in _flat(j_train)}
    model = _port_model(ref, "category")
    trainable, frozen = partition_params(model)
    assert {k: p.numel() for k, p in trainable.items()} == want
    assert len(frozen) == len(list(_flat(j_frozen)))
    assert all(p.requires_grad and p.dtype == torch.float32 for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    with_head = build_category_odise("tiny", train_labels=LABELS, device="cpu",
                                     dtype=torch.bfloat16)
    t2, f2 = partition_params(with_head)
    assert set(t2) == set(want) and any(k.startswith("clip_head.") for k in f2)
    assert all(p.dtype == torch.float32 for p in t2.values())
    assert any(p.dtype == torch.bfloat16 for p in f2.values())


def test_reference_file_comes_from_jax(ref):
    """The category step's losses kept in the reference file are the JAX
    package's: its ``set_criterion``, run here on the JAX forward's outputs
    kept in the file with the step's key, gives each of them within 1e-5
    relative (the same float32 criterion, jitted apart from the step). And
    the port's ``forward_train`` on the same parameters and batch gives
    those outputs within 1e-4 of each output's largest entry (float32
    through the TINY model, as in ``test_train_step_matches_jax``)."""
    from odise_tpu.losses import CriterionConfig, set_criterion

    batch = step_batch(False)
    keys = ("pred_logits", "pred_masks")
    n = sum(k.startswith("category/output/") and k.endswith("/pred_logits") for k in ref)
    layers = [{k: ref[f"category/output/{i}/{k}"] for k in keys} for i in range(n)]
    assert n == 4
    outs = dict(layers[0], aux_outputs=layers[1:])
    targets = {"labels": batch["gt_labels"], "masks": batch["gt_masks"],
               "valid": batch["gt_valid"]}
    cfg = CriterionConfig(num_classes=len(LABELS), **CRIT)
    losses = jax.jit(lambda o, t: set_criterion(o, t, jax.random.PRNGKey(STEP_KEY), cfg))(
        jax.tree_util.tree_map(jnp.asarray, outs),
        jax.tree_util.tree_map(jnp.asarray, targets))
    assert len(losses) == 3 * n
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(ref[f"category/metric/{k}"]), rtol=1e-5,
                                   err_msg=k)
    model = _port_model(ref, "category")
    with torch.no_grad():
        port = model.forward_train(torch.from_numpy(batch["image"]),
                                   torch.from_numpy(text_embed_raw()), LABELS)
    for i, layer in enumerate([port] + list(port["aux_outputs"])):
        for k in keys:
            want = layers[i][k]
            np.testing.assert_allclose(layer[k].numpy(), want, rtol=0,
                                       atol=1e-4 * float(np.abs(want).max()),
                                       err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("with_clip_head", [False, True])
def test_full_trainable_count_is_jax_count(with_clip_head):
    """FULL CategoryODISE on the meta device (no weight allocated): the JAX
    package's 28,591,297 trainable parameters (tests/test_factory.py), with
    or without the frozen CLIP head."""
    from odise_torch.engine import partition_params
    from odise_torch.model_zoo.factory import build_category_odise

    model = build_category_odise("full", with_clip_head=with_clip_head, device="meta",
                                 dtype=torch.bfloat16)
    trainable, frozen = partition_params(model)
    assert sum(p.numel() for p in trainable.values()) == 28_591_297
    assert sum(p.numel() for p in frozen.values()) > 1_000_000_000


def test_optimizer_matches_optax():
    """Three steps of the port's AdamW and clip against the JAX package's
    ``make_optimizer`` (optax clip_by_global_norm, then adamw with its
    no-decay mask, a warmup and a milestone) on a small tree of kernels,
    biases, a norm scale and raw parameters: 1e-6 relative."""
    import optax

    from odise_tpu.engine.optimizer import make_optimizer as j_make
    from odise_torch.engine.optimizer import clip_by_global_norm_, global_norm
    from odise_torch.engine.optimizer import make_optimizer

    rng = np.random.RandomState(0)
    tree = {"dense": {"kernel": rng.randn(3, 4), "bias": rng.randn(4)},
            "norm": {"scale": rng.randn(4), "bias": rng.randn(4)},
            "query_embed": rng.randn(5, 4), "positional_embedding": rng.randn(1, 3, 4),
            "logit_scale": np.float64(2.0)}
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)
    kw = dict(lr=1e-2, weight_decay=0.05, milestones=(2,), warmup_steps=2,
              warmup_factor=0.1)
    tx = j_make(tree, grad_clip=0.5, **kw)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(j_params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    port = {_port_name(p): torch.nn.Parameter(torch.from_numpy(
        np.array(flax_leaf_to_torch(p, v)))) for p, v in _flat(tree)}
    opt = make_optimizer(port, **kw)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda x: np.asarray(rng.randn(*x.shape), np.float32), tree)
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, g), state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for p, v in _flat(g):
            port[_port_name(p)].grad = torch.from_numpy(np.array(flax_leaf_to_torch(p, v)))
        grads = [q.grad for q in port.values()]
        clip_by_global_norm_(grads, 0.5, global_norm(grads))
        opt.step()
    for p, v in _flat(jax.tree_util.tree_map(np.asarray, j_params)):
        np.testing.assert_allclose(port[_port_name(p)].detach().numpy(),
                                   flax_leaf_to_torch(p, v), rtol=1e-6, atol=1e-7,
                                   err_msg="/".join(p))


def test_mapper_and_loader_match_jax():
    """Three batches of two from both packages' loaders over the same
    in-memory records, seeds and ``RandomState`` draws (flip, LSJ scale,
    crop window, caption words with dropout): equal targets and words, and
    images within one uint8 level (cv2 resizes uint8 in fixed point)."""
    from odise_tpu.data import dataset_mapper as jdm
    from odise_tpu.data import loader as jl
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_train_loader
    from odise_torch.data.synthetic import make_shapes_records

    records = make_shapes_records(3, size=96, seed=2, with_captions=True, vary=True)
    kw = dict(image_size=64, max_instances=4, with_captions=True, num_words=3,
              word_dropout=0.3)
    ours = build_train_loader(records, COCOPanopticDatasetMapper(device="cpu", **kw), 2,
                              seed=5)
    theirs = jl.build_train_loader(records, jdm.COCOPanopticDatasetMapper(**kw), 2, seed=5)
    for _ in range(3):
        got, want = next(ours), next(theirs)
        assert sorted(got) == sorted(want)
        for k in ("gt_labels", "gt_masks", "gt_valid", "word_tokens", "word_valid"):
            assert np.array_equal(got[k].numpy(), want[k]), k
        assert got["gt_valid"].any()
        assert float(np.abs(got["image"].numpy() - want["image"]).max()) <= 1 / 255 + 1e-6


def test_backbone_slide_training_matches_jax(ref):
    """Slide training over two overlapping 128-px crops of a 128x192 image,
    run one at a time, each checkpointed, and averaged where they overlap:
    the s2..s5 features, and the gradients that reach the captioner's
    trainable parameters through the frozen UNet. Features 1e-4, gradients
    1e-4 of their largest entry: float32 through the SD towers and the
    UNet's backward. (A grid of 64-px crops would put the TINY UNet's
    deepest level at 1x1, whose one-value GroupNorm groups amplify rounding
    noise to 1e-2 in both packages; see tests/test_torch_model.py.)"""
    img, cot = backbone_inputs()
    model = _port_model(ref, "category", use_checkpoint=True, slide_training=True,
                        slide_serial=True)
    from odise_torch.engine import partition_params

    trainable, _ = partition_params(model)
    calls = []
    hook = model.backbone.feature_extractor.register_forward_pre_hook(
        lambda m, a: calls.append(tuple(a[0].shape)))
    feats = model.backbone(torch.from_numpy(img).permute(0, 3, 1, 2), training=True)
    loss = sum((feats[k] * torch.from_numpy(cot[k]).permute(0, 3, 1, 2)).sum() for k in cot)
    loss.backward()
    hook.remove()
    # two crops, one at a time, each run again in the backward
    assert calls == [(1, 3, SIZE, SIZE)] * 4
    for k in cot:
        np.testing.assert_allclose(feats[k].detach().permute(0, 2, 3, 1).numpy(),
                                   ref[f"backbone/feature/{k}"], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    want = _tree(ref, "backbone/grad/")
    got = {}
    for path in want:
        name = "backbone.feature_extractor." + _port_name(path)
        got[_port_name(path)] = trainable[name].grad.numpy()
    assert {p[0] for p in want} == set(CAPTIONER)
    _close_tree(got, want, 1e-4, "captioner grad", floor=1e-5)


def _port_step(ref, tag, monkeypatch, accum=1, n=B):
    from odise_torch.engine import (make_caption_train_step, make_category_train_step,
                                    make_optimizer, partition_params)
    from odise_torch.losses import CriterionConfig

    caption = tag == "caption"
    model = _port_model(ref, tag)
    trainable, _ = partition_params(model)
    opt = make_optimizer(trainable, **OPT)
    cfg = CriterionConfig(num_classes=1 if caption else len(LABELS), **CRIT)
    if caption:
        step = make_caption_train_step(model, opt, cfg, grad_clip=CLIP, accum_steps=accum)
    else:
        step = make_category_train_step(model, opt, cfg, torch.from_numpy(text_embed_raw()),
                                        LABELS, grad_clip=CLIP, accum_steps=accum)
    return model, trainable, step


@pytest.mark.parametrize("tag", ["category", "caption"])
def test_train_step_matches_jax(tag, ref, monkeypatch):
    """One whole step against the JAX package's train step on the same
    parameters, batch and random points: every loss and metric, the
    trainable gradients (the port's after optax's clip, so JAX's scaled by
    the same clip) and every trainable parameter after AdamW.

    Float32 through the TINY model, its backward, the criterion and the
    grounding loss. Losses 1e-4 relative. Gradients within 1e-2 of each
    tensor's largest entry (measured up to 5.8e-3, in the backbone's
    projections, whose normalisations over one-channel groups cancel most
    of the gradient), or within 1e-6 of the set's largest gradient for
    tensors whose gradient vanishes in exact arithmetic and is float32
    noise in both (a bias before a normalisation, a key bias under the
    softmax). Parameters: a first AdamW step moves each by
    lr * g / (|g| + eps) plus the decay. Where JAX's gradient (after the
    clip) is at least 100 eps, that is insensitive to float32 noise, and
    each parameter is held within 1e-5 of JAX's (measured up to 1.4e-6);
    below (some 30% of the entries here) the step divides noise by noise,
    and each parameter is held only within 2 lr, the most two such steps
    can differ."""
    from odise_torch.losses import CriterionConfig

    caption = tag == "caption"
    model, trainable, step = _port_step(ref, tag, monkeypatch)
    cfg = CriterionConfig(**CRIT)
    inject(monkeypatch, jax_criterion_draws(jax.random.PRNGKey(STEP_KEY), 4, B, B * T, cfg))
    metrics = step(_torch_batch(step_batch(caption)), None)
    want = {k[len(tag) + 8:]: float(v) for k, v in ref.items()
            if k.startswith(f"{tag}/metric/")}
    assert sorted(metrics) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=1e-4, atol=1e-7, err_msg=k)
    scale = min(1.0, CLIP / want["grad_norm"])
    grads = _tree(ref, f"{tag}/grad/")
    got = {n: p.grad.numpy() for n, p in trainable.items()}
    assert set(got) == {_port_name(p) for p in grads}
    _close_tree(got, {p: g * scale for p, g in grads.items()}, 1e-2, "grad", floor=1e-6)
    for path, w in _tree(ref, f"{tag}/new/").items():
        name = _port_name(path)
        strong = np.abs(flax_leaf_to_torch(path, grads[path]) * scale) >= 100 * 1e-8
        diff = np.abs(trainable[name].detach().numpy() - flax_leaf_to_torch(path, w))
        bound = np.where(strong, 1e-5, 2 * OPT["lr"] + 1e-6)
        assert (diff <= bound).all(), ("/".join(path), float((diff - bound).max()))


def test_accum_steps_2_equals_mean_of_micro_grads(ref, monkeypatch):
    """``accum_steps=2`` on a batch of two: one update with the mean of the
    two micro-batches' gradients, each micro-batch's losses taken with the
    mean of the micro-batches' target counts (3 and 2 here: 2.5, as DDP's
    all-reduced count), against the same computed by hand: 1e-6 relative
    (the same float32 arithmetic)."""
    from odise_torch.engine import make_optimizer, partition_params
    from odise_torch.engine.optimizer import clip_by_global_norm_, global_norm
    from odise_torch.losses import CriterionConfig, matcher, set_criterion

    def draws():
        counter = iter(range(10 ** 6))

        def draw(generator, shape, device, kind, layer):
            return torch.from_numpy(np.random.RandomState(next(counter)).rand(*shape)
                                    .astype(np.float32))
        return draw

    batch = _torch_batch(step_batch(False))
    monkeypatch.setattr(matcher, "draw_uniform", draws())
    model, trainable, step = _port_step(ref, "category", monkeypatch, accum=2)
    metrics = step(batch, None)

    monkeypatch.setattr(matcher, "draw_uniform", draws())
    model2 = _port_model(ref, "category")
    train2, _ = partition_params(model2)
    opt2 = make_optimizer(train2, **OPT)
    cfg = CriterionConfig(num_classes=len(LABELS), **CRIT)
    params = list(train2.values())
    nm = torch.tensor(2.5)
    totals, grad_sum = [], [torch.zeros_like(p) for p in params]
    for i in range(2):
        mb = {k: v[i:i + 1] for k, v in batch.items()}
        outs = model2.forward_train(mb["image"], torch.from_numpy(text_embed_raw()), LABELS)
        losses = set_criterion(outs, {"labels": mb["gt_labels"], "masks": mb["gt_masks"],
                                      "valid": mb["gt_valid"]}, cfg, None, nm)
        total = sum(losses.values())
        for acc, g in zip(grad_sum, torch.autograd.grad(total, params, allow_unused=True)):
            if g is not None:
                acc += g
        totals.append(float(total.detach()))
    for p, g in zip(params, grad_sum):
        p.grad = g / 2
    grads = [p.grad for p in params]
    clip_by_global_norm_(grads, CLIP, global_norm(grads))
    opt2.step()
    np.testing.assert_allclose(float(metrics["total_loss"]), np.mean(totals), rtol=1e-6)
    for name, p in trainable.items():
        np.testing.assert_allclose(p.detach().numpy(), train2[name].detach().numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


def backbone_inputs():
    """A 128x192 image (two crops of 128 px overlapping by 64) and a
    cotangent for each feature map."""
    rng = np.random.RandomState(5)
    w = SIZE * 3 // 2
    img = rng.rand(1, SIZE, w, 3).astype(np.float32)
    cot = {f"s{i}": rng.randn(1, SIZE >> i, w >> i, 32).astype(np.float32)
           for i in (2, 3, 4, 5)}
    return img, cot


if __name__ == "__main__":
    write_reference()
