"""The mesh's ``model`` axis (``odise_torch/parallel/mesh.py``) on the CPU.

* ``param_sharding_rule`` shards exactly the leaves JAX's rule shards at
  ``model=2``, on the torch dimension that holds the flax last dimension:
  TINY against a live ``jax.eval_shape`` of the JAX model, FULL against
  ``odise_tpu/model_zoo/bench_manifest.json.gz`` with the port on the
  ``meta`` device.
* Two gloo ranks at ``data=1, model=2`` hold half of each sharded leaf and
  the rest whole, and give one unsharded process's eval outputs and train
  step bitwise (the all-gather moves bytes, so the ranks compute on the
  very weights the process does, in the same order, on one thread each).
  The train step runs the backbone under ``torch.utils.checkpoint``, whose
  recomputed forward gathers again.
* At ``data=2, model=1`` the data axis is the default group: every rank
  reads its own place and the world's size, as before the mesh.
"""

import gzip
import json
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from .torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
LABELS = (("thing a",), ("thing b",), ("stuff c",))
SIZE, B, T = 128, 2, 3
WORLD = 2


def _torch_dim(path, shape):
    """The torch dimension that holds a flax leaf's last dimension."""
    return 0 if path[-1] == "kernel" else len(shape) - 1


def _jax_sharded(leaves):
    """flax path -> whether JAX's rule shards it over ``model`` on a CPU mesh
    of data=4, model=2 (the suite's 8 virtual devices)."""
    from odise_tpu.parallel import mesh as jmesh

    mesh = jmesh.create_mesh(data=4, model=2)
    out = {}
    for path, shape in leaves.items():
        leaf = types.SimpleNamespace(shape=tuple(shape), ndim=len(shape))
        spec = tuple(jmesh.param_sharding_rule(("params",) + path, leaf, mesh).spec)
        out[path] = jmesh.MODEL_AXIS in spec
    return out


def _port_plan_matches(model, leaves):
    from odise_torch.model_zoo.from_jax import flax_to_torch_name
    from odise_torch.parallel.mesh import Mesh, sharding_plan

    plan = sharding_plan(model, Mesh(data=4, model=2))
    jax_choice = _jax_sharded(leaves)
    want = {flax_to_torch_name(p): _torch_dim(p, s) for p, s in leaves.items() if jax_choice[p]}
    assert plan == want
    return plan


@pytest.mark.parametrize("scale", ["tiny", "full"])
def test_rule_shards_the_leaves_jax_shards(scale):
    """At TINY every leaf of the JAX CategoryODISE's ``init_full`` tree (the
    vocabulary text tower too); at FULL the 2146 leaves of the JAX eval
    model's manifest, the vocabulary text tower (not in it) aside. Both
    shard some leaves and keep others whole: JAX's divisibility rule is
    reached both ways."""
    from odise_torch.model_zoo.factory import build_category_odise

    if scale == "tiny":
        import jax
        import jax.numpy as jnp

        from odise_tpu.model_zoo.factory import build_category_odise as jax_build
        from odise_tpu.models.odise import CategoryODISE as JCategoryODISE

        # no parameter's shape depends on the input's size: trace the smallest
        jm = jax_build("tiny", dtype=jnp.float32)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((3, 16)),
            method=JCategoryODISE.init_full))["params"]
        leaves = {tuple(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
                  for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        model = build_category_odise("tiny", device="meta")
    else:
        with gzip.open(REPO / "odise_tpu/model_zoo/bench_manifest.json.gz", "rt") as f:
            manifest = json.load(f)
        leaves = {tuple(k.split("/")[1:]): tuple(shape) for k, (shape, _) in manifest.items()}
        labels = tuple((f"category {i}",) for i in range(133))
        model = build_category_odise("full", train_labels=labels, device="meta",
                                     dtype=torch.bfloat16)
        model.text_encoder = None
    plan = _port_plan_matches(model, leaves)
    frozen = [n for n, p in model.named_parameters()
              if n.split(".")[0] in ("text_encoder", "clip_head") or ".ldm_extractor." in n
              or ".clip_visual." in n]
    assert plan and len(plan) < len(frozen)
    assert set(plan) <= set(frozen)


# ---------------------------------------------------------------- two ranks


def _inputs():
    """The TINY model's state (random, seeded), an eval image, the
    vocabulary's tokens and a train batch of two images, as numpy."""
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.models.clip.tokenizer import tokenize

    torch.manual_seed(5)
    model = build_category_odise("tiny", train_labels=LABELS, device="cpu")
    with torch.no_grad():  # off flax's start, whose zeroed UNet convs pass no gradient
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    rng = np.random.RandomState(3)
    batch = {"image": rng.rand(B, SIZE, SIZE, 3).astype(np.float32),
             "gt_labels": rng.randint(0, 3, (B, T)).astype(np.int64),
             "gt_masks": np.zeros((B, T, SIZE, SIZE), bool),
             "gt_valid": np.ones((B, T), bool)}
    for b in range(B):
        for t in range(T):
            y, x = rng.randint(0, SIZE - 56, 2)
            batch["gt_masks"][b, t, y:y + rng.randint(24, 56), x:x + rng.randint(24, 56)] = True
    batch["gt_valid"][1, 2] = False
    return dict(state={k: v.numpy() for k, v in model.state_dict().items()},
                image=rng.rand(1, SIZE, SIZE, 3).astype(np.float32),
                tokens=tokenize([t for group in LABELS for t in group]).astype(np.int64),
                batch=batch)


def _run(inputs, mesh=None):
    """The eval outputs and one train step of the TINY model from
    ``inputs``, sharded over ``mesh``'s model axis where one is given."""
    from odise_torch.engine import make_category_train_step, make_optimizer, partition_params
    from odise_torch.losses import CriterionConfig
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.parallel import shard_params

    model = build_category_odise("tiny", train_labels=LABELS, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["state"].items()})
    plan = shard_params(model, mesh) if mesh is not None else {}
    held = {n: p.numel() for n, p in model.named_parameters()}
    with torch.no_grad():
        text = model.encode_vocab(torch.from_numpy(inputs["tokens"]))
        mask_cls, mask_pred = model.forward_eval(torch.from_numpy(inputs["image"]), text, LABELS)
    trainable, _ = partition_params(model)
    step = make_category_train_step(model, make_optimizer(trainable, lr=1e-3, weight_decay=0.05),
                                    CriterionConfig(num_classes=3, num_points=64), text, LABELS)
    torch.manual_seed(9)  # the criterion's points
    model.train()
    metrics = step({k: torch.from_numpy(v) for k, v in inputs["batch"].items()}, None)
    return dict(plan=plan, held=held, text=text.numpy(), mask_cls=mask_cls.numpy(),
                mask_pred=mask_pred.numpy(),
                metrics={k: float(v) for k, v in metrics.items()},
                grads={n: p.grad.numpy().copy() for n, p in trainable.items()})


def _rank_fn(inputs, out):
    from odise_torch.parallel import (all_reduce_mean_, all_reduce_sum, create_mesh,
                                      gather_pickled, get_data_rank, get_data_world_size,
                                      get_rank)

    torch.set_num_threads(1)  # as the one process it is held to
    create_mesh(data=2, model=1)
    world_axis = (get_data_rank(), get_data_world_size())
    mesh = create_mesh(data=1, model=2)
    mean = torch.tensor([float(get_rank())])
    all_reduce_mean_([mean])
    collectives = (float(mean), float(all_reduce_sum(torch.ones(1))), gather_pickled(get_rank()))
    result = _run(inputs, mesh)
    result.update(world_axis=world_axis, model_axis=(get_data_rank(), get_data_world_size()),
                  mesh=(mesh.data_rank, mesh.model_rank), collectives=collectives)
    torch.save(result, os.path.join(out, f"rank{get_rank()}.pt"))


@pytest.fixture(scope="module")
def model_axis(tmp_path_factory):
    from odise_torch.engine.launch import launch

    inputs = _inputs()
    out = tmp_path_factory.mktemp("mesh")
    # the two ranks take well under a minute alone: one that never meets
    # the other fails the test instead of waiting out the group's 30 minutes
    launch(_rank_fn, WORLD, dist_url=f"file://{out}/rendezvous", device="cpu",
           args=(inputs, str(out)), timeout=300)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, _run(inputs)


def test_model_axis_holds_half_of_each_sharded_leaf(model_axis):
    """Each rank holds half of every leaf in its plan and every other leaf
    whole; both ranks' plans are the rule's; the mesh places rank r at
    (0, r)."""
    ranks, one = model_axis
    for r, got in enumerate(ranks):
        assert got["mesh"] == (0, r)
        assert got["plan"] and got["plan"] == ranks[0]["plan"]
        for name, n in one["held"].items():
            assert got["held"][name] == (n // 2 if name in got["plan"] else n), name


def test_model_axis_eval_equals_one_process(model_axis):
    """The vocabulary's text embeds, ``mask_cls`` and ``mask_pred`` of the
    sharded ranks equal one unsharded process's bitwise."""
    ranks, one = model_axis
    for got in ranks:
        for key in ("text", "mask_cls", "mask_pred"):
            assert np.array_equal(got[key], one[key]), key


def test_model_axis_train_step_equals_one_process(model_axis):
    """One train step (backbone checkpointed, crops of 64 px): every metric
    and every trainable gradient of each sharded rank equal one unsharded
    process's bitwise; the gradients reach the implicit captioner through
    the gathered UNet."""
    ranks, one = model_axis
    for name in ("alpha_cond", "clip_project.linear.weight"):
        assert np.abs(one["grads"][f"backbone.feature_extractor.{name}"]).max() > 0
    for got in ranks:
        assert got["metrics"] == one["metrics"]
        assert sorted(got["grads"]) == sorted(one["grads"])
        for name, g in one["grads"].items():
            assert np.array_equal(got["grads"][name], g), name


def test_data_axis_at_model_one_is_the_world(model_axis):
    """At data=2, model=1 each rank's data axis is the default group (its
    own rank of the world's 2), the layout before the mesh. At data=1, model=2 both
    ranks take the whole batch: the counts' sum and the statistics' gather
    stay on the rank, while the gradients' mean runs over every rank (which
    makes a model group's copies equal)."""
    ranks, _ = model_axis
    assert [got["world_axis"] for got in ranks] == [(0, 2), (1, 2)]
    assert [got["model_axis"] for got in ranks] == [(0, 1), (0, 1)]
    assert [got["collectives"] for got in ranks] == [(0.5, 1.0, [0]), (0.5, 1.0, [1])]


def test_create_mesh_refuses_a_wrong_layout():
    from odise_torch.parallel import create_mesh, get_data_world_size

    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        create_mesh(data=2, model=1)
    with pytest.raises(ValueError, match="model groups of 2"):
        create_mesh(model=2)
    mesh = create_mesh()
    assert (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank) == (1, 1, 0, 0)
    assert get_data_world_size() == 1
