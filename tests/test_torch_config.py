"""The port's lazy configs (``odise_torch/config``, ``odise_torch/configs``)
against the JAX package's: every case of ``tests/test_config.py`` on the
port, the shipped configs resolved to the same trees with ``odise_tpu``
targets read as ``odise_torch`` ones, and the FULL model a config builds
against the one ``build_category_odise`` builds."""

import os
import textwrap

import pytest
import torch

from odise_torch.config import (
    L,
    ConfigDict,
    apply_overrides,
    auto_scale_workers,
    get_config,
    instantiate,
    instantiate_odise,
    load_config,
    resolve,
)

REPO = os.path.join(os.path.dirname(__file__), "..")


def _dataclass_like(a, b=2, c=None):
    return {"a": a, "b": b, "c": c}


class _Model:
    def __init__(self, dim, sub=None, name="m"):
        self.dim = dim
        self.sub = sub
        self.name = name


def test_lazy_call_builds_tree():
    cfg = L(_Model)(dim=4, sub=L(_Model)(dim=8))
    assert cfg.dim == 4
    assert cfg.sub.dim == 8
    obj = instantiate(cfg)
    assert isinstance(obj, _Model) and obj.dim == 4
    assert isinstance(obj.sub, _Model) and obj.sub.dim == 8


def test_interpolation_absolute_and_relative():
    cfg = ConfigDict(
        model=L(_Model)(
            dim=256,
            sub=L(_Model)(dim="${..dim}", name="${root_name}"),
        ),
        root_name="hello",
    )
    r = resolve(cfg)
    assert r.model.sub.dim == 256
    assert r.model.sub.name == "hello"
    obj = instantiate(cfg)
    assert obj["model"].sub.dim == 256


def test_string_embedding_interpolation():
    cfg = ConfigDict(run="exp1", out="output/${run}/ckpt")
    assert resolve(cfg).out == "output/exp1/ckpt"


def test_apply_overrides():
    cfg = ConfigDict(train=ConfigDict(max_iter=100, amp=ConfigDict(enabled=True)),
                     lst=[1, 2, 3])
    apply_overrides(cfg, ["train.max_iter=5", "train.amp.enabled=False",
                          "lst.1=99", "train.new_key='x'"])
    assert cfg.train.max_iter == 5
    assert cfg.train.amp.enabled is False
    assert cfg.lst[1] == 99
    assert cfg.train.new_key == "x"


def test_load_config_file(tmp_path):
    p = tmp_path / "cfg.py"
    p.write_text(textwrap.dedent("""
        from odise_torch.config import L, ConfigDict
        def _helper(x): return x * 2
        train = dict(max_iter=10, lr="${optimizer.lr}")
        optimizer = dict(lr=1e-4)
    """))
    cfg = load_config(str(p))
    assert cfg.train.max_iter == 10
    assert resolve(cfg).train.lr == 1e-4
    assert "_helper" not in cfg


def test_instantiate_plain_tree_passthrough():
    out = instantiate({"a": [1, 2, {"b": L(_dataclass_like)(a=1)}]})
    assert out["a"][2]["b"] == {"a": 1, "b": 2, "c": None}


def test_auto_scale_workers():
    cfg = ConfigDict(
        train=ConfigDict(reference_world_size=8, max_iter=800, eval_period=80,
                         checkpointer=ConfigDict(period=40)),
        dataloader=ConfigDict(train=ConfigDict(total_batch_size=64)),
        optimizer=ConfigDict(lr=1e-4),
        lr_multiplier=ConfigDict(milestones=[400, 600]),
    )
    scaled = auto_scale_workers(cfg, 4)
    assert scaled.dataloader.train.total_batch_size == 32
    assert scaled.optimizer.lr == pytest.approx(5e-5)
    assert scaled.train.max_iter == 1600
    assert scaled.lr_multiplier.milestones == [800, 1200]
    # no-op when equal
    assert auto_scale_workers(cfg, 8) is cfg


@pytest.mark.parametrize("accum_steps", [1, 4])
def test_auto_scale_workers_shipped_recipe(accum_steps):
    """The shipped COCO recipe (32 workers, batch 64) on one worker, as the
    JAX function scales it: batch, lr, iterations and periods follow the
    world size times ``accum_steps``; ``optimizer.milestones`` and
    ``optimizer.warmup_steps`` stay as written (only an ``lr_multiplier``
    node's would scale)."""
    cfg = get_config("Panoptic/odise_label_coco_50e.py")
    cfg.train.accum_steps = accum_steps
    scaled = auto_scale_workers(cfg, 1)
    scale = accum_steps / 32
    assert scaled.dataloader.train.total_batch_size == 64 * scale
    assert scaled.optimizer.lr == pytest.approx(1e-4 * scale)
    assert scaled.train.max_iter == round(92188 / scale)
    assert scaled.train.eval_period == round(5000 / scale)
    assert scaled.train.checkpointer.period == round(4500 / scale)
    assert scaled.optimizer.milestones == [163889, 177546]
    assert scaled.optimizer.warmup_steps == 500
    assert scaled.train.reference_world_size == accum_steps


def test_catalog():
    from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.remove("_test_ds")
    DatasetCatalog.register("_test_ds", lambda: [{"file_name": "x.jpg"}])
    assert DatasetCatalog.get("_test_ds")[0]["file_name"] == "x.jpg"
    with pytest.raises(ValueError):
        DatasetCatalog.register("_test_ds", lambda: [])
    meta = MetadataCatalog.get("_test_meta")
    meta.set(thing_classes=["a", "b"])
    assert MetadataCatalog.get("_test_meta").thing_classes == ["a", "b"]
    with pytest.raises(AttributeError):
        _ = meta.missing_key
    DatasetCatalog.remove("_test_ds")


def test_loaders_take_catalog_names():
    """``build_train_loader`` takes a registered name and ``total_batch_size``
    as the JAX loader does; ``build_test_loader`` walks the records in
    order, as the JAX one does."""
    import numpy as np
    from odise_tpu.data import loader as jl

    from odise_torch.data.catalog import DatasetCatalog
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_test_loader, build_train_loader
    from odise_torch.data.synthetic import make_shapes_records

    records = make_shapes_records(5, size=32, seed=3)
    DatasetCatalog.remove("_test_loader")
    DatasetCatalog.register("_test_loader", lambda: records)
    mapper = COCOPanopticDatasetMapper(image_size=32, max_instances=3, device="cpu")
    by_name = next(build_train_loader("_test_loader", mapper, total_batch_size=3, seed=7))
    by_list = next(build_train_loader(records, mapper, 3, seed=7))
    assert by_name["image"].shape == (3, 32, 32, 3)
    for k in by_name:
        assert torch.equal(by_name[k], by_list[k])
    ours = [[r["image_id"] for r in chunk]
            for chunk in build_test_loader("_test_loader", batch_size=2, limit=4)]
    theirs = [[r["image_id"] for r in chunk]
              for chunk in jl.build_test_loader(records, batch_size=2, limit=4)]
    assert ours == theirs == [[0, 1], [2, 3]]
    mapped = next(build_test_loader("_test_loader", mapper=COCOPanopticDatasetMapper(
        is_train=False, max_instances=3, device="cpu")))
    assert np.array_equal(mapped[0]["image"].numpy(), records[0]["image"] / np.float32(255))
    DatasetCatalog.remove("_test_loader")


def test_save_config_roundtrip_readable(tmp_path):
    from odise_torch.config import save_config

    cfg = ConfigDict(
        model=L(_Model)(dim=4, sub=L(_Model)(dim=8)),
        train=ConfigDict(max_iter=10),
    )
    path = str(tmp_path / "config.yaml")
    save_config(cfg, path)
    text = open(path).read()
    assert "_target_" in text and "max_iter: 10" in text


def test_get_config_loads_shipped_configs():
    cfg = get_config("common/train.py")
    assert cfg.train.seed == 42
    full = get_config("Panoptic/odise_label_coco_50e.py")
    assert full.train.max_iter == 92188
    assert full.train.reference_world_size == 32
    with pytest.raises(FileNotFoundError):
        get_config("common/no_such_config.py")


# the only values the port's configs may set otherwise
PORT_VALUES = {("train", "device"): ("tpu", "cuda"),
               ("train", "checkpointer", "backend"): ("orbax", "torch"),
               ("train", "wandb", "project"): ("odise_tpu", "odise_torch")}


def _plain(node):
    """A resolved config tree as plain data: a target becomes its dotted
    name with ``odise_tpu`` read as ``odise_torch``; a function defined in
    a config file (whose module name is drawn at load) becomes its name."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "_target_" and not isinstance(v, str):
                module = v.__module__
                v = (v.__qualname__ if module.startswith("odise_cfg_")
                     else f"{module}.{v.__qualname__}")
            out[k] = _plain(v)
        return out
    if isinstance(node, (list, tuple)):
        return type(node)(_plain(v) for v in node)
    if isinstance(node, str):
        return node.replace("odise_tpu.", "odise_torch.")
    return node


def _swap_port_values(tree, which):
    for path, values in PORT_VALUES.items():
        node = tree
        for k in path[:-1]:
            node = node[k]
        assert node[path[-1]] == values[which], (path, node[path[-1]])
        node[path[-1]] = "<port value>"
    return tree


@pytest.mark.parametrize("name", ["odise_label_coco_50e", "odise_caption_coco_50e",
                                  "odise_label_tiny_synth", "odise_caption_tiny_synth"])
def test_configs_match_jax(name):
    from odise_tpu import config as jcfg

    import odise_torch.config as pcfg

    overrides = ["train.max_iter=4", "train.checkpointer.period=2", "train.eval_period=4",
                 "dataloader.train.dataset='_smoke_train'", "train.log_period=1"]
    trees = []
    for m, root, which in ((jcfg, "configs", 0), (pcfg, "odise_torch/configs", 1)):
        cfg = m.auto_scale_workers(m.load_config(
            os.path.join(REPO, root, "Panoptic", f"{name}.py")), 1)
        m.apply_overrides(cfg, overrides)
        trees.append(_swap_port_values(_plain(m.resolve(cfg)), which))
    assert trees[0] == trees[1]
    assert "odise_tpu" not in repr(trees[1])


@pytest.mark.parametrize("variant", ["label", "caption"])
def test_full_model_from_config_matches_factory(variant):
    """The FULL model the shipped config builds (on the meta device) has the
    parameters, names and shapes, of the factory's; the config's compute
    dtype is float32, as the JAX modules' defaults are."""
    from odise_torch.model_zoo.factory import build_caption_odise, build_category_odise

    cfg = resolve(get_config(f"Panoptic/odise_{variant}_coco_50e.py"))
    model = instantiate_odise(cfg.model, device="meta")
    build = build_category_odise if variant == "label" else build_caption_odise
    ref = build("full", device="meta")
    ours = {n: tuple(p.shape) for n, p in model.named_parameters()}
    theirs = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert ours == theirs
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.train_labels == ref.train_labels
    assert (model.object_mask_threshold, model.overlap_threshold,
            model.test_topk_per_image) == (0.0, 0.8, 100)


@pytest.mark.parametrize("variant,field,value", [
    ("label", "sem_seg_head.transformer_predictor.pre_norm", True),
    ("label", "sem_seg_head.pixel_decoder.transformer_dropout", 0.1),
    ("label", "size_divisibility", 32),
    ("caption", "word_head.num_words", 4),
    ("caption", "backbone.feature_extractor.clip_model_name", "ViT-B-16"),
])
def test_instantiate_odise_refuses_what_only_jax_holds(variant, field, value):
    """The JAX modules' fields that the port's modules do not take are
    dropped from the graph at their shipped values (the test above builds
    it) and refused at any other, which the port would ignore."""
    from odise_torch.config.build import _jax_only_fields, drop_jax_only_fields

    cfg = resolve(get_config(f"Panoptic/odise_{variant}_coco_50e.py"))
    node, name = cfg.model, field.rsplit(".", 1)[-1]
    for part in field.split(".")[:-1]:
        node = node[part]
    assert name in node and name in _jax_only_fields()[node["_target_"]]
    node[name] = value
    with pytest.raises(ValueError, match=name):
        instantiate_odise(cfg.model, device="meta")
    node[name] = _jax_only_fields()[node["_target_"]][name]
    drop_jax_only_fields(cfg.model)
    assert name not in node


def test_instantiate_odise_needs_the_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("Panoptic/odise_label_tiny_synth.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        instantiate_odise(cfg.model)
    model = instantiate_odise(cfg.model, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_grounding_config_collect_mode():
    from odise_tpu.losses import GroundingConfig as JaxGroundingConfig

    from odise_torch.losses import GroundingConfig

    assert GroundingConfig().collect_mode == JaxGroundingConfig().collect_mode == "diff"
    for mode in ("diff", "concat", None):
        GroundingConfig(collect_mode=mode)
    with pytest.raises(ValueError):
        GroundingConfig(collect_mode="gather")


def test_label_files_of_every_vocabulary():
    """Every vocabulary the configs name has its label file in the port, as
    in the JAX package (the extra eval tasks instantiate them first)."""
    from odise_tpu.data.build import get_openseg_labels as jax_labels

    from odise_torch.data.build import get_openseg_labels

    for name in ("ade20k_150", "ade20k_847", "coco_panoptic", "pascal_context_59",
                 "pascal_context_459", "pascal_voc_21", "lvis_1203"):
        for prompt in (False, True):
            assert get_openseg_labels(name, prompt) == jax_labels(name, prompt)
