"""The port's dataset preparation scripts (``odise_torch/prepare``) against
the JAX package's (``datasets/prepare_*.py``, loaded from their files with
importlib) on one tiny raw layout of each dataset, on the CPU.

Each pair runs on its own copy of the layout and must write the same files:
equal JSON content, equal label arrays (read back with PIL, as the JAX
side reads them), the port's TIFF read by PIL equal to the JAX script's.
``write_ade20k_raw`` and ``write_coco_raw`` draw the layouts with the port's
PNG writer; ``chip_smoke.py`` phase 14 (e) draws its ADE20K layout with the
first. This module imports neither PIL nor JAX at the top, so that the
card's machine can import it.
"""

import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from .torch_threads import one_thread  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent
# A-150 stuff classes the bands use (0-based): wall, sky, floor
ADE_STUFF = (0, 2, 3)


def ade_things():
    from odise_torch.data.datasets.register_ade20k import ade150_categories

    return [j for j, c in enumerate(ade150_categories()) if c["isthing"]]


def draw_ade_image(rng, h, w, invalid_class=False):
    """(semantic map: A-150 id + 1, 0 unlabeled; instance map: R the thing
    class among the 100 (1-based), G the instance, B 0): three stuff bands,
    four thing rectangles (two of one class), an unlabeled square and,
    with ``invalid_class``, an instance of class 101, which both scripts
    skip."""
    things = ade_things()
    sem = np.zeros((h, w), np.uint8)
    inst = np.zeros((h, w, 3), np.uint8)
    cuts = sorted(rng.randint(h // 5, 4 * h // 5, 2))
    for cls, y0, y1 in zip(ADE_STUFF, [0] + cuts, cuts + [h]):
        sem[y0:y1] = cls + 1
    picks = rng.choice(len(things), 3, replace=False)
    for g, k in enumerate([picks[0], picks[0], picks[1], picks[2]], start=1):
        y, x = rng.randint(0, h - h // 4), rng.randint(0, w - w // 4)
        hh, ww = rng.randint(h // 8, h // 4), rng.randint(w // 8, w // 4)
        sem[y:y + hh, x:x + ww] = things[k] + 1
        inst[y:y + hh, x:x + ww] = (k + 1, g, 0)
    if invalid_class:
        inst[:4, :4] = (101, 1, 0)
    y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
    sem[y:y + 8, x:x + 8] = 0
    inst[y:y + 8, x:x + 8] = 0
    return sem, inst


def write_ade20k_raw(root, stems, h=48, w=64, seed=0, images=None):
    """``ADEChallengeData2016``'s validation semantic and instance PNGs
    (and, where ``images`` maps a stem to a file, its image) under
    ``root``; returns stem -> (semantic, instance) as drawn."""
    from odise_torch.data.image_io import write_png

    base = os.path.join(root, "ADEChallengeData2016")
    for d in ("annotations/validation", "annotations_instance/validation",
              "images/validation"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    rng = np.random.RandomState(seed)
    drawn = {}
    for i, stem in enumerate(stems):
        sem, inst = draw_ade_image(rng, h, w, invalid_class=i == 0)
        write_png(os.path.join(base, "annotations", "validation", stem + ".png"), sem)
        write_png(os.path.join(base, "annotations_instance", "validation", stem + ".png"), inst)
        if images and stem in images:
            shutil.copyfile(images[stem], os.path.join(base, "images", "validation",
                                                       stem + ".jpg"))
        drawn[stem] = (sem, inst)
    return drawn


def ade_record_matches(rec, sem, inst) -> bool:
    """Whether an ``ade20k_panoptic_val`` record (its panoptic PNG and
    segments) gives the drawn classes pixel for pixel: the semantic map's
    A-150 id where labelled (but under an instance of class 101, which the
    scripts skip), void where unlabeled, a thing class under every
    instance."""
    from odise_torch.data.image_io import read_rgb_png
    from odise_torch.data.transforms import rgb2id

    ids = rgb2id(read_rgb_png(rec["pan_seg_file_name"]))
    got = np.full(sem.shape, 255, np.int64)
    for seg in rec["segments_info"]:
        got[ids == seg["id"]] = seg["category_id"]
    valid = (sem > 0) & ~((inst[..., 0] > 100) & (inst[..., 1] > 0))
    return bool(np.array_equal(got[valid], sem[valid].astype(np.int64) - 1)
                and (got[sem == 0] == 255).all()
                and np.isin(got[valid & (inst[..., 1] > 0)], ade_things()).all())


def write_coco_raw(root, seed=0, h=40, w=56):
    """COCO's panoptic jsons and PNGs for val and train, two images each:
    stuff bands, thing rectangles, void; returns (split, file) -> the id
    map and its segments."""
    from odise_torch.data.build import coco_panoptic_categories
    from odise_torch.data.image_io import write_png
    from odise_torch.data.transforms import id2rgb

    cats = coco_panoptic_categories()
    things = [c["id"] for c in cats if c["isthing"]]
    stuff = [c["id"] for c in cats if not c["isthing"]]
    rng = np.random.RandomState(seed)
    drawn = {}
    for split in ("val", "train"):
        pan_dir = os.path.join(root, "coco", f"panoptic_{split}2017")
        os.makedirs(pan_dir, exist_ok=True)
        os.makedirs(os.path.join(root, "coco", "annotations"), exist_ok=True)
        anns = []
        for k in range(2):
            ids = np.zeros((h, w), np.uint32)
            segs = []
            for j, y0 in enumerate((0, h // 2)):
                sid = int(rng.randint(1, 2 ** 24))
                ids[y0:y0 + h // 2] = sid
                segs.append({"id": sid, "category_id": int(rng.choice(stuff))})
            for _ in range(3):
                sid = int(rng.randint(1, 2 ** 24))
                y, x = rng.randint(0, h - 10), rng.randint(0, w - 10)
                ids[y:y + 10, x:x + 10] = sid
                segs.append({"id": sid, "category_id": int(rng.choice(things))})
            ids[:3, :3] = 0
            name = f"{k:012d}.png"
            write_png(os.path.join(pan_dir, name), id2rgb(ids))
            anns.append({"image_id": k, "file_name": name, "segments_info": segs})
            drawn[(split, name)] = (ids, segs)
        with open(os.path.join(root, "coco", "annotations", f"panoptic_{split}2017.json"),
                  "w") as f:
            json.dump({"annotations": anns, "categories": cats}, f)
    return drawn


def write_lvis_raw(root):
    os.makedirs(os.path.join(root, "lvis"))
    cats = [{"id": 3, "name": "aerosol_can", "synonyms": ["aerosol_can", "spray_can"]},
            {"id": 1, "name": "alarm_clock", "synonyms": ["alarm_clock"]},
            {"id": 2, "name": "apple", "synonyms": ["apple", "apple", "green_apple"]},
            {"id": 4, "name": "bagel"}]
    with open(os.path.join(root, "lvis", "lvis_v1_val.json"), "w") as f:
        json.dump({"categories": cats}, f)


def write_pascal_raw(root, seed=0):
    """Pascal Context's ``.mat`` LabelMaps (0 unlabeled, 1..459) and image
    names for both splits, one image of each without its ``.mat``; returns
    stem -> LabelMap."""
    import scipy.io as sio

    rng = np.random.RandomState(seed)
    mats = os.path.join(root, "VOCdevkit", "VOC2010", "trainval")
    os.makedirs(mats)
    drawn = {}
    for split, stems in (("training", ["2008_000002", "2008_000003", "2008_000099"]),
                         ("validation", ["2008_000008", "2008_000123"])):
        img_dir = os.path.join(root, "pascal_ctx_d2", "images", split)
        os.makedirs(img_dir)
        for i, stem in enumerate(stems):
            with open(os.path.join(img_dir, stem + ".jpg"), "wb") as f:
                f.write(b"not read")
            if i == len(stems) - 1:
                continue  # no annotation: both scripts skip it
            lm = rng.randint(0, 460, (30, 41)).astype(np.uint16)
            lm[0, :5] = 0
            sio.savemat(os.path.join(mats, stem + ".mat"), {"LabelMap": lm})
            drawn[stem] = lm
    return drawn


def jax_script(name, tmp_path=None):
    """The JAX package's ``datasets/<name>.py`` as a module; with
    ``tmp_path`` its ``__file__`` is moved there, so that a script that
    writes beside itself writes under ``tmp_path``."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "datasets" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if tmp_path is not None:
        module.__file__ = str(tmp_path / "datasets" / f"{name}.py")
    return module


def port_script(name):
    return importlib.import_module(f"odise_torch.prepare.{name}")


def two_roots(tmp_path, write):
    """(JAX's root, the port's root): the same raw layout in each."""
    roots = tmp_path / "jax", tmp_path / "port"
    drawn = [write(str(r)) for r in roots]
    return roots, drawn[0]


def pil_array(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def files_under(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def assert_same_outputs(roots, skip=()):
    """Every file under both roots: JSON equal as data, PNG and TIFF equal
    as PIL's arrays (and mode), anything else byte for byte."""
    from PIL import Image

    a, b = roots
    names = files_under(a)
    assert names == files_under(b)
    for name in names:
        if name.startswith(skip):
            continue
        pa, pb = a / name, b / name
        if name.endswith(".json"):
            assert json.loads(pa.read_text()) == json.loads(pb.read_text()), name
        elif name.endswith((".png", ".tif")):
            ia, ib = Image.open(pa), Image.open(pb)
            assert ia.mode == ib.mode, name
            assert np.array_equal(np.asarray(ia), np.asarray(ib)), name
        else:
            assert pa.read_bytes() == pb.read_bytes(), name
    return names


def test_ade20k_pan_seg_equals_jax(tmp_path):
    roots, drawn = two_roots(tmp_path, lambda r: write_ade20k_raw(r, ["a_01", "a_02", "a_03"]))
    jax_script("prepare_ade20k_pan_seg").main(str(roots[0]))
    port_script("prepare_ade20k_pan_seg").main(str(roots[1]))
    names = assert_same_outputs(roots)
    assert "ADEChallengeData2016/ade20k_panoptic_val.json" in names
    # read back through the registration's loader: the segments are what was drawn
    from odise_torch.data.datasets.register_ade20k import ade150_meta, load_ade_panoptic_json

    ade = roots[1] / "ADEChallengeData2016"
    recs = load_ade_panoptic_json(str(ade / "ade20k_panoptic_val.json"),
                                  str(ade / "images" / "validation"),
                                  str(ade / "ade20k_panoptic_val"), str(ade / "sem"),
                                  ade150_meta())
    assert len(recs) == 3
    assert all(ade_record_matches(rec, *drawn[rec["image_id"]]) for rec in recs)


def test_ade20k_ins_seg_equals_jax(tmp_path):
    roots, drawn = two_roots(tmp_path, lambda r: write_ade20k_raw(r, ["b_01", "b_02"]))
    jax_script("prepare_ade20k_ins_seg").main(str(roots[0]))
    port_script("prepare_ade20k_ins_seg").main(str(roots[1]))
    assert_same_outputs(roots)
    data = json.loads((roots[1] / "ADEChallengeData2016" / "ade20k_instance_val.json")
                      .read_text())
    assert len(data["annotations"]) == 2 * 4 and len(data["categories"]) == 100


def test_coco_semantic_from_panoptic_equals_jax(tmp_path):
    roots, drawn = two_roots(tmp_path, write_coco_raw)
    jax_script("prepare_coco_semantic_annos_from_panoptic_annos").process_split(
        str(roots[0]), "val")
    jax_script("prepare_coco_semantic_annos_from_panoptic_annos").process_split(
        str(roots[0]), "train")
    port_script("prepare_coco_semantic_annos_from_panoptic_annos").main(str(roots[1]))
    names = assert_same_outputs(roots)
    from odise_torch.data.datasets.register_coco import coco_meta

    to_contiguous = coco_meta()["stuff_dataset_id_to_contiguous_id"]
    for (split, name), (ids, segs) in drawn.items():
        assert f"coco/panoptic_semseg_{split}2017/{name}" in names
        sem = pil_array(roots[1] / "coco" / f"panoptic_semseg_{split}2017" / name)
        want = np.full(ids.shape, 255, np.uint8)
        for s in segs:
            want[ids == s["id"]] = to_contiguous[s["category_id"]]
        assert np.array_equal(sem, want)


def test_lvis_openseg_labels_equal_jax(tmp_path):
    """Both write their two label files (the JAX script into a copy of its
    package's label directory under ``tmp_path``, the port's into
    ``out_dir``): equal bytes; the port writes into its own package by
    default."""
    for r in ("jax", "port"):
        write_lvis_raw(str(tmp_path / r))
    jax_out = tmp_path / "odise_tpu" / "data" / "datasets" / "openseg_labels"
    port_out = tmp_path / "port_labels"
    jax_out.mkdir(parents=True)
    (tmp_path / "datasets").mkdir()
    port_out.mkdir()
    jax_script("prepare_lvis_openseg_labels", tmp_path).main(str(tmp_path / "jax"))
    module = port_script("prepare_lvis_openseg_labels")
    module.main(str(tmp_path / "port"), out_dir=str(port_out))
    for name in ("lvis_1203.txt", "lvis_1203_with_prompt_eng.txt"):
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes()
    assert (port_out / "lvis_1203_with_prompt_eng.txt").read_text().splitlines()[1] == \
        "2:apple,green apple"
    assert Path(module.LABEL_DIR) == REPO / "odise_torch" / "data" / "datasets" / "openseg_labels"


def test_pascal_ctx_full_sem_seg_equals_jax(tmp_path):
    """The 16-bit TIFFs: the port's (its own writer) read by PIL equal to
    the JAX script's (PIL's writer), ids shifted down with 0 to 65535."""
    roots, drawn = two_roots(tmp_path, write_pascal_raw)
    jax_script("prepare_pascal_ctx_full_sem_seg").main(str(roots[0]))
    port_script("prepare_pascal_ctx_full_sem_seg").main(str(roots[1]))
    names = assert_same_outputs(roots)
    tifs = [n for n in names if n.endswith(".tif")]
    assert len(tifs) == len(drawn) == 3
    from odise_torch.data.image_io import read_label

    for name in tifs:
        lm = drawn[Path(name).stem]
        want = np.where(lm == 0, 65535, lm.astype(np.int64) - 1).astype(np.uint16)
        port = roots[1] / name
        assert np.array_equal(pil_array(port), want)
        assert np.array_equal(read_label(port), want)


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (64, 80)])
def test_write_tiff_round_trips(tmp_path, shape):
    """``write_tiff`` gives back the array through the port's
    ``decode_tiff`` and through PIL (mode I;16), extremes included; other
    dtypes and ranks raise."""
    from odise_torch.data.image_io import read_label, write_tiff

    a = np.random.RandomState(0).randint(0, 65536, shape).astype(np.uint16)
    a.flat[0], a.flat[-1] = 0, 65535
    path = tmp_path / "x.tif"
    write_tiff(path, a)
    from PIL import Image

    assert Image.open(path).mode == "I;16"
    assert np.array_equal(pil_array(path), a) and np.array_equal(read_label(path), a)
    for bad in (a.astype(np.uint8), a.astype(np.int32), a[None]):
        with pytest.raises(ValueError):
            write_tiff(path, bad)


def test_scripts_run_as_modules(tmp_path):
    """``python -m odise_torch.prepare.<name>`` with the root from
    ``$DETECTRON2_DATASETS``, with no PIL importable."""
    import subprocess

    write_ade20k_raw(str(tmp_path), ["c_01"])
    code = ("import sys; sys.modules['PIL'] = None; import runpy; "
            "runpy.run_module('odise_torch.prepare.prepare_ade20k_ins_seg', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env=dict(os.environ, DETECTRON2_DATASETS=str(tmp_path)),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "(4 instances)" in out.stdout
    assert (tmp_path / "ADEChallengeData2016" / "ade20k_instance_val.json").is_file()
