"""The port's data layer against the JAX package's on the CPU: PNG and TIFF
decoding against PIL, COCO RLE and polygons against
``odise_tpu.data.coco_mask`` (cv2's fill), the five dataset registrations,
the mapper and loader on file records, ``write_shapes_dataset`` against
``make_shapes_records(out_dir, ...)``, and evaluation and training from
files. Everything here is equal to the JAX side bit for bit, but images
after the LSJ resize (one uint8 level, as the in-memory mapper test)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from odise_tpu.data import coco_mask as jcm
from odise_torch.data import coco_mask as pcm
from odise_torch.data.image_io import (decode_png, read_image, read_label, read_rgb_png,
                                       write_png)

SIZE = (23, 37)  # odd, not square


# palette sizes: PIL packs a palette of up to 16 colours into 4-bit indices
COLOURS = {"P": 7, "P_8bit": 200}


def _pixels(mode, rng):
    h, w = SIZE
    if mode == "I;16":
        return rng.randint(0, 65536, (h, w)).astype(np.uint16)
    ch = {"L": 0, "P": 0, "P_8bit": 0, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    # a gradient plus noise, so that PIL's encoder picks several row filters
    base = (np.add.outer(np.arange(h) * 5, np.arange(w) * 3) % 256).astype(np.int64)
    if ch:
        base = base[..., None] + np.arange(ch) * 40
    return ((base + rng.randint(0, 9, base.shape)) % COLOURS.get(mode, 256)).astype(np.uint8)


def _palette(rng, mode="P"):
    return rng.randint(0, 256, (COLOURS[mode], 3)).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "P", "P_8bit", "RGB", "RGBA", "LA", "I;16"])
def test_png_written_by_pil_decodes_as_pil(mode, tmp_path):
    """Files PIL writes: the port's label read, RGB read and image read are
    PIL's ``np.asarray(Image.open(p))`` and ``convert("RGB")``, bit for bit."""
    rng = np.random.RandomState(0)
    px = _pixels(mode, rng)
    im = Image.fromarray(px) if mode != "LA" else Image.fromarray(px, "LA")
    if mode.startswith("P"):
        im.putpalette(_palette(rng, mode).reshape(-1).tolist())
    path = tmp_path / "a.png"
    im.save(path)
    pil = Image.open(path)
    assert pil.mode == ("P" if mode.startswith("P") else mode)
    assert np.array_equal(read_label(path), np.asarray(pil))
    if mode != "I;16":
        rgb = np.asarray(pil.convert("RGB"))
        assert np.array_equal(read_rgb_png(path), rgb)
        assert np.array_equal(read_image(path, "cpu").numpy(), rgb)
    else:
        assert read_label(path).dtype == np.uint16


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average",
                                                               "paeth"])
@pytest.mark.parametrize("mode", ["L", "P", "RGB", "RGBA", "I;16"])
def test_png_written_by_the_port_decodes_in_pil(mode, filter_type, tmp_path):
    """Files the port writes, every row with one filter: PIL and the port
    decode the same pixels as were written."""
    rng = np.random.RandomState(1)
    px = _pixels(mode, rng)
    palette = _palette(rng) if mode == "P" else None
    path = tmp_path / "a.png"
    write_png(path, px, palette=palette, filter_type=filter_type)
    assert decode_png(path.read_bytes()).mode == mode
    pil = Image.open(path)
    assert pil.mode == mode
    assert np.array_equal(np.asarray(pil), px)
    assert np.array_equal(read_label(path), px)
    # writable, also where no row is filtered and the pixels are the
    # decompressed bytes themselves
    assert read_label(path).flags.writeable
    if mode != "I;16":
        assert read_rgb_png(path).flags.writeable
    if mode == "P":
        assert np.array_equal(np.asarray(pil.convert("RGB")), read_rgb_png(path))


@pytest.mark.parametrize("kind", ["u16_le", "u16_be", "u8", "rgb"])
def test_tiff_decodes_as_pil(kind, tmp_path):
    """Uncompressed TIFFs as PIL saves them (the 16-bit label files of
    Pascal Context 459 and ADE20K-847), in either byte order."""
    rng = np.random.RandomState(2)
    h, w = SIZE
    if kind == "u16_be":
        arr = rng.randint(0, 65536, (h, w)).astype(np.uint16)
        im = Image.frombytes("I;16B", (w, h), arr.astype(">u2").tobytes())
    elif kind == "rgb":
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        im = Image.fromarray(arr)
    else:
        arr = rng.randint(0, 65536 if kind == "u16_le" else 256, (h, w)).astype(
            np.uint16 if kind == "u16_le" else np.uint8)
        im = Image.fromarray(arr)
    path = tmp_path / "a.tif"
    im.save(path)
    got = read_label(path)
    assert np.array_equal(got, np.asarray(Image.open(path))) and np.array_equal(got, arr)
    assert got.dtype == (np.uint8 if kind in ("u8", "rgb") else np.uint16)
    Image.fromarray(arr).save(tmp_path / "z.tif", compression="tiff_deflate")
    with pytest.raises(ValueError, match="259"):
        read_label(tmp_path / "z.tif")


def test_jpeg_on_the_cpu_is_pil_and_labels_refuse_it(tmp_path):
    """On the CPU a JPEG goes through PIL, whatever its name; a label file
    must be PNG or TIFF."""
    rng = np.random.RandomState(3)
    path = tmp_path / "a.png"
    Image.fromarray(rng.randint(0, 256, (16, 24, 3)).astype(np.uint8)).save(path, "JPEG")
    assert np.array_equal(read_image(path, "cpu").numpy(),
                          np.asarray(Image.open(path).convert("RGB")))
    with pytest.raises(ValueError, match="neither PNG nor TIFF"):
        read_label(path)


def test_nvjpeg_refuses_a_second_device(monkeypatch):
    """nvJPEG's one handle and state live on the device of the process's
    first decode; a decode onto another device raises before any call."""
    from odise_torch.data import image_io

    monkeypatch.setattr(image_io.decode_jpeg_cuda, "device", torch.device("cuda", 1))
    with pytest.raises(ValueError, match="lives on cuda:1, not cuda:0"):
        image_io.decode_jpeg_cuda(b"\xff\xd8\xff", "cuda:0")
    with pytest.raises(ValueError, match="onto a CUDA device, not cpu"):
        image_io.decode_jpeg_cuda(b"\xff\xd8\xff", "cpu")


# ---------------------------------------------------------------- RLE, polygons


def test_rle_matches_jax():
    """Round trips of masks with runs at both ends, column-major order on a
    non-square mask, and compressed strings whose deltas go negative."""
    rng = np.random.RandomState(4)
    for trial in range(30):
        h, w = rng.randint(1, 40, 2)
        m = rng.rand(h, w) < rng.choice([0.05, 0.5, 0.95])
        if trial % 3 == 0:
            m[:, 0] = m[:, -1] = True
        for compress in (True, False):
            rle = pcm.mask_to_rle(m, compress)
            assert rle == jcm.mask_to_rle(m, compress)
            assert np.array_equal(pcm.rle_to_mask(rle), m)
            assert np.array_equal(pcm.rle_to_mask(rle), jcm.rle_to_mask(rle))
    # run lengths that fall (negative deltas) and rise again
    counts = [5, 300, 2, 40, 1, 1000, 3, 2]
    s = jcm.encode_compressed_counts(counts)
    assert pcm.encode_compressed_counts(counts) == s
    assert pcm.decode_compressed_counts(s) == jcm.decode_compressed_counts(s) == counts
    rle = {"size": [13, sum(counts) // 13 + 1], "counts": counts + [13 * (sum(counts) // 13 + 1)
                                                                    - sum(counts)]}
    assert np.array_equal(pcm.rle_to_mask(rle), jcm.rle_to_mask(rle))
    m = pcm.rle_to_mask(rle)
    assert m[:5, 0].sum() == 0 and m[5:13, 0].all()  # column-major runs


POLYGONS = {
    "convex": [[2.2, 2.0, 30.6, 5.4, 24.0, 19.5, 5.1, 16.8]],
    "concave": [[2, 2, 30, 2, 30, 20, 16, 8, 2, 20]],
    "self_intersecting": [[3, 3, 33, 19, 33, 3, 3, 19]],
    "two_overlapping": [[2, 2, 20, 2, 20, 15, 2, 15], [10, 6, 34, 6, 34, 21, 10, 21]],
    "partly_outside": [[-8.4, 4.0, 20.0, -6.2, 45.5, 12.0, 18.0, 30.7]],
    "fewer_than_3_points": [[4, 4, 20, 20], [5, 5, 30, 9, 12, 18]],
}


@pytest.mark.parametrize("case", sorted(POLYGONS))
def test_polygons_match_cv2_fill(case):
    h, w = SIZE
    polys = POLYGONS[case]
    got, want = pcm.polygons_to_mask(polys, h, w), jcm.polygons_to_mask(polys, h, w)
    assert got.any() and np.array_equal(got, want)


def test_polygons_match_cv2_fill_seeded():
    """Random polygons, one to four an annotation, of 1 to 30 vertices,
    around and beyond the image."""
    rng = np.random.RandomState(5)
    for _ in range(400):
        h, w = rng.randint(1, 80, 2)
        polys = []
        for _ in range(rng.randint(1, 5)):
            k = rng.randint(1, 30)
            c = np.array([rng.uniform(-0.2, 1.2) * w, rng.uniform(-0.2, 1.2) * h])
            pts = c + rng.randn(k, 2) * rng.choice([0.5, 1.0, 3.0]) * np.array([w, h]) / 4
            polys.append((pts.round() if rng.rand() < 0.3 else pts).reshape(-1).tolist())
        assert np.array_equal(pcm.polygons_to_mask(polys, h, w),
                              jcm.polygons_to_mask(polys, h, w)), (h, w, polys)
    anns = [{"segmentation": POLYGONS["convex"]},
            {"segmentation": pcm.mask_to_rle(rng.rand(*SIZE) < 0.3)}]
    assert np.array_equal(pcm.annotations_to_masks(anns, *SIZE),
                          jcm.annotations_to_masks(anns, *SIZE))


def test_polygons_match_cv2_fill_coco_sized():
    """COCO-sized polygons on a 640x480 image: 5 to 60 vertices at radii of
    30 to 300 px, so edges run hundreds of pixels (the fixed-point slope and
    line steps over their whole length), some across the border, some with
    their vertices in random order (self-intersecting), some near-horizontal
    or near-vertical slivers."""
    rng = np.random.RandomState(6)
    h, w = 480, 640
    for trial in range(60):
        polys = []
        for _ in range(rng.randint(1, 4)):
            k = rng.randint(5, 61)
            centre = np.array([rng.uniform(-0.1, 1.1) * w, rng.uniform(-0.1, 1.1) * h])
            angles = rng.uniform(0, 2 * np.pi, k)
            if rng.rand() < 0.75:
                angles.sort()
            radii = rng.uniform(30, 300) * rng.uniform(0.4, 1.0, k)
            pts = centre + radii[:, None] * np.stack([np.cos(angles), np.sin(angles)], 1)
            if trial % 10 == 9:  # a sliver along one axis
                pts[:, trial % 20 // 10] = centre[trial % 20 // 10] + rng.uniform(-3, 3, k)
            polys.append((pts.round() if rng.rand() < 0.3 else pts).reshape(-1).tolist())
        got, want = pcm.polygons_to_mask(polys, h, w), jcm.polygons_to_mask(polys, h, w)
        assert np.array_equal(got, want), (trial, int((got != want).sum()))


# ---------------------------------------------------------------- registrations


def _json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _touch(*paths):
    for p in paths:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        open(p, "wb").close()


def _panoptic_json(cat_ids, n=2):
    return {"images": [{"id": i, "file_name": f"{i:012d}.jpg", "height": 8, "width": 8}
                       for i in range(n)],
            "annotations": [{"image_id": i, "file_name": f"{i:012d}.png",
                             "segments_info": [{"id": 7 + j, "category_id": c, "iscrowd": j % 2,
                                                "area": 3, "bbox": [0, 0, 1, 1]}
                                               for j, c in enumerate(cat_ids)]}
                            for i in range(n)]}


def _instances_json(cat_ids):
    return {"images": [{"id": 3, "file_name": "b.jpg", "height": 5, "width": 6},
                       {"id": 1, "file_name": "a.jpg", "height": 4, "width": 4}],
            "annotations": [{"image_id": 1, "category_id": c, "iscrowd": 0, "area": 2,
                             "bbox": [0, 0, 1, 1], "segmentation": [[0, 0, 2, 0, 2, 2]]}
                            for c in cat_ids] + [
                {"image_id": 3, "category_id": 1, "iscrowd": 1, "bbox": [0, 0, 1, 1],
                 "segmentation": {"size": [5, 6], "counts": "0;8"}}]}


def _fixture_tree(root):
    """One tiny file tree per family, as its registration expects."""
    j = os.path.join
    coco = j(root, "coco")
    for split in ("train", "val"):
        _json(j(coco, "annotations", f"panoptic_{split}2017.json"), _panoptic_json([1, 2, 200]))
        _json(j(coco, "annotations", f"instances_{split}2017.json"), _instances_json([1, 18]))
    _json(j(coco, "annotations", "captions_train2017.json"), {"annotations": [
        {"image_id": 0, "caption": "a cat"}, {"image_id": 0, "caption": "two dogs"}]})
    ade = j(root, "ADEChallengeData2016")
    _json(j(ade, "ade20k_panoptic_val.json"), _panoptic_json([1, 3]))
    for split in ("train", "val"):
        _json(j(ade, f"ade20k_instance_{split}.json"), _instances_json([7, 3, 999]))
    _touch(j(ade, "annotations_detectron2", "validation", "x.png"),
           j(ade, "annotations_detectron2", "validation", "a.png"),
           j(root, "ADE20K_2021_17_01", "annotations_detectron2", "val", "y.tif"))
    _touch(j(root, "pascal_ctx_d2", "annotations_ctx59", "validation", "c.png"),
           j(root, "pascal_ctx_d2", "annotations_ctx459", "validation", "c.tif"),
           j(root, "VOCdevkit", "VOC2012", "annotations_detectron2", "val", "v.png"))
    mv = j(root, "mapillary_vistas")
    for d in ("training", "validation"):
        _touch(j(mv, d, "labels", "m.png"))
        _json(j(mv, d, "panoptic", "panoptic_2018.json"), _panoptic_json([1, 20]))
    for split in ("train", "test"):
        _touch(j(coco, "coco_stuff_10k", "annotations_detectron2", split, "s.png"))


FAMILIES = {
    "register_coco": ("register_coco_panoptic", [
        "coco_2017_train_panoptic_with_sem_seg", "coco_2017_val_panoptic_with_sem_seg",
        "coco_2017_train_panoptic_caption_with_sem_seg"]),
    "register_ade20k": ("register_ade20k", [
        "ade20k_panoptic_val", "ade20k_sem_seg_val", "ade20k_instance_train",
        "ade20k_instance_val", "ade20k_full_sem_seg_val"]),
    "register_pascal": ("register_pascal", [
        "ctx59_sem_seg_val", "ctx459_sem_seg_val", "pascal21_sem_seg_val"]),
    "register_mapillary": ("register_mapillary_vistas", [
        f"mapillary_vistas_{kind}_{split}" for kind in ("sem_seg", "panoptic")
        for split in ("train", "val")]),
    "register_coco_stuff": ("register_coco_stuff_10k", [
        "coco_2017_train_stuff_10k_sem_seg", "coco_2017_test_stuff_10k_sem_seg"]),
}


def _family(pkg, family):
    """(the family's register function, the package's catalogs)."""
    import importlib

    mod = importlib.import_module(f"{pkg}.data.datasets.{family}")
    return (getattr(mod, FAMILIES[family][0]),
            importlib.import_module(f"{pkg}.data.catalog"))


def _reregister(pkg, family, root=None):
    """The family's names dropped and registered again under ``root``
    (default: the dataset root, as at import); returns the names added."""
    fn, cat = _family(pkg, family)
    for name in FAMILIES[family][1]:
        cat.DatasetCatalog.remove(name)
        cat.MetadataCatalog.remove(name)
    before = set(cat.DatasetCatalog.list())
    fn(root)
    return sorted(set(cat.DatasetCatalog.list()) - before)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_registrations_match_jax(family, tmp_path):
    """Each family's names, metadata and loaded records, over a fixture
    tree in its layout, equal the JAX package's."""
    import odise_tpu.data  # noqa: F401  (registers at import, as the port does)

    _fixture_tree(str(tmp_path))
    got = {}
    try:
        for pkg in ("odise_tpu", "odise_torch"):
            names = _reregister(pkg, family, str(tmp_path))
            assert names == sorted(FAMILIES[family][1])
            cat = _family(pkg, family)[1]
            got[pkg] = {n: (cat.MetadataCatalog.get(n).as_dict(), cat.DatasetCatalog.get(n))
                        for n in names}
    finally:
        for pkg in ("odise_tpu", "odise_torch"):
            _reregister(pkg, family)
    assert got["odise_torch"] == got["odise_tpu"]
    assert all(records for _, records in got["odise_torch"].values())
    if family == "register_coco":
        caption = got["odise_torch"]["coco_2017_train_panoptic_caption_with_sem_seg"][1]
        assert caption[0]["captions"] == ["a cat", "two dogs"]
        assert "captions" not in caption[1]


# ---------------------------------------------------------------- file records


def _coco_tree(root, n=3, size=(40, 56)):
    """A COCO-layout tree of ``n`` train images (JPEG, and PNG under a .jpg
    name), panoptic PNGs with COCO things and stuff (one crowd), the
    panoptic json and captions. Returns the segment id maps."""
    from odise_torch.data.transforms import id2rgb

    rng = np.random.RandomState(6)
    coco = os.path.join(root, "coco")
    for d in ("train2017", "panoptic_train2017", "annotations"):
        os.makedirs(os.path.join(coco, d), exist_ok=True)
    anns, caps, id_maps = [], [], []
    h, w = size
    for i in range(n):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ids = np.full((h, w), 5, np.uint32)  # stuff: wall (199)
        ids[5:25, 4:30] = 3    # thing: person (1)
        ids[20:38, 30:52] = 4  # thing: dog (18), the crowd
        ids[2:12, 40:54] = 6   # thing: car (3)
        stem = f"{i:012d}"
        path = os.path.join(coco, "train2017", stem + ".jpg")
        if i % 2:
            write_png(path, img)
        else:
            Image.fromarray(img).save(path, "JPEG", quality=95)
        write_png(os.path.join(coco, "panoptic_train2017", stem + ".png"), id2rgb(ids))
        anns.append({"image_id": i, "file_name": stem + ".png", "segments_info": [
            {"id": 3, "category_id": 1, "iscrowd": 0}, {"id": 4, "category_id": 18, "iscrowd": 1},
            {"id": 5, "category_id": 199, "iscrowd": 0},
            {"id": 6, "category_id": 3, "iscrowd": 0}]})
        caps += [{"image_id": i, "caption": f"a person and a dog {i}"},
                 {"image_id": i, "caption": "a wall"}]
        id_maps.append(ids)
    _json(os.path.join(coco, "annotations", "panoptic_train2017.json"), {"annotations": anns})
    _json(os.path.join(coco, "annotations", "captions_train2017.json"), {"annotations": caps})
    return id_maps


def test_mapper_and_loader_from_files_match_jax(tmp_path):
    """The registered caption split of a COCO-layout tree, read from its
    files by both packages' loaders with the same seeds and draws: equal
    records, targets and words, and images within one uint8 level (cv2
    resizes uint8 in fixed point), as ``test_mapper_and_loader_match_jax``
    holds the in-memory path."""
    from odise_tpu.data import dataset_mapper as jdm
    from odise_tpu.data import loader as jl
    from odise_tpu.data.catalog import DatasetCatalog as JCatalog
    from odise_torch.data.catalog import DatasetCatalog
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_train_loader

    _coco_tree(str(tmp_path))
    name = "coco_2017_train_panoptic_caption_with_sem_seg"
    try:
        for pkg in ("odise_tpu", "odise_torch"):
            _reregister(pkg, "register_coco", str(tmp_path))
        records, jax_records = DatasetCatalog.get(name), JCatalog.get(name)
    finally:
        for pkg in ("odise_tpu", "odise_torch"):
            _reregister(pkg, "register_coco")
    assert records == jax_records and len(records) == 3 and records[0]["captions"]
    kw = dict(image_size=64, max_instances=4, with_captions=True, num_words=3,
              word_dropout=0.3)
    ours = build_train_loader(records, COCOPanopticDatasetMapper(device="cpu", **kw), 2,
                              seed=5)
    theirs = jl.build_train_loader(jax_records, jdm.COCOPanopticDatasetMapper(**kw), 2, seed=5)
    for _ in range(3):
        got, want = next(ours), next(theirs)
        assert sorted(got) == sorted(want)
        for k in ("gt_labels", "gt_masks", "gt_valid", "word_tokens", "word_valid"):
            assert np.array_equal(got[k].numpy(), want[k]), k
        assert got["gt_valid"].any() and got["word_valid"].any()
        assert float(np.abs(got["image"].numpy() - want["image"]).max()) <= 1 / 255 + 1e-6


def test_write_shapes_dataset_matches_jax(tmp_path):
    """The same files by name and pixels (read by PIL and by the port) and
    the same records, paths aside, as the JAX ``make_shapes_records``."""
    from odise_tpu.data.synthetic import make_shapes_records as jax_records
    from odise_torch.data.synthetic import write_shapes_dataset

    kw = dict(size=40, seed=1, with_captions=True, vary=True)
    want = jax_records(str(tmp_path / "jax"), 3, **kw)
    got = write_shapes_dataset(str(tmp_path / "port"), 3, **kw)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    for g, w in zip(got, want):
        assert g == {k: v.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                     if isinstance(v, str) else v for k, v in w.items()}
        for key in ("file_name", "pan_seg_file_name", "sem_seg_file_name"):
            pil = np.asarray(Image.open(w[key]))
            assert np.array_equal(np.asarray(Image.open(g[key])), pil)
            assert np.array_equal(read_label(w[key]), pil)


@pytest.fixture(scope="module")
def tiny_infer():
    from odise_torch.data.synthetic import SYNTH_LABELS, SYNTH_THING
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary

    torch.manual_seed(0)
    model = build_category_odise("tiny", device="cpu")
    return OpenPanopticInference(model, build_open_vocabulary(model, SYNTH_LABELS,
                                                              thing_mask=SYNTH_THING))


def test_evaluate_from_files_equals_in_memory(tiny_infer, tmp_path):
    """``evaluate_open_vocab`` on records that name their files (images,
    semantic and panoptic PNGs; instance gt from an instances index of RLE
    and polygon masks) gives every metric of the same records held in
    memory (instance gt from the panoptic thing segments)."""
    from odise_torch.data.synthetic import SYNTH_LABELS, SYNTH_THING, make_shapes_records
    from odise_torch.data.synthetic import write_shapes_dataset
    from odise_torch.evaluation.run import evaluate_open_vocab

    files = write_shapes_dataset(str(tmp_path), 2, size=48, seed=3)
    memory = make_shapes_records(2, size=48, seed=3)
    index = {}
    for rec in memory:
        index[rec["image_id"]] = []
        for seg in rec["segments_info"]:
            if SYNTH_THING[seg["category_id"]]:
                m = rec["pan_seg"] == seg["id"]
                # the cat is a rectangle: its corners as a polygon cv2 fills exactly
                ys, xs = np.nonzero(m)
                rect = m.sum() == (np.ptp(ys) + 1) * (np.ptp(xs) + 1)
                box = [xs.min(), ys.min(), xs.max(), ys.min(), xs.max(), ys.max(), xs.min(),
                       ys.max()]
                index[rec["image_id"]].append({
                    "category_id": seg["category_id"], "iscrowd": 0,
                    "segmentation": [[float(v) for v in box]] if rect else pcm.mask_to_rle(m)})
    kw = dict(labels=SYNTH_LABELS, thing_mask=SYNTH_THING, short_side=64, max_size=160)
    got = evaluate_open_vocab(tiny_infer, files, inst_gt_index=index, **kw)
    want = evaluate_open_vocab(tiny_infer, memory, **kw)
    assert got.pop("s_per_img") > 0 and want.pop("s_per_img") > 0
    assert got == want and got["images"] == 2 and got["host_fallback_images"] == 0


def test_train_net_from_a_file_dataset(tmp_path):
    """One TINY step and the final evaluation of ``python -m
    odise_torch.train_net`` on registered datasets whose records name PNG
    files."""
    from odise_torch import train_net
    from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from odise_torch.data.synthetic import synth_categories, write_shapes_dataset

    for name, n, seed in (("_files_train", 2, 0), ("_files_val", 1, 7)):
        records = write_shapes_dataset(str(tmp_path / name), n, size=48, seed=seed)
        DatasetCatalog.remove(name)
        DatasetCatalog.register(name, lambda records=records: records)
        MetadataCatalog.get(name).set(ignore_label=255, categories=synth_categories())
    config = os.path.join(os.path.dirname(__file__), "..", "odise_torch", "configs",
                          "Panoptic", "odise_label_tiny_synth.py")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = train_net.main(["--config-file", config, "--output", str(tmp_path / "out"),
                              "--max-eval-images", "1", "train.device=cpu", "train.max_iter=1",
                              "train.eval_period=1", "dataloader.train.dataset=_files_train",
                              "dataloader.wrapper.dataset_name=_files_val"])
    finally:
        torch.set_num_threads(n_threads)
        for name in ("_files_train", "_files_val"):
            DatasetCatalog.remove(name)
    assert run.history[0]["grad_norm"] > 0 and np.isfinite(run.history[0]["total_loss"])
    assert run.eval_results["main"]["images"] == 1


def test_nvjpeg_is_found_in_the_toolkit_named_by_cuda_home(tmp_path, monkeypatch):
    """The JPEG decoder's build links nvJPEG from ``$CUDA_HOME`` first, by
    its versioned name where the toolkit has no unversioned one, with the
    library's directory as its run path."""
    from odise_torch.ops import _build

    (tmp_path / "include").mkdir()
    (tmp_path / "include" / "nvjpeg.h").touch()
    (tmp_path / "lib64").mkdir()
    (tmp_path / "lib64" / "libnvjpeg.so.12").touch()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    flags = _build.flags("jpeg_decode")
    assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert flags[len(_build.NVCC_FLAGS):] == (
        "-I", str(tmp_path / "include"), "-L", str(tmp_path / "lib64"), "-l:libnvjpeg.so.12",
        "-Xlinker", f"-rpath={tmp_path / 'lib64'}")
    assert _build.flags("ms_deform_attn") == _build.NVCC_FLAGS
