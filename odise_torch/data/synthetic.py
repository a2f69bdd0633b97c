"""Synthetic shapes records (counterpart of ``odise_tpu/data/synthetic.py``).

Colour-coded shapes on a stuff background: class 2 "grass" (stuff) fills
the image, class 0 "cat" (thing) is a red rectangle and class 1 "dog"
(thing) a blue disk drawn on top. ``_draw_sample`` is the JAX package's,
unchanged, so one seed gives the same pixels in both packages.

``make_shapes_records`` keeps the samples in memory, as arrays under
``image``, ``pan_seg`` and ``sem_seg`` (the record keys the eval loop
reads); ``write_shapes_dataset`` writes the same samples to PNG files, as
the JAX package's ``make_shapes_records(out_dir, ...)`` does, and returns
records that name them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .image_io import write_png
from .transforms import id2rgb

SYNTH_LABELS: Tuple[Tuple[str, ...], ...] = (("cat",), ("dog",), ("grass",))
SYNTH_THING = (True, True, False)


def synth_categories() -> List[Dict]:
    return [{"id": i, "isthing": int(SYNTH_THING[i]), "name": l[0]}
            for i, l in enumerate(SYNTH_LABELS)]


def _draw_sample(rng: np.random.RandomState, size: int, vary: bool = False):
    """One image + per-pixel category map + instance-id map.

    ``vary=True`` makes each thing present with p=0.75 (at least one always).
    """
    img = np.empty((size, size, 3), np.float32)
    # grass background with texture noise
    img[..., 0] = 30
    img[..., 1] = 150
    img[..., 2] = 40
    img += rng.randn(size, size, 3) * 18

    sem = np.full((size, size), 2, np.uint8)     # grass
    ids = np.full((size, size), 3, np.uint32)    # grass segment id

    if vary:
        with_cat = rng.rand() < 0.75
        # at least one thing in every image
        with_dog = rng.rand() < 0.75 or not with_cat
    else:
        with_cat = with_dog = True

    # cat: red rectangle
    cat = np.zeros((size, size), bool)
    if with_cat:
        h = rng.randint(size // 4, size // 2 + 1)
        w = rng.randint(size // 4, size // 2 + 1)
        y = rng.randint(0, size - h)
        x = rng.randint(0, size - w)
        cat[y:y + h, x:x + w] = True
        img[cat] = (np.asarray([200, 40, 40])
                    + rng.randn(int(cat.sum()), 3) * 15)
        sem[cat] = 0
        ids[cat] = 1

    # dog: blue disk, drawn on top (may partially occlude the cat)
    if with_dog:
        yy, xx = np.mgrid[:size, :size]
        for _ in range(100):
            r = rng.randint(size // 8, size // 4 + 1)
            cy = rng.randint(r, size - r)
            cx = rng.randint(r, size - r)
            dog = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            # keep a visible chunk of the cat (panoptic GT needs both things)
            if not with_cat or (cat & ~dog).sum() >= (size * size) // 64:
                break
        img[dog] = (np.asarray([40, 60, 210])
                    + rng.randn(int(dog.sum()), 3) * 15)
        sem[dog] = 1
        ids[dog] = 2

    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, sem, ids


def make_shapes_records(n: int, *, size: int = 64, seed: int = 0,
                        with_captions: bool = False,
                        vary: bool = False) -> List[Dict]:
    """n in-memory records: ``image`` [size, size, 3] uint8, ``pan_seg``
    [size, size] uint32 segment ids, ``sem_seg`` [size, size] uint8 class
    ids, ``segments_info`` and ``image_id``. ``with_captions`` adds
    ``captions`` and ``words`` as the JAX package does."""
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n):
        img, sem, ids = _draw_sample(rng, size, vary=vary)
        segments = [{"id": seg_id, "category_id": cat_id, "iscrowd": 0}
                    for seg_id, cat_id in ((1, 0), (2, 1), (3, 2))
                    if (ids == seg_id).any()]
        record = {"image": img, "image_id": i, "pan_seg": ids, "sem_seg": sem,
                  "segments_info": segments}
        if with_captions:
            present = [SYNTH_LABELS[s["category_id"]][0] for s in segments]
            things = [n for n in present if n != "grass"]
            record["captions"] = [
                "a photo of a " + " and a ".join(things) + " on grass"]
            record["words"] = present
        records.append(record)
    return records


def write_shapes_dataset(out_dir: str, n: int, *, size: int = 64, seed: int = 0,
                         prefix: str = "synth", with_captions: bool = False,
                         vary: bool = False) -> List[Dict]:
    """``make_shapes_records``' samples written to ``out_dir`` as the JAX
    package writes them (``{prefix}{i}.png`` RGB, ``{prefix}{i}_pan.png``
    panoptic RGB, ``{prefix}{i}_sem.png`` gray class ids); returns records
    with ``file_name``, ``pan_seg_file_name`` and ``sem_seg_file_name`` in
    place of the arrays."""
    os.makedirs(out_dir, exist_ok=True)
    records = make_shapes_records(n, size=size, seed=seed, with_captions=with_captions,
                                  vary=vary)
    for i, rec in enumerate(records):
        paths = {key: os.path.join(out_dir, f"{prefix}{i}{suffix}.png")
                 for key, suffix in (("file_name", ""), ("pan_seg_file_name", "_pan"),
                                     ("sem_seg_file_name", "_sem"))}
        write_png(paths["file_name"], rec.pop("image"))
        write_png(paths["pan_seg_file_name"], id2rgb(rec.pop("pan_seg")))
        write_png(paths["sem_seg_file_name"], rec.pop("sem_seg"))
        rec.update(paths)
    return records
