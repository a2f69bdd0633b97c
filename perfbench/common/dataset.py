"""A COCO-panoptic-layout training set drawn from the seed: ``records`` of
640x480 JPEG images (the three under ``perfbench/data``, COCO's most common
size), each with its own drawn panoptic PNG (three stuff bands, five thing
ellipses, a void square; contiguous COCO panoptic ids, as the port's
registration gives them) and two captions naming what it shows. The files
go under a fixed directory of the run's ``TMPDIR`` named by the seed.
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
import zlib
from typing import List

import numpy as np

from perfbench.reference import labels as rlabels

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
JPEGS = ("ade.jpg", "coco.jpg", "ego4d.jpg")
H, W = 480, 640
N_THING = 80  # COCO panoptic's contiguous ids: 80 things, then 53 stuff


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG, every row unfiltered."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def draw(rng: np.random.Generator, names):
    """(ids [H, W] uint32, segments_info, captions) of one image."""
    ids = np.zeros((H, W), np.uint32)
    segments, things = [], []
    cuts = sorted(rng.integers(H // 5, 4 * H // 5, 2).tolist())
    stuff = rng.choice(np.arange(N_THING, len(names)), 3, replace=False)
    for k, (cat, y0, y1) in enumerate(zip(stuff, [0] + cuts, cuts + [H])):
        sid = 1 + 70001 * (k + 1) % 2 ** 24
        ids[y0:y1] = sid
        segments.append({"id": int(sid), "category_id": int(cat), "iscrowd": 0})
    yy, xx = np.mgrid[:H, :W]
    for k, cat in enumerate(rng.choice(N_THING, 5, replace=False)):
        cy, cx = rng.integers(40, H - 40), rng.integers(40, W - 40)
        ry, rx = rng.integers(20, 120), rng.integers(20, 160)
        sid = 1 + 9973 * (k + 11) % 2 ** 24
        ids[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = sid
        segments.append({"id": int(sid), "category_id": int(cat), "iscrowd": 0})
        things.append(names[cat][0])
    y, x = rng.integers(0, H - 24), rng.integers(0, W - 24)
    ids[y:y + 24, x:x + 24] = 0
    present = set(np.unique(ids).tolist())
    segments = [s for s in segments if s["id"] in present]
    stuff_name = names[stuff[0]][0]
    captions = [f"a {things[0]} and a {things[1]} by the {stuff_name}",
                f"a photo of a {things[2]} next to a {things[3]}"]
    return ids, segments, captions


def root(seed: int, tag: str) -> str:
    return os.path.join(tempfile.gettempdir(), "perfbench-data", f"{tag}-{seed}")


def write(seed: int, n: int, tag: str) -> List[dict]:
    """``n`` records under ``root(seed, tag)``."""
    root_dir = root(seed, tag)
    shutil.rmtree(root_dir, ignore_errors=True)
    os.makedirs(root_dir)
    names = rlabels.coco_panoptic_labels()
    rng = np.random.default_rng(int(seed))
    records = []
    for i in range(n):
        ids, segments, captions = draw(rng, names)
        rgb = np.stack([ids & 255, (ids >> 8) & 255, (ids >> 16) & 255], -1).astype(np.uint8)
        png = os.path.join(root_dir, f"{i:06d}.png")
        write_png(png, rgb)
        records.append({"file_name": os.path.join(DATA, JPEGS[i % len(JPEGS)]),
                        "image_id": i, "pan_seg_file_name": png, "height": H, "width": W,
                        "segments_info": segments, "captions": captions})
    return records
