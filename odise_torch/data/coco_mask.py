"""COCO ``segmentation`` payloads as masks, without pycocotools or cv2
(counterpart of ``odise_tpu/data/coco_mask.py``).

The three COCO encodings: polygons ``[[x0, y0, x1, y1, ...], ...]``,
uncompressed RLE ``{"size": [h, w], "counts": [int, ...]}`` and compressed
RLE ``{"size": [h, w], "counts": "<ascii>"}``. RLE runs are column-major
and alternate background and foreground, starting with background.

The JAX package rasterizes polygons with ``cv2.fillPoly`` (8-connected,
integer vertices, every polygon of an annotation in one call); the port
depends on no cv2. ``polygons_to_mask`` reproduces that call in
numpy, pixel for pixel: cv2 draws each edge as an 8-connected line (clipped
to the image as cv2 clips it), then fills between the edges of each row by
the even-odd rule over every polygon together, in 16.16 fixed point; so
where two polygons of one annotation overlap, the overlap is left unfilled
but for its outlines, as in cv2.

A fourth payload is ADE20K's: ``InstancePngMask``, an instance PNG and the
(R, G) key of its pixels, which the prepared instance json names in place
of a ``segmentation`` (``prepare/prepare_ade20k_ins_seg.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from .image_io import read_label


@dataclasses.dataclass(frozen=True)
class InstancePngMask:
    """An instance as ADE20K stores it: the pixels of the PNG ``png`` whose
    (R, G) equals ``key`` (R the thing class, G the instance). The PNG is
    read when the mask is built."""

    png: str
    key: Tuple[int, int]


Segmentation = Union[List[Sequence[float]], Dict, InstancePngMask]

__all__ = ["InstancePngMask", "annotations_to_masks", "decode_compressed_counts",
           "encode_compressed_counts", "mask_to_rle", "polygons_to_mask", "rle_to_mask",
           "segmentation_to_mask"]


def decode_compressed_counts(s: Union[str, bytes]) -> List[int]:
    """COCO's compressed RLE counts string -> counts. Each count is 6-bit
    chunks (characters offset by 48), bit 5 the continuation flag, bit 4 of
    the last chunk the sign; from the third count on, a delta against the
    count two before."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    p, n = 0, len(s)
    while p < n:
        x = k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_compressed_counts(counts: Sequence[int]) -> str:
    """Inverse of :func:`decode_compressed_counts`."""
    out: List[str] = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            # stop when what is left is the sign extension of bit 4
            more = x != (-1 if c & 0x10 else 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_to_mask(rle: Dict) -> np.ndarray:
    """Uncompressed or compressed RLE -> [h, w] bool mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decode_compressed_counts(counts)
    counts = np.asarray(counts, np.int64)
    if (counts < 0).any() or int(counts.sum()) != h * w:
        raise ValueError(f"RLE covers {int(counts.sum())} pixels, expected {h * w}")
    ends = np.cumsum(counts)
    flat = np.zeros(h * w + 1, np.int8)
    # foreground runs are the odd ones: +1 at each start, -1 past each end
    np.add.at(flat, ends[0::2][:len(counts) // 2], 1)
    np.add.at(flat, ends[1::2], -1)
    return np.cumsum(flat[:-1]).astype(bool).reshape((w, h)).T


def mask_to_rle(mask: np.ndarray, compress: bool = True) -> Dict:
    """[h, w] bool mask -> COCO RLE (column-major runs)."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    if compress:
        return {"size": [h, w], "counts": encode_compressed_counts(counts)}
    return {"size": [h, w], "counts": counts}


# ------------------------------------------------------ cv2.fillPoly in numpy

_SHIFT = 16  # cv2's XY_SHIFT: x in 16.16 fixed point

Point = Tuple[int, int]


def _clip_line(w: int, h: int, p1: Point, p2: Point) -> Tuple[bool, Point, Point]:
    """cv2's ``clipLine`` (Cohen-Sutherland in int64, the crossings in
    double, truncated): whether any of the segment is inside the image, and
    the endpoints as cv2 leaves them."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _outside(w: int, h: int, p: Point) -> bool:
    return not (0 <= p[0] < w and 0 <= p[1] < h)


def _line_pixels(w: int, h: int, p1: Point, p2: Point) -> Tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of cv2's 8-connected line from p1 to p2: clipped to the
    image first, then Bresenham from its left end."""
    if _outside(w, h, p1) or _outside(w, h, p2):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    major, minor = max(dx, abs(dy)), min(dx, abs(dy))
    k = np.arange(major + 1, dtype=np.int64)
    # cv2's error term moves the minor axis after step j where
    # major - 2 * minor * (j + 1) + 2 * major * steps_so_far < 0
    steps = (2 * minor * k + major - 1) // (2 * major) if major else k
    if abs(dy) > dx:
        return p1[1] + sy * k, p1[0] + steps
    return p1[1] + sy * steps, p1[0] + k


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def polygons_to_mask(polygons: List[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygons ([x0, y0, x1, y1, ...] lists) -> [h, w] bool mask, as
    ``cv2.fillPoly(mask, pts, 1)`` draws them with ``pts`` the polygons of
    three or more points, their vertices rounded to int32 (the JAX
    package's call)."""
    mask = np.zeros((h, w), bool)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polygons if len(p) >= 6]
    edges = []  # (y0, y1, x at y0 in 16.16, dx per row), as cv2's PolyEdge
    for poly in pts:
        prev = poly[-1]
        for cur in poly:
            t0, t1 = (int(prev[0]), int(prev[1])), (int(cur[0]), int(cur[1]))
            ys, xs = _line_pixels(w, h, t0, t1)
            mask[ys, xs] = True
            x0c, y0c = t0[0] << _SHIFT, t0[1]
            x1c, y1c = t1[0] << _SHIFT, t1[1]
            if _outside(w, h, t0) or _outside(w, h, t1):
                # the edge's x comes from its clipped endpoints, and so
                # does its slope where they lie on two rows
                _, c0, c1 = _clip_line(w, h, t0, t1)
                x0c, x1c = c0[0] << _SHIFT, c1[0] << _SHIFT
                if c0[1] != c1[1]:
                    y0c, y1c = c0[1], c1[1]
            prev = cur
            if t0[1] == t1[1]:
                continue
            dx = _trunc_div(x1c - x0c, y1c - y0c)
            if t0[1] < t1[1]:
                edges.append((t0[1], t1[1], x0c + (t0[1] - y0c) * dx, dx))
            else:
                edges.append((t1[1], t0[1], x1c + (t1[1] - y1c) * dx, dx))
    if len(edges) < 2:
        return mask
    y0, y1, x0, dx = (np.asarray(v, np.int64) for v in zip(*edges))
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (w << _SHIFT)):
        return mask
    # each edge crosses the rows y0 <= y < y1; a row's crossings, sorted by
    # x, pair up into the spans cv2 fills (every row has an even count)
    lo, hi = np.maximum(y0, 0), np.minimum(y1, h)
    n = np.maximum(hi - lo, 0)
    edge = np.repeat(np.arange(len(y0)), n)
    rows = lo[edge] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    xs = x0[edge] + (rows - y0[edge]) * dx[edge]
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # a span covers the pixels whose x lies between its two crossings
    r, a, b = rows[0::2], (xs[0::2] + (1 << _SHIFT) - 1) >> _SHIFT, xs[1::2] >> _SHIFT
    keep = (a < w) & (b >= 0)
    r, a, b = r[keep], np.maximum(a[keep], 0), np.minimum(b[keep], w - 1)
    runs = np.zeros((h, w + 1), np.int32)
    np.add.at(runs, (r, a), 1)
    np.add.at(runs, (r, b + 1), -1)
    return mask | (np.cumsum(runs[:, :w], axis=1) > 0)


def segmentation_to_mask(seg: Segmentation, h: int, w: int) -> np.ndarray:
    """Any COCO ``segmentation`` payload -> [h, w] bool mask."""
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict):
        m = rle_to_mask(seg)
        if m.shape != (h, w):
            raise ValueError(f"RLE size {m.shape} != image size {(h, w)}")
        return m
    raise TypeError(f"unsupported segmentation type {type(seg)}")


def annotations_to_masks(anns: List[Dict], h: int, w: int) -> np.ndarray:
    """[N, h, w] bool masks of a list of COCO annotations (each instance
    PNG among them read once)."""
    if not anns:
        return np.zeros((0, h, w), bool)
    pngs: Dict[str, np.ndarray] = {}

    def mask(seg: Segmentation) -> np.ndarray:
        if not isinstance(seg, InstancePngMask):
            return segmentation_to_mask(seg, h, w)
        if seg.png not in pngs:
            pngs[seg.png] = read_label(seg.png)
        inst = pngs[seg.png]
        if inst.ndim != 3 or inst.shape[:2] != (h, w):
            raise ValueError(f"{seg.png}: instance PNG of shape {inst.shape}, "
                             f"image {(h, w)}")
        return (inst[..., 0] == seg.key[0]) & (inst[..., 1] == seg.key[1])

    return np.stack([mask(a["segmentation"]) for a in anns])
