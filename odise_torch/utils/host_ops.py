"""Host C++ ops of the evaluation and data path, bound with ctypes
(counterpart of ``odise_tpu/native``): ``rgb2id``, ``pq_intersections``,
``mask_iou`` and ``bincount_u32`` from ``csrc/host_ops.cpp``, which
``ops/_build.py`` compiles with the host's C++ compiler into
``odise_torch/_build/`` at first use.

Unlike the JAX package there is no fallback: a failed build or load raises.
The numpy forms beside them (``*_plain``) are the plain versions the tests
hold them to. ``pq_intersections`` returns its pairs in ascending order, as
its plain version does (the C++ counter gives them in hash order), so that
the PQ statistics sum in the same order either way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

__all__ = ["bincount_u32", "bincount_u32_plain", "mask_iou", "mask_iou_plain",
           "pq_intersections", "pq_intersections_plain", "rgb2id", "rgb2id_plain"]

# pairs the first call makes room for; more take a second call, as in JAX
PAIRS_CAP = 4096


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ..ops import _build

    lib = _build.load("host_ops")
    lib.rgb2id.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.rgb2id.restype = None
    lib.pq_intersections.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.pq_intersections.restype = ctypes.c_int64
    lib.mask_iou.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.mask_iou.restype = ctypes.c_double
    lib.bincount_u32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_int64]
    lib.bincount_u32.restype = None
    return lib


def _same_shape(a: np.ndarray, b: np.ndarray, what: str) -> None:
    if a.shape != b.shape:
        raise ValueError(f"{what} takes two arrays of one shape, not {a.shape} and {b.shape}")


def rgb2id(rgb: np.ndarray) -> np.ndarray:
    """Panoptic PNG RGB [..., 3] uint8 -> uint32 ids (panopticapi's rule)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.shape[-1:] != (3,):
        raise ValueError(f"rgb2id takes [..., 3] RGB, not {rgb.shape}")
    out = np.empty(rgb.shape[:-1], np.uint32)
    _lib().rgb2id(rgb.ctypes.data, out.ctypes.data, out.size)
    return out


def pq_intersections(gt: np.ndarray, pred: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The distinct (gt id, pred id) pairs of two id maps, ascending, and
    their pixel counts: (gt ids uint32, pred ids uint32, counts uint64)."""
    gt = np.ascontiguousarray(gt, dtype=np.uint32)
    pred = np.ascontiguousarray(pred, dtype=np.uint32)
    _same_shape(gt, pred, "pq_intersections")
    lib, cap = _lib(), PAIRS_CAP
    while True:
        pairs = np.empty(cap, np.uint64)
        counts = np.empty(cap, np.uint64)
        m = lib.pq_intersections(gt.ctypes.data, pred.ctypes.data, gt.size,
                                 pairs.ctypes.data, counts.ctypes.data, cap)
        if m <= cap:
            break
        cap = int(m)
    order = np.argsort(pairs[:m], kind="stable")
    pairs, counts = pairs[order], counts[order]
    return ((pairs >> np.uint64(32)).astype(np.uint32),
            (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32), counts)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two masks of one shape (nonzero = in); 0.0 where both are empty."""
    a = np.ascontiguousarray(a).astype(np.uint8, copy=False)
    b = np.ascontiguousarray(b).astype(np.uint8, copy=False)
    _same_shape(a, b, "mask_iou")
    return float(_lib().mask_iou(a.ctypes.data, b.ctypes.data, a.size))


def bincount_u32(ids: np.ndarray, num_ids: int) -> np.ndarray:
    """Pixels per id over a uint32 id map: [num_ids] uint64; ids at or past
    ``num_ids`` are not counted."""
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    counts = np.empty(int(num_ids), np.uint64)
    _lib().bincount_u32(ids.ctypes.data, ids.size, counts.ctypes.data, counts.size)
    return counts


# ---------------------------------------------------------------- plain versions


def rgb2id_plain(rgb: np.ndarray) -> np.ndarray:
    c = np.asarray(rgb).astype(np.uint32)
    return c[..., 0] + 256 * c[..., 1] + 65536 * c[..., 2]


def pq_intersections_plain(gt: np.ndarray, pred: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    combined = (np.asarray(gt, np.uint32).astype(np.uint64) * np.uint64(2 ** 32)
                + np.asarray(pred, np.uint32).astype(np.uint64))
    pairs, counts = np.unique(combined, return_counts=True)
    return ((pairs >> np.uint64(32)).astype(np.uint32),
            (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32), counts.astype(np.uint64))


def mask_iou_plain(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter / union) if union else 0.0


def bincount_u32_plain(ids: np.ndarray, num_ids: int) -> np.ndarray:
    ids = np.asarray(ids, np.uint32).ravel()
    return np.bincount(ids[ids < num_ids], minlength=int(num_ids)).astype(np.uint64)
