"""JPEG fixtures for the card's nvJPEG decoder, with PIL's decode of each.

``tests/data/torch_jpeg_reference.npz`` holds four JPEGs made from a seed
(baseline 4:2:0 at 641x479, not a multiple of the 16-px MCU; 4:4:4;
grayscale; progressive), PIL's ``convert("RGB")`` decode of each and of the
three ``demo/examples/*.jpg``, and a sha256 of every JPEG's bytes and of
every decode, checked on load. The card's tests use no PIL: they hold
nvJPEG against these decodes. Rewrite the file (on a machine with PIL) with

    python -m tests.torch_jpeg_fixtures

This module imports neither PIL nor JAX at import time.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
PATH = REPO / "tests" / "data" / "torch_jpeg_reference.npz"
DEMO = REPO / "demo" / "examples"
CASES = ("baseline_420_641x479", "baseline_444", "grayscale", "progressive")
DEMO_IMAGES = ("ade", "coco", "ego4d")


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _scene(rng, h, w):
    """A photo-like RGB image: smooth colour fields, soft shapes, fine noise."""
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    img = np.stack([
        128 + 90 * np.sin(2.1 * xx + 1.3 * yy + rng.rand() * 6),
        128 + 80 * np.cos(1.7 * yy - 2.3 * xx + rng.rand() * 6),
        128 + 70 * np.sin(3.1 * (xx + yy) + rng.rand() * 6)], axis=-1)
    for _ in range(6):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 20 + rng.rand() * 80
        d = np.sqrt((np.mgrid[:h, :w][0] - cy) ** 2 + (np.mgrid[:h, :w][1] - cx) ** 2)
        alpha = np.clip((r - d) / 6, 0, 1)[..., None]
        img = img * (1 - alpha) + rng.randint(0, 256, 3) * alpha
    img += rng.randn(h, w, 3) * 2
    return np.clip(img, 0, 255).round().astype(np.uint8)


def write():
    from PIL import Image

    rng = np.random.RandomState(0)
    arrays, meta = {}, {}
    settings = {"baseline_420_641x479": dict(size=(479, 641), subsampling=2),
                "baseline_444": dict(size=(480, 640), subsampling=0),
                "grayscale": dict(size=(480, 640), gray=True),
                "progressive": dict(size=(480, 640), subsampling=2, progressive=True)}
    for case in CASES:
        s = settings[case]
        img = Image.fromarray(_scene(rng, *s["size"]))
        if s.get("gray"):
            img = img.convert("L")
        buf = io.BytesIO()
        kw = {k: s[k] for k in ("subsampling", "progressive") if k in s}
        img.save(buf, "JPEG", quality=92, **kw)
        data = buf.getvalue()
        pixels = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
        arrays[f"{case}/jpeg"] = np.frombuffer(data, np.uint8)
        arrays[f"{case}/pixels"] = pixels
        meta[case] = {"jpeg": _sha(data), "pixels": _sha(pixels.tobytes())}
    for name in DEMO_IMAGES:
        data = (DEMO / f"{name}.jpg").read_bytes()
        pixels = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
        arrays[f"demo/{name}/pixels"] = pixels
        meta[f"demo/{name}"] = {"jpeg": _sha(data), "pixels": _sha(pixels.tobytes())}
    import PIL

    meta["_pil"] = PIL.__version__
    arrays["meta"] = np.frombuffer(json.dumps(meta, sort_keys=True).encode(), np.uint8)
    np.savez_compressed(PATH, **arrays)


def load():
    """{case: (jpeg bytes, PIL's [H, W, 3] uint8 decode)} for the four
    fixtures and the three demo images (``demo/<name>``), every sha256
    checked; and the PIL version that decoded them."""
    with np.load(PATH) as z:
        meta = json.loads(z["meta"].tobytes())
        out = {}
        for case in CASES:
            out[case] = (z[f"{case}/jpeg"].tobytes(), z[f"{case}/pixels"])
        for name in DEMO_IMAGES:
            out[f"demo/{name}"] = ((DEMO / f"{name}.jpg").read_bytes(),
                                   z[f"demo/{name}/pixels"])
    for key, (data, pixels) in out.items():
        if (_sha(data), _sha(pixels.tobytes())) != (meta[key]["jpeg"], meta[key]["pixels"]):
            raise ValueError(f"{PATH}: {key} does not match its sha256; rewrite it with "
                             "python -m tests.torch_jpeg_fixtures")
    return out, meta["_pil"]


def jpeg_gap(got: np.ndarray, want: np.ndarray) -> dict:
    """A decode against PIL's: per-channel mean and largest absolute error,
    the mean over the image and the PSNR in dB (inf where equal)."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    mse = float((diff ** 2).mean())
    return {"mean_abs": float(diff.mean()),
            "mean_abs_channel": [float(v) for v in diff.mean(axis=(0, 1))],
            "max_abs_channel": [int(v) for v in diff.max(axis=(0, 1))],
            "psnr_db": float("inf") if mse == 0 else float(10 * np.log10(255 ** 2 / mse))}


# nvJPEG against PIL: its IDCT and chroma upsampling are not libjpeg-turbo's
PSNR_MIN_DB, MEAN_ABS_MAX = 40.0, 1.0


if __name__ == "__main__":
    write()
    cases, pil = load()
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes, PIL {pil}):",
          {k: v[1].shape for k, v in cases.items()})
