"""Image and label files without PIL or cv2 (counterpart of the JAX
package's ``PIL.Image.open`` reads: ``odise_tpu/data/dataset_mapper.py``
and ``tools/train_net.py``'s eval loop).

The port depends on neither image library on the card, so it reads its
files itself, dispatching on the file's signature as PIL does, not on its
name:

* PNG, decoded in numpy with ``zlib``: bit depths 8 and 16 (palette
  images also 1, 2 and 4, as PIL writes small palettes); gray, RGB,
  palette, gray-alpha and RGBA; all five row filters; not interlaced.
* TIFF, decoded in numpy: uncompressed baseline files in strips, gray 8 or
  16 bit and RGB 8 bit, either byte order (the 16-bit label files of
  Pascal Context 459 and ADE20K-847).
* JPEG: on a CUDA device with nvJPEG (``csrc/jpeg_decode.cu``) into a tensor
  on the card; on the CPU through PIL, imported inside the call.

Each reader gives what PIL gives: ``read_label`` is ``np.asarray(Image.open(p))``
(palette indices for a palette PNG, uint16 for a 16-bit file);
``read_rgb_png`` and ``read_image`` are ``Image.open(p).convert("RGB")``.
``write_png`` writes what the synthetic datasets and ``chip_smoke.py`` need.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
import zlib
from typing import Optional

import numpy as np
import torch

__all__ = ["decode_jpeg_cuda", "decode_png", "decode_tiff", "read_image", "read_label",
           "read_rgb_png", "write_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*")

# PNG colour type -> (channels, PIL mode at 8 bits)
_PNG_COLOUR = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 4: (2, "LA"), 6: (4, "RGBA")}


@dataclasses.dataclass
class Decoded:
    """Pixels as ``np.asarray(Image.open(...))`` gives them, with PIL's mode
    and, for a palette image, its [256, 3] palette."""

    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------- PNG


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of [h, 1 + w * bpp] bytes -> [h, w, bpp].

    Sub, Average and Paeth take the byte one pixel to the left after it is
    decoded, so a row cannot be decoded at once. Pixel (y, x) needs only
    (y, x - 1), (y - 1, x) and (y - 1, x - 1), which all lie on the
    anti-diagonal y + x - 1 or before it: the image is sheared so that each
    anti-diagonal is one slice, and decoded one slice at a time (h + w - 1
    steps, each over up to h pixels)."""
    ftype = rows[:, 0]
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} does not exist")
    raw = rows[:, 1:].reshape(h, w, bpp)
    if not ftype.any():
        return raw
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    # sheared[d + 2, y + 1] holds pixel (y, d - y); diagonals -2, -1 and the
    # row y = -1 stay zero, the neighbours the filters take outside the image
    sheared = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    sheared[ys + xs + 2, ys + 1] = raw
    ft = ftype.astype(np.int16)[:, None]
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        f = ft[lo:hi]
        a = sheared[d + 1, lo + 1:hi + 1]
        b = sheared[d + 1, lo:hi]
        c = sheared[d, lo:hi]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        cur = sheared[d + 2, lo + 1:hi + 1]
        cur += pred
        cur &= 0xFF
    return sheared[ys + xs + 2, ys + 1].astype(np.uint8)


def decode_png(data: bytes) -> Decoded:
    """A PNG file's bytes -> its pixels, as PIL opens them."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG file ends before its IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is cut short")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:
            raise ValueError(f"PNG chunk {kind!r} is critical and unknown")
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour not in _PNG_COLOUR or compression or filter_method:
        raise ValueError(f"PNG colour type {colour}, compression {compression}, filter "
                         f"method {filter_method} are not PNG's")
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if depth not in ((1, 2, 4, 8) if colour == 3 else (8, 16)):
        raise ValueError(f"PNG bit depth {depth} with colour type {colour} is not supported")
    channels, mode = _PNG_COLOUR[colour]
    if depth < 8:  # palette indices packed into bytes: filters work on bytes
        row_bytes, bpp = -(-w * depth // 8), 1
    else:
        row_bytes, bpp = w * channels * depth // 8, channels * depth // 8
    # a bytearray, so that an unfiltered image's pixels are a writable view
    raw = np.frombuffer(bytearray(zlib.decompress(b"".join(idat))), np.uint8)
    if raw.size != h * (1 + row_bytes):
        raise ValueError(f"PNG image data holds {raw.size} bytes, not {h * (1 + row_bytes)}")
    px = _unfilter(raw.reshape(h, 1 + row_bytes), h, row_bytes // bpp, bpp)
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((px.reshape(h, row_bytes, 1) >> shifts) & ((1 << depth) - 1))
        px = np.ascontiguousarray(px.reshape(h, -1)[:, :w])
    elif depth == 16:
        if channels == 1:
            px, mode = px.reshape(h, w * 2).view(">u2").astype(np.uint16), "I;16"
        else:
            px = np.ascontiguousarray(px[..., 0::2])  # PIL keeps each sample's high byte
    px = px.reshape(h, w) if px.ndim == 3 and px.shape[2] == 1 else px
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return Decoded(px, mode, full)
    return Decoded(px, mode)


def _filter_rows(px: np.ndarray, filter_type: int) -> np.ndarray:
    """[h, w, bpp] bytes -> [h, 1 + w * bpp] filtered rows (PNG filter
    ``filter_type`` on every row)."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)][filter_type]
    out = ((x - pred) & 0xFF).astype(np.uint8).reshape(px.shape[0], -1)
    return np.concatenate([np.full((px.shape[0], 1), filter_type, np.uint8), out], axis=1)


def write_png(path, array: np.ndarray, palette: Optional[np.ndarray] = None,
              filter_type: Optional[int] = None) -> None:
    """Write ``array`` as a PNG: [H, W] uint8 (gray, or palette indices
    with a [n <= 256, 3] uint8 ``palette``), [H, W] uint16 (16-bit gray),
    [H, W, 2|3|4] uint8 (gray-alpha, RGB, RGBA). Every row gets
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; default Paeth,
    and None for a palette image)."""
    array = np.asarray(array)
    if array.ndim not in (2, 3) or array.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes [H, W] or [H, W, C] uint8 or uint16, not "
                         f"{array.shape} {array.dtype}")
    channels = 1 if array.ndim == 2 else array.shape[2]
    if palette is not None:
        if channels != 1 or array.dtype != np.uint8:
            raise ValueError("a palette image is [H, W] uint8 indices")
        colour = 3
    else:
        colour = {1: 0, 2: 4, 3: 2, 4: 6}.get(channels)
        if colour is None:
            raise ValueError(f"write_png takes 1 to 4 channels, not {channels}")
    if filter_type is None:
        filter_type = 0 if palette is not None else 4
    if filter_type not in range(5):
        raise ValueError(f"PNG row filter {filter_type} does not exist")
    h, w = array.shape[:2]
    depth = 8 * array.itemsize
    px = np.ascontiguousarray(array.astype(array.dtype.newbyteorder(">")))
    rows = _filter_rows(px.view(np.uint8).reshape(h, w, -1), filter_type)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    parts = [PNG_SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                        0, 0, 0))]
    if palette is not None:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).reshape(-1, 3).tobytes()))
    parts += [chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))


# ---------------------------------------------------------------- TIFF

_TIFF_TYPES = {1: "u1", 3: "u2", 4: "u4"}  # BYTE, SHORT, LONG
_TIFF_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TIFF_NAMES = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample",
               259: "Compression", 262: "PhotometricInterpretation", 273: "StripOffsets",
               277: "SamplesPerPixel", 278: "RowsPerStrip", 279: "StripByteCounts",
               284: "PlanarConfiguration", 317: "Predictor", 322: "TileWidth",
               338: "ExtraSamples", 339: "SampleFormat"}


def decode_tiff(data: bytes) -> Decoded:
    """An uncompressed baseline TIFF's bytes (first image, in strips; gray 8
    or 16 bit, or RGB 8 bit) -> its pixels, as PIL opens them. Anything else
    raises, naming the tag."""
    if data[:4] not in TIFF_SIGNATURES:
        raise ValueError("not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", data[4:8])
    (n,) = struct.unpack(e + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        entry = data[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        tag, kind, count, inline = struct.unpack(e + "HHI4s", entry)
        if kind not in _TIFF_TYPES:
            continue  # ASCII, RATIONAL, ...: nothing the pixels need
        size = _TIFF_SIZES[kind] * count
        if size <= 4:
            raw = inline[:size]
        else:
            (off,) = struct.unpack(e + "I", inline)
            raw = data[off:off + size]
        if len(raw) != size:
            raise ValueError(f"TIFF tag {tag} runs past the end of the file")
        tags[tag] = np.frombuffer(raw, e + _TIFF_TYPES[kind]).astype(np.int64)

    def one(tag, default=None):
        if tag not in tags:
            if default is None:
                raise ValueError(f"TIFF tag {tag} ({_TIFF_NAMES[tag]}) is missing")
            return default
        return int(tags[tag][0])

    def refuse(tag, value):
        raise ValueError(f"TIFF tag {tag} ({_TIFF_NAMES[tag]}) = {value} is not supported: "
                         "only uncompressed baseline gray 8/16-bit and RGB 8-bit strips")

    for tag in (322, 338):
        if tag in tags:
            refuse(tag, tags[tag].tolist())
    for tag, want in ((259, 1), (284, 1), (317, 1), (339, 1)):
        if one(tag, 1) != want:
            refuse(tag, one(tag))
    w, h, spp = one(256), one(257), one(277, 1)
    bits = tags.get(258, np.asarray([1])).tolist()
    photometric = one(262)
    if spp not in (1, 3):
        refuse(277, spp)
    if photometric != (1 if spp == 1 else 2):
        refuse(262, photometric)
    if bits not in (([8], [16]) if spp == 1 else ([8, 8, 8],)):
        refuse(258, bits)
    depth = bits[0]
    mode = {1: "L", 2: "I;16", 3: "RGB"}[spp if depth == 8 else 2]
    rows_per_strip = min(one(278, 2 ** 32 - 1), h)
    offsets, counts = tags[273], tags[279]
    row_bytes = w * spp * depth // 8
    strips = []
    for k, (off, cnt) in enumerate(zip(offsets.tolist(), counts.tolist())):
        rows = min(rows_per_strip, h - k * rows_per_strip)
        if rows <= 0:
            break
        if cnt < rows * row_bytes or off + rows * row_bytes > len(data):
            raise ValueError(f"TIFF strip {k} holds {cnt} bytes, not {rows * row_bytes}")
        strips.append(data[off:off + rows * row_bytes])
    buf = b"".join(strips)
    if len(buf) != h * row_bytes:
        raise ValueError(f"TIFF strips hold {len(buf)} bytes, not {h * row_bytes}")
    px = np.frombuffer(buf, e + ("u1" if depth == 8 else "u2"))
    px = px.astype(np.uint8 if depth == 8 else np.uint16)
    return Decoded(px.reshape((h, w) if spp == 1 else (h, w, 3)), mode)


# ---------------------------------------------------------------- dispatch


def _decode(data: bytes, path) -> Decoded:
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:4] in TIFF_SIGNATURES:
        return decode_tiff(data)
    raise ValueError(f"{path}: neither PNG nor TIFF (the port reads labels only from those)")


def _to_rgb(dec: Decoded) -> np.ndarray:
    """``Image.convert("RGB")``: gray replicated, palette looked up, alpha
    dropped."""
    px = dec.pixels
    if dec.mode == "RGB":
        return px
    if dec.mode == "RGBA":
        return np.ascontiguousarray(px[..., :3])
    if dec.mode in ("L", "LA"):
        gray = px if dec.mode == "L" else px[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    if dec.mode == "P":
        return dec.palette[px]
    raise ValueError(f"a {dec.mode} image has no 8-bit RGB form")


def read_label(path) -> np.ndarray:
    """``np.asarray(Image.open(path))`` for a PNG or TIFF label file: [H, W]
    uint8 (gray, or a palette PNG's indices) or uint16 (16-bit files)."""
    return _decode(_read(path), path).pixels


def read_rgb_png(path) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))`` for a PNG or TIFF
    (a panoptic PNG, before ``rgb2id``): [H, W, 3] uint8."""
    return _to_rgb(_decode(_read(path), path))


def read_image(path, device=None) -> torch.Tensor:
    """An image file as RGB uint8 [H, W, 3] on ``device`` (default CUDA),
    as ``Image.open(path).convert("RGB")``. A JPEG is decoded by nvJPEG on a
    CUDA device and by PIL on the CPU; PNG and TIFF by this module."""
    from ..model_zoo.factory import resolve_device

    device = resolve_device(device)
    data = _read(path)
    if data[:3] == JPEG_SIGNATURE:
        if device.type == "cuda":
            return decode_jpeg_cuda(data, device)
        return torch.from_numpy(_decode_jpeg_pil(path))
    if data[:8] == PNG_SIGNATURE or data[:4] in TIFF_SIGNATURES:
        return torch.from_numpy(_to_rgb(_decode(data, path))).to(device)
    raise ValueError(f"{path}: not a JPEG, PNG or TIFF file")


def _decode_jpeg_pil(path) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(f"{path}: a JPEG on the CPU is decoded by PIL (Pillow), which is "
                          "not installed; on a CUDA device nvJPEG decodes it") from err
    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


# ---------------------------------------------------------------- nvJPEG

_NVJPEG_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
                  4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED",
                  7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR", 9: "IMPLEMENTATION_NOT_SUPPORTED",
                  10: "INCOMPLETE_BITSTREAM"}


@functools.lru_cache(maxsize=None)
def _jpeg_lib():
    """``csrc/jpeg_decode.cu``, built against nvJPEG and loaded once per
    process; raises naming nvJPEG where the toolkit lacks it."""
    from ..ops import _build

    lib = _build.load("jpeg_decode")
    lib.jpeg_image_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [
        ctypes.POINTER(ctypes.c_int)] * 4
    lib.jpeg_decode_rgbi.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.jpeg_image_info, lib.jpeg_decode_rgbi):
        fn.restype = ctypes.c_int
    return lib


def _nvjpeg_error(what: str, status: int) -> RuntimeError:
    name = (f"CUDA error {status - 1000}" if status >= 1000
            else f"NVJPEG_STATUS_{_NVJPEG_STATUS.get(status, status)}")
    return RuntimeError(f"nvJPEG {what} failed: {name}")


def decode_jpeg_cuda(data: bytes, device) -> torch.Tensor:
    """A JPEG's bytes -> RGB uint8 [H, W, 3] on the CUDA ``device``, decoded
    by nvJPEG on the current stream; each decode is counted in
    ``decode_jpeg_cuda.decodes``. All decodes of a process go to the device
    of its first (``decode_jpeg_cuda.device``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG decodes onto a CUDA device, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # the first decode creates the process's one nvJPEG handle and state, on
    # its device; they serve no other
    owner = decode_jpeg_cuda.device
    if owner is not None and owner != device:
        raise ValueError(f"nvJPEG's state in this process lives on {owner}, not {device}")
    w, h, comps, subsampling = (ctypes.c_int() for _ in range(4))
    with torch.cuda.device(device):
        status = _jpeg_lib().jpeg_image_info(data, len(data), ctypes.byref(w),
                                             ctypes.byref(h), ctypes.byref(comps),
                                             ctypes.byref(subsampling))
        if status:
            raise _nvjpeg_error("reading the JPEG header", status)
        h, w = h.value, w.value
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=device)
        status = _jpeg_lib().jpeg_decode_rgbi(data, len(data), out.data_ptr(), w * 3,
                                              torch.cuda.current_stream().cuda_stream)
    if status:
        raise _nvjpeg_error("decoding", status)
    decode_jpeg_cuda.device = device
    decode_jpeg_cuda.decodes += 1
    return out


decode_jpeg_cuda.decodes = 0
decode_jpeg_cuda.device = None
