"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled for
``sm_90a`` into ``odise_torch/_build/lib<name>_<hash>.so`` at first use; the
hash covers the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. ``jpeg_decode.cu`` also links nvJPEG,
found in the CUDA toolkit or in the ``nvidia`` wheels beside torch
(``nvjpeg_flags``). nvcc's output, with ptxas's registers and
spills for each kernel, is kept beside the library (``build_log``). Nothing
is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _cuda_roots() -> Iterator[Path]:
    """Where a CUDA library may lie: the toolkit (``$CUDA_HOME``,
    ``/usr/local/cuda``, nvcc's own), then the ``nvidia`` wheels beside the
    installed torch, searched only if the toolkit's do not do."""
    roots = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    nvcc = shutil.which("nvcc")
    if nvcc:
        roots.append(str(Path(nvcc).resolve().parent.parent))
    yield from (Path(r) for r in dict.fromkeys(r for r in roots if r))
    import torch

    wheels = Path(torch.__file__).resolve().parent.parent / "nvidia"
    yield from sorted(p.parent.parent for p in wheels.glob("**/include/nvjpeg.h"))


def nvjpeg_flags() -> Tuple[str, ...]:
    """nvcc's flags to compile against nvJPEG and link it (with its
    directory as the library's run path). Raises naming ``nvjpeg.h`` and
    ``libnvjpeg.so`` where no root of ``_cuda_roots`` holds both."""
    searched = []
    for root in _cuda_roots():
        for inc, lib in (("include", "lib64"), ("include", "lib"),
                         ("targets/x86_64-linux/include", "targets/x86_64-linux/lib")):
            header, libdir = root / inc / "nvjpeg.h", root / lib
            searched.append(str(root))
            libs = sorted(libdir.glob("libnvjpeg.so*")) if header.is_file() else []
            if libs:
                name = "nvjpeg" if (libdir / "libnvjpeg.so").exists() else f":{libs[0].name}"
                return ("-I", str(header.parent), "-L", str(libdir), f"-l{name}",
                        "-Xlinker", f"-rpath={libdir}")
    raise RuntimeError("nvJPEG not found: no nvjpeg.h with libnvjpeg.so under "
                       f"{sorted(set(searched))}; the port decodes JPEGs on the card with it")


# sources that link a library beyond the CUDA runtime: name -> its flags
LINK_FLAGS = {"jpeg_decode": nvjpeg_flags}


def flags(name: str) -> Tuple[str, ...]:
    extra = LINK_FLAGS.get(name)
    return NVCC_FLAGS + (extra() if extra else ())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one nvcc process
    for each, all started together. Returns name -> shared library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = []
    for name, so in out.items():
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
