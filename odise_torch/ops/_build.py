"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` or ``csrc/<name>.cpp`` exposes a plain C interface.
A ``.cu`` is compiled by nvcc for ``sm_90a``, a ``.cpp`` (host code) by the
host's C++ compiler (``$CXX``, else ``g++``, else ``c++``), into
``odise_torch/_build/lib<name>_<hash>.so`` at first use; the hash covers the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. A build that fails raises with the compiler's output.
``jpeg_decode.cu`` also links nvJPEG, found in the CUDA toolkit or in the
``nvidia`` wheels beside torch (``nvjpeg_flags``). nvcc's output, with
ptxas's registers and spills for each kernel, is kept beside the library
(``build_log``). Nothing is built when this module is imported.
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
# host code runs on whichever machine loads it: no -march=native
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

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


def source(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def flags(name: str) -> Tuple[str, ...]:
    if source(name).suffix == ".cpp":
        return HOST_FLAGS
    extra = LINK_FLAGS.get(name)
    return NVCC_FLAGS + (extra() if extra else ())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _host_compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler ($CXX, g++ or c++) found: the port's host ops "
                       "(csrc/*.cpp) are built with one")


def _compiler(name: str) -> str:
    return _host_compiler() if source(name).suffix == ".cpp" else _nvcc()


def library_path(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one compiler
    process for each, all started together. Returns name -> shared library
    path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = []
    for name, so in out.items():
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_compiler(name), *flags(name), "-o", tmp, str(source(name))]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{Path(proc.args[0]).name} failed for {source(name).name}:\n{log}")
        else:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` or ``.cpp``; cached per
    process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
