"""Stored JAX sides of the port's CPU tests.

Several port tests hold the port to a TINY JAX model's outputs. Jitting
that model takes a JAX compile of tens of seconds a test file when the
suite's workers share the cores, so the outputs are made once by the JAX
package and kept in ``tests/data/torch_stored_<name>.npz``: the outputs,
a sha256 of each group of inputs they were made from (the parameters,
the image, the token ids, ...), the JAX model's parameter shapes (its
``eval_shape`` takes seconds; the parameters are drawn on them) and the
jax, jaxlib, flax and optax versions. ``load`` checks the inputs and the
versions against the inputs the test makes and the packages installed
here, and each test file that reads such a file keeps one live JAX check
of it, which applies the JAX model to the parameters drawn on the stored
shapes. Rewrite the files after changing a test's inputs or upgrading the
JAX packages:

    JAX_PLATFORMS=cpu python -m tests.torch_stored [name ...]

(each name is a key of ``WRITERS``; all of them by default, some seconds
each).
"""

import hashlib
import importlib
import sys
from pathlib import Path

import numpy as np

DATA = Path(__file__).with_name("data")
# name -> the test module whose ``jax_shapes()`` gives the JAX model's
# parameter shapes, ``stored_inputs(shapes)`` the inputs and
# ``jax_outputs(inputs)`` the outputs made from them
WRITERS = {
    "model": "tests.test_torch_model",
    "caption": "tests.test_torch_caption",
    "eval": "tests.test_torch_eval",
    "demo": "tests.test_torch_demo",
}


def path(name: str) -> Path:
    return DATA / f"torch_stored_{name}.npz"


def _leaves(x, prefix=""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{prefix}/{k}")
    else:
        yield prefix, np.ascontiguousarray(np.asarray(x))


def digest(x) -> str:
    """sha256 of an array or a nested dict of arrays: names, dtypes,
    shapes and bytes."""
    h = hashlib.sha256()
    for name, a in _leaves(x):
        h.update(f"{name} {a.dtype} {a.shape} ".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def versions() -> str:
    import flax
    import jax
    import jaxlib
    import optax

    return (f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
            f"flax {flax.__version__}, optax {optax.__version__}")


def shapes(name: str) -> dict:
    """The JAX model's parameter shapes stored under ``name``, as the
    ``jax.ShapeDtypeStruct`` tree its ``eval_shape`` gave."""
    import jax

    with np.load(path(name)) as f:
        paths, dims, dtypes = (f[k] for k in ("shape/paths", "shape/dims", "shape/dtypes"))
    tree: dict = {}
    for p, d, t in zip(paths.astype(str), dims, dtypes.astype(str)):
        node, keys = tree, p.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jax.ShapeDtypeStruct(tuple(int(x) for x in d if x >= 0), np.dtype(t))
    return tree


def load(name: str, inputs: dict) -> dict:
    """The outputs stored under ``name`` (key -> array), after checking
    that they were made from ``inputs`` (group -> array or nested dict of
    arrays) by the JAX packages installed here."""
    with np.load(path(name)) as f:
        stored = {k: f[k] for k in f.files}
    rerun = f"rerun JAX_PLATFORMS=cpu python -m tests.torch_stored {name}"
    if str(stored["meta/versions"]) != versions():
        raise AssertionError(f"{path(name).name} was made with {stored['meta/versions']}, "
                             f"here {versions()}; {rerun}")
    made = {k[len("sha256/"):]: str(v) for k, v in stored.items() if k.startswith("sha256/")}
    want = {k: digest(v) for k, v in inputs.items()}
    if made != want:
        bad = sorted(k for k in set(made) | set(want) if made.get(k) != want.get(k))
        raise AssertionError(f"{path(name).name} was made from other inputs: {bad}; {rerun}")
    return {k[len("out/"):]: v for k, v in stored.items() if k.startswith("out/")}


def write(name: str) -> None:
    import jax

    module = importlib.import_module(WRITERS[name])
    tree = module.jax_shapes()
    inputs = module.stored_inputs(tree)
    outputs = module.jax_outputs(inputs)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {"meta/versions": np.asarray(versions()),
           "shape/paths": np.array(["/".join(str(k.key) for k in p) for p, _ in leaves]),
           "shape/dims": np.array([list(a.shape) + [-1] * (6 - len(a.shape))
                                   for _, a in leaves]),
           "shape/dtypes": np.array([str(a.dtype) for _, a in leaves])}
    out.update({f"sha256/{k}": np.asarray(digest(v)) for k, v in inputs.items()})
    out.update({f"out/{k}": np.asarray(v) for k, v in outputs.items()})
    np.savez_compressed(path(name), **out)
    print(f"wrote {path(name)} ({path(name).stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    for n in sys.argv[1:] or sorted(WRITERS):
        write(n)
