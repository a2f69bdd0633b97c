"""What a run imports: nothing under ``perfbench/`` names ``jax``,
``jaxlib``, ``flax`` or ``odise_tpu`` as a top-level module, and nothing
under ``perfbench/reference`` names ``odise_torch``. Top-level names are
compared whole (the part before the first dot): ``odise_torch`` begins
with ``odise_t`` but is not ``odise_tpu``."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "odise_tpu"}


def sources(folder):
    """The benchmark's Python files; not its caches or an unpacked checkout
    (directories whose names start with "." or "_")."""
    for dirpath, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if not d.startswith((".", "_"))]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources(os.path.join(HERE, "reference"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "odise_torch" not in set(top_level_imports(path))


def test_loaded_modules_of_the_reference_and_the_harness():
    """Import the reference, the arithmetic and every driver and metric in
    a fresh process: no forbidden top-level module is loaded, and the
    reference alone loads nothing of the program."""
    code = (
        "import sys\n"
        "import perfbench.reference.build, perfbench.reference.evaluate, "
        "perfbench.reference.train, perfbench.arith.flops\n"
        "ref = {m.split('.')[0] for m in sys.modules}\n"
        "from perfbench.common import manifest\n"
        "for w in manifest.manifest()['workloads']:\n"
        "    manifest.driver(manifest.traffic(w['traffic'])['driver'])\n"
        "for e in manifest.manifest()['per_layer']:\n"
        "    manifest.metric(e['name'])\n"
        "import odise_torch.model_zoo.factory, odise_torch.engine, odise_torch.data.loader\n"
        "allm = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(ref & {'odise_torch'}), sorted(allm & %r))\n" % FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"
