"""Intra-op threads for the port's CPU tests.

The suite runs its files in parallel worker processes (``-n 6 --dist
loadfile``) on a machine of a few cores. torch starts a parallel region over
every core for each op, and with the other workers holding the cores each
region waits on its slowest thread: a TINY op then takes ten to thirty
times as long as it does alone (``test_torch_diffusion.py::
test_latent_diffusion_loads_the_jax_tree``: 6.0 s alone, 137.1 s among the
port's files on six workers of an 8-core CPU). A test file takes a fixture
by importing it::

    from .torch_threads import one_thread  # noqa: F401

``test_torch_train.py`` takes ``train_threads``: its whole-step gradients
are float32 sums whose order follows the thread count, and its tolerances
hold at ``TRAIN_THREADS`` (and at 8) but not at 1 to 3.
"""

import pytest
import torch

TRAIN_THREADS = 4


def _threads(name: str, n: int):
    @pytest.fixture(autouse=True, scope="module", name=name)
    def fixture():
        """``n`` intra-op threads while this module's tests run."""
        before = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(before)

    return fixture


one_thread = _threads("one_thread", 1)
train_threads = _threads("train_threads", TRAIN_THREADS)
