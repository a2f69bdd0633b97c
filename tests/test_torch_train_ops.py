"""The port's training ops against the JAX package on the same numpy inputs
(CPU, float32): the deformable-attention gradients, bilinear point
sampling and the batched auction.

On the CPU the port's deformable attention is autograd through its plain
version; the CUDA backward kernel is held against that plain version by
``tests/test_torch_cuda.py`` (skipped without a card) and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_tpu.losses.matcher import assign_from_cost as j_assign  # noqa: E402
from odise_tpu.ops import lap as jlap  # noqa: E402
from odise_tpu.ops.grid_sample import (  # noqa: E402
    grid_sample as j_grid_sample, point_sample as j_point_sample,
    point_sample_packed_binary as j_packed_binary)
from odise_tpu.ops.ms_deform_attn import _hybrid_impl, _reference_impl  # noqa: E402
from odise_torch.ops import grid_sample, lap  # noqa: E402
from odise_torch.ops.ms_deform_attn import (  # noqa: E402
    ms_deform_attn, ms_deform_attn_backward)

from .test_torch_ops import SHAPES, _deform_inputs  # noqa: E402
from .torch_threads import one_thread  # noqa: F401,E402

_JAX_IMPLS = {
    "reference": lambda v, l, a: _reference_impl(v, SHAPES, l, a),
    # the 40x40 level through the quad gather, the small ones as one-hot matmuls
    "hybrid": lambda v, l, a: _hybrid_impl(v, SHAPES, l, a, matmul_max_rows=1024),
}


@pytest.fixture(scope="module")
def jax_vjps():
    """One jitted VJP per JAX implementation, shared by the cases (the
    inputs' shapes do not change), with the package's deform-attn
    environment variables cleared while they compile and run."""
    mp = pytest.MonkeyPatch()
    for name in ("ODISE_TPU_DEFORM_IMPL", "ODISE_TPU_DEFORM_MATMUL_ROWS",
                 "ODISE_TPU_DEFORM_SPLIT_GATHER"):
        mp.delenv(name, raising=False)
    yield {k: jax.jit(lambda v, l, a, g, f=f: jax.vjp(f, v, l, a)[1](g))
           for k, f in _JAX_IMPLS.items()}
    mp.undo()


def _far_inputs(far, seed):
    """A third of the queries on pixel centres, the rest anywhere in
    [-0.2, 1.2], and the middle level's samples all at +-far."""
    value, loc, att = _deform_inputs(seed=seed, B=2)
    if far:
        signs = np.random.RandomState(seed + 1).choice([-1.0, 1.0], size=loc[:, :, :, 1].shape)
        loc[:, :, :, 1] = (far * signs).astype(np.float32)
    return value, loc, att


@pytest.mark.parametrize("far", [0.0, 2.0, 1e6], ids=["near", "far2", "far1e6"])
@pytest.mark.parametrize("impl", sorted(_JAX_IMPLS))
def test_deform_attn_gradients_match_jax(impl, far, jax_vjps):
    """Gradients for value, sampling locations and weights: the port's
    autograd through its plain version (grid_sample's backward) against
    ``jax.vjp`` of the JAX implementation. 1e-5 relative to each gradient's
    largest entry: float32 sums of 12 samples in another order. Samples
    out of their level give exactly 0 location and weight gradients.

    The location gradient jumps where a pixel coordinate crosses a whole
    pixel, and on pixel centres (the first third of the queries) float32
    decides the side. The reference computes the coordinate as
    grid_sample does and lands on the same side; the hybrid computes
    ``loc * w - 0.5`` and may not, so there its location gradient is held
    on the other queries only."""
    value, loc, att = _far_inputs(far, seed=3)
    g = np.random.RandomState(9).randn(2, loc.shape[1], 2 * 8).astype(np.float32)
    want = [np.asarray(x) for x in jax_vjps[impl](
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(att), jnp.asarray(g))]
    if impl == "hybrid":
        want[1] = want[1][:, loc.shape[1] // 3:]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (value, loc, att)]
    before = ms_deform_attn_backward.launches
    out = ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2])
    out.backward(torch.from_numpy(g))
    assert ms_deform_attn_backward.launches == before  # a CPU call launches nothing
    for name, leaf, w in zip(("value", "locations", "weights"), leaves, want):
        got = leaf.grad.numpy()[:, -w.shape[1]:]
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
    if far:
        assert not leaves[1].grad[:, :, :, 1].any() and not leaves[2].grad[:, :, :, 1].any()
    # the function the card's kernel is held against gives the same
    plain = ms_deform_attn_backward(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                                    torch.from_numpy(att), torch.from_numpy(g))
    for leaf, p in zip(leaves, plain):
        assert torch.equal(leaf.grad, p)


def _sample_inputs(seed, B=2, H=7, W=9, C=3, N=40):
    rng = np.random.RandomState(seed)
    im = rng.randn(B, H, W, C).astype(np.float32)
    pts = (rng.rand(B, N, 2) * 1.3 - 0.15).astype(np.float32)
    # pixel centres and the map's edges
    pts[:, :5, 0] = (rng.randint(0, W, (B, 5)) + 0.5) / W
    pts[:, :5, 1] = (rng.randint(0, H, (B, 5)) + 0.5) / H
    pts[:, 5:7] = [[0.0, 0.0], [1.0, 1.0]]
    return im, pts


def test_point_sample_and_gradients_match_jax():
    """``point_sample`` (NHWC, xy in [0, 1]) and ``grid_sample`` against
    JAX's, values and the gradients for the map and the points, 1e-5 of each
    one's largest entry (float32 bilinear sums in another order)."""
    im, pts = _sample_inputs(0)
    g = np.random.RandomState(1).randn(*pts.shape[:2], im.shape[-1]).astype(np.float32)
    out_j, want = jax.jit(lambda a, b, c: (j_point_sample(a, b), jax.vjp(
        j_point_sample, a, b)[1](c)))(jnp.asarray(im), jnp.asarray(pts), jnp.asarray(g))
    want = [np.asarray(x) for x in want]
    t_im, t_pts = (torch.from_numpy(x).requires_grad_() for x in (im, pts))
    out = grid_sample.point_sample(t_im, t_pts)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=1e-5)
    for got, w in zip((t_im.grad, t_pts.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))
    grid = 2.0 * pts - 1.0
    np.testing.assert_allclose(
        grid_sample.grid_sample(torch.from_numpy(im), torch.from_numpy(grid)).numpy(),
        np.asarray(jax.jit(j_grid_sample)(jnp.asarray(im), jnp.asarray(grid))), rtol=0, atol=1e-5)


def test_binary_sampling_equals_jax_packed():
    """Dense sampling of binary masks equals JAX's bit-plane packed sampling
    (40 masks: two words of bit-planes) bit for bit, as the JAX package
    keeps its packed sampling bit-exact with the dense one: the same four
    products, summed in the same order (JAX run op by op; under jit XLA may
    contract them differently)."""
    n_masks = 40
    rng = np.random.RandomState(n_masks)
    masks = rng.rand(n_masks, 11, 13) > 0.5
    pts = (rng.rand(n_masks, 30, 2) * 1.2 - 0.1).astype(np.float32)
    pts[:, :4, 0] = (rng.randint(0, 13, (n_masks, 4)) + 0.5) / 13
    pts[:, :4, 1] = (rng.randint(0, 11, (n_masks, 4)) + 0.5) / 11
    want = np.asarray(j_packed_binary(jnp.asarray(masks, jnp.float32), jnp.asarray(pts)))
    got = grid_sample.point_sample_binary(torch.from_numpy(masks), torch.from_numpy(pts))
    assert np.array_equal(got.numpy(), want)
    got_float = grid_sample.point_sample_binary(torch.from_numpy(masks.astype(np.float32)),
                                                torch.from_numpy(pts))
    assert torch.equal(got, got_float)


# one compile per shape for every case
_J_LSA = jax.jit(jax.vmap(jlap.linear_sum_assignment))
_J_ASSIGN = jax.jit(j_assign)


def _costs(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.rand(5, 12, 12).astype(np.float32) * 10
    if kind == "rectangular":  # fewer targets than queries: padding columns
        return rng.randn(5, 12, 4).astype(np.float32)
    # ties: costs on a coarse grid, and a repeated row and column
    c = rng.randint(0, 3, (5, 12, 12)).astype(np.float32)
    c[:, 3] = c[:, 7]
    c[:, :, 2] = c[:, :, 5]
    return c


@pytest.mark.parametrize("kind", ["random", "rectangular", "tied"])
def test_auction_matches_jax_and_is_optimal(kind):
    """The batched auction assigns as JAX's vmapped auction does (the same
    column for every row: ties broken by the lowest index, the same
    rounds), and reaches the optimum scipy's linear_sum_assignment finds,
    within the auction's bound of N * eps."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    cost = _costs(kind, seed={"random": 0, "rectangular": 1, "tied": 2}[kind])
    want = np.asarray(_J_LSA(jnp.asarray(cost)))
    got = lap.linear_sum_assignment(torch.from_numpy(cost)).numpy()
    assert np.array_equal(got, want)
    B, N, M = cost.shape
    for b in range(B):
        rows, cols = scipy_lsa(cost[b])
        best = float(cost[b][rows, cols].sum())
        mine = got[b] < M
        total = float(cost[b][np.arange(N)[mine], got[b][mine]].sum())
        eps = max(float(cost[b].max() - cost[b].min()) + (N > M), 1e-6) * 1e-4 / N
        assert abs(total - best) <= N * eps + 1e-5
        assert sorted(got[b].tolist()) == list(range(N))
    matched = lap.assign_from_cost(torch.from_numpy(cost)).numpy()
    assert np.array_equal(matched, np.asarray(_J_ASSIGN(jnp.asarray(cost))))


def test_auction_iteration_cap_fills_like_jax():
    """At a tiny iteration cap some rows are still unassigned: both give them
    the unclaimed columns in the same order."""
    benefit = np.random.RandomState(4).rand(3, 12, 12).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda b: jlap.auction_lap(b, max_iters=2)))(
        jnp.asarray(benefit)))
    got = lap.auction_lap(torch.from_numpy(benefit), max_iters=2, check_every=1).numpy()
    assert np.array_equal(got, want)
    assert all(sorted(r) == list(range(12)) for r in got.tolist())
