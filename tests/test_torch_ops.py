"""The port's deformable-attention op, resize and helpers against the JAX
package, on the same numpy inputs (CPU, float32).

On the CPU the port's ``ms_deform_attn`` runs its plain version; the CUDA
kernel is held against that plain version by ``tests/test_torch_cuda.py``
(skipped without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_tpu.models import helper as jhelper  # noqa: E402
from odise_tpu.ops.ms_deform_attn import _hybrid_impl, _reference_impl  # noqa: E402
from odise_tpu.ops.pallas.ms_deform_attn_kernel import _pallas_forward  # noqa: E402
from odise_torch.models import helper  # noqa: E402
from odise_torch.models.resize import resize  # noqa: E402
from odise_torch.ops.ms_deform_attn import (  # noqa: E402
    _with_window, backward_counts, backward_plan, backward_smem_bytes, count_backward,
    launch_plan, ms_deform_attn, ms_deform_attn_torch)

# one level above the JAX package's 1024-row matmul cutoff, two below
SHAPES = [(40, 40), (6, 8), (3, 4)]


def _deform_inputs(seed=0, B=1, H=2, hd=8, P=4, Lq=40):
    rng = np.random.RandomState(seed)
    L = len(SHAPES)
    Lv = sum(h * w for h, w in SHAPES)
    value = rng.randn(B, Lv, H, hd).astype(np.float32)
    loc = (rng.rand(B, Lq, H, L, P, 2) * 1.4 - 0.2).astype(np.float32)
    # a third of the queries sample exactly on pixel centres (integer
    # x = loc*w - 0.5), including the first and last pixel of each level
    for lvl, (h, w) in enumerate(SHAPES):
        ix = rng.randint(0, w, size=(B, Lq // 3, H, P))
        iy = rng.randint(0, h, size=(B, Lq // 3, H, P))
        ix[..., 0], iy[..., 0] = 0, h - 1
        ix[..., 1], iy[..., 1] = w - 1, 0
        loc[:, : Lq // 3, :, lvl, :, 0] = (ix + 0.5) / w
        loc[:, : Lq // 3, :, lvl, :, 1] = (iy + 0.5) / h
    logits = rng.randn(B, Lq, H, L * P).astype(np.float32)
    att = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, att.reshape(B, Lq, H, L, P).astype(np.float32)


_JAX_IMPLS = {
    "reference": lambda v, l, a: _reference_impl(v, SHAPES, l, a),
    "hybrid_all_gather": lambda v, l, a: _hybrid_impl(v, SHAPES, l, a, matmul_max_rows=0),
    "hybrid_mixed": lambda v, l, a: _hybrid_impl(v, SHAPES, l, a, matmul_max_rows=1024),
    "pallas_all_kernel": lambda v, l, a: _pallas_forward(
        v, tuple(SHAPES), l, a, matmul_max_rows=0, q_tile=32),
    "pallas_mixed": lambda v, l, a: _pallas_forward(
        v, tuple(SHAPES), l, a, matmul_max_rows=50, q_tile=32),
}


@pytest.mark.parametrize("impl", sorted(_JAX_IMPLS))
def test_ms_deform_attn_plain_matches_jax(impl):
    """Plain version vs each JAX implementation (the Pallas kernel in
    interpret mode). Tolerance 1e-5 absolute: float32 sums of 12 samples of
    unit-scale values, summed in another order."""
    value, loc, att = _deform_inputs()
    ref = np.asarray(_JAX_IMPLS[impl](jnp.asarray(value), jnp.asarray(loc),
                                      jnp.asarray(att)))
    before = ms_deform_attn.launches
    out = ms_deform_attn(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                         torch.from_numpy(att))
    assert ms_deform_attn.launches == before  # a CPU call launches nothing
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    plain = ms_deform_attn_torch(torch.from_numpy(value), SHAPES,
                                 torch.from_numpy(loc), torch.from_numpy(att))
    assert torch.equal(out, plain)


@pytest.mark.parametrize("far", [2.0, 1e6])
def test_ms_deform_attn_plain_far_out_level_matches_jax(far):
    """One level's samples all at +-far (outside the level): the plain
    version agrees with JAX ``_reference_impl`` to 1e-5 and equals, exactly,
    its own run with that level's weights zeroed. The kernel's clamping of
    such samples has to keep this."""
    value, loc, att = _deform_inputs(seed=4)
    signs = np.random.RandomState(5).choice([-1.0, 1.0], size=loc[:, :, :, 0].shape)
    loc[:, :, :, 0] = (far * signs).astype(np.float32)
    ref = np.asarray(_reference_impl(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                     jnp.asarray(att)))
    out = ms_deform_attn_torch(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(loc), torch.from_numpy(att))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    att[:, :, :, 0] = 0
    zeroed = ms_deform_attn_torch(torch.from_numpy(value), SHAPES,
                                  torch.from_numpy(loc), torch.from_numpy(att))
    assert torch.equal(out, zeroed)


@pytest.mark.parametrize("case", [
    # (B, Lq, heads, head_dim, dtype, levels, points) -> (chunk elements,
    # chunk bytes, threads per head, specialised, launched warps)
    ((1, 21504, 8, 32, torch.bfloat16, 3, 4), (8, 16, 4, True, 21504)),  # FULL main path
    ((1, 21504, 8, 6, torch.bfloat16, 3, 4), (1, 2, 6, True, 32256)),    # 12 B heads
    ((2, 50, 3, 40, torch.float32, 3, 3), (4, 16, 10, False, 96)),
    ((1, 10, 2, 6, torch.float32, 2, 4), (1, 4, 6, False, 4)),           # 24 B heads
    ((1, 0, 8, 32, torch.bfloat16, 3, 4), (8, 16, 4, True, 0)),          # no queries
], ids=["full_bf16", "hd6_bf16", "hd40_f32", "hd6_f32", "empty"])
def test_launch_plan(case):
    (B, Lq, H, hd, dtype, L, P), (elems, nbytes, per_head, specialised, warps) = case
    plan = launch_plan(B, Lq, H, hd, dtype, L, P)
    assert (plan.chunk_elems, plan.chunk_bytes, plan.threads_per_head,
            plan.specialised, plan.warps) == (elems, nbytes, per_head, specialised, warps)
    assert plan.threads == B * Lq * H * per_head
    bt = plan.block_threads
    assert bt % 32 == 0 and plan.blocks * bt >= plan.threads > (plan.blocks - 1) * bt


_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("case", [
    # (B, Lq, heads, head_dim, dtype, points, window rows or None) ->
    # (chunk elements, chunks a head, lanes a head, block threads, queries a
    # block, window rows, shared-memory bytes, blocks); a string: the
    # ValueError's message
    ((2, 21504, 8, 32, _BF16, 4, None), (8, 4, 4, 256, 256, 6880, 76800, 1344)),   # FULL
    ((2, 64, 8, 8, _F32, 4, None), (4, 2, 2, 256, 256, 8928, 76800, 16)),           # TINY
    ((1, 10, 2, 6, _F32, 4, None), (1, 6, 8, 256, 256, 9440, 76800, 2)),            # padded
    ((1, 10, 2, 40, _BF16, 4, None), (8, 5, 8, 256, 256, 5856, 76800, 2)),          # padded
    ((2, 21504, 8, 32, _BF16, 16, None), (8, 4, 4, 256, 128, 736, 76800, 2688)),    # 16 points
    ((2, 21504, 8, 32, _BF16, 4, 860), (8, 4, 4, 256, 256, 860, 52720, 1344)),      # window set
    ((2, 600, 8, 8, _F32, 4, 5), (4, 2, 2, 256, 256, 5, 41112, 48)),   # 3 runs, tiny window
    ((1, 10, 2, 33, _F32, 4, None), "at most 32 chunks"),      # 33 one-element chunks
    ((1, 10, 2, 264, _BF16, 4, None), "at most 32 chunks"),    # 33 chunks of 16 B
    ((2, 21504, 8, 32, _BF16, 4, 50_000), (8, 4, 4, 256, 256, 50_000, 249_280, 1344)),
    ((1, 10, 2, 8, _F32, 1000, None), "shared memory"),        # lists of 16 queries: 500 KB
    ((1, 10, 2, 4, _F32, 1000, None), "list entries"),         # 32 queries: 128,000 entries
    ((1, 10, 2, 12, _F32, 4, None), (4, 3, 4, 256, 256, 7904, 76800, 2)),   # 3 chunks
    ((1, 10, 2, 24, _BF16, 4, None), (8, 3, 4, 256, 256, 7904, 76800, 2)),  # 3 chunks
    ((1, 10, 2, 3, _F32, 4, None), (1, 3, 4, 256, 256, 10208, 76800, 2)),   # 3 chunks of 1
], ids=["full_bf16", "tiny_f32", "hd6_f32", "hd40_bf16", "16_points", "other_plan",
        "small_window", "hd33_f32", "hd264_bf16", "over_the_shared_budget",
        "lists_over_the_budget", "over_the_entries", "hd12_f32", "hd24_bf16", "hd3_f32"])
def test_backward_plan(case):
    """The backward's blocks: one (batch, head) and a run of queries each,
    a thread per chunk of the head as in the forward (padded to a power of
    two lanes of one warp), and lists for a window in shared memory that
    leave an SM room for 3 blocks; plans whose lists do not fit are
    refused. A window set by hand (as the tests cut windows) gets its shared
    memory recomputed, and one over 227 KB is the C entry point's to
    refuse."""
    (B, Lq, H, hd, dtype, P, rows), want = case
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            backward_plan(B, Lq, H, hd, dtype, P)
        return
    plan = backward_plan(B, Lq, H, hd, dtype, P)
    assert plan.smem_bytes <= 76_800  # a third of an SM's 228 KB, less 1 KB a block
    if rows is not None:
        plan = _with_window(plan, rows, hd, dtype)
    assert (plan.chunk_elems, plan.threads_per_head, plan.lanes_per_head, plan.block_threads,
            plan.queries_per_block, plan.window_rows, plan.smem_bytes, plan.blocks) == want
    assert plan.chunk_elems == launch_plan(B, Lq, H, hd, dtype, 3, 4).chunk_elems
    assert plan.n_points == P
    assert plan.smem_bytes == backward_smem_bytes(plan.window_rows, plan.queries_per_block,
                                                  P, hd, dtype)
    assert 4 * plan.queries_per_block * P <= 65_535
    assert plan.blocks == B * H * -(-Lq // plan.queries_per_block)
    bt = plan.block_threads
    assert bt % 32 == 0 and plan.queries_per_block % (bt // plan.lanes_per_head) == 0


def _counts_by_hand(loc, shapes, plan):
    """``backward_counts`` block by block and sample by sample, in numpy
    float32: each block's inside corners, their box, the window cut from it
    and the corners and rows inside that window."""
    B, Lq, H, _, P, _ = loc.shape
    Q, C = plan.queries_per_block, plan.window_rows
    corners, shared, rows = [0] * len(shapes), [0] * len(shapes), [0] * len(shapes)
    for b in range(B):
        for q0 in range(0, Lq, Q):
            for h in range(H):
                for lvl, (hl, wl) in enumerate(shapes):
                    cs = []
                    for q in range(q0, min(q0 + Q, Lq)):
                        for p in range(P):
                            x = np.floor(loc[b, q, h, lvl, p, 0] * np.float32(wl) - np.float32(0.5))
                            y = np.floor(loc[b, q, h, lvl, p, 1] * np.float32(hl) - np.float32(0.5))
                            if not (-1 <= x <= wl - 1 and -1 <= y <= hl - 1):
                                continue
                            cs += [(int(y) + dy, int(x) + dx) for dy in (0, 1) for dx in (0, 1)
                                   if 0 <= int(y) + dy < hl and 0 <= int(x) + dx < wl]
                    corners[lvl] += len(cs)
                    if not cs:
                        continue
                    y0, x0 = min(c[0] for c in cs), min(c[1] for c in cs)
                    bh, bw = max(c[0] for c in cs) - y0 + 1, max(c[1] for c in cs) - x0 + 1
                    ww = min(bw, C)
                    wh = min(bh, C // ww)
                    inside = [c for c in cs if 0 <= c[0] - y0 < wh and 0 <= c[1] - x0 < ww]
                    shared[lvl] += len(inside)
                    rows[lvl] += len(set(inside))
    return corners, shared, rows


# level shapes for the counts: a square, a wide and a tall level
COUNT_SHAPES = [(8, 8), (4, 12), (10, 3)]


def _count_locations(kind, B=2, Lq=600, H=2, P=4, seed=0):
    rng = np.random.RandomState(seed)
    L = len(COUNT_SHAPES)
    wh = np.array([[w, h] for h, w in COUNT_SHAPES], np.float32)[None, None, None, :, None, :]
    if kind == "random":
        return (rng.rand(B, Lq, H, L, P, 2) * 1.4 - 0.2).astype(np.float32)
    if kind == "edges":  # pixel centres, level borders (0 and 1) and pixel borders
        idx = rng.randint(-1, 13, size=(B, Lq, H, L, P, 2)).astype(np.float32)
        half = rng.choice([0.0, 0.5], size=idx.shape).astype(np.float32)
        return np.clip((idx + half) / wh, 0.0, 1.0).astype(np.float32)
    if kind == "far_out":
        return rng.choice([1e6, -1e6, 3e9, np.inf, -np.inf, np.nan],
                          size=(B, Lq, H, L, P, 2)).astype(np.float32)
    # a fresh encoder layer: reference points (every pixel centre) plus rings
    # of 1 to P pixels, head h in direction 2 pi h / H
    ref = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h),
                                   -1).reshape(-1, 2) for h, w in COUNT_SHAPES])
    t = np.arange(H) * 2 * np.pi / H
    ring = np.stack([np.cos(t), np.sin(t)], -1)
    ring = ring / np.abs(ring).max(-1, keepdims=True)
    ring = ring[:, None, None, :] * np.arange(1, P + 1)[None, None, :, None]
    loc = ref[None, :, None, None, None, :] + ring[None, None] / wh
    return np.broadcast_to(loc, (B, ref.shape[0], H, L, P, 2)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "edges", "far_out", "encoder_start"])
@pytest.mark.parametrize("rows", [5, 30, None], ids=["window_5", "window_30", "default"])
def test_backward_counts(kind, rows):
    """``backward_counts`` (what chip_smoke.py prints of the backward
    kernel's value-gradient reductions) against the same count made block by
    block: every corner inside its level counted exactly once, in shared
    memory or in the global path, and nothing for far-out or NaN samples."""
    loc = _count_locations(kind)
    B, Lq, H = loc.shape[:3]
    plan = backward_plan(B, Lq, H, 8, torch.float32, 4)
    if rows is not None:  # boxes cut
        plan = _with_window(plan, rows, 8, torch.float32)
    got = backward_counts(torch.from_numpy(loc), COUNT_SHAPES, plan)
    corners, shared, rows = _counts_by_hand(loc, COUNT_SHAPES, plan)
    assert (list(got.corners), list(got.in_shared), list(got.flushed_rows)) == (
        corners, shared, rows)
    assert all(0 <= s <= c for s, c in zip(got.in_shared, got.corners))
    per = 8 // 4  # reductions a corner or a row: 4 channels each
    assert got.direct_reductions == sum(corners) * per
    assert got.global_reductions == (sum(corners) - sum(shared) + sum(rows)) * per
    if kind == "far_out":
        assert got.corners == (0, 0, 0) and got.global_reductions == 0
    elif rows is None:
        assert got.in_shared == got.corners  # a level of 120 rows fits whole
    elif rows == 5:
        assert sum(shared) < sum(corners)  # cut windows send corners to the global path


def test_ms_deform_attn_rejects_bad_shapes():
    value, loc, att = _deform_inputs()
    with pytest.raises(ValueError):
        ms_deform_attn(torch.from_numpy(value), SHAPES[:2],
                       torch.from_numpy(loc), torch.from_numpy(att))
    with pytest.raises(ValueError):
        ms_deform_attn(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                       torch.from_numpy(att[:, :-1]))


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("size", [(23, 37), (5, 7)], ids=["up", "down"])
def test_resize_matches_jax_image_resize(method, size):
    """jax.image.resize semantics (antialiased downsampling, Keys cubic,
    half-pixel centres); 1e-5 covers float32 kernel-weight rounding."""
    x = np.random.RandomState(1).randn(2, 3, 11, 17).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + size, method=method))
    out = resize(torch.from_numpy(x), size, method).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["max", "mean"])
def test_ensemble_logits_with_labels(method):
    labels = (("a", "b"), ("c",), ("d", "e", "f"))
    x = np.random.RandomState(2).randn(2, 5, 6).astype(np.float32)
    ref = np.asarray(jhelper.ensemble_logits_with_labels(jnp.asarray(x), labels, method))
    out = helper.ensemble_logits_with_labels(torch.from_numpy(x), labels, method)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_l2_normalize_and_mask_pooling():
    """l2_normalize is rsqrt(sum+eps), finite at zero (1e-6: float32);
    mask_pooling takes NCHW features where JAX takes NHWC."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 8).astype(np.float32)
    x[0, 0] = 0.0
    out = helper.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jhelper.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    assert np.all(out[0, 0] == 0.0)
    feats = rng.randn(2, 9, 10, 6).astype(np.float32)  # NHWC
    masks = rng.randn(2, 5, 9, 10).astype(np.float32)
    ref = np.asarray(jhelper.mask_pooling(jnp.asarray(feats), jnp.asarray(masks)))
    out = helper.mask_pooling(torch.from_numpy(feats).permute(0, 3, 1, 2),
                              torch.from_numpy(masks))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_count_backward_needs_the_card():
    """The kernel's own count is read on the card; CPU tensors are refused
    before anything is built or launched."""
    v = torch.zeros(1, 21, 2, 8)
    loc = torch.rand(1, 5, 2, 2, 4, 2)
    a = torch.full((1, 5, 2, 2, 4), 0.125)
    with pytest.raises(ValueError, match="on the card"):
        count_backward(v, [(4, 4), (1, 5)], loc, a, torch.zeros(1, 5, 16))
