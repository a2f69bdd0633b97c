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
    backward_plan, launch_plan, ms_deform_attn, ms_deform_attn_torch)

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


@pytest.mark.parametrize("case", [
    # (B, Lq, heads, head_dim, dtype) -> (chunk elements, chunks a head,
    # lanes a head); None: refused
    ((2, 21504, 8, 32, torch.bfloat16), (8, 4, 4)),  # FULL main path
    ((2, 64, 8, 8, torch.float32), (4, 2, 2)),       # TINY
    ((1, 10, 2, 6, torch.float32), (1, 6, 8)),       # 24 B heads, padded
    ((1, 10, 2, 40, torch.bfloat16), (8, 5, 8)),     # 80 B heads, padded
    ((1, 10, 2, 33, torch.float32), None),           # 33 one-element chunks
    ((1, 10, 2, 264, torch.bfloat16), None),         # 33 chunks of 16 B
], ids=["full_bf16", "tiny_f32", "hd6_f32", "hd40_bf16", "hd33_f32", "hd264_bf16"])
def test_backward_plan(case):
    """The backward's threads: the forward's chunks, a head's padded to a
    power of two lanes of one warp; more than 32 chunks are refused."""
    (B, Lq, H, hd, dtype), want = case
    if want is None:
        with pytest.raises(ValueError, match="at most 32 chunks"):
            backward_plan(B, Lq, H, hd, dtype)
        return
    plan = backward_plan(B, Lq, H, hd, dtype)
    assert (plan.chunk_elems, plan.threads_per_head, plan.lanes_per_head) == want
    assert plan.chunk_elems == launch_plan(B, Lq, H, hd, dtype, 3, 4).chunk_elems
    assert plan.threads == B * Lq * H * plan.lanes_per_head
    bt = plan.block_threads
    assert bt % 32 == 0 and plan.blocks * bt >= plan.threads > (plan.blocks - 1) * bt


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
