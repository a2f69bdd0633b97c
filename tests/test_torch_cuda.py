"""The deformable-attention CUDA kernels (forward and backward) against
their plain PyTorch versions, the evaluation statistics on the card
against the same on the CPU, nvJPEG's decodes against PIL's, the
collectives of training over several ranks on the card, TINY Stable
Diffusion sampling on the card against the CPU, and FULL float32 eval
and train steps against the JAX package's stored runs. Imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every test skips without a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odise_torch.models.decoder.pixel_decoder import MSDeformAttn  # noqa: E402
from odise_torch.ops.ms_deform_attn import (  # noqa: E402
    _with_window, backward_counts, backward_plan, count_backward, launch, launch_backward,
    launch_plan, ms_deform_attn, ms_deform_attn_backward, ms_deform_attn_backward_torch,
    ms_deform_attn_torch, resident_warps)

SHAPES = [(40, 40), (6, 8), (3, 4)]
MAIN_PATH_SHAPES = [(32, 32), (64, 64), (128, 128)]  # 1024-px image, coarsest first
# the 1024x2560 and 2560x1024 buckets: non-square levels, 53,760 queries
WIDE_SHAPES = [(32, 80), (64, 160), (128, 320)]
TALL_SHAPES = [(80, 32), (160, 64), (320, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False


def _inputs(hd, dtype, seed=0, B=2, H=3, P=4, Lq=50, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    L = len(shapes)
    Lv = sum(h * w for h, w in shapes)
    value = rng.randn(B, Lv, H, hd).astype(np.float32)
    loc = (rng.rand(B, Lq, H, L, P, 2) * 1.6 - 0.3).astype(np.float32)
    for lvl, (h, w) in enumerate(shapes):  # pixel centres on a third
        loc[:, : Lq // 3, :, lvl, :, 0] = (rng.randint(0, w, (B, Lq // 3, H, P)) + 0.5) / w
        loc[:, : Lq // 3, :, lvl, :, 1] = (rng.randint(0, h, (B, Lq // 3, H, P)) + 0.5) / h
    att = rng.rand(B, Lq, H, L, P).astype(np.float32)
    att /= att.sum(axis=(-2, -1), keepdims=True)
    return (torch.from_numpy(value).cuda().to(dtype), torch.from_numpy(loc).cuda(),
            torch.from_numpy(att).cuda().to(dtype))


def _tolerance(ref):
    """float32: 1e-5 (another summation order). bf16: both round their
    float32 sum to bf16 once, so two bf16 ulps of the largest output."""
    if ref.dtype == torch.float32:
        return 1e-5
    return 2 * float(ref.abs().max()) * 2.0 ** -8


def _check(v, l, a, shapes=SHAPES):
    before = ms_deform_attn.launches
    out = ms_deform_attn(v, shapes, l, a)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    B, Lq, H = l.shape[:3]
    assert out.dtype == v.dtype and out.shape == (B, Lq, H * v.shape[-1])
    ref = ms_deform_attn_torch(v, shapes, l, a)
    assert float((out.float() - ref.float()).abs().max()) <= _tolerance(ref)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [6, 8, 32, 40])  # 6: one-element chunks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain(cuda, hd, dtype):
    _check(*_inputs(hd, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_at_main_path_levels(cuda, dtype):
    """Batch 2, the main path's 8 heads of 32 and its three levels, fewer
    queries."""
    _check(*_inputs(32, dtype, B=2, H=8, Lq=512, shapes=MAIN_PATH_SHAPES),
           MAIN_PATH_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [WIDE_SHAPES, TALL_SHAPES], ids=["1024x2560", "2560x1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_at_bucket_levels(cuda, shapes, dtype):
    """Batch 1, 8 heads of 32, every query of the widest and the tallest
    bucket: a level's height and width taken the wrong way round would
    move every sample here, where square levels cannot tell."""
    Lq = sum(h * w for h, w in shapes)
    assert Lq == 53760
    _check(*_inputs(32, dtype, B=1, H=8, Lq=Lq, shapes=shapes), shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("levels,points", [(2, 4), (3, 3)])
@pytest.mark.parametrize("hd", [6, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_other_counts(cuda, levels, points, hd, dtype):
    """Level and point counts other than the main path's 3 and 4 take the
    kernel's generic loop."""
    shapes = SHAPES[:levels]
    _check(*_inputs(hd, dtype, P=points, shapes=shapes), shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [6, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_far_out_level_adds_exactly_zero(cuda, hd, dtype):
    """Samples at +-1e6 and +-3e9 (never converted to int) add exactly +0:
    the output equals, bit for bit, the kernel's output with that level's
    samples inside it and their weights zeroed, and matches the plain
    version with that level's weights zeroed."""
    v, l, a = _inputs(hd, dtype, seed=1)
    far = np.random.RandomState(2).choice([1e6, -1e6, 3e9, -3e9], size=l[:, :, :, 1].shape)
    l_far = l.clone()
    l_far[:, :, :, 1] = torch.from_numpy(far.astype(np.float32)).cuda()
    a_zero = a.clone()
    a_zero[:, :, :, 1] = 0
    out = _check(v, l_far, a)
    assert torch.equal(out, ms_deform_attn(v, SHAPES, l, a_zero))
    ref = ms_deform_attn_torch(v, SHAPES, l_far, a_zero)
    assert float((out.float() - ref.float()).abs().max()) <= _tolerance(ref)


def _misaligned(t):
    """The same values in a view that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    v, l, a = _inputs(32, torch.bfloat16)
    with pytest.raises(TypeError):
        ms_deform_attn(v, SHAPES, l.to(torch.bfloat16), a)  # locations must be f32
    with pytest.raises(TypeError):
        ms_deform_attn(v, SHAPES, l, a.float())  # weights in the value's dtype
    with pytest.raises(ValueError):
        ms_deform_attn(v.transpose(0, 1).contiguous().transpose(0, 1), SHAPES, l, a)
    for i in range(3):  # 16-byte chunks need 16-byte aligned inputs
        args = [v, l, a]
        args[i] = _misaligned(args[i])
        assert args[i].is_contiguous() and args[i].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            ms_deform_attn(args[0], SHAPES, args[1], args[2])


@pytest.mark.cuda
def test_one_element_chunks_take_misaligned_inputs(cuda):
    v, l, a = _inputs(6, torch.bfloat16)
    _check(_misaligned(v), _misaligned(l), _misaligned(a))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [6, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_generic_variant_equals_main_path_variant(cuda, hd, dtype):
    """At the main path's 3 levels of 4 points the generic variant, run by
    hand, gives the same bits as the variant with the counts compiled in."""
    v, l, a = _inputs(hd, dtype, H=8, Lq=300, shapes=MAIN_PATH_SHAPES)
    plan = launch_plan(*l.shape[:3], hd, dtype, *l.shape[3:5])
    assert plan.specialised
    out = _check(v, l, a, MAIN_PATH_SHAPES)
    assert torch.equal(out, launch(v, MAIN_PATH_SHAPES, l, a, plan._replace(specialised=False)))


@pytest.mark.cuda
def test_kernel_refuses_a_plan_it_cannot_run(cuda):
    v, l, a = _inputs(32, torch.bfloat16)  # 3 levels of 4 points
    plan = launch_plan(*l.shape[:3], 32, torch.bfloat16, *l.shape[3:5])
    bad = [plan._replace(blocks=plan.blocks - 1),                      # short of the output
           plan._replace(block_threads=256, blocks=-(-plan.threads // 256)),  # over the bound
           plan._replace(chunk_elems=4)]                                # no such variant
    shapes2 = SHAPES[:2]
    v2, l2, a2 = _inputs(32, torch.bfloat16, shapes=shapes2)  # 2 levels
    before = ms_deform_attn.launches
    for p in bad:
        with pytest.raises(RuntimeError, match="launch failed"):
            launch(v, SHAPES, l, a, p)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch(v2, shapes2, l2, a2, plan)  # the 3-level, 4-point variant
    assert ms_deform_attn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_resident_warps(cuda, dtype):
    """The main-path variant is capped so that an SM holds at least 24 of
    its warps."""
    plan = launch_plan(1, 21504, 8, 32, dtype, 3, 4)
    assert 24 <= resident_warps(dtype, plan) <= 64


@pytest.mark.cuda
def test_device_eval_runner_on_the_card_matches_the_cpu(cuda):
    """One image's statistics from mask logits on the card and the same
    logits on the CPU: integers equal, floats within 1e-5 relative."""
    from odise_torch.evaluation.device_eval import DeviceEvalRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(3)
    q, k, oh, ow = 12, 7, 45, 61
    mask_cls = rng.randn(q, k + 1).astype(np.float32) * 2
    mask_cls[np.arange(q), rng.randint(0, k, q)] += 5.0
    mask_pred = rng.randn(q, 64, 96).astype(np.float32) * 3
    sem_gt = rng.randint(0, k, (oh, ow)).astype(np.int32)
    gt_ids = np.zeros((oh, ow), np.uint32)
    gt_ids[2:20, 3:30] = 7
    gt_ids[22:40, 5:50] = 42
    gts = dict(sem_gt=sem_gt, pan_gt_ids=gt_ids, pan_seg_ids=np.array([7, 42], np.uint32),
               inst_gt_masks=np.stack([gt_ids == 7, gt_ids == 42]))
    stats, confs = [], []
    for dev in ("cuda", "cpu"):
        runner = DeviceEvalRunner(num_classes=k, thing_mask=np.arange(k) < 4,
                                  object_mask_threshold=0.0, overlap_threshold=0.8,
                                  topk=20, grids=((48, 64),))
        stats.append(runner.process(torch.from_numpy(mask_cls).to(dev),
                                    torch.from_numpy(mask_pred).to(dev), (60, 81),
                                    (oh, ow), **gts))
        confs.append(runner.flush_confusion())
    got, want = stats
    assert sorted(got) == sorted(want) and np.array_equal(*confs)
    for key, w in want.items():
        if isinstance(w, int) or w.dtype.kind != "f":
            assert np.array_equal(got[key], w), key
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=0, err_msg=key)


# Power-of-two level sizes: float32 then holds every pixel coordinate
# loc * w - 0.5 exactly, in the kernel as in float64, so the location
# gradient's jumps at whole pixels fall on the same side in both.
BWD_SHAPES = [(32, 32), (8, 16), (4, 4)]


def _check_backward(v, l, a, shapes=BWD_SHAPES, seed=0, plan=None):
    """The backward kernel (under ``plan``, by default ``backward_plan``'s)
    against the plain backward run in float64 on the same inputs: for each
    gradient within the float32 plain backward's own error plus 1e-5 of the
    largest gradient (bf16: plus two bf16 ulps of it). Returns the kernel's
    gradients."""
    B, Lq, H = l.shape[:3]
    g = torch.from_numpy(np.random.RandomState(seed).randn(B, Lq, H * v.shape[-1])
                         .astype(np.float32)).cuda().to(v.dtype)
    before = ms_deform_attn_backward.launches
    if plan is None:
        got = ms_deform_attn_backward(v, shapes, l, a, g)
    else:
        got = launch_backward(v, shapes, l, a, g, plan)
    torch.cuda.synchronize()
    assert ms_deform_attn_backward.launches == before + 1
    plain = ms_deform_attn_backward_torch(v.float(), shapes, l, a.float(), g.float())
    exact = ms_deform_attn_backward_torch(v.double(), shapes, l.double(), a.double(),
                                          g.double())
    rel = 1e-5 if v.dtype == torch.float32 else 2 * 2.0 ** -8
    for x, p, e, like in zip(got, plain, exact, (v, l, a)):
        assert x.dtype == like.dtype and x.shape == like.shape
        tol = float((p.double() - e).abs().max()) + rel * float(e.abs().max())
        assert float((x.double() - e).abs().max()) <= tol
    return got


# head_dims of the backward's cases: 6 and 40 pad a head's chunks to 8
# lanes; 12 (float32) and 24 (bf16) take 3 chunks of 16 B on 4 lanes
BWD_HEAD_DIMS = [6, 12, 24, 32, 40]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [6, 8, 12, 24, 32, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_matches_plain(cuda, hd, dtype):
    _check_backward(*_inputs(hd, dtype, shapes=BWD_SHAPES))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_matches_plain_at_main_path_levels(cuda, dtype):
    """Batch 2, the main path's 8 heads of 32 and its three levels."""
    _check_backward(*_inputs(32, dtype, B=2, H=8, Lq=512, shapes=MAIN_PATH_SHAPES),
                    MAIN_PATH_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("levels,points", [(2, 4), (3, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_matches_plain_other_counts(cuda, levels, points, dtype):
    shapes = BWD_SHAPES[:levels]
    _check_backward(*_inputs(32, dtype, P=points, shapes=shapes), shapes)


def _encoder_locations(shapes, B, H, P, spread, seed=0):
    """Every pixel centre of every level as a query's reference point, plus
    the ring offsets a fresh MSDeformAttn starts from (1 to P pixels, head h
    in direction 2 pi h / H), plus offsets of ``spread`` pixels' standard
    deviation."""
    rng = np.random.RandomState(seed)
    ref = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w,
                                               (np.arange(h) + 0.5) / h), -1).reshape(-1, 2)
                          for h, w in shapes])
    mod = MSDeformAttn(H * 8, len(shapes), H, P)
    ring = mod.sampling_offsets.bias.detach().numpy().reshape(H, len(shapes), P, 2)
    wh = np.array([[w, h] for h, w in shapes], np.float32)[None, None, None, :, None, :]
    offsets = ring[None, None] + spread * rng.randn(B, ref.shape[0], H, len(shapes), P, 2)
    loc = ref[None, :, None, None, None, :] + offsets / wh
    return torch.from_numpy(loc.astype(np.float32)).cuda()


# power-of-two levels whose finest (65,536 rows) is larger than the
# backward kernel's window (6,880 rows in bf16, 2,784 in float32)
SPREAD_SHAPES = [(32, 128), (64, 256), (128, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,spread", [(MAIN_PATH_SHAPES, 0.0), (SPREAD_SHAPES, 64.0)],
                         ids=["encoder_start", "spread"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_windows(cuda, shapes, spread, dtype):
    """Batch 2 over every query of the levels, 8 heads of 32: where a fresh
    encoder samples at the 1024-px levels (nearly every corner summed in its
    block's window), and offsets of 64 pixels at levels whose finest is
    larger than the window (most of its corners miss the window and take
    the global path)."""
    B, H, P = 2, 8, 4
    loc = _encoder_locations(shapes, B, H, P, spread)
    Lq = loc.shape[1]
    v, _, a = _inputs(32, dtype, seed=3, B=B, H=H, P=P, Lq=Lq, shapes=shapes)
    _check_backward(v, loc, a, shapes)
    share = _counts_on_the_card(v, loc, a, shapes).in_shared_share
    if spread:
        assert share[-1] < 0.5
    else:  # the levels of no more rows than the window fit whole
        assert share[:2] == (1.0, 1.0) and share[2] > 0.9


def _edge_inputs(hd, dtype, Lq=300):
    """``_inputs`` over 4 heads, with a tenth of the locations moved onto
    a level's border (0 or 1), where one corner of a pair lies outside the
    level; 300 queries make a whole run of 256 and a short one."""
    v, l, a = _inputs(hd, dtype, seed=4, H=4, Lq=Lq, shapes=BWD_SHAPES)
    edge = torch.from_numpy(np.random.RandomState(5).rand(*l.shape) < 0.1).cuda()
    return v, torch.where(edge, torch.round(l).clamp(0, 1), l).contiguous(), a


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 40])
@pytest.mark.parametrize("hd", BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_window_cut_and_level_edges(cuda, rows, hd, dtype):
    """Windows of 1, 7 and 40 rows cut nearly every block's box, so corners
    fall on both sides of each window's last row and column, and the last
    run of queries is short; a third of the samples lie on pixel centres
    (the first and last pixels of a level among them) and some exactly on a
    level's border."""
    v, l, a = _edge_inputs(hd, dtype)
    B, Lq, H = l.shape[:3]
    plan = _with_window(backward_plan(B, Lq, H, hd, dtype, 4), rows, hd, dtype)
    _check_backward(v, l, a, plan=plan)
    counts = _counts_on_the_card(v, l, a, BWD_SHAPES, plan)
    assert 0 < sum(counts.in_shared) < sum(counts.corners)


def _counts_on_the_card(v, l, a, shapes, plan=None):
    """What the backward kernel did with the value gradient (its counting
    instantiation, ``count_backward``), held to ``backward_counts``, the
    host's count from the locations and the plan alone; no launch is
    counted."""
    B, Lq, H, _, P, _ = l.shape
    if plan is None:
        plan = backward_plan(B, Lq, H, v.shape[-1], v.dtype, P)
    g = torch.randn((B, Lq, H * v.shape[-1]), device="cuda").to(v.dtype)
    before = ms_deform_attn_backward.launches
    got = count_backward(v, shapes, l, a, g, plan)
    assert ms_deform_attn_backward.launches == before
    assert got == backward_counts(l, shapes, plan)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "edges", "far_out", "encoder_start", "spread"])
@pytest.mark.parametrize("hd", BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_counts_match_the_kernel(cuda, kind, hd, dtype):
    """The kernel's own count of list links, global reductions and flushed
    rows (per level) equals the host's (``backward_counts``, what
    chip_smoke.py prints beside it) under the default window and one of 7
    rows: every corner inside its level is summed once, on chip or in the
    global path, by every head width (3 chunks a head included)."""
    if kind in ("encoder_start", "spread"):
        shapes = MAIN_PATH_SHAPES[:2]
        l = _encoder_locations(shapes, 2, 4, 4, 0.0 if kind == "encoder_start" else 16.0)
        v, _, a = _inputs(hd, dtype, seed=3, H=4, Lq=l.shape[1], shapes=shapes)
    else:
        shapes = BWD_SHAPES
        v, l, a = _edge_inputs(hd, dtype)
        if kind == "far_out":
            far = np.random.RandomState(2).choice([1e6, -1e6, 3e9, np.inf, np.nan], l.shape)
            l = torch.from_numpy(far.astype(np.float32)).cuda()
    B, Lq, H = l.shape[:3]
    plan = backward_plan(B, Lq, H, hd, dtype, 4)
    for p in (plan, _with_window(plan, 7, hd, dtype)):
        counts = _counts_on_the_card(v, l, a, shapes, p)
        if kind == "far_out":
            assert sum(counts.corners) == 0 and counts.global_reductions == 0
        else:
            assert sum(counts.in_shared) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,points", [
    ([(16, 64), (2, 8), (64, 4)], 1),
    ([(16, 64), (2, 8), (64, 4)], 5),     # a group of 4 points and a group of 1
    ([(8, 4), (4, 8), (2, 2), (16, 16), (1, 1), (2, 8), (8, 2), (4, 4)], 2),  # 8 levels
    ([(32, 16)], 8),
], ids=["1_point", "5_points", "8_levels", "1_level_8_points"])
@pytest.mark.parametrize("hd", [12, 24, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_matches_plain_generic_levels(cuda, shapes, points, hd, dtype):
    """Non-square power-of-two levels, 1 to 8 of them, and point counts
    that are not whole groups of 4."""
    _check_backward(*_inputs(hd, dtype, P=points, shapes=shapes), shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [6, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_far_out_is_exactly_zero(cuda, hd, dtype):
    """Samples at +-1e6 and +-3e9: every gradient of a sample out there is
    exactly 0, and the value gets nothing from it."""
    v, l, a = _inputs(hd, dtype, seed=1, shapes=BWD_SHAPES)
    far = np.random.RandomState(2).choice([1e6, -1e6, 3e9, -3e9], size=l.shape)
    l_far = torch.from_numpy(far.astype(np.float32)).cuda()
    g = torch.ones((l.shape[0], l.shape[1], l.shape[2] * hd), device="cuda", dtype=dtype)
    for grad in ms_deform_attn_backward(v, BWD_SHAPES, l_far, a, g):
        assert not bool(grad.any())
    l_one = l.clone()
    l_one[:, :, :, 1] = l_far[:, :, :, 1]
    _, g_loc, g_attn = _check_backward(v, l_one, a)
    assert not bool(g_loc[:, :, :, 1].any()) and not bool(g_attn[:, :, :, 1].any())


@pytest.mark.cuda
def test_backward_rejects_what_it_cannot_take(cuda):
    v, l, a = _inputs(32, torch.bfloat16, shapes=BWD_SHAPES)
    g = torch.zeros((v.shape[0], l.shape[1], l.shape[2] * 32), device="cuda",
                    dtype=torch.bfloat16)
    before = ms_deform_attn_backward.launches
    with pytest.raises(TypeError):
        ms_deform_attn_backward(v, BWD_SHAPES, l, a, g.float())  # grad_out in the value's dtype
    with pytest.raises(ValueError):
        ms_deform_attn_backward(v, BWD_SHAPES, l, a, g[:, :-1])
    for i in (0, 3):  # 16-byte chunks need value and grad_out 16-byte aligned
        args = [v, l, a, g]
        args[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match="16-byte aligned"):
            launch_backward(args[0], BWD_SHAPES, args[1], args[2], args[3])
    plan = backward_plan(*l.shape[:3], 32, torch.bfloat16, 4)
    assert (plan.threads_per_head, plan.lanes_per_head) == (4, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_backward(v, BWD_SHAPES, l, a, g, plan._replace(blocks=plan.blocks - 1))
    with pytest.raises(RuntimeError, match="launch failed"):  # not whole warps
        launch_backward(v, BWD_SHAPES, l, a, g, plan._replace(block_threads=96 + 16,
                                                              blocks=10 ** 6))
    with pytest.raises(RuntimeError, match="launch failed"):  # over 256 threads
        launch_backward(v, BWD_SHAPES, l, a, g, plan._replace(block_threads=512))
    with pytest.raises(RuntimeError, match="launch failed"):  # over 227 KB of shared memory
        launch_backward(v, BWD_SHAPES, l, a, g, plan._replace(window_rows=10 ** 5))
    with pytest.raises(RuntimeError, match="launch failed"):  # not whole passes of 64
        launch_backward(v, BWD_SHAPES, l, a, g, plan._replace(queries_per_block=96))
    with pytest.raises(RuntimeError, match="launch failed"):  # over 65,535 list entries
        launch_backward(v, BWD_SHAPES, l, a, g, plan._replace(queries_per_block=64 * 100))
    assert ms_deform_attn_backward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_function_launches_both_kernels(cuda, dtype):
    """Through autograd on CUDA tensors, ms_deform_attn launches the forward
    kernel and its backward the backward kernel, with the gradients
    ms_deform_attn_backward gives."""
    v, l, a = _inputs(32, dtype, H=8, shapes=MAIN_PATH_SHAPES)
    leaves = [t.clone().requires_grad_() for t in (v, l, a)]
    f0, b0 = ms_deform_attn.launches, ms_deform_attn_backward.launches
    out = ms_deform_attn(leaves[0], MAIN_PATH_SHAPES, leaves[1], leaves[2])
    g = torch.randn(out.shape, device="cuda").to(dtype)
    out.backward(g)
    torch.cuda.synchronize()
    assert (ms_deform_attn.launches - f0, ms_deform_attn_backward.launches - b0) == (1, 1)
    want = ms_deform_attn_backward(v, MAIN_PATH_SHAPES, l, a, g)
    for leaf, w in zip(leaves, want):
        # atomics add in another order each run: float32 rounding apart
        tol = 1e-5 * float(w.float().abs().max()) if dtype == torch.float32 else \
            2 * 2.0 ** -8 * float(w.float().abs().max())
        assert float((leaf.grad.float() - w.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_resident_warps(cuda, dtype):
    plan = backward_plan(2, 21504, 8, 32, dtype, 4)
    assert 4 <= resident_warps(dtype, plan) <= 64


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,max_iters", [
    (16, 10, 10, 2000),   # a TINY step's matching: every (layer, image) at once
    (20, 100, 4, 2000),   # FULL's 100 queries, padding columns
    (6, 12, 12, 40),      # the cap inside a graph chunk: 2 replays, 8 rounds eagerly
])
def test_auction_on_card_equals_cpu(cuda, B, N, M, max_iters):
    """On the card the auction replays its rounds as a CUDA graph: the
    assignment equals the CPU's eager rounds', on ties too, and a second
    call with new costs reuses the graph."""
    from odise_torch.ops import lap

    rng = np.random.RandomState(B + N + M)
    hits = lap._rounds_graph.cache_info().hits
    for trial in range(2):
        cost = rng.randint(0, 4, (B, N, M)).astype(np.float32) if trial else \
            rng.rand(B, N, M).astype(np.float32)
        benefit = -torch.from_numpy(cost)
        if M < N:
            lo = benefit.reshape(B, -1).amin(1) - 1.0
            benefit = torch.cat([benefit, lo[:, None, None].expand(B, N, N - M)], dim=2)
        card = lap.auction_lap(benefit.cuda(), max_iters=max_iters)
        cpu = lap.auction_lap(benefit, max_iters=max_iters)
        assert torch.equal(card.cpu(), cpu)
    assert lap._rounds_graph.cache_info().hits > hits


@pytest.mark.cuda
def test_full_parity_with_jax_through_the_converters(cuda):
    """FULL CategoryODISE in float32 (TF32 off), its SD v1.3, CLIP and ODISE
    weights generated in the reference's layout and loaded through the
    port's converters, against the JAX package's FULL float32 run on the
    same dicts (``tests/data/torch_full_reference.npz``, sha256-checked):
    every stage within ``PARITY["full"]``'s tolerance, the eval forward's
    panoptic map on 99% of the pixels or more, 6 kernel launches per
    forward pass (two: the head's capture and the eval forward)."""
    from .test_torch_convert import port_parity

    torch.backends.cuda.matmul.allow_tf32 = False

    def zero(model):
        ms_deform_attn.launches = 0

    errors, agreement, _ = port_parity("full", "cuda", hook=zero)
    assert ms_deform_attn.launches == 12
    missed = {k: v for k, v in errors.items() if not v[0] <= v[2]}
    assert not missed, missed
    assert agreement >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["category", "caption"])
def test_full_train_step_matches_jax(kind, cuda):
    """One float32 train step (TF32 off) of FULL CategoryODISE or
    CaptionODISE from the reference-layout weights against the JAX
    package's stored step (``tests/data/torch_full_train_reference.npz``,
    sha256-checked), on its numpy draws and taking its assignment, chosen
    points and decisions at the backbone projections' ReLU near-ties: every
    loss and metric, trainable gradient and AdamW change within
    ``tests/test_torch_full_train.py``'s bounds, and both deform-attn
    kernels launched 6 times."""
    from . import test_torch_full_train as full_train

    torch.backends.cuda.matmul.allow_tf32 = False
    dicts, shas = full_train.train_inputs("full")
    ref = full_train.load_reference("full", shas)
    report = full_train.port_step("full", kind, dicts, ref, "cuda")
    print("\n".join(full_train.report_lines(kind, report)))
    assert full_train.misses(report) == []
    assert report["launches"] == (6, 6)


@pytest.mark.cuda
def test_tiny_latent_diffusion_card_equals_cpu(cuda):
    """TINY ``LatentDiffusion`` (widths 32, 32, 64 x 2; 3 DDIM steps, 8x8
    latents, guidance 7.5) with the reference-layout weights of
    ``tests/test_torch_ldm.py``, in float32 with TF32 off, on the card
    against the CPU from the same tokens and starting latent: the image
    before the clip within 1e-3 of the CPU's largest magnitude (each step
    multiplies the UNet's differences by the guidance), and
    ``forward_test`` that image clipped to [0, 1]."""
    from .test_torch_ldm import build_port, ldm_inputs, load_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    state, shas = ldm_inputs("tiny")
    ref = load_reference("tiny", shas)
    cpu = build_port("tiny", dict(state), "cpu")
    card = build_port("tiny", state, "cuda")
    tok, noise = torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["noise"])
    want = cpu.sample(tok, noise=noise)
    got = card.sample(tok, noise=noise)
    assert got.device.type == "cuda" and got.shape == (1, 3, 64, 64)
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-3
    img = card.forward_test(tok, noise=noise)
    assert torch.equal(img, ((got + 1) / 2).clamp(0, 1))


JPEG_CASES = ["baseline_420_641x479", "baseline_444", "grayscale", "progressive",
              "demo/ade", "demo/coco", "demo/ego4d"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", JPEG_CASES)
def test_nvjpeg_matches_pil(cuda, case):
    """nvJPEG's decode of each JPEG fixture and demo image against PIL's
    stored decode (``tests/data/torch_jpeg_reference.npz``): the shape
    exactly; PSNR and mean absolute error within ``PSNR_MIN_DB`` and
    ``MEAN_ABS_MAX`` (nvJPEG's IDCT and chroma upsampling are not
    libjpeg-turbo's). Prints the gap per channel."""
    from odise_torch.data.image_io import decode_jpeg_cuda

    from .torch_jpeg_fixtures import MEAN_ABS_MAX, PSNR_MIN_DB, jpeg_gap, load

    data, want = load()[0][case]
    before = decode_jpeg_cuda.decodes
    got = decode_jpeg_cuda(data, "cuda")
    torch.cuda.synchronize()
    assert decode_jpeg_cuda.decodes == before + 1
    assert got.dtype == torch.uint8 and got.shape == want.shape
    gap = jpeg_gap(got.cpu().numpy(), want)
    print(f"nvJPEG vs PIL {case}: {gap}")
    assert gap["psnr_db"] >= PSNR_MIN_DB and gap["mean_abs"] <= MEAN_ABS_MAX, (case, gap)


@pytest.mark.cuda
def test_nvjpeg_decodes_from_threads(cuda):
    """More threads than cores decode the JPEG fixtures at once, half on
    streams of their own and half on the default stream (each thread has
    its own nvJPEG state, and waits for its last decode before it moves to
    another stream): every decode bitwise equal to one thread's, and no
    decode lost from the count. The thread switch interval is shortened to
    mix the threads' Python between decodes."""
    import os
    import sys
    import threading

    from odise_torch.data.image_io import decode_jpeg_cuda

    from .torch_jpeg_fixtures import load

    cases = [data for data, _ in load()[0].values()]
    want = [decode_jpeg_cuda(data, "cuda").cpu() for data in cases]
    n_threads, rounds = 2 * (os.cpu_count() or 4), 5
    bad, errors = [], []

    def work(k):
        try:
            stream = torch.cuda.Stream() if k % 2 else torch.cuda.default_stream()
            for r in range(rounds):
                for i, data in enumerate(cases):
                    with torch.cuda.stream(stream if r % 2 else torch.cuda.default_stream()):
                        got = decode_jpeg_cuda(data, "cuda")
                        torch.cuda.current_stream().synchronize()
                    if not torch.equal(got.cpu(), want[i]):
                        bad.append((k, r, i))
        except Exception as err:  # reported below, with the thread's number
            errors.append((k, repr(err)))

    before = decode_jpeg_cuda.decodes
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad, (errors, bad[:5])
    assert decode_jpeg_cuda.decodes - before == n_threads * rounds * len(cases)


@pytest.mark.cuda
def test_mapper_decodes_jpeg_on_its_side_stream(cuda, tmp_path):
    """The training mapper's JPEG, decoded on its side stream after the
    current stream has queued work, equals ``read_image``'s decode, and the
    augmentations read it after the decode."""
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.image_io import read_image

    from .torch_jpeg_fixtures import load

    data, _ = load()[0]["demo/coco"]
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    mapper = COCOPanopticDatasetMapper(image_size=512, max_instances=4, is_train=False,
                                       device="cuda")
    busy = torch.randn(4096, 4096, device="cuda")
    for _ in range(20):  # queue work on the current stream before the decode
        busy = busy @ busy / 64
    out = mapper({"file_name": str(path)})
    want = read_image(path, "cuda").float() / 255.0
    assert torch.equal(out["image"], want)


@pytest.mark.cuda
def test_read_image_dispatches_on_the_signature(cuda, tmp_path):
    """On the card a JPEG goes to nvJPEG whatever its name, and a PNG is
    decoded on the host and moved to the card, equal to the CPU's read."""
    from odise_torch.data.image_io import decode_jpeg_cuda, read_image, write_png

    from .torch_jpeg_fixtures import load

    data, want = load()[0]["baseline_444"]
    (tmp_path / "a.png").write_bytes(data)
    write_png(tmp_path / "b.jpg", want)
    before = decode_jpeg_cuda.decodes
    jpeg = read_image(tmp_path / "a.png", "cuda")
    assert decode_jpeg_cuda.decodes == before + 1
    assert torch.equal(jpeg, decode_jpeg_cuda(data, "cuda"))
    png = read_image(tmp_path / "b.jpg", "cuda")
    assert png.device.type == "cuda" and decode_jpeg_cuda.decodes == before + 2
    assert np.array_equal(png.cpu().numpy(), want)


@pytest.mark.cuda
def test_collectives_on_a_one_rank_nccl_group(cuda, tmp_path):
    """The port's collectives (chip_smoke.py's phase 13 (a)) on a one-rank
    NCCL group on card 0: all-reduce, the grounding loss's gather forward
    and backward and without gradients, ``all_gather_object``, each equal
    to the host's values."""
    import chip_smoke
    from odise_torch.parallel import initialize_multihost

    initialize_multihost(f"file://{tmp_path}/rendezvous", 1, 0, device="cuda:0")
    try:
        result = chip_smoke.collective_checks()
    finally:
        torch.distributed.destroy_process_group()
    print(result)
    assert result["backend"] == "nccl" and result["world"] == 1
    assert all(e == 0 for e in result["errors"].values()), result["errors"]


@pytest.mark.cuda
def test_collectives_on_two_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """The same on two gloo ranks on card 0 (``launch`` with the card and
    gloo asked for), with the train step's mean all-reduce and
    ``gather_pickled`` across the two."""
    import json

    import chip_smoke
    from odise_torch.engine.launch import launch

    launch(chip_smoke._collectives_rank, 2, dist_url=f"file://{tmp_path}/rendezvous",
           args=(str(tmp_path),), backend="gloo", device="cuda:0", timeout=300)
    for rank in range(2):
        result = json.loads((tmp_path / f"collectives{rank}.json").read_text())
        print(result)
        assert result["backend"] == "gloo" and result["world"] == 2
        assert result["device"] == "cuda:0"
        assert all(e == 0 for e in result["errors"].values()), result["errors"]
