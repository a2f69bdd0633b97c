"""The deformable-attention CUDA kernel against its plain PyTorch version,
on the card. Imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every test skips without a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_torch  # noqa: E402

SHAPES = [(40, 40), (6, 8), (3, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False


def _inputs(hd, dtype, seed=0, B=2, H=3, P=4, Lq=50):
    rng = np.random.RandomState(seed)
    L = len(SHAPES)
    Lv = sum(h * w for h, w in SHAPES)
    value = rng.randn(B, Lv, H, hd).astype(np.float32)
    loc = (rng.rand(B, Lq, H, L, P, 2) * 1.6 - 0.3).astype(np.float32)
    for lvl, (h, w) in enumerate(SHAPES):  # pixel centres on a third
        loc[:, : Lq // 3, :, lvl, :, 0] = (rng.randint(0, w, (B, Lq // 3, H, P)) + 0.5) / w
        loc[:, : Lq // 3, :, lvl, :, 1] = (rng.randint(0, h, (B, Lq // 3, H, P)) + 0.5) / h
    att = rng.rand(B, Lq, H, L, P).astype(np.float32)
    att /= att.sum(axis=(-2, -1), keepdims=True)
    return (torch.from_numpy(value).cuda().to(dtype), torch.from_numpy(loc).cuda(),
            torch.from_numpy(att).cuda().to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 32, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain(cuda, hd, dtype):
    """float32: 1e-5 (another summation order). bf16: both round their
    float32 sum to bf16 once, so two bf16 ulps of the largest output."""
    v, l, a = _inputs(hd, dtype)
    before = ms_deform_attn.launches
    out = ms_deform_attn(v, SHAPES, l, a)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    assert out.dtype == dtype and out.shape == (2, 50, 3 * hd)
    ref = ms_deform_attn_torch(v, SHAPES, l, a).float()
    tol = 1e-5 if dtype == torch.float32 else 2 * float(ref.abs().max()) * 2.0 ** -8
    assert float((out.float() - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    v, l, a = _inputs(32, torch.bfloat16)
    with pytest.raises(TypeError):
        ms_deform_attn(v, SHAPES, l.to(torch.bfloat16), a)  # locations must be f32
    with pytest.raises(TypeError):
        ms_deform_attn(v, SHAPES, l, a.float())  # weights in the value's dtype
    with pytest.raises(ValueError):
        ms_deform_attn(v.transpose(0, 1).contiguous().transpose(0, 1), SHAPES, l, a)
