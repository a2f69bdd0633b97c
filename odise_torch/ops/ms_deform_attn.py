"""Multi-scale deformable attention, forward and backward.

Same signature and layouts as ``odise_tpu.ops.ms_deform_attn.ms_deform_attn``.
A CUDA tensor goes to the hand-written kernels in
``odise_torch/csrc/ms_deform_attn.cu`` through ``MSDeformAttnFunction``:
the forward kernel, and the backward kernel for the gradients of all three
inputs. A CPU tensor goes to ``ms_deform_attn_torch``, the plain per-level
``grid_sample`` version, and autograd differentiates it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["MSDeformAttnFunction", "backward_plan", "launch", "launch_backward",
           "launch_plan", "ms_deform_attn", "ms_deform_attn_backward",
           "ms_deform_attn_backward_torch", "ms_deform_attn_torch",
           "resident_warps"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ms_deform_attn_torch(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain version: per level ``F.grid_sample`` plus a weighted sum, in
    float32 (float64 for a float64 value), cast to the value's dtype at the
    end."""
    B, _, n_heads, hd = value.shape
    _, Lq, _, n_levels, n_points, _ = sampling_locations.shape
    acc = torch.float64 if value.dtype == torch.float64 else torch.float32
    value_list = value.to(acc).split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * sampling_locations.to(acc) - 1
    weights = attention_weights.to(acc)
    out = value.new_zeros((B, Lq, n_heads, hd), dtype=acc)
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value_list[lvl].reshape(B, h, w, n_heads, hd)
        v = v.permute(0, 3, 4, 1, 2).reshape(B * n_heads, hd, h, w)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4)
        g = g.reshape(B * n_heads, Lq, n_points, 2)
        sampled = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # [B*H, hd, Lq, P]
        sampled = sampled.reshape(B, n_heads, hd, Lq, n_points)
        w_l = weights[:, :, :, lvl].permute(0, 2, 1, 3)  # [B, H, Lq, P]
        out += torch.einsum("bhcqp,bhqp->bqhc", sampled, w_l)
    return out.reshape(B, Lq, n_heads * hd).to(value.dtype)


def ms_deform_attn_backward_torch(value, spatial_shapes, sampling_locations,
                                  attention_weights, grad_out):
    """Plain version of the backward: autograd through
    ``ms_deform_attn_torch`` (``grid_sample``'s backward), in the inputs'
    precision. Returns (grad_value, grad_sampling_locations,
    grad_attention_weights)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in
                  (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_torch(inputs[0], spatial_shapes, inputs[1], inputs[2])
        return torch.autograd.grad(out, inputs, grad_out.to(out.dtype))


def _check(value, spatial_shapes, sampling_locations, attention_weights):
    if value.dim() != 4:
        raise ValueError(f"value must be [B, Len_v, heads, head_dim], got "
                         f"{tuple(value.shape)}")
    B, Len_v, n_heads, _ = value.shape
    if sampling_locations.dim() != 6 or sampling_locations.shape[-1] != 2:
        raise ValueError("sampling_locations must be [B, Len_q, heads, levels, "
                         f"points, 2], got {tuple(sampling_locations.shape)}")
    _, Len_q, _, n_levels, n_points, _ = sampling_locations.shape
    if tuple(sampling_locations.shape[:3]) != (B, Len_q, n_heads):
        raise ValueError("sampling_locations does not match value in batch or "
                         "heads")
    if n_levels != len(spatial_shapes):
        raise ValueError(f"{len(spatial_shapes)} spatial shapes for "
                         f"{n_levels} levels")
    if Len_v != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"Len_v={Len_v} != sum(h*w) of {list(spatial_shapes)}")
    want = (B, Len_q, n_heads, n_levels, n_points)
    if tuple(attention_weights.shape) != want:
        raise ValueError(f"attention_weights must be {want}, got "
                         f"{tuple(attention_weights.shape)}")
    devices = {t.device for t in (value, sampling_locations, attention_weights)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")


BLOCK_THREADS = 128  # at most kBlockThreads in the kernel's source


class LaunchPlan(NamedTuple):
    """What the C entry point launches; it refuses a plan the kernel was not
    compiled for."""
    chunk_elems: int       # value elements a thread reads per corner
    chunk_bytes: int
    threads_per_head: int
    specialised: bool      # the variant compiled for 3 levels of 4 points
    threads: int
    block_threads: int
    blocks: int

    @property
    def warps(self) -> int:
        return self.blocks * self.block_threads // 32


def launch_plan(batch: int, len_q: int, n_heads: int, head_dim: int,
                dtype: torch.dtype, n_levels: int, n_points: int) -> LaunchPlan:
    """How the kernel covers an output of [batch, len_q, n_heads, head_dim]:
    one thread per 16-byte chunk of a head's channels where head_dim fills
    whole 16-byte chunks, else one thread per channel; the variant with the
    counts compiled in where they are the main path's 3 levels of 4 points."""
    elem = dtype.itemsize
    vec = 16 // elem if head_dim * elem % 16 == 0 else 1
    per_head = head_dim // vec
    threads = batch * len_q * n_heads * per_head
    return LaunchPlan(chunk_elems=vec, chunk_bytes=vec * elem,
                      threads_per_head=per_head,
                      specialised=(n_levels, n_points) == (3, 4),
                      threads=threads, block_threads=BLOCK_THREADS,
                      blocks=-(-threads // BLOCK_THREADS))


class BackwardPlan(NamedTuple):
    """What the backward C entry point launches: one thread per chunk of a
    head of a query, as in the forward, with a head's threads padded to a
    power of two ``lanes_per_head`` (at most a warp) that sum their partial
    weight and location gradients by warp shuffles."""
    chunk_elems: int
    chunk_bytes: int
    threads_per_head: int  # the head's chunks
    lanes_per_head: int    # the chunks rounded up to a power of two
    threads: int
    block_threads: int
    blocks: int

    @property
    def warps(self) -> int:
        return self.blocks * self.block_threads // 32


def backward_plan(batch: int, len_q: int, n_heads: int, head_dim: int,
                  dtype: torch.dtype) -> BackwardPlan:
    """The forward's chunks (``launch_plan``), a head's chunks padded to a
    power of two lanes; raises ``ValueError`` where a head takes more than
    32 chunks: float32 heads of more than 32 channels that are not a
    multiple of 4, or of more than 128; bf16 heads of more than 32 that are
    not a multiple of 8, or of more than 256."""
    f = launch_plan(batch, len_q, n_heads, head_dim, dtype, 1, 1)
    chunks = f.threads_per_head
    if chunks > 32:
        raise ValueError(f"the backward kernel takes at most 32 chunks a head; "
                         f"head_dim {head_dim} in {dtype} is {chunks}")
    lanes = 1 << (chunks - 1).bit_length()
    threads = batch * len_q * n_heads * lanes
    return BackwardPlan(chunk_elems=f.chunk_elems, chunk_bytes=f.chunk_bytes,
                        threads_per_head=chunks, lanes_per_head=lanes, threads=threads,
                        block_threads=f.block_threads,
                        blocks=-(-threads // f.block_threads))


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' C entry points, built and loaded once per process."""
    lib = _build.load("ms_deform_attn")
    lib.ms_deform_attn_forward.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.ms_deform_attn_forward.restype = ctypes.c_int
    lib.ms_deform_attn_backward.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.ms_deform_attn_backward.restype = ctypes.c_int
    lib.ms_deform_attn_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.ms_deform_attn_backward_occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    for name in ("ms_deform_attn_occupancy", "ms_deform_attn_backward_occupancy"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def resident_warps(dtype: torch.dtype, plan) -> int:
    """Warps of the plan's kernel variant (a ``LaunchPlan`` for the forward,
    a ``BackwardPlan`` for the backward) that an SM of the current card
    holds, from the CUDA runtime's occupancy calculator."""
    blocks = ctypes.c_int(0)
    if isinstance(plan, BackwardPlan):
        err = _lib().ms_deform_attn_backward_occupancy(
            _DTYPE_CODE[dtype], plan.chunk_elems, plan.block_threads, ctypes.byref(blocks))
    else:
        err = _lib().ms_deform_attn_occupancy(
            _DTYPE_CODE[dtype], plan.chunk_elems, int(plan.specialised),
            plan.block_threads, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ms_deform_attn occupancy query failed: CUDA error {err}")
    return blocks.value * plan.block_threads // 32


def _level_table(spatial_shapes):
    """(h, w, first row) of each level as the C array the kernels take."""
    hws, start = [], 0
    for h, w in spatial_shapes:
        hws += [int(h), int(w), start]
        start += int(h) * int(w)
    return (ctypes.c_int * len(hws))(*hws)


def _check_kernel_inputs(value, sampling_locations, attention_weights, extra=()):
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if attention_weights.dtype != value.dtype:
        raise TypeError(f"attention_weights ({attention_weights.dtype}) must "
                        f"have the value's dtype ({value.dtype})")
    if sampling_locations.dtype != torch.float32:
        raise TypeError("sampling_locations must be float32, got "
                        f"{sampling_locations.dtype}")
    inputs = (("value", value), ("sampling_locations", sampling_locations),
              ("attention_weights", attention_weights)) + tuple(extra)
    for name, t in inputs:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sampling_locations.shape[3] > 8:
        raise ValueError("the kernel takes at most 8 levels")
    return inputs


def launch(value, spatial_shapes, sampling_locations, attention_weights,
           plan: LaunchPlan | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors that ``ms_deform_attn`` has checked,
    as ``plan`` says (``launch_plan``'s by default), and count the launch."""
    inputs = _check_kernel_inputs(value, sampling_locations, attention_weights)
    B, Len_v, n_heads, hd = value.shape
    _, Len_q, _, n_levels, n_points, _ = sampling_locations.shape
    if plan is None:
        plan = launch_plan(B, Len_q, n_heads, hd, value.dtype, n_levels, n_points)
    if plan.chunk_bytes == 16:
        for name, t in inputs:
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the "
                                 "kernel's 16-byte chunks")

    hws_arr = _level_table(spatial_shapes)
    out = torch.empty((B, Len_q, n_heads * hd), dtype=value.dtype,
                      device=value.device)
    fn = _lib().ms_deform_attn_forward
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), sampling_locations.data_ptr(),
                 attention_weights.data_ptr(), out.data_ptr(), B, Len_v,
                 Len_q, n_heads, hd, n_levels, n_points,
                 ctypes.addressof(hws_arr), _DTYPE_CODE[value.dtype],
                 plan.chunk_elems, int(plan.specialised), plan.blocks,
                 plan.block_threads, stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn kernel launch failed: CUDA error "
                           f"{err}")
    ms_deform_attn.launches += 1
    return out


def launch_backward(value, spatial_shapes, sampling_locations, attention_weights,
                    grad_out, plan: BackwardPlan | None = None):
    """Launch the backward kernel on CUDA tensors as ``plan`` says
    (``backward_plan``'s by default) and count the launch. ``grad_out`` is
    [B, Len_q, heads * head_dim] in the value's dtype. Returns (grad_value
    in the value's dtype, grad_sampling_locations float32,
    grad_attention_weights in the value's dtype)."""
    if grad_out.dtype != value.dtype:
        raise TypeError(f"grad_out ({grad_out.dtype}) must have the value's "
                        f"dtype ({value.dtype})")
    inputs = _check_kernel_inputs(value, sampling_locations, attention_weights,
                                  (("grad_out", grad_out),))
    B, Len_v, n_heads, hd = value.shape
    _, Len_q, _, n_levels, n_points, _ = sampling_locations.shape
    if tuple(grad_out.shape) != (B, Len_q, n_heads * hd):
        raise ValueError(f"grad_out must be {(B, Len_q, n_heads * hd)}, got "
                         f"{tuple(grad_out.shape)}")
    if plan is None:
        plan = backward_plan(B, Len_q, n_heads, hd, value.dtype)
    if plan.chunk_bytes == 16:
        for name, t in (inputs[0], inputs[3]):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the "
                                 "kernel's 16-byte chunks")
    grad_value = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    grad_loc = torch.empty(sampling_locations.shape, dtype=torch.float32,
                           device=value.device)
    grad_attn = torch.empty(attention_weights.shape, dtype=torch.float32,
                            device=value.device)
    hws_arr = _level_table(spatial_shapes)
    fn = _lib().ms_deform_attn_backward
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), sampling_locations.data_ptr(),
                 attention_weights.data_ptr(), grad_out.data_ptr(),
                 grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
                 B, Len_v, Len_q, n_heads, hd, n_levels, n_points,
                 ctypes.addressof(hws_arr), _DTYPE_CODE[value.dtype],
                 plan.chunk_elems, plan.blocks, plan.block_threads, stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn backward kernel launch failed: CUDA "
                           f"error {err}")
    ms_deform_attn_backward.launches += 1
    return (grad_value.to(value.dtype), grad_loc,
            grad_attn.to(attention_weights.dtype))


def ms_deform_attn_backward(value, spatial_shapes, sampling_locations,
                            attention_weights, grad_out):
    """Gradients of ``ms_deform_attn`` with respect to value, sampling
    locations and attention weights for ``grad_out``. On CUDA tensors it
    launches the backward kernel (counted in
    ``ms_deform_attn_backward.launches``) or raises; on CPU tensors it runs
    the plain version."""
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type == "cuda":
        return launch_backward(value, spatial_shapes, sampling_locations,
                               attention_weights, grad_out.contiguous())
    if value.device.type != "cpu":
        raise ValueError(f"unsupported device {value.device}")
    return ms_deform_attn_backward_torch(value, spatial_shapes, sampling_locations,
                                         attention_weights, grad_out)


ms_deform_attn_backward.launches = 0


class MSDeformAttnFunction(torch.autograd.Function):
    """The CUDA kernels as one differentiable op: forward = ``launch``,
    backward = ``launch_backward``."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return launch(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, sampling_locations, attention_weights = ctx.saved_tensors
        grads = launch_backward(value, ctx.spatial_shapes, sampling_locations,
                                attention_weights, grad_out.contiguous())
        return (*grads, None)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention.

    Args:
      value: [B, Len_v, n_heads, head_dim] float32 or bfloat16, levels
        concatenated along Len_v in the order of ``spatial_shapes``.
      spatial_shapes: (H_l, W_l) per level; sum(H*W) == Len_v.
      sampling_locations: [B, Len_q, n_heads, n_levels, n_points, 2] float32,
        normalized xy (0..1 inside the map).
      attention_weights: [B, Len_q, n_heads, n_levels, n_points], the
        value's dtype.

    Returns [B, Len_q, n_heads * head_dim] in the value's dtype. On CUDA
    tensors it launches the kernel (and counts the launch in
    ``ms_deform_attn.launches``) or raises; where an input needs a gradient
    it does so through ``MSDeformAttnFunction``, whose backward launches the
    backward kernel. On CPU tensors it runs the plain version, which
    autograd differentiates.
    """
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type == "cuda":
        shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (value, sampling_locations, attention_weights)):
            return MSDeformAttnFunction.apply(value, sampling_locations,
                                              attention_weights, shapes)
        return launch(value, shapes, sampling_locations, attention_weights)
    if value.device.type != "cpu":
        raise ValueError(f"unsupported device {value.device}")
    return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                attention_weights)


ms_deform_attn.launches = 0
