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

from ..utils.tracing import span
from . import _build

__all__ = ["MSDeformAttnFunction", "backward_counts", "backward_plan", "backward_smem_bytes",
           "count_backward", "launch", "launch_backward", "launch_plan", "ms_deform_attn",
           "ms_deform_attn_backward", "ms_deform_attn_backward_torch", "ms_deform_attn_torch",
           "resident_warps"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 8  # kMaxLevels in the kernels' source


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


BWD_BLOCK_THREADS = 256   # kBwdMaxThreads in the source
BWD_BLOCKS_PER_SM = 3     # kBwdMinBlocksPerSM: at most 85 registers a thread
BWD_QUERIES = 256         # the most consecutive queries of one head a block takes
# an SM's 228 KB, less the 1 KB the runtime keeps for each block, shared by
# BWD_BLOCKS_PER_SM blocks
BWD_BLOCK_SHARED = 233_472 // BWD_BLOCKS_PER_SM - 1024
MAX_ENTRIES = 65_535      # list entries a block holds (16-bit links)


def backward_smem_bytes(window_rows: int, queries: int, n_points: int, head_dim: int,
                        dtype: torch.dtype) -> int:
    """The backward kernel's dynamic shared memory (``bwd_smem_bytes`` in
    the source): a box of each of up to 8 levels (128 bytes), the block's
    grad_out (``queries`` rows of ``head_dim`` elements, padded to 16
    bytes), the list head of each of ``window_rows`` rows (an even count of
    ints), and a list entry of 8 bytes for each corner of each sample of
    the block's queries at one level."""
    grad = -(-queries * head_dim * dtype.itemsize // 16) * 16
    return 128 + grad + 4 * ((window_rows + 1) & ~1) + 8 * 4 * queries * n_points


class BackwardPlan(NamedTuple):
    """What the backward C entry point launches: a block takes
    ``queries_per_block`` consecutive queries of one (batch, head), with a
    thread per chunk of the head as in the forward (a head's threads padded
    to a power of two ``lanes_per_head`` of one warp), and the value
    gradient of a window of ``window_rows`` rows of the head summed from
    lists in shared memory, 4 entries for each of a query's ``n_points``
    samples of a level."""
    chunk_elems: int
    chunk_bytes: int
    threads_per_head: int  # the head's chunks
    lanes_per_head: int    # the chunks rounded up to a power of two
    n_points: int
    queries_per_block: int
    window_rows: int
    smem_bytes: int
    block_threads: int
    blocks: int

    @property
    def warps(self) -> int:
        return self.blocks * self.block_threads // 32


def backward_plan(batch: int, len_q: int, n_heads: int, head_dim: int,
                  dtype: torch.dtype, n_points: int) -> BackwardPlan:
    """The forward's chunks (``launch_plan``), a head's padded to a power of
    two lanes; blocks over 256 consecutive queries of one head (halved
    while their lists take more than 65,535 entries or than a third of an
    SM's shared memory) of 256 threads (fewer where that is more than one
    pass over the queries), with a window of as many rows as leave an SM
    room for 3 blocks. Raises ``ValueError`` where a head takes more than
    32 chunks (float32 heads of more than 32 channels that are not a
    multiple of 4, or of more than 128; bf16 heads of more than 32 that are
    not a multiple of 8, or of more than 256), and where a block's lists
    are over 65,535 entries or its shared memory over 227 KB."""
    f = launch_plan(batch, len_q, n_heads, head_dim, dtype, 1, 1)
    chunks = f.threads_per_head
    if chunks > 32:
        raise ValueError(f"the backward kernel takes at most 32 chunks a head; "
                         f"head_dim {head_dim} in {dtype} is {chunks}")
    lanes = 1 << (chunks - 1).bit_length()
    queries_per_block = BWD_QUERIES
    while queries_per_block * lanes > 32 and (
            4 * queries_per_block * n_points > MAX_ENTRIES
            or backward_smem_bytes(2, queries_per_block, n_points, head_dim,
                                   dtype) > BWD_BLOCK_SHARED):
        queries_per_block //= 2
    entries = 4 * queries_per_block * n_points
    if entries > MAX_ENTRIES:
        raise ValueError(f"{queries_per_block} queries of {n_points} points take {entries} "
                         f"list entries in shared memory; a block holds {MAX_ENTRIES}")
    free = BWD_BLOCK_SHARED - backward_smem_bytes(0, queries_per_block, n_points,
                                                  head_dim, dtype)
    window_rows = max(free // 4 & ~1, 0)
    smem = backward_smem_bytes(window_rows, queries_per_block, n_points, head_dim, dtype)
    if window_rows < 1:
        raise ValueError(f"lists for {queries_per_block} queries of {n_points} points take "
                         f"{smem} bytes of shared memory; a block has {BWD_BLOCK_SHARED} "
                         f"where an SM holds {BWD_BLOCKS_PER_SM}")
    runs = -(-len_q // queries_per_block)
    return BackwardPlan(chunk_elems=f.chunk_elems, chunk_bytes=f.chunk_bytes,
                        threads_per_head=chunks, lanes_per_head=lanes, n_points=n_points,
                        queries_per_block=queries_per_block, window_rows=window_rows,
                        smem_bytes=smem,
                        block_threads=min(BWD_BLOCK_THREADS, lanes * queries_per_block),
                        blocks=batch * runs * n_heads)


def _with_window(plan: BackwardPlan, window_rows: int, head_dim: int,
                 dtype: torch.dtype) -> BackwardPlan:
    """``plan`` with a window of ``window_rows`` rows, which tests use to cut
    windows small; the C entry point refuses a window that does not fit."""
    return plan._replace(window_rows=window_rows, smem_bytes=backward_smem_bytes(
        window_rows, plan.queries_per_block, plan.n_points, head_dim, dtype))


class BackwardCounts(NamedTuple):
    """What the backward kernel does with the value gradient on given
    sampling locations: counted on the host (``backward_counts``) or read
    from the kernel (``count_backward``); per level where a tuple."""
    corners: Tuple[int, ...]        # sample corners inside their level
    in_shared: Tuple[int, ...]      # of which inside their block's window,
                                    # summed on chip
    flushed_rows: Tuple[int, ...]   # window rows touched, each flushed once
    global_reductions: int          # global reduction instructions in all
    direct_reductions: int          # the same with every corner reduced in
                                    # global memory

    @property
    def in_shared_share(self) -> Tuple[float, ...]:
        return tuple(s / c if c else 1.0 for s, c in zip(self.in_shared, self.corners))


def backward_counts(sampling_locations: torch.Tensor,
                    spatial_shapes: Sequence[Tuple[int, int]],
                    plan: BackwardPlan) -> BackwardCounts:
    """Count, from the sampling locations and the plan alone, what the
    backward kernel does: each block's box of inside corners per level and
    its window (the same float32 pixel coordinates and the same cut as the
    kernel), the corners summed on chip, the window rows they touch (each
    flushed once per block), and the global reductions: one per 4 channels
    (or per channel where the chunk is one element) of each corner outside
    its window and of each flushed row."""
    loc = sampling_locations
    B, Lq, H, _, P, _ = loc.shape
    D = plan.chunk_elems * plan.threads_per_head
    per_row = D // 4 if plan.chunk_elems % 4 == 0 else D
    C = plan.window_rows
    runs = -(-Lq // plan.queries_per_block)
    dev = loc.device
    run = torch.arange(Lq, device=dev) // plan.queries_per_block
    block = ((torch.arange(B, device=dev)[:, None, None] * runs + run[None, :, None]) * H
             + torch.arange(H, device=dev)[None, None, :])
    block = block[..., None].expand(B, Lq, H, P).reshape(-1)
    n_blocks = B * runs * H
    corners, in_shared, flushed = [], [], []

    def reduce(v, near, fill, how):
        out = torch.full((n_blocks,), fill, dtype=torch.long, device=dev)
        return out.scatter_reduce(0, block, torch.where(near, v, fill), how)

    for lvl, (h, w) in enumerate(spatial_shapes):
        x0f = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5).reshape(-1)
        y0f = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5).reshape(-1)
        near = (x0f >= -1) & (x0f <= w - 1) & (y0f >= -1) & (y0f <= h - 1)
        x0 = torch.where(near, x0f, 0).long()
        y0 = torch.where(near, y0f, 0).long()
        wy = reduce(y0.clamp(min=0), near, 2 ** 62, "amin")
        yhi = reduce((y0 + 1).clamp(max=h - 1), near, -1, "amax")
        wx = reduce(x0.clamp(min=0), near, 2 ** 62, "amin")
        xhi = reduce((x0 + 1).clamp(max=w - 1), near, -1, "amax")
        bh, bw = (yhi - wy + 1).clamp(min=0), (xhi - wx + 1).clamp(min=0)
        ww = bw.clamp(max=C)
        wh = torch.minimum(bh, C // ww.clamp(min=1))
        inside_n, shared_n, rows = 0, 0, []
        for dy in (0, 1):
            for dx in (0, 1):
                cy, cx = y0 + dy, x0 + dx
                inside = near & (cy >= 0) & (cy <= h - 1) & (cx >= 0) & (cx <= w - 1)
                ry, rx = cy - wy[block], cx - wx[block]
                shared = (inside & (ry >= 0) & (ry < wh[block]) & (rx >= 0)
                          & (rx < ww[block]))
                inside_n += int(inside.sum())
                shared_n += int(shared.sum())
                rows.append((block * C + ry * ww[block] + rx)[shared])
        corners.append(inside_n)
        in_shared.append(shared_n)
        flushed.append(int(torch.unique(torch.cat(rows)).numel()))
    outside = sum(corners) - sum(in_shared)
    return BackwardCounts(corners=tuple(corners), in_shared=tuple(in_shared),
                          flushed_rows=tuple(flushed),
                          global_reductions=(outside + sum(flushed)) * per_row,
                          direct_reductions=sum(corners) * per_row)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' C entry points, built and loaded once per process."""
    lib = _build.load("ms_deform_attn")
    lib.ms_deform_attn_forward.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.ms_deform_attn_forward.restype = ctypes.c_int
    lib.ms_deform_attn_backward.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 2
    lib.ms_deform_attn_backward.restype = ctypes.c_int
    lib.ms_deform_attn_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.ms_deform_attn_backward_occupancy.argtypes = [ctypes.c_int] * 7 + [
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
            _DTYPE_CODE[dtype], plan.chunk_elems, plan.chunk_elems * plan.threads_per_head,
            plan.window_rows, plan.queries_per_block, plan.n_points, plan.block_threads,
            ctypes.byref(blocks))
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
    if sampling_locations.shape[3] > MAX_LEVELS:
        raise ValueError(f"the kernel takes at most {MAX_LEVELS} levels")
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
    grads = _run_backward(value, spatial_shapes, sampling_locations, attention_weights,
                          grad_out, plan, None)
    ms_deform_attn_backward.launches += 1
    return grads


def count_backward(value, spatial_shapes, sampling_locations, attention_weights,
                   grad_out, plan: BackwardPlan | None = None) -> BackwardCounts:
    """What the backward kernel did with the value gradient on these inputs,
    read from the card: the kernel's counting instantiation (the same
    source, which also adds up its own list links, global reductions and
    flushed rows) launched as ``launch_backward`` would launch the kernel.
    A measurement, not a launch of the training path: it is not counted in
    ``ms_deform_attn_backward.launches``."""
    if value.device.type != "cuda":
        raise ValueError("count_backward reads the kernel's counts on the card")
    B, Len_q, n_heads, n_levels, n_points, _ = sampling_locations.shape
    hd = value.shape[-1]
    if plan is None:
        plan = backward_plan(B, Len_q, n_heads, hd, value.dtype, n_points)
    counts = torch.zeros(1 + 3 * MAX_LEVELS, dtype=torch.int64, device=value.device)
    _run_backward(value, spatial_shapes, sampling_locations, attention_weights, grad_out,
                  plan, counts)
    n = counts.tolist()
    linked, direct, rows = (tuple(n[1 + 3 * lvl + i] for lvl in range(n_levels))
                            for i in range(3))
    corners = tuple(s + d for s, d in zip(linked, direct))
    per_row = hd // 4 if plan.chunk_elems % 4 == 0 else hd
    return BackwardCounts(corners=corners, in_shared=linked, flushed_rows=rows,
                          global_reductions=n[0], direct_reductions=sum(corners) * per_row)


def _run_backward(value, spatial_shapes, sampling_locations, attention_weights, grad_out,
                  plan, counts):
    """Launch the backward kernel (``counts``: None, or a zeroed int64
    tensor on the card for the counting instantiation) and return its
    gradients."""
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
        plan = backward_plan(B, Len_q, n_heads, hd, value.dtype, n_points)
    if plan.n_points != n_points:
        raise ValueError(f"a plan for {plan.n_points} points, not {n_points}")
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
                 plan.chunk_elems, plan.queries_per_block, plan.window_rows, plan.blocks,
                 plan.block_threads, None if counts is None else counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn backward kernel launch failed: CUDA "
                           f"error {err}")
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
        with span("odise.ms_deform_attn.bwd"):
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
    with span("odise.ms_deform_attn"):
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
