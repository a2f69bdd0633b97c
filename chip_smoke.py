"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit; build every CUDA source under
     odise_torch/csrc (one nvcc each, started together), print ptxas's
     report of registers and spills as nvcc gave it, and the warps an SM
     holds of each kernel variant (CUDA occupancy calculator);
  2. hold the deformable-attention kernel against its plain PyTorch version
     (run in float64, beside the plain version's own float32 error) at the
     main path's shapes and at the level shapes of the widest and the
     tallest shape bucket (1024x2560, 2560x1024: non-square, 53,760
     queries), in float32 and bf16, on random, out-of-range and
     pixel-centre sampling locations; print the launch plan at 53,760
     queries;
  3. serve four 1024-px requests with CategoryODISE at FULL width in bf16
     (deterministic pattern weights, 133- and 20-label vocabularies):
     encode_vocab, forward_eval_trunk, forward_eval_head,
     semantic_inference, panoptic_inference; the kernel's launch count must
     grow by 6 per image, and the logit checksums must match the recorded
     ones;
  4. on the inputs the main path gave the first encoder layer: compare the
     kernel with the plain version, and time both with the L2 flushed and
     the kernel also back to back; time the kernel's generic variant on the
     same inputs beside the one the main path runs;
  5. trace one more K=133 request with torch.profiler: the device kernels
     that take the most time, the deformable-attention kernel's in-place
     time, and the device's idle share over the request; read from the
     launched kernel's name that it ran 16-byte bf16 chunks in the variant
     for 3 levels of 4 points;
  6. hold the TINY model on the card against the same model on the CPU;
  7. the evaluation path at any image size: six synthetic records (one
     1024 px, five cut from a 640-px one) reach five shape buckets
     (1024x1024, 1024x1408, 1408x1024, 1024x1728, 1024x2560); the FULL
     CategoryODISE of phase 3 serves them through OpenPanopticInference and
     evaluate_open_vocab with statistics on the card against COCO
     panoptic's 133 prompt-engineered labels. Per image it checks 6 kernel
     launches, the level shapes the kernel got, the output shapes for the
     bucket, finite results, no host fallback and the output checksums
     (``EVAL_SUMS``), and prints bucket, SD crops, request ms, PQ, mIoU and
     AP, twice over (the first pass meets each bucket's shapes for the
     first time); for two images it holds the statistics on the card
     against the same statistics on the CPU; it times the kernel on the
     widest bucket's inputs and traces one request there. Then a FULL
     CaptionODISE serves the 1024-px pattern image (checksum
     ``CAPTION_SUMS``) and the same six records;
  8. training: FULL CategoryODISE built for training (bf16 compute, float32
     trainable parameters, no CLIP head, slide training over serial
     checkpointed crops), its trainable count held to the JAX package's
     28,591,297; synthetic records through the LSJ mapper at 1024 px with
     100 instance slots; five optimizer steps with ``Trainer`` at batch 2
     (it fits: 12.2 GiB at peak on an NVIDIA H100 80GB HBM3, 700.00 W, so
     no accumulation): finite
     metrics, 6 forward and 6 backward kernel launches per image batch, the
     first step's loss held to ``TRAIN_SUMS``, grad_norm > 0, every frozen
     parameter bitwise unchanged; step times, peak memory, one warm step
     under the profiler; the backward kernel on the main path's own inputs
     timed cold and warm against its bound and the plain version; one TINY
     step on the card against the same step on the CPU, then again with
     two faults planted in the backward kernel, each of which that check
     must fail; two FULL CaptionODISE steps with the grounding loss. The
     backward kernel is timed on the training path's inputs and on a fresh
     encoder layer's (reference points plus the ring offsets a new
     MSDeformAttn starts from), each with its global reductions and the
     share of corners it summed on chip.
  9. the train and eval CLI: ``odise_torch.train_net.main`` on the port's
     ``configs/Panoptic/odise_label_coco_50e.py`` (FULL CategoryODISE with
     the CLIP head, float32 as the JAX modules' defaults compute, batch 2 at
     1024-px LSJ after ``auto_scale_workers`` on one card), on synthetic
     640-px records registered as ``_smoke_train`` and ``_smoke_val``: (a)
     4 steps with checkpoints every 2 and the final eval on 2 images (6
     forward launches per step and per image, 6 backward per step; finite
     metrics, grad_norm > 0, the frozen towers bitwise equal to a fresh
     seeded build, 28,591,297 trainable parameters, the checkpoints kept,
     the extra tasks skipped, their files absent); (b) ``--resume`` to 6 steps, which
     must start at iteration 4 with the optimizer's count at 4; (c)
     ``--eval-only --init-from model_final``, whose metrics (PQ, mIoU, AP
     and the rest) must equal (b)'s final eval;
 10. learning: first both kernels against their float64 plain versions at
     this phase's TINY shapes (float32, 4 heads of 8, batch 4, the category
     run's levels 4x4 to 16x16 and the caption run's 2x2 to 8x8), and the
     matcher's auction on the card, its rounds replayed as a CUDA graph,
     against the CPU's; then ``odise_torch.convergence.run_convergence`` on
     TINY models, CategoryODISE (100 steps over the serial checkpointed
     slide) and CaptionODISE (200 steps, grounding over the local batch),
     held to ``tests/test_convergence.py``'s thresholds: the loss drop, PQ,
     mIoU and AP after, their rise, and PQ before at chance; after each
     run both kernels again, on the inputs its first train step gave the
     first encoder layer;
 11. reference weights (``reference_weights_phase``): SD v1.3, OpenAI CLIP
     ViT-L/14 with the 336-px head's own state, and a released ODISE
     checkpoint's trainable set, generated in the reference's key layout
     from a seed (``tests/test_torch_convert.py``) and loaded through the
     port's converters: (a) ``model_zoo.get(trained=True)`` from an
     ``ODISE_MODEL_ZOO`` mirror, its 28,591,297 trainable parameters equal
     to the converted file, then SD and CLIP installed, the three
     checkpoints filling every tensor of the model once; (b) FULL
     CategoryODISE in float32 (TF32 off) against the JAX package's FULL
     float32 run on the same weights (``tests/data/torch_full_reference
     .npz``), every stage within its tolerance, 12 kernel launches; (c)
     ``odise_torch.demo.segment`` in bf16 on the 1024-px pattern image with
     COCO's 133 labels, then with ``--vocab`` merged in: 6 launches per
     image, finite outputs, a 1024x1024 map, ids in range, no more
     segments than queries classified as a label, ms per image first and
     warm, peak memory; (d) the forward kernel against float64 on
     the inputs (b) gave the first encoder layer;
 12. datasets from their files (``dataset_phase``): nvJPEG held against
     PIL's stored decodes of the JPEG fixtures and the demo images (PSNR
     and mean absolute error, ``tests/torch_jpeg_fixtures.py``) and timed; a
     COCO-layout dataset written under ``output/chip_smoke_dataset`` (the
     three 640x480 demo JPEGs as train and val images, seeded panoptic PNGs
     of COCO things and stuff with a crowd and a void, the semantic PNGs
     derived from them, the panoptic, instances (integer-vertex polygons,
     the crowd as compressed RLE) and captions jsons), every label file and
     instance mask read back equal to what was drawn; the caption split's
     captions through the caption mapper; ``python -m
     odise_torch.train_net``'s main in a subprocess with
     ``DETECTRON2_DATASETS`` on ``configs/Panoptic/odise_label_coco_50e.py``
     (FULL, float32, batch 2 at 1024-px LSJ): 4 steps and the final eval
     on ``coco_2017_val_panoptic_with_sem_seg``, 6+6 launches a step and 6
     an image, finite metrics, the extra tasks skipped with a warning (their
     files are absent); then the same val records, read by ``image_io`` and
     held in memory, evaluated here by ``model_final``: every metric equal
     to the file-backed eval; a main task with absent files raises.
 13. two ranks (``parallel_phase``; NCCL refuses two ranks on one card, so
     the two ranks share it over gloo, and NCCL runs at world size 1): (a)
     the collectives the port uses (all-reduce, the train step's mean
     all-reduce, the grounding loss's gather forward and backward and
     without gradients, ``all_gather_object``) on a one-rank NCCL group
     and on two gloo ranks, against the host's values, and what NCCL
     reports for two ranks on one card; (b) one FULL float32 step of phase
     8's recipe in one process at batch 2 and on two ranks of one image
     each (the one process's assignment of queries to targets and its
     importance-sampled points, which the pattern weights leave to float32
     noise; the ranks' own differences counted, and a one-process batch-1
     step's on each image beside them): each rank's uniform draws bitwise
     its rows of the one process's, the ranks' mean metrics within 1e-4,
     their gradients within 1e-3 of the one process's, both ranks bitwise
     equal, for CategoryODISE and CaptionODISE ("diff"); (c) ``train_net`` through
     ``launch`` on two ranks: the shipped COCO recipe on phase 12's files,
     3 steps at a total batch of 4, the final eval shared 2 + 1 over 3
     images, the ranks' parameters bitwise equal, only rank 0 writing,
     the merged metrics equal to a one-process ``--eval-only``.
 14. Stable Diffusion's text-to-image sampling and the rest of the JAX
     package's tools (``ldm_phase``): (a) TINY ``LatentDiffusion`` on the
     card against the CPU before the final clip (1e-3 of the largest
     magnitude); (b) FULL SD v1.3 (UNet 320, VAE 128, text 12 x 768) from
     weights in the reference's layout through the port's converter,
     float32 with TF32 off, 2 DDIM steps with guidance 7.5, against the
     JAX package's run on the same weights (``tests/data/
     torch_ldm_reference.npz``): both embeddings and the first step's eps
     within 1e-4 of JAX's largest magnitude, every later eps, latent and
     the image before the clip within 1e-3; (c) the same weights in bf16
     at the JAX module's defaults (50 DDIM steps, guidance 7.5, one prompt,
     512 px): first and warm image seconds, ms a DDIM step, the VAE
     decode's ms, peak memory, the image finite and in [0, 1]; (d)
     ``python -m odise_torch.analyze_model`` at FULL, 28,591,297 trainable;
     (e) the port's dataset scripts on a raw ADE20K layout (two demo JPEGs,
     drawn semantic and instance PNGs) and phase 12's COCO layout, their
     outputs read back through ``ade20k_panoptic_val`` and
     ``coco_2017_val_panoptic_with_sem_seg`` equal to what was drawn, the
     two prepared ADE20K images evaluated by the FULL CategoryODISE in bf16
     over ADE's 150 labels with instances on, their ground truth read from
     the prepared instance json (6 launches an image, finite PQ, mIoU and
     AP), and
     the semantic-PQ tool on the prepared COCO maps against themselves (PQ
     100). No PIL anywhere.
Phase 1 also builds the backward kernel and prints its launch plan, shared
memory and resident warps; phase 2 also holds it against the plain backward
run in float64, at the main path's levels on random, out-of-range,
pixel-centre, fresh-encoder and widely spread locations (where most corners
miss their block's window), at other level and point counts, and far out.
Where the backward summed the value gradient (global reductions, corners
summed on chip per level, rows flushed) is counted on the card by the
kernel's counting instantiation (``count_backward``) and must equal the
host's count from the locations and the plan (``backward_counts``).
Each phase prints its time. Then it prints the ``kernels`` JSON line and,
last, the ``ok`` line.
It needs a card and the repository around it, and exits non-zero without.
"""

import importlib
import json
import re
import subprocess
import sys
import time

import torch

# s5, s4, s3 of a 1024-px image, coarsest first as the pixel decoder orders them
SHAPES = [(32, 32), (64, 64), (128, 128)]
# the same levels in the widest and the tallest shape bucket
WIDE = [(32, 80), (64, 160), (128, 320)]
TALL = [(80, 32), (160, 64), (320, 128)]
HEADS, HEAD_DIM, POINTS = 8, 32, 4
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores
TIMING_ITERS = 100
WARM_ITERS = 200
# sum|mask_cls| + sum|mask_pred| per vocabulary size, recorded on an H100 with
# the pattern weights below; held to 1e-3 relative (bf16 through ~200 layers,
# other sum orders in a changed kernel)
LOGIT_SUMS = {133: 7.809334e6, 20: 7.750097e6}
# the same checksum for each of phase 7's six records with FULL
# CategoryODISE, and for CaptionODISE's K=133 pattern request
EVAL_SUMS = [7.810762e6, 7.809446e6, 1.072929e7, 1.072937e7, 1.331647e7, 1.959822e7]
CAPTION_SUMS = {133: 7.813043e6}
# phase 8: the first FULL CategoryODISE train step's total_loss, recorded on
# an H100 with the pattern weights and phase 8's data and seeds; held to 1e-3
# relative, as the checksums above
TRAIN_SUMS = {"category_first_total_loss": 1.665287e2}
TRAIN_STEPS, CAPTION_STEPS = 5, 2
# power-of-two level sizes, where float32 holds every pixel coordinate
# loc * w - 0.5 of a float32 location exactly, so the location gradient's
# jumps at whole pixels fall on the same side in float32 and float64
GENERIC = [(16, 32), (8, 16)]
# power-of-two levels whose finest (65,536 rows) is larger than the backward
# kernel's window (6,880 rows in bf16), so that widely spread samples miss it
SPREAD = [(32, 128), (64, 256), (128, 512)]
BWD_KERNEL = "ms_deform_attn_bwd_kernel"
# its template arguments: element type, chunk width in elements, of the
# production instantiation (not the one that counts)
BWD_KERNEL_ARGS = re.compile(BWD_KERNEL + r"<(\w+), (\d+), false>")
# phase 7's records: (rows, cols) cut from the 640-px one, after the 1024-px one
CUTS = [(640, 640), (480, 640), (640, 480), (384, 640), (256, 640)]
KERNEL = "ms_deform_attn_fwd_kernel"
# the template arguments in a launched kernel's name: element type, chunk
# width in elements, levels and points compiled in (0: any)
KERNEL_ARGS = re.compile(KERNEL + r"<(\w+), (\d+), (\d+), (\d+)>")
ELEMENT_BYTES = {"__nv_bfloat16": 2, "float": 4}


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def build_kernels():
    from odise_torch.ops import _build
    from odise_torch.ops.ms_deform_attn import backward_plan, launch_plan, resident_warps

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(names)
    log(f"built {names} in {time.perf_counter() - t0:.1f} s")
    for name in names:
        path = _build.build_log(name)
        text = path.read_text() if path.exists() else f"no nvcc log at {path}"
        for line in text.splitlines():
            if "entry function" in line or "spill" in line or "Used" in line:
                log(f"{name}: {line.strip()}")
    for dtype in (torch.float32, torch.bfloat16):
        for head_dim in (HEAD_DIM, 6):  # 16-byte chunks, one-element chunks
            for points in (POINTS, 3):  # the main path's counts, other counts
                plan = launch_plan(1, 1, HEADS, head_dim, dtype, len(SHAPES), points)
                log(f"ms_deform_attn <{str(dtype)[6:]}, chunk {plan.chunk_elems}, "
                    f"{'3 levels of 4 points' if plan.specialised else 'any counts'}>: "
                    f"{resident_warps(dtype, plan)} resident warps per SM "
                    f"in blocks of {plan.block_threads}")
            plan = backward_plan(2, sum(h * w for h, w in SHAPES), HEADS, head_dim, dtype,
                                 POINTS)
            log(f"ms_deform_attn backward <{str(dtype)[6:]}, chunk {plan.chunk_elems}> "
                f"({plan.threads_per_head} chunks a head on {plan.lanes_per_head} lanes): "
                f"{resident_warps(dtype, plan)} resident warps per SM in blocks of "
                f"{plan.block_threads}, {plan.queries_per_block} queries a block, a window "
                f"of {plan.window_rows} rows, {plan.smem_bytes} bytes of shared memory; "
                f"{plan.blocks} blocks at batch 2")


def reference_points(shapes, device="cuda"):
    """The encoder's reference points: every pixel centre of every level,
    normalised, levels in order (the pixel decoder's)."""
    ref = []
    for h, w in shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        ref.append(torch.stack([xx, yy], -1).reshape(h * w, 2))
    return torch.cat(ref)


def ring_offsets(shapes, points, heads=HEADS, head_dim=HEAD_DIM):
    """The sampling-offset bias a fresh MSDeformAttn starts from: head h on
    rings of 1 to ``points`` pixels in direction 2 pi h / heads, in each
    level's pixels; [heads, levels, points, 2]."""
    from odise_torch.models.decoder.pixel_decoder import MSDeformAttn

    mod = MSDeformAttn(heads * head_dim, len(shapes), heads, points)
    return mod.sampling_offsets.bias.detach().reshape(heads, len(shapes), points, 2)


def deform_inputs(kind, dtype, gen, shapes=SHAPES, batch=1, points=POINTS,
                  heads=HEADS, head_dim=HEAD_DIM):
    """Deformable-attention inputs on the card: ``heads`` heads of
    ``head_dim`` (FULL's 8 of 32 by default) over every
    query of the levels ``shapes``, at random, out-of-range or pixel-centre
    locations; or at the encoder's reference points plus the ring offsets
    a fresh MSDeformAttn starts from (``encoder_start``), or plus offsets of
    64 pixels' standard deviation, which scatter a block's samples beyond
    its window at a level larger than the window (``spread``)."""
    Lq = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = torch.randn((batch, Lq, heads, head_dim), generator=gen, device="cuda")
    shape = (batch, Lq, heads, L, points, 2)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device="cuda")[None, None, None, :, None, :]
    if kind == "random":
        loc = torch.rand(shape, generator=gen, device="cuda")
    elif kind == "out_of_range":
        loc = torch.rand(shape, generator=gen, device="cuda") * 2.0 - 0.5
    elif kind == "pixel_centres":  # x = loc * w - 0.5 is an integer, edges included
        idx = torch.floor(torch.rand(shape, generator=gen, device="cuda") * wh)
        loc = (idx + 0.5) / wh
    else:
        ref = reference_points(shapes)[None, :, None, None, None, :]
        if kind == "encoder_start":
            offsets = ring_offsets(shapes, points, heads, head_dim).cuda()[None, None]
        else:  # spread
            offsets = torch.randn(shape, generator=gen, device="cuda") * 64.0
        loc = (ref + offsets / wh).expand(shape).contiguous()
    logits = torch.randn((batch, Lq, heads, L * points), generator=gen, device="cuda")
    attn = torch.softmax(logits, -1).reshape(batch, Lq, heads, L, points)
    return value.to(dtype), loc, attn.to(dtype)


def tolerance(dtype, exact):
    """float32: 1e-5, another summation order of unit-scale terms. bf16:
    the kernel rounds its float32 sum to bf16 once; two bf16 ulps of the
    largest output."""
    if dtype == torch.float32:
        return 1e-5
    return 2 * float(exact.abs().max()) * 2.0 ** -8


def check_kernel(value, loc, attn, label, shapes=SHAPES):
    """The kernel and the plain version in float32, each against the plain
    version in float64 on the same inputs (the exact answer). The kernel may
    be off it by the plain version's own error plus ``tolerance``: float32
    cannot hold a pixel coordinate ``loc * w - 0.5`` exactly unless w is a
    power of two, and both round it (by up to 1.5e-5 pixel at a 320-pixel
    level), which alone moves an output by some 1e-5. Returns the kernel's
    error."""
    from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_torch

    out = ms_deform_attn(value, shapes, loc, attn)
    plain = ms_deform_attn_torch(value.float(), shapes, loc, attn.float())
    exact = ms_deform_attn_torch(value.double(), shapes, loc.double(), attn.double())
    torch.cuda.synchronize()
    err = float((out.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    tol = plain_err + tolerance(value.dtype, exact)
    log(f"kernel vs float64 [{label}]: max_abs_err {err:.3e}, plain version "
        f"{plain_err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"kernel disagrees with its plain version [{label}]")
    return err


def backward_counts_line(value, loc, attn, grad_out, shapes):
    """What the backward kernel did with the value gradient on these inputs
    under its launch plan, counted on the card by the kernel's counting
    instantiation (``count_backward``) and held to the host's count from the
    locations and the plan (``backward_counts``): printed, and returned."""
    from odise_torch.ops.ms_deform_attn import backward_counts, backward_plan, count_backward

    B, Lq, H = loc.shape[:3]
    plan = backward_plan(B, Lq, H, value.shape[-1], value.dtype, loc.shape[4])
    counts = count_backward(value, shapes, loc, attn, grad_out, plan)
    host = backward_counts(loc, shapes, plan)
    if counts != host:
        raise AssertionError(f"the backward kernel counted {counts}, the host {host}")
    log(f"  value-gradient reductions, counted by the kernel (the host's count "
        f"agrees): {counts.global_reductions:,} global "
        f"({counts.direct_reductions:,} with every corner reduced in global memory, "
        f"{counts.direct_reductions / max(counts.global_reductions, 1):.2f}x); corners "
        f"kept in shared memory per level " + ", ".join(
            f"{s:.4f}" for s in counts.in_shared_share)
        + f"; rows flushed per level {list(counts.flushed_rows)}")
    return counts


def check_backward(value, loc, attn, label, shapes=SHAPES, gen=None):
    """The backward kernel and the plain backward in float32, each against
    the plain backward in float64 on the same inputs and a random grad_out.
    For each gradient the kernel may be off float64 by the float32 plain
    version's own error plus 1e-5 of the largest gradient (bf16: plus two
    bf16 ulps of it, the kernel rounds its float32 sums once). Prints where
    the kernel summed the value gradient (``backward_counts_line``).
    Returns the kernel's largest error and that count."""
    from odise_torch.ops.ms_deform_attn import (ms_deform_attn_backward,
                                                ms_deform_attn_backward_torch)

    B, Lq, H = loc.shape[:3]
    grad_out = torch.randn((B, Lq, H * value.shape[-1]), generator=gen,
                           device="cuda").to(value.dtype)
    got = ms_deform_attn_backward(value, shapes, loc, attn, grad_out)
    plain = ms_deform_attn_backward_torch(value.float(), shapes, loc, attn.float(),
                                          grad_out.float())
    exact = ms_deform_attn_backward_torch(value.double(), shapes, loc.double(),
                                          attn.double(), grad_out.double())
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, p, e in zip(("value", "locations", "weights"), got, plain, exact):
        err = float((g.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        scale = float(e.abs().max())
        rel = 1e-5 if value.dtype == torch.float32 else 2 * 2.0 ** -8
        tol = plain_err + rel * scale
        log(f"backward vs float64 [{label}] grad {name}: max_abs_err {err:.3e}, plain "
            f"{plain_err:.3e}, largest {scale:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"backward kernel disagrees with its plain version "
                                 f"[{label}, grad {name}]")
        worst = max(worst, err)
    return worst, backward_counts_line(value, loc, attn, grad_out, shapes)


def check_backward_far_out(dtype, gen):
    """Every sample at +-1e6: all three gradients exactly 0. Then one level
    far out: that level's weight and location gradients exactly 0."""
    from odise_torch.ops.ms_deform_attn import ms_deform_attn_backward

    value, loc, attn = deform_inputs("random", dtype, gen, batch=2)
    far = torch.where(torch.rand(loc.shape, generator=gen, device="cuda") < 0.5,
                      -1e6, 1e6).to(torch.float32)
    grad_out = torch.randn((2, loc.shape[1], HEADS * HEAD_DIM), generator=gen,
                           device="cuda").to(dtype)
    got = ms_deform_attn_backward(value, SHAPES, far, attn, grad_out)
    one = loc.clone()
    one[:, :, :, 1] = far[:, :, :, 1]
    _, g_loc, g_attn = ms_deform_attn_backward(value, SHAPES, one, attn, grad_out)
    torch.cuda.synchronize()
    zero = [int((g != 0).sum()) for g in got] + [
        int((g_loc[:, :, :, 1] != 0).sum()), int((g_attn[:, :, :, 1] != 0).sum())]
    log(f"backward at +-1e6 [{str(dtype)[6:]}]: nonzero gradient elements {zero} "
        "(value, locations, weights; the far level's locations, weights)")
    if any(zero):
        raise AssertionError("far-out samples gave a gradient other than 0")


def time_cold(fn, iters=TIMING_ITERS):
    """Mean ms per call, each call timed alone with CUDA events after the
    L2 (50 MB) is overwritten: the time with none of the inputs cached. On
    the main path the layers just before the call have written its inputs,
    so they are largely in L2 (``time_warm`` and phase 5)."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def time_warm(fn, iters=WARM_ITERS):
    """Mean ms per call over `iters` calls back to back on the same inputs,
    which then stay in L2."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_request(request_fn, inference=True, kernel=KERNEL):
    """One request (or train step), ``request_fn()``, under torch.profiler
    (CPU and CUDA activity). Prints the ten device kernels that take the
    most time and the device's idle share over the request; returns the
    launches of the kernels whose name holds ``kernel`` as (kernel name,
    device ms)."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("request"):
            request_fn()
    events = prof.events()
    window = [e.time_range for e in events
              if e.name == "request" and e.device_type == DeviceType.CPU]
    # device work only: not the ranges that record_function annotates on the
    # device timeline (the request itself, the optimizer's step)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "request" and not getattr(e, "is_user_annotation", False)]
    if len(window) != 1 or not device:
        raise AssertionError(f"the profiler recorded {len(window)} request "
                             f"windows and {len(device)} device events")
    w0, w1 = window[0].start, window[0].end
    by_name, busy, edge = {}, 0.0, w0
    for e in sorted(device, key=lambda e: e.time_range.start):
        t0, t1 = max(e.time_range.start, edge), min(e.time_range.end, w1)
        if t1 > t0:
            busy += t1 - t0
            edge = t1
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + e.time_range.elapsed_us())
    total = sum(tot for _, tot in by_name.values())
    log(f"profiled request: {(w1 - w0) / 1e3:.3f} ms on the host clock, "
        f"device busy {busy / 1e3:.3f} ms, idle share {1 - busy / (w1 - w0):.4f}; "
        f"{len(device)} device events, {total / 1e3:.3f} ms of device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    for name, (n, tot) in top:
        log(f"  {tot / 1e3:9.3f} ms {100 * tot / total:5.1f}% {n:5d}x  {name[:110]}")
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in device
            if kernel in e.name]


def deform_bound_ms(value, loc, attn, shapes=SHAPES):
    """Least time for the card: each input read once and the output written
    once at the HBM rate, or the float32 multiply-adds over the corners
    that this data puts inside their level, whichever is larger."""
    elem = value.element_size()
    n_bytes = (value.numel() * elem + loc.numel() * 4 + attn.numel() * elem
               + value.numel() // value.shape[1] * loc.shape[1] * elem)
    corners = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        for dx in (0, 1):
            for dy in (0, 1):
                inside = ((x0 + dx >= 0) & (x0 + dx <= w - 1)
                          & (y0 + dy >= 0) & (y0 + dy <= h - 1))
                corners += int(inside.sum())
    flops = corners * HEAD_DIM * 2
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    log(f"bound: {n_bytes / 1e6:.1f} MB -> {t_bytes * 1e3:.1f} us; "
        f"{flops / 1e9:.3f} GFLOP -> {t_ops * 1e3:.1f} us")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pattern_fill_(model):
    """0.02 * sin(0.001 * i), i running over all parameters in order."""
    i = 0
    with torch.no_grad():
        for p in model.parameters():
            idx = torch.arange(i, i + p.numel(), dtype=torch.float64, device=p.device)
            p.copy_((0.02 * torch.sin(0.001 * idx)).reshape(p.shape))
            i += p.numel()
    return i


def pattern_image(size, device):
    n = size * size * 3
    x = torch.arange(n, dtype=torch.float32, device=device)
    return (0.5 + 0.5 * torch.sin(x * 0.37)).reshape(1, size, size, 3)


def vocabulary(n_things, n_stuff, tag):
    labels = tuple((f"{tag} {i}",) for i in range(n_things + n_stuff))
    thing = torch.tensor([True] * n_things + [False] * n_stuff)
    return labels, thing


def serve(model, requests, image, train_labels):
    """One request: encode the vocabulary, run the trunk and the head, fuse.
    Returns per-request records."""
    from odise_torch.models.clip.tokenizer import tokenize
    from odise_torch.models.inference import panoptic_inference, semantic_inference
    from odise_torch.models.odise import category_overlapping_mask

    device = image.device
    records = []
    for labels, thing in requests:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        names = [l[0] for l in labels]
        text = model.encode_vocab(torch.from_numpy(tokenize(names)).long().to(device))
        clip_text = model.encode_vocab(torch.from_numpy(
            tokenize([f"a photo of a {n}." for n in names])).long().to(device))
        overlap = torch.from_numpy(
            category_overlapping_mask(train_labels, labels)).to(device)
        trunk = model.forward_eval_trunk(image)
        mask_cls = model.forward_eval_head(trunk, text, labels, clip_text,
                                           labels, overlap)
        mask_pred = trunk["mask_pred"]
        sem = semantic_inference(mask_cls[0], mask_pred[0])
        pan = panoptic_inference(mask_cls[0], mask_pred[0], thing,
                                 object_mask_threshold=0.0, overlap_threshold=0.8)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        Q, K = model.num_queries, len(labels)
        H, W = image.shape[1:3]
        if tuple(mask_cls.shape) != (1, Q, K + 1) or tuple(mask_pred.shape) != (1, Q, H, W):
            raise AssertionError(f"shapes {tuple(mask_cls.shape)} {tuple(mask_pred.shape)}")
        for name, t in (("mask_cls", mask_cls), ("mask_pred", mask_pred), ("sem", sem)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} is not finite")
        records.append(dict(
            ms=ms, K=K,
            logit_sum=float(mask_cls.float().abs().sum() + mask_pred.float().abs().sum()),
            sem_sum=float(sem.float().sum()),
            segments=int(pan.num_segments),
            mask_cls=mask_cls, mask_pred=mask_pred))
    return records


def coco_cut(rec, rows, cols):
    """A synthetic record cut to ``rows`` x ``cols``, its classes (cat, dog,
    grass) mapped onto COCO panoptic's."""
    import numpy as np

    from odise_torch.data.build import coco_panoptic_categories
    from odise_torch.data.synthetic import SYNTH_LABELS

    names = [c["name"] for c in coco_panoptic_categories()]
    to_coco = np.asarray([names.index(l[0]) for l in SYNTH_LABELS], np.uint8)
    out = dict(rec, image=rec["image"][:rows, :cols], pan_seg=rec["pan_seg"][:rows, :cols],
               sem_seg=to_coco[rec["sem_seg"][:rows, :cols]])
    present = set(np.unique(out["pan_seg"]).tolist())
    out["segments_info"] = [dict(s, category_id=int(to_coco[s["category_id"]]))
                            for s in rec["segments_info"] if s["id"] in present]
    return out


def eval_records():
    """Phase 7's records: one 1024-px synthetic record, and five cut from a
    640-px one (``CUTS``), on COCO panoptic's classes."""
    from odise_torch.data.synthetic import make_shapes_records

    big = make_shapes_records(1, size=1024, seed=0)[0]
    small = make_shapes_records(1, size=640, seed=1)[0]
    return [coco_cut(big, 1024, 1024)] + [coco_cut(small, r, c) for r, c in CUTS]


class Layer0Inputs:
    """A pre-hook on the pixel decoder's first encoder layer: the level
    shapes of every call, and the arguments of the first call at each set of
    level shapes."""

    def __init__(self, model):
        self.layer = model.sem_seg_head.pixel_decoder.encoder_layer_0
        self.levels, self.first = [], {}
        self.hook = self.layer.register_forward_pre_hook(self._record)

    def _record(self, mod, args):
        levels = [tuple(int(x) for x in s) for s in args[3]]
        self.levels.append(levels)
        self.first.setdefault(tuple(levels), args)


def kernel_on_inputs(layer0, shapes, label):
    """The kernel on the inputs the main path gave the first encoder layer
    at the level shapes ``shapes``: held against the plain version, timed
    cold and warm beside the plain version, and its bound. Returns those
    numbers and the kernel's inputs."""
    from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_torch

    src, pos, ref_points, levels = layer0.first[tuple(shapes)]
    with torch.inference_mode():
        v, loc, attn = layer0.layer.self_attn.sampling_inputs(src + pos, ref_points,
                                                              src, levels)
        err = check_kernel(v, loc, attn, label, shapes)
        cold = time_cold(lambda: ms_deform_attn(v, shapes, loc, attn))
        warm = time_warm(lambda: ms_deform_attn(v, shapes, loc, attn))
        plain = time_cold(lambda: ms_deform_attn_torch(v, shapes, loc, attn))
        bound, bound_by = deform_bound_ms(v, loc, attn, shapes)
    log(f"deform attn on {label} ({loc.shape[1]} queries): kernel {cold:.4f} ms cold, "
        f"{warm:.4f} ms warm, plain {plain:.4f} ms, bound {bound:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=cold, warm_ms=warm, plain_ms=plain,
                bound_ms=bound, bound_by=bound_by), (v, loc, attn)


class Recorder:
    """Wraps an OpenPanopticInference. Per call it keeps the padded shape,
    the output shapes, their checksum and finiteness, the SD crops and the
    level shapes the deformable attention got (``layer0``); the outputs
    themselves only for the calls listed in ``keep``, and the padded images
    of the first call whose levels are ``WIDE``."""

    def __init__(self, infer, keep=()):
        self.infer, self.model, self.keep = infer, infer.model, set(keep)
        self.calls, self.kept, self.crops = [], {}, []
        self.wide_images = None
        self.layer0 = Layer0Inputs(infer.model)
        self.hooks = [
            infer.model.backbone.feature_extractor.register_forward_pre_hook(
                lambda mod, args: self.crops.append(int(args[0].shape[0]))),
            self.layer0.hook]

    def __call__(self, images):
        mask_cls, mask_pred = self.infer(images)
        i = len(self.calls)
        self.calls.append(dict(
            bucket=tuple(images.shape[1:3]), cls_shape=tuple(mask_cls.shape),
            pred_shape=tuple(mask_pred.shape),
            checksum=float(mask_cls.float().abs().sum() + mask_pred.float().abs().sum()),
            finite=bool(torch.isfinite(mask_cls).all() and torch.isfinite(mask_pred).all())))
        if i in self.keep:
            self.kept[i] = (mask_cls, mask_pred)
        if self.layer0.levels[-1] == WIDE and self.wide_images is None:
            self.wide_images = images
        return mask_cls, mask_pred

    def remove(self):
        for h in self.hooks:
            h.remove()


def expected_bucket(rec):
    from odise_torch.data.transforms import ResizeShortestEdge
    from odise_torch.evaluation.buckets import compute_eval_buckets, pick_bucket

    h, w = ResizeShortestEdge(1024, 2560).output_size(*rec["image"].shape[:2])
    return pick_bucket(-(-h // 64) * 64, -(-w // 64) * 64, compute_eval_buckets())


def evaluate_records(recorder, records, labels, thing, tag, want_sums):
    """evaluate_open_vocab on each record alone, timed from the host with a
    synchronize on either side; every check of phase 7 on each image.
    Returns the kernel launches."""
    import math

    from odise_torch.evaluation.run import evaluate_open_vocab
    from odise_torch.ops.ms_deform_attn import ms_deform_attn

    Q, K = recorder.model.num_queries, len(labels)
    ms_deform_attn.launches = 0
    for i, rec in enumerate(records):
        before = ms_deform_attn.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = evaluate_open_vocab(recorder, [rec], labels=labels, thing_mask=thing)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        call, crops = recorder.calls[-1], recorder.crops[-1]
        levels = recorder.layer0.levels[-1]
        bh, bw = call["bucket"]
        log(f"{tag} image {i} ({rec['image'].shape[0]}x{rec['image'].shape[1]}): bucket "
            f"{bh}x{bw}, {crops} SD crops, levels {levels}, {ms:.1f} ms (evaluate_open_vocab "
            f"{r['s_per_img'] * 1e3:.1f} ms), PQ {r['PQ']:.4f} mIoU {r['mIoU']:.4f} "
            f"AP {r['AP']:.4f}, checksum {call['checksum']:.6e}")
        short = min(bh, bw)
        faults = [
            (ms_deform_attn.launches - before != 6, "kernel launches other than 6"),
            (call["bucket"] != expected_bucket(rec), f"bucket, not {expected_bucket(rec)}"),
            (call["cls_shape"] != (1, Q, K + 1) or call["pred_shape"] != (1, Q, bh, bw),
             f"output shapes {call['cls_shape']} {call['pred_shape']}"),
            (levels != [(bh // s, bw // s) for s in (32, 16, 8)], "level shapes"),
            (crops != -(-(max(bh, bw) - short) // short) + 1, "SD crop count"),
            (not call["finite"], "outputs not finite"),
            (not all(math.isfinite(v) for v in r.values()), f"results not finite: {r}"),
            (r.get("host_fallback_images") != 0 or r["images"] != 1, "host fallback")]
        if want_sums is not None:
            faults.append((not abs(call["checksum"] - want_sums[i]) <= 1e-3 * want_sums[i],
                           f"checksum not within 1e-3 of the recorded {want_sums[i]:.6e}"))
        for bad, what in faults:
            if bad:
                raise AssertionError(f"{tag} image {i}: {what}")
    return ms_deform_attn.launches


def pixel_maps(mask_cls, mask_pred, src_hw, orig_hw, grid, thing, model):
    """The per-pixel maps behind the statistics: semantic labels, panoptic
    ids and instance masks on the output grid."""
    from odise_torch.evaluation.device_eval import _sem_labels, resize_chw
    from odise_torch.models.inference import instance_inference, panoptic_inference

    masks_r = resize_chw(mask_pred, src_hw, orig_hw, grid)
    pan = panoptic_inference(mask_cls, masks_r, thing, model.object_mask_threshold,
                             model.overlap_threshold, valid_hw=orig_hw)
    inst = instance_inference(mask_cls, masks_r, thing, model.test_topk_per_image,
                              valid_hw=orig_hw)
    return {"semantic labels": _sem_labels(mask_cls, masks_r),
            "panoptic ids": pan.panoptic_seg, "instance masks": inst.masks}


def stats_card_vs_cpu(outputs, rec, labels, thing_np, model):
    """DeviceEvalRunner on the card and on the CPU (the outputs copied to the
    host) for one image's outputs and gt. Where a threshold flips pixels of
    a map, at most 1e-4 of the grid's pixels in each map (over all top-k
    instance masks together), each statistic may differ by what the flips
    of its own map explain and no more: a flipped pixel moves one count
    from one cell to another of the confusion matrix (semantic labels) or
    of ``pan_counts`` (panoptic ids), and changes one detection's area and
    its intersection with the one gt instance there by one (instance masks;
    gt instances are disjoint). Integer statistics must be equal save that;
    the float intersections and areas may also differ by 1e-5 of their
    total, and the instance scores by 1e-5 relative. The segment tables,
    instance classes and gt areas must be equal."""
    import numpy as np

    from odise_torch.data.transforms import ResizeShortestEdge
    from odise_torch.evaluation.buckets import compute_eval_buckets
    from odise_torch.evaluation.device_eval import DeviceEvalRunner, pick_grid
    from odise_torch.evaluation.run import prep_record

    p = prep_record(rec, ResizeShortestEdge(1024, 2560), compute_eval_buckets(), thing_np)
    src, orig = (p["h"], p["w"]), (p["oh"], p["ow"])
    grid = pick_grid(*orig)
    gts = dict(sem_gt=p["sem_gt"], pan_gt_ids=p["gt_ids"],
               pan_seg_ids=np.asarray([s["id"] for s in p["gt_segments"]], np.uint32),
               inst_gt_masks=p["inst_gt_masks"])
    got = []
    for dev in (outputs[0].device, torch.device("cpu")):
        mask_cls, mask_pred = (o[0].to(dev) for o in outputs)
        runner = DeviceEvalRunner(
            num_classes=len(labels), thing_mask=thing_np,
            object_mask_threshold=model.object_mask_threshold,
            overlap_threshold=model.overlap_threshold, topk=model.test_topk_per_image)
        t0 = time.perf_counter()
        stats = runner.process(mask_cls, mask_pred, src, orig, **gts)
        stats["confusion"] = runner.flush_confusion()
        secs = time.perf_counter() - t0
        maps = pixel_maps(mask_cls, mask_pred, src, orig, grid,
                          torch.from_numpy(thing_np), model)
        got.append((stats, {k: v.cpu() for k, v in maps.items()}))
        log(f"  statistics on the {dev}: {secs:.2f} s")
    (card, card_maps), (cpu, cpu_maps) = got
    n = grid[0] * grid[1]
    flips = {k: int((card_maps[k] != cpu_maps[k]).sum()) for k in card_maps}
    log(f"  grid {grid[0]}x{grid[1]}, original {orig[0]}x{orig[1]}: pixels that differ "
        f"between card and CPU: {flips} (limit {1e-4 * n:.0f} per map)")
    if any(f > 1e-4 * n for f in flips.values()):
        raise AssertionError("the card and the CPU differ on too many pixels")
    sem, pan, inst = (flips[k] for k in ("semantic labels", "panoptic ids",
                                         "instance masks"))
    slack = {"confusion": 2 * sem, "pan_counts": 2 * pan,
             "inst_inter": inst, "inst_dt_area": inst}
    if set(card) != set(cpu):
        raise AssertionError(f"statistics {sorted(card)} on the card, {sorted(cpu)} on the CPU")
    for key, want in cpu.items():
        have, want = np.asarray(card[key], np.float64), np.asarray(want, np.float64)
        if have.shape != want.shape:
            raise AssertionError(f"statistic {key}: shape {have.shape} on the card, "
                                 f"{want.shape} on the CPU")
        if key == "inst_scores":
            err = float(np.abs(have - want).max(initial=0)
                        / max(np.abs(want).max(initial=0), 1e-30))
            limit, what = 1e-5, "max relative difference"
        else:
            err = float(np.abs(have - want).sum())
            limit, what = slack.get(key, 0), "sum of |differences|"
            if key in ("inst_inter", "inst_dt_area", "inst_gt_area"):
                limit += 1e-5 * float(np.abs(want).sum())
        log(f"  {key}: card vs CPU {what} {err:.3e} (limit {limit:.3e})")
        if not err <= limit:
            raise AssertionError(f"statistic {key} on the card disagrees with the CPU")


def widest_bucket_kernel(recorder):
    """The kernel on the inputs the 1024x2560 bucket gave the first encoder
    layer (``kernel_on_inputs``), and its in-place time in one more traced
    request on that bucket."""
    numbers, (_, loc, _) = kernel_on_inputs(recorder.layer0, WIDE,
                                            "1024x2560 bucket inputs, bfloat16")
    in_place = profile_request(lambda: recorder.infer(recorder.wide_images))
    if len(in_place) != 6:
        raise AssertionError(f"{len(in_place)} {KERNEL} launches in one request")
    in_place_ms = sum(ms for _, ms in in_place) / len(in_place)
    log(f"deform attn at the 1024x2560 bucket: {in_place_ms:.4f} ms in place")
    return dict(bucket=[1024, 2560], shapes=WIDE, queries=int(loc.shape[1]),
                in_place_ms=in_place_ms, **numbers)


def eval_category(model, records, labels, thing):
    """Phase 7 with the FULL CategoryODISE of phase 3. Returns the kernel's
    numbers at the widest bucket and the evaluation's kernel launches."""
    from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary

    torch.cuda.reset_peak_memory_stats()
    vocab = build_open_vocabulary(model, labels, thing_mask=thing)
    recorder = Recorder(OpenPanopticInference(model, vocab), keep=(0, 5))
    # the first pass is the first use of each bucket's shapes, the second warm
    launches = sum(evaluate_records(recorder, records, labels, thing,
                                    f"CategoryODISE pass {n}", EVAL_SUMS) for n in (1, 2))
    log(f"CategoryODISE: {launches} kernel launches over {2 * len(records)} images, "
        f"peak memory allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log("checksums: EVAL_SUMS = [" + ", ".join(
        f"{c['checksum']:.6e}" for c in recorder.calls[:len(records)]) + "]")
    for i in sorted(recorder.kept):
        log(f"statistics on the card vs the CPU, image {i}:")
        stats_card_vs_cpu(recorder.kept[i], records[i], labels, thing, model)
    largest = widest_bucket_kernel(recorder)
    recorder.remove()
    return largest, launches


def eval_caption(records, labels, thing, image):
    """Phase 7 with a FULL CaptionODISE (pattern weights, bf16): the 1024-px
    pattern request with a 133-label pattern vocabulary, then the records.
    Returns the evaluation's kernel launches."""
    from odise_torch.model_zoo.factory import build_caption_odise
    from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary
    from odise_torch.ops.ms_deform_attn import ms_deform_attn

    t0 = time.perf_counter()
    model = build_caption_odise("full", device="cuda", dtype=torch.bfloat16)
    n_params = pattern_fill_(model)
    torch.cuda.synchronize()
    log(f"FULL CaptionODISE: {n_params / 1e9:.3f} B parameters, built and filled in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = 0
    with torch.inference_mode():
        r = serve(model, [vocabulary(80, 53, "category")], image, model.train_labels)[0]
    log(f"CaptionODISE K=133 pattern request: {r['ms']:.1f} ms, logit_sum "
        f"{r['logit_sum']:.6e}, sem_sum {r['sem_sum']:.6e}, segments {r['segments']}; "
        f"checksum: CAPTION_SUMS = {{133: {r['logit_sum']:.6e}}}")
    if ms_deform_attn.launches != 6:
        raise AssertionError(f"{ms_deform_attn.launches} kernel launches for one image")
    if not abs(r["logit_sum"] - CAPTION_SUMS[133]) <= 1e-3 * CAPTION_SUMS[133]:
        raise AssertionError(f"CaptionODISE logit_sum {r['logit_sum']:.6e} is not within "
                             f"1e-3 of the recorded {CAPTION_SUMS[133]:.6e}")
    vocab = build_open_vocabulary(model, labels, thing_mask=thing)
    recorder = Recorder(OpenPanopticInference(model, vocab))
    launches = evaluate_records(recorder, records, labels, thing, "CaptionODISE", None)
    recorder.remove()
    log(f"CaptionODISE: {launches} kernel launches over {len(records)} images, peak "
        f"memory allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return launches


def backward_bound_ms(value, loc, attn, shapes=SHAPES):
    """Least time for the card for the backward: value, locations, weights
    and grad_out read once and the three gradients written once at the HBM
    rate, or its float32 operations, whichever is larger. The weight
    gradient and both location sums follow from the four corner dot
    products sum_c g_c v_kc: 8 operations per sample and channel; the value
    gradient takes a multiply and an add per inside corner and channel."""
    elem = value.element_size()
    samples = loc.numel() // 2
    n_bytes = (2 * value.numel() * elem + 2 * loc.numel() * 4 + 2 * attn.numel() * elem
               + value.numel() // value.shape[1] * loc.shape[1] * elem)
    corners = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5)
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5)
        for dx in (0, 1):
            for dy in (0, 1):
                corners += int(((x0 + dx >= 0) & (x0 + dx <= w - 1)
                                & (y0 + dy >= 0) & (y0 + dy <= h - 1)).sum())
    flops = (samples * 8 + corners * 2) * value.shape[-1]
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    log(f"backward bound: {n_bytes / 1e6:.1f} MB -> {t_bytes * 1e3:.1f} us; "
        f"{flops / 1e9:.3f} GFLOP -> {t_ops * 1e3:.1f} us")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def training_inputs(layer0):
    """The deformable-attention inputs the training path gave the first
    encoder layer (its first call)."""
    src, pos, ref_points, levels = layer0.first[tuple(SHAPES)]
    with torch.no_grad():
        return layer0.layer.self_attn.sampling_inputs((src + pos).detach(), ref_points,
                                                      src.detach(), levels)


def encoder_start_inputs(batch=2):
    """The first encoder layer's deformable-attention inputs in a model at
    the start of training: a fresh bf16 MSDeformAttn (seeded; offsets on
    its rings of 1 to 4 pixels, uniform attention weights) at the encoder's
    reference points of a 1024-px image, on random query and value features."""
    from odise_torch.models.decoder.pixel_decoder import MSDeformAttn

    torch.manual_seed(0)
    mod = MSDeformAttn(HEADS * HEAD_DIM, len(SHAPES), HEADS, POINTS,
                       dtype=torch.bfloat16).cuda()
    Lq = sum(h * w for h, w in SHAPES)
    gen = torch.Generator(device="cuda").manual_seed(6)
    query, value = (torch.randn((batch, Lq, HEADS * HEAD_DIM), generator=gen,
                                device="cuda").to(torch.bfloat16) for _ in range(2))
    ref = reference_points(SHAPES)[None, :, None, :].expand(batch, Lq, len(SHAPES), 2)
    with torch.no_grad():
        return mod.sampling_inputs(query, ref, value, SHAPES)


def backward_on_inputs(v, loc, attn, label):
    """The backward kernel on these inputs with a random grad_out: held
    against the plain backward, timed cold and warm beside the plain
    backward, its bound, and where it summed the value gradient."""
    from odise_torch.ops.ms_deform_attn import (launch_backward,
                                                ms_deform_attn_backward_torch)

    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(5)
        err, counts = check_backward(v, loc, attn, label, SHAPES, gen)
        grad_out = torch.randn((loc.shape[0], loc.shape[1], v.shape[2] * v.shape[3]),
                               generator=gen, device="cuda").to(v.dtype)
        cold = time_cold(lambda: launch_backward(v, SHAPES, loc, attn, grad_out))
        warm = time_warm(lambda: launch_backward(v, SHAPES, loc, attn, grad_out))
        plain = time_cold(lambda: ms_deform_attn_backward_torch(v, SHAPES, loc, attn,
                                                                grad_out), iters=20)
        bound, bound_by = backward_bound_ms(v, loc, attn)
    log(f"deform attn backward on {label} (batch {loc.shape[0]}, {loc.shape[1]} queries): "
        f"kernel {cold:.4f} ms cold, {warm:.4f} ms warm, plain {plain:.4f} ms, bound "
        f"{bound:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=cold, warm_ms=warm, plain_ms=plain, bound_ms=bound,
                bound_by=bound_by, global_reductions=counts.global_reductions,
                direct_reductions=counts.direct_reductions,
                in_shared_share=list(counts.in_shared_share))


def train_loader(size, with_captions, seed):
    """Phase 8's data: synthetic records of ``size`` px through the LSJ
    mapper at 1024 px with 100 instance slots, batches of 2 on the card."""
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_train_loader
    from odise_torch.data.synthetic import make_shapes_records

    records = make_shapes_records(4, size=size, seed=seed, with_captions=with_captions,
                                  vary=with_captions)
    mapper = COCOPanopticDatasetMapper(image_size=1024, max_instances=100,
                                       with_captions=with_captions, device="cuda")
    return build_train_loader(records, mapper, 2, seed=seed)


class TimedStep:
    """A train step timed from the host with a synchronize on either side,
    with the forward and backward kernel launches of each call."""

    def __init__(self, step):
        self.step, self.ms, self.launches = step, [], []

    def __call__(self, batch, generator):
        from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_backward

        f0, b0 = ms_deform_attn.launches, ms_deform_attn_backward.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = self.step(batch, generator)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.launches.append((ms_deform_attn.launches - f0,
                              ms_deform_attn_backward.launches - b0))
        return metrics


def build_for_training(build, labels=None, dtype=torch.bfloat16):
    """A FULL model for training on the card: ``dtype`` compute, no CLIP
    head, slide training over serial checkpointed crops; the towers frozen,
    then the pattern weights."""
    from odise_torch.engine import partition_params

    kw = {} if labels is None else dict(train_labels=labels)
    model = build("full", with_clip_head=False, use_checkpoint=True, slide_training=True,
                  slide_serial=True, device="cuda", dtype=dtype, **kw)
    trainable, frozen = partition_params(model)
    pattern_fill_(model)
    return model, trainable, frozen


def train_category(labels):
    """Phase 8's FULL CategoryODISE steps. Returns the numbers the kernels
    line and PERF.md take."""
    import statistics

    from odise_torch.engine import Trainer, make_category_train_step, make_optimizer
    from odise_torch.losses import CriterionConfig
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.models.clip.tokenizer import tokenize
    from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_backward

    t0 = time.perf_counter()
    model, trainable, frozen = build_for_training(build_category_odise, labels)
    n_train = sum(p.numel() for p in trainable.values())
    log(f"FULL CategoryODISE for training: {n_train:,} trainable parameters in "
        f"{len(trainable)} tensors (float32), {sum(p.numel() for p in frozen.values()):,} "
        f"frozen; built in {time.perf_counter() - t0:.1f} s")
    if n_train != 28_591_297:
        raise AssertionError(f"{n_train} trainable parameters, not the JAX package's "
                             "28,591,297")
    with torch.no_grad():
        text = model.encode_vocab(torch.from_numpy(
            tokenize([l[0] for l in labels])).long().cuda())
    frozen_before = {k: p.detach().clone() for k, p in frozen.items()}
    cfg = CriterionConfig(num_classes=len(labels))
    layer0 = Layer0Inputs(model)
    data = train_loader(640, False, 0)
    batch0 = next(data)

    def loader():
        yield batch0
        yield from data

    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = make_optimizer(trainable, lr=1e-4, weight_decay=0.05)
    timed = TimedStep(make_category_train_step(model, opt, cfg, text, labels,
                                               grad_clip=0.01))
    trainer = Trainer(timed, loader(), gen)
    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn_backward.launches = 0
    trainer.train(0, TRAIN_STEPS)
    launches = (ms_deform_attn.launches, ms_deform_attn_backward.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    layer0.hook.remove()
    hist = trainer.metrics_history
    for i, (m, ms, ln) in enumerate(zip(hist, timed.ms, timed.launches)):
        log(f"category step {i}: {ms:.1f} ms, total_loss {m['total_loss']:.6e}, grad_norm "
            f"{m['grad_norm']:.4e}, loss_ce {m['loss_ce']:.4f}, loss_mask "
            f"{m['loss_mask']:.4f}, loss_dice {m['loss_dice']:.4f}, deform-attn "
            f"launches forward {ln[0]}, backward {ln[1]}")
    first_ms, warm_ms = timed.ms[0], statistics.median(timed.ms[1:])
    log(f"category training (batch 2): first step {timed.ms[0]:.1f} ms, warm step "
        f"{warm_ms:.1f} ms (median of steps 2 to {TRAIN_STEPS}), peak memory allocated "
        f"{peak:.2f} GiB; checksum: TRAIN_SUMS = "
        f"{{'category_first_total_loss': {hist[0]['total_loss']:.6e}}}")
    faults = [(any(ln != (6, 6) for ln in timed.launches),
               "deform-attn launches other than 6 forward and 6 backward per image batch"),
              (not all(m["grad_norm"] > 0 for m in hist), "grad_norm 0"),
              (len(hist) != TRAIN_STEPS, f"{len(hist)} steps")]
    want = TRAIN_SUMS["category_first_total_loss"]
    if want is not None:
        faults.append((not abs(hist[0]["total_loss"] - want) <= 1e-3 * abs(want),
                       f"first total_loss not within 1e-3 of the recorded {want:.6e}"))
    changed = [k for k, p in frozen.items() if not torch.equal(p, frozen_before[k])]
    faults.append((bool(changed), f"frozen parameters changed: {changed[:5]}"))
    for bad, what in faults:
        if bad:
            raise AssertionError(f"category training: {what}")
    del frozen_before
    log(f"{len(frozen)} frozen tensors bitwise unchanged after {TRAIN_STEPS} steps")

    in_place = profile_request(lambda: trainer.train(TRAIN_STEPS, TRAIN_STEPS + 1),
                               inference=False, kernel="ms_deform_attn_")
    fwd = [ms for n, ms in in_place if KERNEL in n]
    bwd = [ms for n, ms in in_place if BWD_KERNEL in n]
    if len(fwd) != 6 or len(bwd) != 6:
        raise AssertionError(f"the profiler saw {len(fwd)} forward and {len(bwd)} "
                             "backward deform-attn launches in one step")
    ran = {m.groups() for m in (BWD_KERNEL_ARGS.search(n) for n, _ in in_place) if m}
    log(f"backward kernel launched as {sorted(ran)} (element type, chunk)")
    if len(ran) != 1:
        raise AssertionError(f"the backward kernel ran as {sorted(ran)} in one step, "
                             "expected one variant with readable template arguments")
    elem_type, elems = ran.pop()
    bwd_vector_bytes = ELEMENT_BYTES[elem_type] * int(elems)
    if (elem_type, bwd_vector_bytes) != ("__nv_bfloat16", 16):
        raise AssertionError("the training path did not run the backward kernel on 16-byte "
                             "bf16 chunks")
    log(f"deform attn in one profiled train step: forward {sum(fwd):.4f} ms over "
        f"{len(fwd)} launches ({sum(fwd) / len(fwd):.4f} ms each), backward "
        f"{sum(bwd):.4f} ms over {len(bwd)} launches ({sum(bwd) / len(bwd):.4f} ms each)")
    bwd_numbers = backward_on_inputs(*training_inputs(layer0), "training-path inputs, bfloat16")
    del layer0, model, trainable, frozen, opt, trainer, timed
    torch.cuda.empty_cache()
    start_numbers = backward_on_inputs(*encoder_start_inputs(),
                                       "a fresh encoder layer's inputs, bfloat16")
    return dict(launches=launches, peak_gib=peak, first_ms=first_ms, warm_ms=warm_ms,
                bwd_vector_bytes=bwd_vector_bytes, fwd_in_place_ms=sum(fwd) / len(fwd),
                bwd_in_place_ms=sum(bwd) / len(bwd), bwd=bwd_numbers,
                bwd_encoder_start=start_numbers)


class PointDraws:
    """The criterion's uniform draws (``matcher.draw_uniform``) from one
    seeded host generator per (kind, layer) and call, so that two runs of
    the same step, on the card and on the CPU, sample the same points."""

    def __init__(self, seed):
        self.seed, self.calls = seed, {}

    def __call__(self, generator, shape, device, kind, layer):
        import numpy as np

        n = self.calls.get((kind, layer), 0)
        self.calls[(kind, layer)] = n + 1
        key = [self.seed, n, layer, ("match", "oversample", "random").index(kind)]
        u = np.random.RandomState(key).rand(*shape).astype(np.float32)
        return torch.from_numpy(u).to(device)


def tiny_train_step(dev, labels, state, batch):
    """One TINY CategoryODISE train step (float32, a 2x2 slide grid of
    128-px crops) on ``dev`` from the weights ``state`` (None: the seeded
    build's), on ``batch``, with the points of ``PointDraws(7)``. Returns
    the metrics, the trainable gradients on the CPU, the deform-attn
    launches (forward, backward) and the weights it started from."""
    from odise_torch.engine import make_category_train_step, make_optimizer, partition_params
    from odise_torch.losses import CriterionConfig, matcher
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.models.clip.tokenizer import tokenize
    from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_backward

    model = build_category_odise("tiny", train_labels=labels, device=dev,
                                 backbone_in_size=(128, 128))
    if state is None:
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    trainable, _ = partition_params(model)
    with torch.no_grad():
        text = model.encode_vocab(torch.from_numpy(
            tokenize([l[0] for l in labels])).long().to(dev))
    step = make_category_train_step(
        model, make_optimizer(trainable),
        CriterionConfig(num_classes=len(labels), num_points=256), text, labels)
    draw = matcher.draw_uniform
    matcher.draw_uniform = PointDraws(7)
    try:
        f0, b0 = ms_deform_attn.launches, ms_deform_attn_backward.launches
        metrics = step({k: v.to(dev) for k, v in batch.items()}, None)
        launched = (ms_deform_attn.launches - f0, ms_deform_attn_backward.launches - b0)
    finally:
        matcher.draw_uniform = draw
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.detach().cpu() for k, p in trainable.items()}, launched, state)


def card_vs_cpu(cpu, card):
    """The TINY step's readings: the largest relative loss difference, the
    relative L2 difference of the whole gradient set, and each tensor's
    largest difference over its largest CPU entry (plus 1e-6)."""
    (cpu_m, cpu_g), (card_m, card_g) = cpu, card
    loss_err = max(abs(card_m[k] - v) / max(abs(v), 1e-30) for k, v in cpu_m.items()
                   if k.startswith("loss") or k == "total_loss")
    per_tensor = {k: float((card_g[k] - g).abs().max()) / (float(g.abs().max()) + 1e-6)
                  for k, g in cpu_g.items()}
    diff = sum(float((card_g[k] - g).double().square().sum()) for k, g in cpu_g.items())
    norm = sum(float(g.double().square().sum()) for g in cpu_g.values())
    return loss_err, (diff / norm) ** 0.5, per_tensor


def planted_faults():
    """Wrong backward kernels, each the real kernel's gradients changed
    after its launch: the value gradient scaled by 0.9, and the location
    gradient without its level-size factor (w, h)."""
    def value_scaled(grads, shapes):
        return (grads[0] * 0.9,) + tuple(grads[1:])

    def loc_without_size(grads, shapes):
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                          device=grads[1].device)
        return grads[0], grads[1] / wh[None, None, None, :, None, :], grads[2]

    return {"grad_value x 0.9": value_scaled,
            "grad_loc without its (w, h) factor": loc_without_size}


def tiny_train_card_vs_cpu():
    """One TINY CategoryODISE train step on the card and on the CPU from the
    same weights, batch and points. Losses within 1e-3 relative. Gradients
    (after the clip, the same scale on both): the whole trainable set within
    1e-2 of the CPU's in L2 norm, and each tensor within 5e-2 of its largest
    CPU entry plus 1e-6. Float32 on both sides, other sum orders (atomics in
    the backward kernel and in cuDNN) through some 100 layers of backward;
    TINY's projections normalise groups of one channel, whose backward
    cancels most of the gradient, so a tensor's own error runs higher than
    the set's (3.1e-2 for ``backbone.proj_0.conv1.weight`` on an H100 80GB
    HBM3 at 700 W). Then the same step on the card with each of
    ``planted_faults`` in the backward kernel: the check must fail each.
    Returns the set's relative L2 error."""
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_train_loader
    from odise_torch.data.synthetic import make_shapes_records

    # the module (the package exports its function under the same name)
    mda = importlib.import_module("odise_torch.ops.ms_deform_attn")
    labels = (("cat",), ("dog",), ("grass",))
    mapper = COCOPanopticDatasetMapper(image_size=256, max_instances=4, device="cpu")
    batch = next(build_train_loader(make_shapes_records(2, size=256, seed=3), mapper, 2,
                                    seed=3))
    torch.manual_seed(0)  # the TINY weights, so that every run reads the same
    cpu_m, cpu_g, cpu_l, state = tiny_train_step("cpu", labels, None, batch)
    card_m, card_g, card_l, _ = tiny_train_step("cuda", labels, state, batch)
    if cpu_l != (0, 0) or card_l != (2, 2):
        raise AssertionError(f"TINY step launches: CPU {cpu_l}, card {card_l}; expected "
                             "none on the CPU, 2 forward and 2 backward on the card")

    def passes(loss_err, set_err, per_tensor):
        return loss_err <= 1e-3 and set_err <= 1e-2 and max(per_tensor.values()) <= 5e-2

    def report(what, card_total, readings):
        loss_err, set_err, per_tensor = readings
        worst = sorted(per_tensor, key=per_tensor.get, reverse=True)[:3]
        log(f"TINY train step card vs CPU{what}: total_loss {card_total:.6e} vs "
            f"{cpu_m['total_loss']:.6e}, largest relative loss difference {loss_err:.3e} "
            f"(tolerance 1e-3); gradients: relative L2 difference of the set {set_err:.3e} "
            f"(tolerance 1e-2), largest per tensor " + ", ".join(
                f"{k} {per_tensor[k]:.3e}" for k in worst) + " (tolerance 5e-2)")

    readings = card_vs_cpu((cpu_m, cpu_g), (card_m, card_g))
    report("", card_m["total_loss"], readings)
    if not passes(*readings):
        raise AssertionError("TINY train step: the card disagrees with the CPU")
    real = mda.launch_backward
    for name, fault in planted_faults().items():
        def faulty(value, spatial_shapes, *args, fault=fault, **kw):
            return fault(real(value, spatial_shapes, *args, **kw), spatial_shapes)

        mda.launch_backward = faulty
        try:
            m, g, _, _ = tiny_train_step("cuda", labels, state, batch)
        finally:
            mda.launch_backward = real
        planted = card_vs_cpu((cpu_m, cpu_g), (m, g))
        report(f", planted fault {name}", m["total_loss"], planted)
        if passes(*planted):
            raise AssertionError(f"the TINY check passed a wrong backward kernel ({name})")
    return readings[1]


def train_caption():
    """Two FULL CaptionODISE steps with the grounding loss: finite metrics,
    6 forward and 6 backward kernel launches per step."""
    from odise_torch.engine import Trainer, make_caption_train_step, make_optimizer
    from odise_torch.losses import CriterionConfig
    from odise_torch.model_zoo.factory import build_caption_odise

    model, trainable, _ = build_for_training(build_caption_odise)
    opt = make_optimizer(trainable, lr=1e-4, weight_decay=0.05)
    timed = TimedStep(make_caption_train_step(model, opt, CriterionConfig(num_classes=1),
                                              grad_clip=0.01))
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(timed, train_loader(640, True, 1),
                      torch.Generator(device="cuda").manual_seed(1))
    trainer.train(0, CAPTION_STEPS)
    for i, (m, ms, ln) in enumerate(zip(trainer.metrics_history, timed.ms, timed.launches)):
        log(f"caption step {i}: {ms:.1f} ms, total_loss {m['total_loss']:.6e}, "
            f"loss_mask_word {m['loss_mask_word']:.4f}, grad_norm {m['grad_norm']:.4e}, "
            f"deform-attn launches forward {ln[0]}, backward {ln[1]}")
    log(f"caption training: peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if any(ln != (6, 6) for ln in timed.launches):
        raise AssertionError("caption training: deform-attn launches other than 6 and 6")
    if not all(m["grad_norm"] > 0 for m in trainer.metrics_history):
        raise AssertionError("caption training: grad_norm 0")


def launch_counts():
    from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_backward

    return ms_deform_attn.launches, ms_deform_attn_backward.launches


def zero_launch_counts():
    from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_backward

    ms_deform_attn.launches = ms_deform_attn_backward.launches = 0


def cli_run(argv, label):
    """One ``odise_torch.train_net.main(argv)`` with the launch counts set to
    0 just before and read just after; its time and peak memory."""
    from odise_torch import train_net

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    out = train_net.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train_net {label}: {seconds:.1f} s, peak memory allocated {peak:.2f} GiB, "
        f"deform-attn launches forward {launches[0]}, backward {launches[1]}")
    return out, launches, peak, seconds


def train_net_phase():
    """Phase 9: ``python -m odise_torch.train_net``'s main on the port's
    ``odise_label_coco_50e.py`` at FULL width, on in-memory synthetic
    records registered as ``_smoke_train`` and ``_smoke_val``: (a) 4 steps,
    checkpoints every 2, the final eval on 2 images; (b) ``--resume`` to 6
    steps; (c) ``--eval-only --init-from model_final``, whose PQ, mIoU and AP
    must equal (b)'s final eval. Returns the numbers PERF.md and the kernels
    line take."""
    import os
    import shutil
    import statistics

    from odise_torch import train_net
    from odise_torch.data.build import coco_panoptic_categories
    from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from odise_torch.data.synthetic import make_shapes_records
    from odise_torch.engine.checkpoint import Checkpointer

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "output", "chip_smoke_train_net")
    shutil.rmtree(out, ignore_errors=True)
    for name, seed, n in (("_smoke_train", 0, 4), ("_smoke_val", 5, 2)):
        records = [coco_cut(r, 640, 640) for r in make_shapes_records(n, size=640, seed=seed)]
        DatasetCatalog.remove(name)
        DatasetCatalog.register(name, lambda records=records: records)
        MetadataCatalog.get(name).set(ignore_label=255, categories=coco_panoptic_categories())
    common = ["--config-file", os.path.join(root, "odise_torch", "configs", "Panoptic",
                                            "odise_label_coco_50e.py"),
              "--output", out, "--max-eval-images", "2"]
    opts = ["dataloader.train.dataset=_smoke_train", "dataloader.wrapper.dataset_name=_smoke_val",
            "train.checkpointer.period=2", "train.eval_period=4", "train.log_period=1"]
    ck_dir = os.path.join(out, "checkpoints")
    faults = []

    # (a) train 4 steps
    run, launches_a, peak_a, seconds_a = cli_run(common + opts + ["train.max_iter=4"],
                                                 "(a) 4 steps")
    cfg, model = run.cfg, run.model
    batch = cfg.dataloader.train.total_batch_size
    size = cfg.dataloader.train.mapper.image_size
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    dtypes = sorted({str(p.dtype)[6:] for p in model.parameters()})
    log(f"config-built FULL CategoryODISE: {n_train:,} trainable parameters, parameter "
        f"dtypes {dtypes}, batch {batch} at {size}-px LSJ (auto_scale_workers on 1 card), "
        f"lr {cfg.optimizer.lr:.4g}, warmup {cfg.optimizer.warmup_steps} steps, "
        f"milestones {list(cfg.optimizer.milestones)}")
    ms = [m["time"] * 1e3 for m in run.history]
    for i, m in enumerate(run.history):
        log(f"(a) step {i}: {ms[i]:.1f} ms, total_loss {m['total_loss']:.6e}, grad_norm "
            f"{m['grad_norm']:.4e}, loss_ce {m['loss_ce']:.4f}, loss_mask {m['loss_mask']:.4f}, "
            f"loss_dice {m['loss_dice']:.4f}")
    first_ms, warm_ms = ms[0], statistics.median(ms[1:])
    kept = sorted(os.listdir(ck_dir))
    last = open(os.path.join(ck_dir, "last_checkpoint")).read()
    skipped = sorted(set(cfg.extra_task) - set(run.eval_results))
    main_a = run.eval_results.get("main", {})
    log(f"(a) first step {first_ms:.1f} ms, warm {warm_ms:.1f} ms (median of steps 2 to 4); "
        f"checkpoints {kept}, last_checkpoint {last!r} (max_to_keep "
        f"{cfg.train.checkpointer.max_to_keep}); final eval on {main_a.get('images')} images: "
        f"PQ {main_a.get('PQ')}, mIoU {main_a.get('mIoU')}, AP {main_a.get('AP')}; extra tasks "
        f"skipped (their files are absent): {skipped}")
    fresh = train_net.build_model(cfg)
    changed = [n for (n, p), q in zip(model.named_parameters(), fresh.parameters())
               if not p.requires_grad and not torch.equal(p, q)]
    n_frozen = sum(1 for p in model.parameters() if not p.requires_grad)
    log(f"{n_frozen} frozen tensors bitwise equal to a fresh seeded build after 4 steps: "
        f"{not changed}")
    faults += [(n_train != 28_591_297, f"{n_train} trainable parameters, not 28,591,297"),
               (batch != 2 or size != 1024, f"batch {batch} at {size} px, not 2 at 1024"),
               (launches_a != (6 * (4 + 2), 6 * 4),
                f"(a) launches {launches_a}, not 6 per step and eval image forward and 6 per "
                "step backward"),
               (len(run.history) != 4, f"(a) ran {len(run.history)} steps"),
               (not all(torch.isfinite(torch.tensor(list(m.values()))).all()
                        and m["grad_norm"] > 0 for m in run.history),
                "(a) non-finite metrics or grad_norm 0"),
               (bool(changed), f"frozen parameters changed: {changed[:5]}"),
               (kept != ["last_checkpoint", "model_0000001.pth", "model_best.pth",
                         "model_final.pth"] or last != "model_best", f"(a) checkpoints {kept}"),
               (skipped != sorted(cfg.extra_task), f"extra tasks evaluated: {skipped}"),
               (main_a.get("images") != 2, "(a) final eval")]
    del run, model, fresh
    # (b) resume to 6 steps
    run, launches_b, peak_b, seconds_b = cli_run(common + ["--resume"] + opts
                                                 + ["train.max_iter=6"], "(b) --resume to 6")
    main_b = run.eval_results.get("main", {})
    log(f"(b) started at iteration {run.start_iter}, optimizer count after loading "
        f"{run.start_count}; steps " + ", ".join(
            f"{m['time'] * 1e3:.1f} ms (total_loss {m['total_loss']:.6e})" for m in run.history)
        + f"; final eval PQ {main_b.get('PQ')}, mIoU {main_b.get('mIoU')}, "
        f"AP {main_b.get('AP')}; checkpoints {sorted(os.listdir(ck_dir))}")
    faults += [((run.start_iter, run.start_count, run.optimizer.count) != (4, 4, 6),
                f"(b) started at {run.start_iter} with count {run.start_count}"),
               (launches_b != (6 * (2 + 2), 6 * 2), f"(b) launches {launches_b}")]
    # on the host, so that (c)'s peak memory is its own
    tensors_b = {k: t.cpu() for k, t in run.model.state_dict().items()}
    del run
    # (c) evaluate model_final
    results, launches_c, peak_c, seconds_c = cli_run(
        common + ["--eval-only", "--init-from", os.path.join(ck_dir, "model_final.pth")]
        + opts, "(c) --eval-only --init-from model_final")
    main_c = results.get("main", {})
    # every metric, not only PQ, mIoU and AP (which 6 steps from random
    # weights may leave at 0); the time per image aside
    keys = sorted(k for k in main_b if k != "s_per_img")
    diffs = {k: abs(float(main_c.get(k, float("nan"))) - float(main_b[k])) for k in keys}
    log(f"(c) PQ {main_c.get('PQ')}, mIoU {main_c.get('mIoU')}, AP {main_c.get('AP')}; "
        f"nonzero in (b): {({k: round(float(main_b[k]), 4) for k in keys if main_b[k]})}; "
        f"largest difference from (b)'s final eval over {len(keys)} metrics "
        f"{max(diffs.values()):.3g} (tolerance 0: the same weights and images through the "
        "same kernels, whose forward sums in a fixed order)")
    # what makes (c) score as (b): the model that --eval-only builds and
    # loads (train_net.main's own two calls) equals (b)'s trained model
    loaded = train_net.build_model(cfg)
    Checkpointer(ck_dir).load(os.path.join(ck_dir, "model_final.pth"),
                              dict(loaded.named_parameters()))
    unequal = [n for n, t in loaded.state_dict().items()
               if not torch.equal(t.cpu(), tensors_b[n])]
    log(f"(c)'s model, built from train.seed and loaded from model_final: "
        f"{len(tensors_b)} tensors, bitwise equal to (b)'s trained model: {not unequal}")
    del loaded, tensors_b
    faults += [(not all(d == 0 for d in diffs.values()),
                f"(c) differs from (b)'s final eval: {({k: d for k, d in diffs.items() if d})}"),
               (bool(unequal), f"(c)'s model differs from (b)'s: {unequal[:5]}"),
               (launches_c != (6 * 2, 0), f"(c) launches {launches_c}")]
    shutil.rmtree(out, ignore_errors=True)
    for bad, what in faults:
        if bad:
            raise AssertionError(f"train_net phase: {what}")
    return dict(launches={"a": launches_a, "b": launches_b, "c": launches_c},
                first_ms=first_ms, warm_ms=warm_ms, peak_gib=max(peak_a, peak_b, peak_c),
                seconds=[seconds_a, seconds_b, seconds_c], trainable=n_train)


def auction_check():
    """The matcher's auction on the card, on problems built as the matcher
    builds them at a TINY convergence step's shape (16 problems of 10
    queries, 8 target slots of which 3 hold a mask, 2 padding columns) and
    at a FULL step's (20 problems of 100 queries and 100 slots, 5 with a
    mask): the card's rounds, replayed as a CUDA graph, give the CPU's
    assignment to the element. Times one call on the card (CUDA events,
    the graph already captured) with the rounds it ran."""
    import numpy as np

    from odise_torch.ops.lap import auction_lap

    out = {}
    for B, N, T, valid in ((16, 10, 8, 3), (20, 100, 100, 5)):
        cost = np.random.RandomState(N).rand(B, N, T).astype(np.float32)
        cost[:, :, valid:] = cost[:, :, :valid].max(axis=(1, 2))[:, None, None] + 1.0
        benefit = -torch.from_numpy(cost)
        if T < N:
            lo = benefit.reshape(B, -1).amin(1) - 1.0
            benefit = torch.cat([benefit, lo[:, None, None].expand(B, N, N - T)], dim=2)
        dev = benefit.cuda()
        auction_lap(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        r0 = auction_lap.rounds
        start.record()
        got = auction_lap(dev)
        end.record()
        end.synchronize()
        ms, rounds = start.elapsed_time(end), auction_lap.rounds - r0
        same = torch.equal(got.cpu(), auction_lap(benefit))
        log(f"auction [{B}, {N}, {N}] ({T} slots, {valid} with a mask) on the card: "
            f"{ms:.2f} ms for {rounds} rounds ({1e3 * ms / rounds:.2f} us a round); equal "
            f"to the CPU's: {same}")
        if not same:
            raise AssertionError(f"auction [{B}, {N}, {N}]: the card's assignment differs")
        out[f"{B}x{N}"] = dict(ms=ms, rounds=rounds)
    return out


# phase 10's level shapes (coarsest first) for the TINY models' 4 heads of
# 8: the category run's 128-px images and the caption run's 64-px ones
CONVERGENCE_LEVELS = {"category": [(4, 4), (8, 8), (16, 16)],
                      "caption": [(2, 2), (4, 4), (8, 8)]}
TINY_HEADS, TINY_HEAD_DIM = 4, 8
# tests/test_convergence.py's thresholds, unchanged: loss drop (%), then PQ,
# mIoU and AP after, PQ (and mIoU) rise, PQ before
CONVERGENCE = {
    "category": dict(kw=dict(steps=100, lr=2e-3, use_checkpoint=True, slide_training=True,
                             backbone_in_size=(64, 64), size=128),
                     drop=40.0, after=dict(PQ=35.0, mIoU=50.0, AP=20.0),
                     rise=dict(PQ=30.0, mIoU=30.0), before_pq=20.0),
    "caption": dict(kw=dict(steps=200, lr=2e-3, collect_mode=None),
                    drop=25.0, after=dict(PQ=25.0, mIoU=40.0, AP=15.0),
                    rise=dict(PQ=20.0), before_pq=20.0),
}


class FirstTrainInputs:
    """A forward pre-hook on every module: at the first call of a pixel
    decoder's encoder layer with gradients on (the first train step's
    encoder layer 0), the deformable-attention kernel's inputs, computed
    from that call's arguments with the layer's weights of that moment."""

    def __init__(self):
        from odise_torch.models.decoder.pixel_decoder import DeformableEncoderLayer

        self.layer_type, self.inputs = DeformableEncoderLayer, None
        self.hook = torch.nn.modules.module.register_module_forward_pre_hook(self._record)

    def _record(self, mod, args):
        if self.inputs is None and isinstance(mod, self.layer_type) and torch.is_grad_enabled():
            src, pos, ref_points, levels = args
            with torch.no_grad():
                v, loc, attn = mod.self_attn.sampling_inputs(src + pos, ref_points, src, levels)
            self.inputs = (v.clone(), loc.clone(), attn.clone(),
                           [tuple(int(x) for x in lv) for lv in levels])


def convergence_phase():
    """Phase 10: ``odise_torch.convergence.run_convergence`` on the card,
    both variants, held to the JAX convergence test's thresholds. First
    both kernels are held to their plain versions at this phase's own
    shapes (TINY: 4 heads of 8 in float32, batch 4, on the category run's
    levels and the caption run's, whose coarsest is 2x2, every corner on a
    border), with ``check_kernel``'s and ``check_backward``'s rule; after
    each run, again on the inputs its first train step gave the first
    encoder layer."""
    from odise_torch.convergence import run_convergence
    from odise_torch.ops.lap import auction_lap

    gen = torch.Generator(device="cuda").manual_seed(10)
    errs = {"fwd": [], "bwd": []}
    for levels in CONVERGENCE_LEVELS.values():
        for kind in ("random", "out_of_range", "pixel_centres", "encoder_start"):
            inputs = deform_inputs(kind, torch.float32, gen, levels, batch=4,
                                   heads=TINY_HEADS, head_dim=TINY_HEAD_DIM)
            label = f"{levels}, TINY, batch 4, {kind}, float32"
            errs["fwd"].append(check_kernel(*inputs, label, levels))
            errs["bwd"].append(check_backward(*inputs, label, levels, gen)[0])
    out = {"auction_ms": auction_check()}
    for variant, spec in CONVERGENCE.items():
        zero_launch_counts()
        auction_lap.calls = auction_lap.rounds = 0
        first = FirstTrainInputs()
        try:
            r = run_convergence(variant=variant, batch=4, n_train=32, n_val=8, seed=0,
                                dataset_name=f"_smoke_conv_{variant}", **spec["kw"])
        finally:
            first.hook.remove()
        launches = launch_counts()
        v, loc, attn, levels = first.inputs
        if levels != CONVERGENCE_LEVELS[variant] or tuple(v.shape) != (
                4, sum(h * w for h, w in levels), TINY_HEADS, TINY_HEAD_DIM):
            raise AssertionError(f"convergence {variant} ran the kernel at levels {levels}, "
                                 f"value {tuple(v.shape)}, not this phase's checked shapes")
        label = f"convergence {variant}, first train step's encoder layer 0"
        errs["fwd"].append(check_kernel(v, loc, attn, label, levels))
        errs["bwd"].append(check_backward(v, loc, attn, label, levels, gen)[0])
        del first, v, loc, attn
        log(f"convergence {variant}: the matcher's auction ran {auction_lap.calls} times, "
            f"{auction_lap.rounds} rounds ({auction_lap.rounds / auction_lap.calls:.1f} a "
            "call; the cap is 2000)")
        before, after = r["metrics_before"], r["metrics_after"]
        log(f"convergence {variant}: {r['steps']} steps, {r['sec_per_step'] * 1e3:.1f} ms a "
            f"step, loss {r['loss_first10_mean']:.4f} -> {r['loss_last10_mean']:.4f} "
            f"(drop {r['loss_drop_pct']:.2f}%, threshold {spec['drop']}); before PQ "
            f"{before['PQ']:.2f} mIoU {before['mIoU']:.2f} AP {before['AP']:.2f}; after PQ "
            f"{after['PQ']:.2f} mIoU {after['mIoU']:.2f} AP {after['AP']:.2f} (thresholds "
            f"{spec['after']}, rise {spec['rise']}); deform-attn launches forward "
            f"{launches[0]}, backward {launches[1]}")
        misses = [f"loss drop {r['loss_drop_pct']:.2f}% < {spec['drop']}"
                  ] if r["loss_drop_pct"] < spec["drop"] else []
        misses += [f"{k} {after[k]:.2f} < {v}" for k, v in spec["after"].items() if after[k] < v]
        misses += [f"{k} rose {after[k] - before[k]:.2f} < {v}"
                   for k, v in spec["rise"].items() if after[k] < before[k] + v]
        if not before["PQ"] < spec["before_pq"]:
            misses.append(f"PQ before {before['PQ']:.2f} >= {spec['before_pq']}")
        if misses or launches[1] == 0:
            raise AssertionError(f"convergence {variant} missed: {misses}, launches {launches}")
        out[variant] = dict(r, launches=launches)
    out["max_abs_err"] = {k: max(e) for k, e in errs.items()}
    return out


# s5, s4, s3 of one 512-px SD crop, the parity run's levels
REFERENCE_SHAPES = [(16, 16), (32, 32), (64, 64)]
DEMO_VOCAB = "black pickup truck, pickup truck; sky"


def reference_weights_phase():
    """Phase 11: weights in the reference's layout (SD v1.3, OpenAI CLIP
    ViT-L/14 and its 336-px head, a released ODISE checkpoint's trainable
    set, generated from a seed by ``tests/test_torch_convert.py``) through
    the port's converters: (a) the model zoo from a local mirror, every
    tensor of the model from one of the checkpoints; (b) FULL float32
    parity with the JAX package's stored FULL run, stage by stage; (c) the
    demo's ``segment`` at FULL in bf16 on the 1024-px pattern image with
    COCO's labels, then with ``--vocab`` merged in; (d) the forward kernel
    against float64 on the inputs (b) gave the first encoder layer."""
    import os
    import shutil

    import numpy as np

    from odise_torch import demo
    from odise_torch.model_zoo import model_zoo
    from odise_torch.model_zoo.convert import (clip_install, install, odise_install,
                                               sd_install)
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.model_zoo.from_jax import match_flax_tree
    from odise_torch.models.wrapper import build_open_vocabulary
    from odise_torch.ops.ms_deform_attn import ms_deform_attn
    from tests.test_torch_convert import clip_spec, fill, port_parity, reference_state_dicts

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 parity
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    made = reference_state_dicts("full")
    dicts = made[0]
    head_state, _ = fill(clip_spec("full", head=True, text=False))
    n = sum(v.size for d in (*dicts.values(), head_state) for v in d.values())
    log(f"reference weights: {n / 1e9:.3f} B values in the reference's layout, made in "
        f"{time.perf_counter() - t0:.1f} s")

    # (a) the model zoo, from a local mirror of the released checkpoint
    zoo = os.path.join("output", "chip_smoke_zoo")
    os.makedirs(os.path.join(zoo, "Panoptic"), exist_ok=True)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in dicts["odise"].items()}},
               os.path.join(zoo, "Panoptic", "odise_label_coco_50e.pth"))
    saved = os.environ.get("ODISE_MODEL_ZOO")
    os.environ["ODISE_MODEL_ZOO"] = zoo
    try:
        t0 = time.perf_counter()
        model = model_zoo.get("Panoptic/odise_label_coco_50e.py", trained=True)
        zoo_s = time.perf_counter() - t0
    finally:
        if saved is None:
            del os.environ["ODISE_MODEL_ZOO"]
        else:
            os.environ["ODISE_MODEL_ZOO"] = saved
        shutil.rmtree(zoo)
    state = model.state_dict()
    odise = odise_install(model, dicts["odise"])
    matched, _ = match_flax_tree(model, odise.tree)
    differ = [name for name, v in matched
              if not torch.equal(state[name].cpu(), torch.from_numpy(np.array(v, order="C")))]
    n_trainable = sum(v.size for _, v in matched)
    log(f"model_zoo.get(trained=True): {zoo_s:.1f} s; {len(matched)} trainable tensors, "
        f"{n_trainable:,} parameters, {len(differ)} differ from the converted checkpoint")
    if differ or n_trainable != 28_591_297 or len(matched) != len(odise.towers):
        raise AssertionError(f"the zoo's trainable set is not the checkpoint's: {differ[:5]}")
    t0 = time.perf_counter()
    names = [name for name, _ in matched]
    for what in (sd_install(model, dicts["sd"]),
                 clip_install(model, dicts["clip"], clip_head_state=head_state)):
        install(model, what)  # raises if a tensor of its towers is left unfilled
        names += [name for name, _ in match_flax_tree(model, what.tree)[0]]
    torch.cuda.synchronize()
    if len(names) != len(set(names)) or set(names) != set(state):
        raise AssertionError(f"the checkpoints fill {len(set(names))} of the model's "
                             f"{len(state)} tensors, {len(names) - len(set(names))} twice")
    log(f"SD and CLIP installed in {time.perf_counter() - t0:.1f} s: the three checkpoints "
        f"fill all {len(state)} tensors of the model, each once")
    del state, matched, odise

    # (b) FULL float32 parity with the JAX package, and (d) the kernel on
    # the inputs it gave the first encoder layer
    hooked = {}

    def before_capture(m):
        hooked["layer0"] = Layer0Inputs(m)
        ms_deform_attn.launches = 0

    t0 = time.perf_counter()
    errors, agreement, parity_model = port_parity("full", "cuda", made=made, hook=before_capture)
    parity_launches = ms_deform_attn.launches
    layer0 = hooked["layer0"]
    layer0.hook.remove()
    log(f"FULL float32 parity with the JAX package, 512-px ramp image "
        f"({time.perf_counter() - t0:.1f} s, {parity_launches} kernel launches):")
    for key, (err, sum_err, tol) in errors.items():
        log(f"  {key:16s} max rel err {err:.3e} (tolerance {tol:g}), sum|x| rel err "
            f"{sum_err:.3e}{'' if err <= tol else '  MISSED'}")
    log(f"  panoptic map agreement with JAX's: {agreement:.6f} (at least 0.99)")
    missed = [k for k, (err, _, tol) in errors.items() if not err <= tol]
    if missed or not agreement >= 0.99 or parity_launches != 12:
        raise AssertionError(f"FULL parity missed {missed}, agreement {agreement}, "
                             f"{parity_launches} launches (12 expected)")
    if layer0.levels[0] != REFERENCE_SHAPES:
        raise AssertionError(f"the parity run's levels were {layer0.levels[0]}")
    kernel, (v, _, _) = kernel_on_inputs(layer0, REFERENCE_SHAPES,
                                         "reference weights, 512 px, float32")
    if v.dtype != torch.float32:
        raise AssertionError(f"the parity run ran the kernel in {v.dtype}")
    del layer0, parity_model, v, made, dicts, head_state
    torch.cuda.empty_cache()

    # (c) the demo at FULL in bf16 on the zoo model's weights
    demo_model = build_category_odise("full", dtype=torch.bfloat16)
    demo_model.load_state_dict(model.state_dict())
    del model
    torch.cuda.empty_cache()
    image = (pattern_image(1024, "cuda")[0] * 255).round().to(torch.uint8)
    torch.cuda.reset_peak_memory_stats()
    demo_runs = []
    for tag, argv in (("COCO", []), ("COCO and --vocab", ["--vocab", DEMO_VOCAB])):
        labels, things = demo.build_demo_vocab(demo.parse_args(argv))
        vocab = build_open_vocabulary(demo_model, labels, thing_mask=things)
        for run in ("first", "warm"):
            ms_deform_attn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = demo.segment(demo_model, vocab, image)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            seg, cats = out.panoptic_seg, out.segment_category[:out.num_segments]
            probs = torch.softmax(out.mask_cls[0].float(), -1)
            # every segment comes from a query whose class is not null
            labelled = int((probs.argmax(-1) != len(labels)).sum())
            ok = (ms_deform_attn.launches == 6 and tuple(seg.shape) == (1024, 1024)
                  and out.num_segments <= labelled
                  and bool(torch.isfinite(out.mask_cls).all())
                  and bool(torch.isfinite(out.mask_pred).all())
                  and int(seg.min()) >= 0 and int(seg.max()) <= out.num_segments
                  and bool(((cats >= 0) & (cats < len(labels))).all()))
            names = [labels[c][0] for c in cats.tolist()]
            log(f"demo segment [{tag}, K={len(labels)}, {run}]: {ms:.1f} ms, "
                f"{ms_deform_attn.launches} kernel launches, {out.num_segments} segments "
                f"{names[:8]}, map {tuple(seg.shape)}; {labelled} of {len(probs)} queries "
                f"not null (mean null probability {float(probs[:, -1].mean()):.4f}, best "
                f"label {float(probs[:, :-1].amax(-1).mean()):.4f}), "
                f"{float((out.mask_pred >= 0).float().mean()):.4f} of mask logits >= 0")
            if not ok:
                raise AssertionError(f"the demo's segment failed its checks [{tag}, {run}]")
            demo_runs.append(dict(vocab=tag, K=len(labels), run=run, ms=ms,
                                  launches=ms_deform_attn.launches))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"demo peak memory allocated: {peak_gib:.2f} GiB")
    del demo_model
    torch.cuda.empty_cache()
    return dict(kernel=kernel, parity_launches=parity_launches, demo=demo_runs,
                demo_peak_gib=peak_gib,
                parity={k: e[0] for k, e in errors.items()}, agreement=agreement)


# phase 12: COCO's things and stuff the generated dataset draws (dataset ids)
DATASET_THINGS = (1, 2, 3, 17, 18)    # person, bicycle, car, cat, dog
DATASET_STUFF = (187, 199, 193)       # sky, wall, grass: bands top to bottom
DEMO_JPEGS = ("ade", "coco", "ego4d")  # demo/examples/*.jpg, 640x480, COCO's size
# the CLI's main in a subprocess, as ``python -m odise_torch.train_net`` runs
# it, with the kernels' launch counts set to 0 before and written out after
CLI_RUNNER = """
import json, sys, time
import torch
from odise_torch import train_net
from odise_torch.data.image_io import decode_jpeg_cuda
from odise_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_backward
ms_deform_attn.launches = ms_deform_attn_backward.launches = 0
t0 = time.perf_counter()
run = train_net.main(sys.argv[2:])
torch.cuda.synchronize()
with open(sys.argv[1], "w") as f:
    json.dump({"seconds": time.perf_counter() - t0, "history": run.history,
               "eval": run.eval_results, "jpeg_decodes": decode_jpeg_cuda.decodes,
               "launches": [ms_deform_attn.launches, ms_deform_attn_backward.launches],
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}, f, default=float)
"""


def draw_coco_image(rng, image_id, h=480, w=640):
    """Panoptic segments for one image: three stuff bands, a thing polygon
    (integer vertices) in each of four cells of a 3x2 grid, a crowd blob in
    another, and a void square. Returns the id map, its segments_info, and
    the instance annotations with the masks they were drawn from."""
    import numpy as np

    from odise_torch.data.coco_mask import mask_to_rle, polygons_to_mask

    ids = np.zeros((h, w), np.uint32)
    cuts = sorted(rng.randint(h // 5, 4 * h // 5, 2))
    segments, anns = [], []
    for k, (cat, y0, y1) in enumerate(zip(DATASET_STUFF, [0] + cuts, cuts + [h])):
        sid = 1 + 70001 * (k + 1) % 2 ** 24  # ids that use all three RGB channels
        ids[y0:y1] = sid
        segments.append({"id": sid, "category_id": cat, "iscrowd": 0})
    cells = rng.permutation(6)
    for k, cell in enumerate(cells[:5]):
        cy, cx = (cell // 3) * (h // 2) + h // 4, (cell % 3) * (w // 3) + w // 6
        crowd = k == 4
        if crowd:
            yy, xx = np.mgrid[:h, :w]
            mask = ((yy - cy) / 70.0) ** 2 + ((xx - cx) / 90.0) ** 2 <= 1
            seg = mask_to_rle(mask)
        else:
            n = rng.randint(5, 12)
            angle = np.sort(rng.rand(n)) * 2 * np.pi
            radius = rng.uniform(30, 100, n)
            poly = np.stack([cx + radius * np.cos(angle), cy + 0.9 * radius * np.sin(angle)], 1)
            seg = [np.round(poly).reshape(-1).astype(float).tolist()]
            mask = polygons_to_mask(seg, h, w)
        sid = 1 + 9973 * (k + 11) % 2 ** 24
        ids[mask] = sid
        cat = DATASET_THINGS[k]
        segments.append({"id": sid, "category_id": cat, "iscrowd": int(crowd)})
        anns.append({"id": image_id * 100 + k, "image_id": image_id, "category_id": cat,
                     "iscrowd": int(crowd), "segmentation": seg, "mask": mask})
    y, x = rng.randint(0, h - 24), rng.randint(0, w - 24)
    ids[y:y + 24, x:x + 24] = 0  # void
    for s in segments:
        m = ids == s["id"]
        ys, xs = np.nonzero(m)
        s["area"] = int(m.sum())
        s["bbox"] = [int(xs.min()), int(ys.min()), int(np.ptp(xs)) + 1, int(np.ptp(ys)) + 1]
    return ids, [s for s in segments if s["area"]], anns


def write_coco_dataset(root):
    """The COCO layout ``register_coco.py`` reads, under ``root``: the demo
    JPEGs as {train,val}2017 images, panoptic PNGs, the semantic PNGs derived
    from them as ``datasets/prepare_coco_semantic_annos_from_panoptic_annos
    .py`` derives them, the panoptic, instances and captions jsons. Returns
    what was written, for the read-back checks."""
    import os

    import numpy as np

    from odise_torch.data.build import coco_panoptic_categories
    from odise_torch.data.datasets.register_coco import coco_meta
    from odise_torch.data.image_io import write_png
    from odise_torch.data.transforms import id2rgb

    meta = coco_meta()
    to_contiguous = meta["stuff_dataset_id_to_contiguous_id"]
    coco = os.path.join(root, "coco")
    demo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo", "examples")
    written = {}
    for split, base in (("train", 0), ("val", 100)):
        for d in (f"{split}2017", f"panoptic_{split}2017", f"panoptic_semseg_{split}2017",
                  "annotations"):
            os.makedirs(os.path.join(coco, d), exist_ok=True)
        rng = np.random.RandomState(base + 12)
        images, pan_anns, inst_anns, captions = [], [], [], []
        for k, name in enumerate(DEMO_JPEGS):
            image_id = base + k
            stem = f"{image_id:012d}"
            src = os.path.join(demo, f"{name}.jpg")
            dst = os.path.join(coco, f"{split}2017", stem + ".jpg")
            with open(src, "rb") as f, open(dst, "wb") as g:
                g.write(f.read())
            ids, segments, anns = draw_coco_image(rng, image_id)
            sem = np.full(ids.shape, 255, np.uint8)
            for s in segments:
                sem[ids == s["id"]] = to_contiguous[s["category_id"]]
            write_png(os.path.join(coco, f"panoptic_{split}2017", stem + ".png"), id2rgb(ids))
            write_png(os.path.join(coco, f"panoptic_semseg_{split}2017", stem + ".png"), sem)
            images.append({"id": image_id, "file_name": stem + ".jpg", "height": 480,
                           "width": 640})
            pan_anns.append({"image_id": image_id, "file_name": stem + ".png",
                             "segments_info": segments})
            inst_anns += [{k2: v for k2, v in a.items() if k2 != "mask"} for a in anns]
            captions += [{"id": 2 * image_id + j, "image_id": image_id, "caption": c}
                         for j, c in enumerate((f"a {name} scene with a person and a dog",
                                                "a car under the sky"))]
            written[(split, image_id)] = dict(ids=ids, sem=sem, anns=anns)
        cats = coco_panoptic_categories()
        for fname, obj in ((f"panoptic_{split}2017.json",
                            {"images": images, "annotations": pan_anns, "categories": cats}),
                           (f"instances_{split}2017.json",
                            {"images": images, "annotations": inst_anns,
                             "categories": [c for c in cats if c["isthing"]]})):
            with open(os.path.join(coco, "annotations", fname), "w") as f:
                json.dump(obj, f)
        if split == "train":
            with open(os.path.join(coco, "annotations", "captions_train2017.json"), "w") as f:
                json.dump({"images": images, "annotations": captions}, f)
    return written


def check_nvjpeg():
    """nvJPEG against PIL's stored decodes of the JPEG fixtures and the demo
    images (``tests/data/torch_jpeg_reference.npz``), and its decode time
    per 640x480 demo JPEG, logged."""
    from odise_torch.data.image_io import decode_jpeg_cuda
    from tests.torch_jpeg_fixtures import MEAN_ABS_MAX, PSNR_MIN_DB, jpeg_gap, load

    cases, pil_version = load()
    misses = []
    for case, (data, want) in cases.items():
        got = decode_jpeg_cuda(data, "cuda").cpu().numpy()
        if got.shape != want.shape:
            misses.append(f"{case}: shape {got.shape}, PIL {want.shape}")
            continue
        gap = jpeg_gap(got, want)
        log(f"nvJPEG vs PIL {pil_version} {case} {want.shape}: PSNR {gap['psnr_db']:.2f} dB, "
            f"mean abs {gap['mean_abs']:.4f} (per channel "
            f"{[round(v, 4) for v in gap['mean_abs_channel']]}), max abs per channel "
            f"{gap['max_abs_channel']}")
        if not (gap["psnr_db"] >= PSNR_MIN_DB and gap["mean_abs"] <= MEAN_ABS_MAX):
            misses.append(f"{case}: {gap}")
    if misses:
        raise AssertionError(f"nvJPEG misses PSNR >= {PSNR_MIN_DB} dB or mean abs <= "
                             f"{MEAN_ABS_MAX} against PIL: {misses}")
    ms = {}
    for name in DEMO_JPEGS:
        data = cases[f"demo/{name}"][0]
        decode_jpeg_cuda(data, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            decode_jpeg_cuda(data, "cuda")
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    log(f"nvJPEG decode, host clock to a synchronize, warm, 20 each: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))


def dataset_phase():
    """Phase 12: the shipped COCO recipe from files at FULL. A COCO-layout
    dataset from the demo JPEGs and seeded panoptic segments is written and
    read back; ``python -m odise_torch.train_net``'s main on
    ``odise_label_coco_50e.py`` in a subprocess with ``DETECTRON2_DATASETS``
    set trains 4 steps and evaluates on ``coco_2017_val_panoptic_with_sem_seg``;
    then the same val records, their files read by ``image_io`` and held in
    memory, are evaluated in this process by the same weights, and must
    score the same."""
    import os
    import shutil
    import statistics

    import numpy as np

    from odise_torch import train_net
    from odise_torch.config import apply_overrides, auto_scale_workers, instantiate, load_config
    from odise_torch.config import resolve
    from odise_torch.data.coco_mask import annotations_to_masks
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.datasets.register_coco import (coco_meta, load_coco_panoptic_json,
                                                         load_instance_gt_index)
    from odise_torch.data.image_io import read_image, read_label, read_rgb_png
    from odise_torch.data.transforms import ResizeShortestEdge, rgb2id
    from odise_torch.engine.checkpoint import Checkpointer
    from odise_torch.evaluation.buckets import compute_eval_buckets
    from odise_torch.evaluation.run import evaluate_open_vocab, prep_record
    from odise_torch.models.wrapper import OpenPanopticInference

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "output", "chip_smoke_dataset")
    out = os.path.join(root, "run")
    shutil.rmtree(root, ignore_errors=True)
    faults = []
    check_nvjpeg()

    t0 = time.perf_counter()
    written = write_coco_dataset(root)
    log(f"wrote the COCO-layout dataset ({len(written)} images) in "
        f"{time.perf_counter() - t0:.1f} s")
    # every label file and instance mask read back
    meta = coco_meta()
    coco = os.path.join(root, "coco")
    for split in ("train", "val"):
        index = load_instance_gt_index(os.path.join(coco, "annotations",
                                                    f"instances_{split}2017.json"),
                                       meta["thing_dataset_id_to_contiguous_id"])
        for (s, image_id), w in written.items():
            if s != split:
                continue
            stem = f"{image_id:012d}.png"
            ids = rgb2id(read_rgb_png(os.path.join(coco, f"panoptic_{split}2017", stem)))
            sem = read_label(os.path.join(coco, f"panoptic_semseg_{split}2017", stem))
            masks = annotations_to_masks(index[image_id], 480, 640)
            drawn = np.stack([a["mask"] for a in w["anns"]])
            faults += [(not np.array_equal(ids, w["ids"]), f"panoptic PNG {split} {stem}"),
                       (not np.array_equal(sem, w["sem"]), f"semantic PNG {split} {stem}"),
                       (not np.array_equal(masks, drawn), f"instance masks {split} {stem}")]
    t0 = time.perf_counter()
    for _ in range(5):
        read_rgb_png(os.path.join(coco, "panoptic_val2017", "000000000100.png"))
    png_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"label files read back equal to what was written: "
        f"{not any(bad for bad, _ in faults)}; a 640x480 panoptic PNG decodes on the host in "
        f"{png_ms:.1f} ms")

    # the caption split carries captions, and the caption mapper reads them
    cap = load_coco_panoptic_json(
        os.path.join(coco, "annotations", "panoptic_train2017.json"),
        os.path.join(coco, "train2017"), os.path.join(coco, "panoptic_train2017"),
        os.path.join(coco, "panoptic_semseg_train2017"), meta,
        caption_json=os.path.join(coco, "annotations", "captions_train2017.json"))
    mapped = COCOPanopticDatasetMapper(with_captions=True, device="cuda")(cap[0])
    faults += [(len(cap[0].get("captions", ())) != 2, "caption records"),
               (not bool(mapped["word_valid"].any()) or mapped["word_tokens"].shape[-1] != 77,
                "the caption mapper's word_tokens")]
    log(f"caption split: {cap[0]['captions']} -> word_tokens "
        f"{tuple(mapped['word_tokens'].shape)}, {int(mapped['word_valid'].sum())} valid words")
    del mapped

    # the CLI in a subprocess, on the files
    config = os.path.join(here, "odise_torch", "configs", "Panoptic", "odise_label_coco_50e.py")
    opts = ["train.max_iter=4", "train.log_period=1"]
    argv = ["--config-file", config, "--output", out] + opts
    result_file = os.path.join(root, "cli.json")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_RUNNER, result_file] + argv, cwd=here,
                          env=dict(os.environ, DETECTRON2_DATASETS=root),
                          capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train_net on the files failed:\n{proc.stderr[-4000:]}")
    with open(result_file) as f:
        cli = json.load(f)
    text = proc.stdout + proc.stderr
    skipped = [t for t in ("eval_ade150", "eval_ctx59", "eval_ade847", "eval_ctx459",
                           "eval_pas21") if f"Skipping task {t}" in text]
    ms = [m["time"] * 1e3 for m in cli["history"]]
    host_share = [m["data_time"] / m["time"] for m in cli["history"]]
    main = cli["eval"].get("main", {})
    log(f"train_net on the files (subprocess, {cli_s:.1f} s, main {cli['seconds']:.1f} s): "
        f"steps " + ", ".join(f"{t:.1f} ms (total_loss {m['total_loss']:.6e}, grad_norm "
                               f"{m['grad_norm']:.4e}, data {m['data_time'] * 1e3:.1f} ms)"
                               for t, m in zip(ms, cli["history"]))
        + f"; final eval on {main.get('images')} images, {main.get('s_per_img', 0) * 1e3:.1f} "
        f"ms an image: PQ {main.get('PQ')}, mIoU {main.get('mIoU')}, AP {main.get('AP')}; "
        f"deform-attn launches forward {cli['launches'][0]}, backward {cli['launches'][1]}; "
        f"nvJPEG decodes {cli['jpeg_decodes']}; peak memory allocated {cli['peak_gib']:.2f} GiB; "
        f"extra tasks skipped with a warning: {skipped}")
    n_val = sum(1 for s, _ in written if s == "val")
    faults += [(len(cli["history"]) != 4, f"{len(cli['history'])} steps"),
               (not all(np.isfinite(m["total_loss"]) and m["grad_norm"] > 0
                        for m in cli["history"]), "non-finite loss or grad_norm 0"),
               (cli["launches"] != [6 * (4 + n_val), 6 * 4],
                f"launches {cli['launches']}, not 6 per step and eval image and 6 per step "
                "backward"),
               (sorted(cli["eval"]) != ["main"] or main.get("images") != n_val,
                f"evaluated {sorted(cli['eval'])}"),
               (not all(np.isfinite(main.get(k, float("nan"))) for k in ("PQ", "mIoU", "AP")),
                "non-finite PQ, mIoU or AP"),
               (len(skipped) != 5, f"extra tasks skipped: {skipped}"),
               (cli["jpeg_decodes"] < 2 * 4 + n_val,
                f"{cli['jpeg_decodes']} nvJPEG decodes")]

    # the same val records in memory, through the same weights, in this process
    cfg = load_config(config)
    cfg.train.output_dir = out
    cfg = auto_scale_workers(cfg, 1)
    apply_overrides(cfg, opts)
    cfg = resolve(cfg)
    model = train_net.build_model(cfg)
    Checkpointer(os.path.join(out, "checkpoints")).load(
        os.path.join(out, "checkpoints", "model_final.pth"), dict(model.named_parameters()))
    val = load_coco_panoptic_json(
        os.path.join(coco, "annotations", "panoptic_val2017.json"),
        os.path.join(coco, "val2017"), os.path.join(coco, "panoptic_val2017"),
        os.path.join(coco, "panoptic_semseg_val2017"), meta)
    memory = [{"image": read_image(r["file_name"], "cuda").cpu().numpy(),
               "pan_seg": rgb2id(read_rgb_png(r["pan_seg_file_name"])),
               "sem_seg": read_label(r["sem_seg_file_name"]),
               "segments_info": r["segments_info"], "image_id": r["image_id"]} for r in val]
    wrapper = instantiate(cfg.dataloader.wrapper)
    vocab = train_net.build_vocab_and_thing_mask(model, wrapper, model.train_labels)
    thing = vocab.thing_mask.cpu().numpy()
    short, longest = (cfg.dataloader.get("eval_short_side", 1024),
                      cfg.dataloader.get("eval_max_size", 2560))
    index = load_instance_gt_index(os.path.join(coco, "annotations", "instances_val2017.json"),
                                   meta["thing_dataset_id_to_contiguous_id"])
    # what the evaluation prepares from each file record: the same padded
    # image and ground truth as from its record in memory
    prep = [[prep_record(r, ResizeShortestEdge(short, longest), compute_eval_buckets(short,
                                                                                    longest),
                         thing, device="cuda", inst_gt_index=index) for r in recs]
            for recs in (val, memory)]
    def same(a, b):
        if torch.is_tensor(a):
            return torch.equal(a, b)
        return np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b

    unequal = [(i, k) for i, (a, b) in enumerate(zip(*prep)) for k in a if not same(a[k], b[k])]
    log(f"prepared inputs and gt of {len(val)} val images from files equal to those from "
        f"memory: {not unequal}")
    faults.append((bool(unequal), f"prepared from files and from memory differ: {unequal}"))
    zero_launch_counts()
    in_memory = evaluate_open_vocab(
        OpenPanopticInference(model, vocab), memory, labels=vocab.labels, thing_mask=thing,
        short_side=short, max_size=longest, inst_gt_index=index, task="in_memory")
    launches_memory = launch_counts()
    keys = sorted(k for k in main if k != "s_per_img")
    diffs = {k: abs(float(in_memory.get(k, float("nan"))) - float(main[k])) for k in keys}
    log(f"in memory, this process: PQ {in_memory['PQ']}, mIoU {in_memory['mIoU']}, AP "
        f"{in_memory['AP']}, {in_memory['s_per_img'] * 1e3:.1f} ms an image, launches "
        f"{launches_memory}; largest difference from the file-backed eval over {len(keys)} "
        f"metrics {max(diffs.values()):.3g} (tolerance 0)")
    faults += [(any(d != 0 for d in diffs.values()),
                f"file-backed eval differs from in memory: {({k: d for k, d in diffs.items() if d})}"),
               (launches_memory != (6 * n_val, 0), f"in-memory eval launches {launches_memory}")]

    # a main task whose files are absent raises before evaluating
    cfg.dataloader.wrapper["dataset_name"] = "ade20k_panoptic_val"
    cfg.extra_task = {}
    try:
        train_net.do_test(cfg, model)
        faults.append((True, "a main task with absent files was evaluated"))
    except FileNotFoundError as err:
        log(f"a main task with absent files raises: {type(err).__name__}: {err}")
    del model
    shutil.rmtree(root, ignore_errors=True)
    for bad, what in faults:
        if bad:
            raise AssertionError(f"dataset phase: {what}")
    return dict(launches=cli["launches"], first_ms=ms[0], warm_ms=statistics.median(ms[1:]),
                host_share=statistics.median(host_share[1:]), peak_gib=cli["peak_gib"],
                s_per_img=main["s_per_img"])


# phase 13: two ranks share the one card over gloo (NCCL refuses two ranks
# on one card); NCCL runs at world size 1
PARALLEL_WORLD = 2
PARALLEL_STEP_SEEDS = {"category": 0, "caption": 1}  # phase 8's loader and generator seeds
# the CLI's run: the shipped COCO recipe on phase 12's files, 3 steps at a
# total batch of 4 after auto_scale_workers(cfg, 2), the final eval on 3 images
PARALLEL_CLI_STEPS = 3
# one FULL step in float32, compared with its one-process run: metrics
# (the ranks' mean) 1e-4 relative; gradients within 1e-3 of each tensor's
# largest entry, or 1e-6 of the largest over all of them (a gradient that
# vanishes in exact arithmetic, a bias before a normalisation, is float32
# noise on both sides)
PARALLEL_METRIC_RTOL, PARALLEL_GRAD_REL, PARALLEL_GRAD_FLOOR = 1e-4, 1e-3, 1e-6


def _rank_tf32_off():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _digest(tensors):
    """sha256 of the tensors' bytes in name order: equal digests are
    bitwise equal tensors."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


class TimedAllReduce:
    """Inside ``with``, each call of the train step's all-reduce is timed
    from the host with a synchronize on either side, into ``ms``."""

    def __enter__(self):
        from odise_torch.engine import train_loop

        self.ms, self.plain = [], train_loop.all_reduce_mean_

        def timed(tensors):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.plain(tensors)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        train_loop.all_reduce_mean_ = timed
        return self

    def __exit__(self, *exc):
        from odise_torch.engine import train_loop

        train_loop.all_reduce_mean_ = self.plain


def collective_checks(device=None):
    """On this rank of a process group on the card: the collectives the
    port uses against values computed on the host. An all-reduce (sum) of
    4,096 floats; the train step's mean all-reduce of two tensors through
    one flat buffer; the grounding loss's gather along dim 0, forward and
    backward (each rank's rows get the sum over the ranks of their
    gradients), and without gradients; ``all_gather_object`` (which
    ``gather_pickled`` runs). Returns each one's largest absolute error
    (all must be 0: these sums are exact in float32) and the all-reduce's
    ms for 28,591,297 floats, the trainable gradients' size."""
    import numpy as np
    import torch.distributed as dist

    from odise_torch.parallel import multihost as mh

    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device

    def rows(r):
        return torch.from_numpy(np.random.RandomState(100 + r).randn(3, 5).astype(np.float32))

    def coef(r):
        return torch.from_numpy(np.random.RandomState(200 + r).randn(3 * world, 5)
                                .astype(np.float32))

    err = {}
    t = torch.arange(4096, dtype=torch.float32, device=dev) * (rank + 1)
    dist.all_reduce(t)
    err["all_reduce"] = float((t.cpu() - torch.arange(4096.0) * sum(range(1, world + 1)))
                              .abs().max())
    pair = [torch.full((7,), float(rank), device=dev), torch.full((2, 3), 2.0 * rank, device=dev)]
    if world > 1:
        mh.all_reduce_mean_(pair)
    else:  # the helper is the local path at world size 1: reduce directly
        dist.all_reduce(pair[0])
        dist.all_reduce(pair[1])
    mean = sum(range(world)) / world
    err["all_reduce_mean"] = max(float((pair[0].cpu() - mean).abs().max()),
                                 float((pair[1].cpu() - 2 * mean).abs().max()))
    x = rows(rank).to(dev).requires_grad_()
    gathered = mh._GatherRows.apply(x)
    err["gather"] = float((gathered.detach().cpu() - torch.cat([rows(r) for r in range(world)]))
                          .abs().max())
    (gathered * coef(rank).to(dev)).sum().backward()
    want = sum(coef(r) for r in range(world))[rank * 3:(rank + 1) * 3]
    err["gather_backward"] = float((x.grad.cpu() - want).abs().max())
    plain = mh._gather(x.detach()) if world == 1 else mh.all_gather_rows(x, False)
    err["gather_no_grad"] = float((plain.cpu() - torch.cat([rows(r) for r in range(world)]))
                                  .abs().max()) + float(plain.requires_grad)
    objs = [None] * world
    dist.all_gather_object(objs, {"rank": rank, "values": list(range(rank + 3))})
    if world > 1 and mh.gather_pickled({"rank": rank}) != [{"rank": r} for r in range(world)]:
        err["gather_pickled"] = 1.0
    err["all_gather_object"] = float(objs != [{"rank": r, "values": list(range(r + 3))}
                                              for r in range(world)])
    buf = torch.ones(28_591_297, device=dev)
    dist.all_reduce(buf)
    buf.sum().item()  # waits for the reduction
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(buf)
    buf.sum().item()
    return {"errors": err, "all_reduce_28m_ms": (time.perf_counter() - t0) / 3 * 1e3,
            "backend": dist.get_backend(), "world": world, "device": str(dev)}


def _collectives_rank(out_dir, device=None):
    import os

    with open(os.path.join(out_dir, f"collectives{torch.distributed.get_rank()}.json"),
              "w") as f:
        json.dump(collective_checks(device), f)


def _nccl_shared_card_rank(rank, url, out_dir):
    """Two NCCL ranks on card 0, as ``launch`` refuses to start them: what
    NCCL says."""
    import os

    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=url, world_size=2, rank=rank)
        t = torch.ones(1, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f"ran, all_reduce gave {t.item()}"
    except Exception as err:  # what NCCL reports is the finding
        msg = f"{type(err).__name__}: {err}"
    with open(os.path.join(out_dir, f"nccl{rank}.txt"), "w") as f:
        f.write(msg)
    os._exit(0)  # a failed NCCL communicator may not tear down


def nccl_shared_card_probe(out_dir, timeout_s=90):
    """Start two NCCL ranks on card 0 and return what each reported (or
    that it did not report within ``timeout_s``); stops both."""
    import os

    ctx = torch.multiprocessing.start_processes(
        _nccl_shared_card_rank, nprocs=2, args=(f"file://{out_dir}/nccl_rendezvous", out_dir),
        join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout_s
    exit_note = ""
    try:
        while not ctx.join(timeout=1) and time.perf_counter() < deadline:
            pass
    except torch.multiprocessing.ProcessExitedException as err:  # NCCL may abort a rank
        exit_note = f" ({err})"
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join()
    out = []
    for r in range(2):
        path = os.path.join(out_dir, f"nccl{r}.txt")
        out.append(open(path).read() if os.path.exists(path)
                   else f"no report within {timeout_s} s{exit_note}")
    return out


def full_step(kind, rows, reference=None, mesh=None):
    """One step of phase 8's recipe in float32 (TF32 off) on rows ``rows``
    of phase 8's first batch (its loader and generator seeds): FULL
    CategoryODISE or CaptionODISE (grounding over the ranks, "diff")
    without the CLIP head, pattern weights; with ``mesh``, the frozen
    towers sharded over its model axis (phase 15). In a process group every
    data rank draws the batch of 2's points and keeps its own. Returns the
    frozen towers' bytes held and whole, the metrics,
    the step's ms, the kernels' launches, peak memory, the all-reduce's ms
    and digests of the gradients and updated parameters; without
    ``reference`` the gradients themselves, digests of the criterion's
    uniform draws (``matcher.draw_rows``' results, image by image) and its
    two choices, the matcher's assignment and the importance-sampled points.

    ``reference`` (the file those went to in the one-process run at batch
    2) gives the draws and choices for this step's rows. Without a process
    group (one process at batch 1) the step draws the batch of 2's draws
    from its generator and keeps its rows, as a rank does. Either way the
    draws are held bitwise to the one process's (the generator is
    deterministic, so any difference is a slicing or generator fault); in a
    group each gradient's error against the one process's is returned. The
    step then takes the one process's choices:
    the pattern weights' queries and pixels differ little, so that float32
    noise (a batch of 1 runs other cuDNN and GEMM tilings than a batch of
    2) decides between assignments within the auction's increment of each
    other and between points of near-equal uncertainty. How many (layer,
    valid target) pairs the step's own choices differ in is returned
    beside a digest of those choices: a rank's and a one-process batch-1
    step's on the same image tell the batch's share from the ranks'."""
    from odise_torch.engine import (make_caption_train_step, make_category_train_step,
                                    make_optimizer)
    from odise_torch.losses import CriterionConfig, matcher
    from odise_torch.model_zoo.factory import build_caption_odise, build_category_odise
    from odise_torch.models.clip.tokenizer import tokenize

    _rank_tf32_off()
    caption = kind == "caption"
    seed = PARALLEL_STEP_SEEDS[kind]
    labels = None if caption else vocabulary(80, 53, "category")[0]
    # the frozen dict is dropped: it would keep the towers whole under a mesh
    model, trainable = build_for_training(
        build_caption_odise if caption else build_category_odise, labels, torch.float32)[:2]
    whole = frozen_bytes(model)
    if mesh is not None:
        from odise_torch.parallel import shard_params

        shard_params(model, mesh)
        torch.cuda.empty_cache()
    batch = {k: v[rows] for k, v in next(train_loader(640, caption, seed)).items()}
    opt = make_optimizer(trainable, lr=1e-4, weight_decay=0.05)
    if caption:
        step = make_caption_train_step(model, opt, CriterionConfig(num_classes=1),
                                       grad_clip=0.01)
    else:
        with torch.no_grad():
            text = model.encode_vocab(torch.from_numpy(
                tokenize([l[0] for l in labels])).long().cuda())
        step = make_category_train_step(model, opt, CriterionConfig(num_classes=len(labels)),
                                        text, labels, grad_clip=0.01)
    # the criterion's two choices: the assignment of queries to targets and
    # the importance-sampled points; the one process's, for this step's rows
    want = None if reference is None else torch.load(reference, weights_only=True)
    distributed = torch.distributed.is_initialized()
    crit = importlib.import_module("odise_torch.losses.set_criterion")
    plain_assign = matcher.assign_from_cost
    plain_points = crit.get_uncertain_point_coords_with_randomness
    plain_draw = matcher.draw_rows
    chosen = {"matched": [], "points": []}
    own = {"matched": [], "points": []}
    differ = {"matched": 0, "points": 0}
    drawn, draws_unequal = [], []  # each draw's digest for each image's rows
    valid = batch["gt_valid"].bool()
    T = valid.shape[1]

    def draw(generator, shape, device, kind, layer):
        n = shape[0] // len(rows)  # a draw's rows for one image
        if want is None or distributed:
            got = plain_draw(generator, shape, device, kind, layer)
        else:  # one process at batch 1: the batch of 2's draw, its rows
            both = matcher.draw_uniform(generator, (PARALLEL_WORLD * n,) + tuple(shape[1:]),
                                        device, kind, layer)
            got = torch.cat([both[r * n:(r + 1) * n] for r in rows])
        k = len(drawn)
        drawn.append([_digest({"rows": got[i * n:(i + 1) * n]}) for i in range(len(rows))])
        if want is not None and (k >= len(want["draws"])
                                 or drawn[k] != [want["draws"][k][r] for r in rows]):
            draws_unequal.append(f"draw {k} ({kind}, {layer}) {tuple(got.shape)}")
        return got

    def one_process_rows(got, key):
        own[key].append(got)
        if want is None:
            chosen[key].append(got)
            return got
        one = want[key][len(chosen[key])].to(got.device) if key == "points" else \
            want[key].to(got.device)
        if key == "matched":  # [layers * 2, T], layer by layer
            take = torch.cat([one[i * 2:(i + 1) * 2][rows] for i in range(one.shape[0] // 2)])
            differ[key] += int(((take != got) & valid.repeat(one.shape[0] // 2, 1)).sum())
        else:  # [2 * T, points, 2], image by image
            take = torch.cat([one[r * T:(r + 1) * T] for r in rows])
            differ[key] += int(((take != got).any(-1).any(-1) & valid.reshape(-1)).sum())
        chosen[key].append(take)
        return take

    def assign(cost):
        return one_process_rows(plain_assign(cost), "matched")

    def points(*args, **kwargs):
        return one_process_rows(plain_points(*args, **kwargs), "points")

    matcher.assign_from_cost, crit.get_uncertain_point_coords_with_randomness = assign, points
    matcher.draw_rows = draw
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with TimedAllReduce() as reduce:
            metrics = step(batch, torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
    finally:
        matcher.assign_from_cost = plain_assign
        crit.get_uncertain_point_coords_with_randomness = plain_points
        matcher.draw_rows = plain_draw
    ms = (time.perf_counter() - t0) * 1e3
    grads = {n: p.grad for n, p in trainable.items()}
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "ms": ms,
           "frozen_bytes": (frozen_bytes(model), whole),
           "launches": launch_counts(), "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "reduce_ms": reduce.ms, "images": len(rows),
           "grad_digest": _digest(grads), "param_digest": _digest(trainable)}
    if want is None:
        out["grads"] = {n: g.cpu() for n, g in grads.items()}
        out["draws"] = drawn
        out["matched"] = chosen["matched"][0].cpu()
        out["points"] = [p.cpu() for p in chosen["points"]]
        return out
    out["differ"] = differ
    out["valid"] = int(valid.sum()) * len(chosen["points"])
    out["own_digest"] = _digest({f"{key}{i}": t for key, ts in own.items()
                                 for i, t in enumerate(ts)})
    out["draws"] = len(drawn)
    if len(drawn) != len(want["draws"]):
        draws_unequal.append(f"{len(drawn)} draws, the one process {len(want['draws'])}")
    out["draws_unequal"] = draws_unequal
    if distributed:
        want = want["grads"]
        top = max(float(g.abs().max()) for g in want.values())
        worst = (0.0, "")
        for n, g in grads.items():
            w = want[n].cuda()
            bound = max(PARALLEL_GRAD_REL * float(w.abs().max()), PARALLEL_GRAD_FLOOR * top)
            ratio = float((g - w).abs().max()) / bound
            worst = max(worst, (ratio, n))
        out["grad_worst"] = worst
    return out


def _cli_rank(argv, out_dir):
    """``train_net.main(argv)`` on this rank, with the kernels' launches,
    who wrote checkpoints and metrics, and the all-reduce's time."""
    import os

    from odise_torch import train_net
    from odise_torch.engine.checkpoint import Checkpointer
    from odise_torch.utils.events import JSONWriter

    _rank_tf32_off()
    rank = torch.distributed.get_rank()
    writes = {"checkpoints": 0, "metrics": 0}
    save, write = Checkpointer.save, JSONWriter.write

    def counted_save(self, *a, **k):
        writes["checkpoints"] += 1
        return save(self, *a, **k)

    def counted_write(self, *a, **k):
        writes["metrics"] += 1
        return write(self, *a, **k)

    # the rank's process ends after this run: the counters stay in place
    Checkpointer.save, JSONWriter.write = counted_save, counted_write
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TimedAllReduce() as reduce:
        run = train_net.main(argv)
        torch.cuda.synchronize()
    trainable = {n: p for n, p in run.model.named_parameters() if p.requires_grad}
    with open(os.path.join(out_dir, f"cli{rank}.json"), "w") as f:
        json.dump({"seconds": time.perf_counter() - t0, "history": run.history,
                   "eval": run.eval_results, "launches": launch_counts(),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "writes": writes,
                   "reduce_ms": reduce.ms, "param_digest": _digest(trainable),
                   "device": str(next(run.model.parameters()).device)}, f, default=float)


# the one-process --eval-only run, in a subprocess so that its datasets
# register under DETECTRON2_DATASETS
EVAL_RUNNER = """
import json, sys
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from odise_torch import train_net
from odise_torch.ops.ms_deform_attn import ms_deform_attn
ms_deform_attn.launches = 0
results = train_net.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump({"eval": results, "launches": ms_deform_attn.launches}, f, default=float)
"""


def parallel_phase():
    """Phase 13: training and evaluation over two ranks. (a) The collectives
    on the card: a one-rank NCCL group and two gloo ranks sharing card 0,
    each check against the host's values; what NCCL reports for two ranks
    on one card. (b) One FULL float32 step of phase 8's recipe in one
    process at batch 2, then on two gloo ranks of one image each (the draws
    of the batch of 2, sliced; the one process's assignment of queries to
    targets and sampled points, see ``full_step``): each rank's own uniform
    draws bitwise equal to its rows of the one process's, the ranks' mean
    metrics within 1e-4 of the one process's, their all-reduced gradients within 1e-3 of its (each
    tensor's largest entry, or 1e-6 of the largest of all), both ranks'
    gradients and updated parameters bitwise equal; CategoryODISE, then
    CaptionODISE with the negatives gathered over the ranks ("diff").
    Beside it, not gated: one process at batch 1 on each image, on the
    batch of 2's draws, and how often its own choices differ from the batch
    of 2's and from the rank's on that image. (c)
    ``train_net`` on two gloo ranks on card 0 through ``launch``: the
    shipped ``odise_label_coco_50e.py`` on phase 12's files, 3 steps at a
    total batch of 4 (2 a rank), the final eval shared 2 + 1 over the 3
    val images; both ranks' parameters bitwise equal, only rank 0 writes,
    both ranks' merged metrics equal to a one-process ``--eval-only
    --init-from model_final``, 6 + 6 launches a step and 6 an eval image
    on each rank. Returns the numbers PERF.md and the kernels line take."""
    import os
    import shutil
    import statistics
    import subprocess

    import torch.distributed as dist

    from odise_torch.engine.launch import launch
    from odise_torch.parallel import initialize_multihost

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "output", "chip_smoke_parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    faults = []
    t_phase = time.perf_counter()

    # (a) the collectives
    t0 = time.perf_counter()
    initialize_multihost(f"file://{root}/nccl_one", 1, 0, device="cuda:0")
    nccl_one = collective_checks()
    dist.destroy_process_group()
    launch(_collectives_rank, PARALLEL_WORLD, dist_url=f"file://{root}/gloo_two",
           args=(root,), backend="gloo", device="cuda:0")
    gloo_two = [json.load(open(os.path.join(root, f"collectives{r}.json")))
                for r in range(PARALLEL_WORLD)]
    nccl_shared = nccl_shared_card_probe(root)
    for res in [nccl_one] + gloo_two:
        log(f"collectives, {res['backend']} world {res['world']} on {res['device']}: largest "
            f"errors {res['errors']}; all-reduce of 28,591,297 floats "
            f"{res['all_reduce_28m_ms']:.2f} ms")
        faults.append((any(e != 0 for e in res["errors"].values()),
                       f"{res['backend']} world {res['world']}: {res['errors']}"))
    log(f"two NCCL ranks on one card report: {nccl_shared}")
    seconds_a = time.perf_counter() - t0

    # (b) one step, one process at batch 2 against two ranks of one image
    t0 = time.perf_counter()
    steps = {}
    for kind in ("category", "caption"):
        one = full_step(kind, [0, 1])
        reference = os.path.join(root, f"{kind}_one.pt")
        torch.save({k: one.pop(k) for k in ("grads", "draws", "matched", "points")}, reference)
        steps[kind] = {"one": one}
        torch.cuda.empty_cache()
        # one process at batch 1 on each image, on the batch of 2's draws:
        # how often its own choices differ from the batch of 2's without ranks
        steps[kind]["alone"] = [full_step(kind, [r], reference) for r in range(PARALLEL_WORLD)]
        torch.cuda.empty_cache()
    launch(_full_steps_rank, PARALLEL_WORLD, dist_url=f"file://{root}/steps",
           args=(root,), backend="gloo", device="cuda:0")
    for kind in ("category", "caption"):
        ranks = [json.load(open(os.path.join(root, f"{kind}{r}.json")))
                 for r in range(PARALLEL_WORLD)]
        one, alone = steps[kind]["one"], steps[kind]["alone"]
        steps[kind]["ranks"] = ranks
        log(f"(b) {kind}: the ranks' uniform draws against the one process's rows, bitwise: "
            + "; ".join(f"rank {r}: {x['draws']} draws, unequal {x['draws_unequal']}"
                        for r, x in enumerate(ranks))
            + "; one process at batch 1 on the batch of 2's draws: " + "; ".join(
                f"image {r}: {a['draws']} draws, unequal {a['draws_unequal']}, "
                f"{a['ms']:.1f} ms, of its {a['valid']} (layer, valid target) "
                f"pairs its own auction matched {a['differ']['matched']} to another query "
                f"and its own sampling chose other points for {a['differ']['points']}; its "
                f"own choices equal rank {r}'s: {a['own_digest'] == ranks[r]['own_digest']}"
                for r, a in enumerate(alone)))
        rel = {k: abs(ranks[0]["metrics"][k] - v) / max(abs(v), 1e-30)
               for k, v in one["metrics"].items()}
        worst_metric = max(rel.items(), key=lambda kv: kv[1])
        log(f"(b) {kind}: one process, batch 2: {one['ms']:.1f} ms, total_loss "
            f"{one['metrics']['total_loss']:.6e}, grad_norm {one['metrics']['grad_norm']:.4e}, "
            f"launches {one['launches']}, peak {one['peak_gib']:.2f} GiB; two ranks of one "
            "image: " + "; ".join(
                f"rank {r}: {x['ms']:.1f} ms, launches {x['launches']}, peak "
                f"{x['peak_gib']:.2f} GiB, all-reduce {x['reduce_ms']} ms, gradients' worst "
                f"{x['grad_worst'][0]:.3g} of the bound ({x['grad_worst'][1]}); of its "
                f"{x['valid']} (layer, valid target) pairs its own auction matched "
                f"{x['differ']['matched']} to another query and its own sampling chose "
                f"other points for {x['differ']['points']}"
                for r, x in enumerate(ranks))
            + f"; the ranks' mean metrics' largest relative difference {worst_metric[1]:.3g} "
            f"({worst_metric[0]}); ranks bitwise equal: gradients "
            f"{ranks[0]['grad_digest'] == ranks[1]['grad_digest']}, parameters "
            f"{ranks[0]['param_digest'] == ranks[1]['param_digest']}")
        faults += [(any(x["draws"] == 0 or x["draws_unequal"] for x in ranks + alone),
                    f"(b) {kind} draws "
                    f"{[(x['draws'], x['draws_unequal']) for x in ranks + alone]}"),
                   (worst_metric[1] > PARALLEL_METRIC_RTOL, f"(b) {kind} metric {worst_metric}"),
                   (any(x["grad_worst"][0] > 1 for x in ranks),
                    f"(b) {kind} gradients {[x['grad_worst'] for x in ranks]}"),
                   (ranks[0]["grad_digest"] != ranks[1]["grad_digest"]
                    or ranks[0]["param_digest"] != ranks[1]["param_digest"],
                    f"(b) {kind}: the ranks' gradients or parameters differ"),
                   (tuple(one["launches"]) != (6, 6)
                    or any(tuple(x["launches"]) != (6, 6) for x in ranks),
                    f"(b) {kind} launches"),
                   (not all(len(x["reduce_ms"]) == 1 for x in ranks),
                    f"(b) {kind}: not one all-reduce a step")]
    seconds_b = time.perf_counter() - t0

    # (c) the CLI on two ranks, from phase 12's files
    t0 = time.perf_counter()
    written = write_coco_dataset(root)
    n_val = sum(1 for s, _ in written if s == "val")
    out = os.path.join(root, "run")
    config = os.path.join(here, "odise_torch", "configs", "Panoptic", "odise_label_coco_50e.py")
    opts = [f"train.max_iter={PARALLEL_CLI_STEPS}", "train.log_period=1",
            "train.device=cuda:0"]
    argv = ["--config-file", config, "--output", out] + opts
    saved_root = os.environ.get("DETECTRON2_DATASETS")
    os.environ["DETECTRON2_DATASETS"] = root  # the ranks register the datasets from it
    try:
        launch(_cli_rank, PARALLEL_WORLD, dist_url=f"file://{root}/cli", args=(argv, root),
               backend="gloo", device="cuda:0")
    finally:
        if saved_root is None:
            os.environ.pop("DETECTRON2_DATASETS")
        else:
            os.environ["DETECTRON2_DATASETS"] = saved_root
    cli = [json.load(open(os.path.join(root, f"cli{r}.json"))) for r in range(PARALLEL_WORLD)]
    result_file = os.path.join(root, "eval_only.json")
    proc = subprocess.run(
        [sys.executable, "-c", EVAL_RUNNER, result_file, "--config-file", config, "--output",
         os.path.join(root, "eval_only"), "--eval-only", "--init-from",
         os.path.join(out, "checkpoints", "model_final.pth")] + opts[2:],
        cwd=here, env=dict(os.environ, DETECTRON2_DATASETS=root), capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"--eval-only failed:\n{proc.stderr[-4000:]}")
    with open(result_file) as f:
        one = json.load(f)
    merged = [{k: v for k, v in c["eval"]["main"].items() if k != "s_per_img"} for c in cli]
    alone = {k: v for k, v in one["eval"]["main"].items() if k != "s_per_img"}
    diffs = {k: abs(merged[0][k] - v) / max(abs(v), 1e-30) for k, v in alone.items()}
    with open(os.path.join(out, "log.txt")) as f:
        main_log = f.read()
    files = sorted(os.listdir(out))
    for r, c in enumerate(cli):
        ms = [m["time"] * 1e3 for m in c["history"]]
        data_ms = [m["data_time"] * 1e3 for m in c["history"]]
        log(f"(c) rank {r} on {c['device']}: {c['seconds']:.1f} s; steps " + ", ".join(
            f"{t:.1f} ms (data {d:.1f} ms)" for t, d in zip(ms, data_ms))
            + f", warm median {statistics.median(ms[1:]):.1f} ms; all-reduce "
            f"{[round(x, 2) for x in c['reduce_ms']]} ms; launches {c['launches']}; peak "
            f"{c['peak_gib']:.2f} GiB; writes {c['writes']}; eval on "
            f"{c['eval']['main']['images']} images")
    log(f"(c) output files {files}; merged metrics equal on both ranks: "
        f"{merged[0] == merged[1]}; largest relative difference from the one-process "
        f"--eval-only (launches {one['launches']}) over {len(alone)} metrics "
        f"{max(diffs.values()):.3g}: PQ {alone.get('PQ')}, mIoU {alone.get('mIoU')}, "
        f"AP {alone.get('AP')}")
    own = [6 * (PARALLEL_CLI_STEPS + len(range(r, n_val, PARALLEL_WORLD)))
           for r in range(PARALLEL_WORLD)]
    faults += [(cli[0]["param_digest"] != cli[1]["param_digest"],
                "(c) the ranks' trainable parameters differ"),
               (cli[1]["writes"] != {"checkpoints": 0, "metrics": 0}
                or not all(cli[0]["writes"].values()), f"(c) writes {[c['writes'] for c in cli]}"),
               ("Rank 1 of 2" in main_log or "log.txt.rank1" not in files
                or "metrics.json" not in files or "checkpoints" not in files,
                f"(c) files {files}"),
               (merged[0] != merged[1], "(c) the ranks' merged metrics differ"),
               (merged[0].get("images") != n_val, f"(c) evaluated {merged[0].get('images')}"),
               (max(diffs.values()) > 1e-9, f"(c) differs from --eval-only: {diffs}"),
               (one["launches"] != 6 * n_val, f"(c) --eval-only launches {one['launches']}"),
               (any(tuple(c["launches"]) != (own[r], 6 * PARALLEL_CLI_STEPS)
                    for r, c in enumerate(cli)),
                f"(c) launches {[c['launches'] for c in cli]}, not {own} and "
                f"{6 * PARALLEL_CLI_STEPS}"),
               (any(len(c["history"]) != PARALLEL_CLI_STEPS for c in cli), "(c) steps")]
    seconds_c = time.perf_counter() - t0
    seconds = time.perf_counter() - t_phase
    log(f"phase 13: (a) {seconds_a:.1f} s, (b) {seconds_b:.1f} s, (c) {seconds_c:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    for bad, what in faults:
        if bad:
            raise AssertionError(f"parallel phase: {what}")
    return dict(seconds=seconds, nccl_shared=nccl_shared,
                collectives=[nccl_one] + gloo_two,
                steps={k: {"one_ms": v["one"]["ms"], "rank_ms": [x["ms"] for x in v["ranks"]],
                           "launches": [x["launches"] for x in v["ranks"]],
                           "reduce_ms": [x["reduce_ms"] for x in v["ranks"]]}
                       for k, v in steps.items()},
                cli=[{"launches": c["launches"], "peak_gib": c["peak_gib"],
                      "warm_ms": statistics.median([m["time"] * 1e3 for m in c["history"][1:]]),
                      "data_ms": [m["data_time"] * 1e3 for m in c["history"]],
                      "reduce_ms": c["reduce_ms"]} for c in cli])


def _full_steps_rank(out_dir):
    """(b) on this rank: the category step, then the caption step, each
    against the one process's file."""
    import os

    rank = torch.distributed.get_rank()
    for kind in ("category", "caption"):
        out = full_step(kind, [rank], os.path.join(out_dir, f"{kind}_one.pt"))
        with open(os.path.join(out_dir, f"{kind}{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.cuda.empty_cache()


# phase 14: (c)'s sampling, the JAX module's defaults; (e)'s ADE20K images
LDM_STEPS, LDM_WARM = 50, 3
PREPARE_STEMS = {"ADE_val_00000001": "ade", "ADE_val_00000002": "coco"}  # demo JPEGs


def with_dataset_root(root):
    """Register the ADE20K and COCO names under ``root`` (``None``: the
    default root again), dropping what they were."""
    from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from odise_torch.data.datasets.register_ade20k import register_ade20k
    from odise_torch.data.datasets.register_coco import register_coco_panoptic

    for name in DatasetCatalog.list():
        if name.startswith(("ade20k_", "coco_2017_")):
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)
    register_ade20k(root)
    register_coco_panoptic(root)


def ldm_phase():
    """Phase 14: Stable Diffusion's text-to-image sampling and the rest of
    the JAX package's tools. (a) TINY ``LatentDiffusion`` (widths 32, 32,
    64 x 2; 3 DDIM steps, 8x8 latents) on the card against the CPU on the
    same weights and starting latent, before the clip; (b) FULL SD v1.3
    (reference-layout weights from ``tests/test_torch_ldm.py`` through the
    port's converter), float32 with TF32 off, 2 DDIM steps, guidance 7.5,
    against the JAX package's run in ``tests/data/torch_ldm_reference.npz``:
    both embeddings, each step's guided eps and latent, the image before
    the clip; (c) the same weights in bf16 at the JAX module's defaults (50
    DDIM steps, guidance 7.5, one prompt at 512 px): first and warm image
    seconds, ms a DDIM step, the VAE decode's ms, peak memory; (d)
    ``analyze_model`` at FULL; (e) the port's dataset scripts on a raw
    ADE20K layout (two demo JPEGs with drawn semantic and instance PNGs)
    and phase 12's COCO layout, read back through the registrations,
    two prepared ADE20K images evaluated by the FULL CategoryODISE in bf16
    over ADE's 150 labels, and the semantic-PQ tool on the prepared COCO
    maps against themselves."""
    import os
    import shutil
    import statistics

    import numpy as np

    from odise_torch import analyze_model, evaluate_pq_for_semantic_segmentation as sem_pq
    from odise_torch.data.build import get_openseg_labels
    from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from odise_torch.data.datasets.register_ade20k import (ade150_categories,
                                                           load_ade_instance_gt_index)
    from odise_torch.data.image_io import read_label, write_png
    from odise_torch.evaluation.run import evaluate_open_vocab
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.models.clip.tokenizer import tokenize
    from odise_torch.models.sd.ldm import build_latent_diffusion
    from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary
    from odise_torch.prepare import (prepare_ade20k_ins_seg, prepare_ade20k_pan_seg,
                                     prepare_coco_semantic_annos_from_panoptic_annos as coco_sem)
    from tests.test_torch_ldm import (PROMPT, build_port, ldm_inputs, ldm_parity,
                                      load_reference)
    from tests.test_torch_prepare import ade_record_matches, write_ade20k_raw

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 parity
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    faults = []

    # (a) TINY on the card against the CPU, before the clip
    state, shas = ldm_inputs("tiny")
    ref = load_reference("tiny", shas)
    cpu = build_port("tiny", dict(state), "cpu")
    card = build_port("tiny", state, "cuda")
    tok, noise = torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["noise"])
    img_cpu = cpu.sample(tok, noise=noise)
    img_card = card.sample(tok, noise=noise).cpu()
    err_a = float((img_card - img_cpu).abs().max() / img_cpu.abs().max())
    log(f"(a) TINY LatentDiffusion, card vs CPU, image before the clip {tuple(img_card.shape)}: "
        f"max err {err_a:.3e} of the largest |x| (tolerance 1e-3)")
    faults.append((not err_a <= 1e-3, f"TINY card vs CPU {err_a:.3e}"))
    del cpu, card, state

    # (b) FULL float32 against the JAX package's run on the same weights
    t0 = time.perf_counter()
    made = ldm_inputs("full")
    log(f"(b) SD v1.3 in the reference's layout: "
        f"{sum(v.size for v in made[0].values()) / 1e9:.3f} B values, made in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errors, captures, model = ldm_parity("full", "cuda", made)
    log(f"(b) FULL float32 parity with the JAX package, 2 DDIM steps, guidance 7.5 "
        f"({time.perf_counter() - t0:.1f} s with the install):")
    for key, (err, tol) in errors.items():
        log(f"  {key:9s} max err {err:.3e} of JAX's largest |x| (tolerance {tol:g})"
            f"{'' if err <= tol else '  MISSED'}")
    steps = sorted(int(k[4:]) for k in errors if k.startswith("eps_"))
    log("  growth step to step: eps " + ", ".join(f"{errors[f'eps_{k}'][0]:.3e}" for k in steps)
        + "; latent " + ", ".join(f"{errors[f'latent_{k}'][0]:.3e}" for k in steps))
    faults.append((any(not e <= t for e, t in errors.values()),
                   f"FULL parity missed {[k for k, (e, t) in errors.items() if not e <= t]}"))
    del captures, made

    # (c) bf16 at the JAX module's defaults: 50 DDIM steps, guidance 7.5, 512 px
    fast = build_latent_diffusion("full", dtype=torch.bfloat16)
    fast.load_state_dict(model.state_dict())
    del model
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(tokenize([PROMPT])).long().cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    seconds, image = [], None
    for _ in range(1 + LDM_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image = fast.forward_test(tokens, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    latent = fast.initial_noise(1, gen, "cuda")
    decode_ms = []
    with torch.no_grad():
        for _ in range(LDM_WARM):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fast.decode_from_latent(latent.to(torch.bfloat16))
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    warm_s, decode = statistics.median(seconds[1:]), statistics.median(decode_ms)
    step_ms = (warm_s * 1e3 - decode) / fast.diffusion.num_timesteps
    ok = (tuple(image.shape) == (1, 3, 512, 512) and bool(torch.isfinite(image).all())
          and float(image.min()) >= 0 and float(image.max()) <= 1)
    log(f"(c) bf16, {fast.diffusion.num_timesteps} DDIM steps, guidance "
        f"{fast.guidance_scale}, 512 px: first image {seconds[0]:.3f} s, warm "
        f"{warm_s:.3f} s (median of {LDM_WARM}: {', '.join(f'{x:.3f}' for x in seconds[1:])}); "
        f"{step_ms:.2f} ms a DDIM step (UNet at batch 2 and the step's arithmetic, the "
        f"prompt's two embeddings spread over the steps), VAE decode {decode:.2f} ms; peak "
        f"{peak_gib:.2f} GiB; image {tuple(image.shape)} {str(image.dtype)[6:]}, in "
        f"[{float(image.min()):.3f}, {float(image.max()):.3f}], mean {float(image.float().mean()):.4f}, "
        f"{float(((image == 0) | (image == 1)).float().mean()):.4f} of values clipped")
    faults.append((not ok, "the bf16 image is not (1, 3, 512, 512), finite, in [0, 1]"))
    del fast, image, latent
    torch.cuda.empty_cache()

    # (d) the parameter tables at FULL
    t0 = time.perf_counter()
    counts = analyze_model.main(["--scale", "full", "--max-depth", "1"])
    log(f"(d) analyze_model at FULL: {counts['total']:,} parameters, "
        f"{counts['trainable']:,} trainable ({time.perf_counter() - t0:.1f} s)")
    faults.append((counts["trainable"] != 28_591_297, f"{counts['trainable']:,} trainable"))
    torch.cuda.empty_cache()

    # (e) the port's dataset scripts, then evaluation from what they wrote
    root = os.path.join("output", "chip_smoke_prepare")
    shutil.rmtree(root, ignore_errors=True)
    demo_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo", "examples")
    drawn = write_ade20k_raw(root, list(PREPARE_STEMS), h=480, w=640, images={
        stem: os.path.join(demo_dir, f"{name}.jpg") for stem, name in PREPARE_STEMS.items()})
    ade = os.path.join(root, "ADEChallengeData2016")
    os.makedirs(os.path.join(ade, "annotations_detectron2", "validation"))
    for stem, (sem, _) in drawn.items():  # datasets/prepare_ade20k_sem_seg.py's output
        write_png(os.path.join(ade, "annotations_detectron2", "validation", stem + ".png"),
                  np.where(sem == 0, 255, sem.astype(np.int64) - 1).astype(np.uint8))
    written = write_coco_dataset(root)
    for split in ("train", "val"):
        shutil.rmtree(os.path.join(root, "coco", f"panoptic_semseg_{split}2017"))
    t0 = time.perf_counter()
    prepare_ade20k_pan_seg.main(root)
    prepare_ade20k_ins_seg.main(root)
    coco_sem.main(root)
    prepare_s = time.perf_counter() - t0
    with_dataset_root(root)
    try:
        recs = DatasetCatalog.get("ade20k_panoptic_val")
        bad = [rec["image_id"] for rec in recs
               if not ade_record_matches(rec, *drawn[rec["image_id"]])]
        coco_bad = [key for key in written if key[0] == "val"]
        for rec in DatasetCatalog.get("coco_2017_val_panoptic_with_sem_seg"):
            if np.array_equal(read_label(rec["sem_seg_file_name"]),
                              written[("val", rec["image_id"])]["sem"]):
                coco_bad.remove(("val", rec["image_id"]))
        with open(os.path.join(ade, "ade20k_instance_val.json")) as f:
            n_inst = len(json.load(f)["annotations"])
        log(f"(e) prepare_ade20k_pan_seg, prepare_ade20k_ins_seg ({n_inst} instances) and "
            f"prepare_coco_semantic_annos_from_panoptic_annos in {prepare_s:.2f} s; read back "
            f"through ade20k_panoptic_val ({len(recs)} records) and "
            f"coco_2017_val_panoptic_with_sem_seg: {len(bad) + len(coco_bad)} differ from "
            f"what was drawn")
        faults += [(bad or coco_bad or len(recs) != len(drawn),
                    f"prepared files differ from what was drawn: {bad} {coco_bad}"),
                   (n_inst != 4 * len(drawn), f"{n_inst} ADE instances")]

        labels = tuple(tuple(l) for l in get_openseg_labels("ade20k_150", True))
        thing = np.asarray([bool(c["isthing"]) for c in ade150_categories()])
        eval_model = build_category_odise("full", train_labels=labels, dtype=torch.bfloat16)
        pattern_fill_(eval_model)
        vocab = build_open_vocabulary(eval_model, labels, thing_mask=thing)
        # the instance gt as train_net reads it for this task: the prepared
        # json's masks by PNG and key, its images by file name (C34)
        meta = MetadataCatalog.get("ade20k_panoptic_val")
        index = load_ade_instance_gt_index(meta.json_file,
                                           meta.thing_dataset_id_to_contiguous_id)
        zero_launch_counts()
        metrics = evaluate_open_vocab(OpenPanopticInference(eval_model, vocab), recs,
                                      labels=labels, thing_mask=thing, inst_gt_index=index,
                                      task="ade20k_prepared")
        eval_launches = launch_counts()
        log(f"(e) FULL CategoryODISE, bf16, over ADE's 150 labels on the {len(recs)} prepared "
            f"images, instances on ({sum(len(v) for v in index.values())} from the prepared "
            f"json): PQ {metrics['PQ']}, mIoU {metrics['mIoU']}, AP {metrics['AP']}, "
            f"{metrics['s_per_img'] * 1e3:.1f} ms an image, launches {eval_launches}")
        faults += [(eval_launches != (6 * len(recs), 0), f"launches {eval_launches}"),
                   (sum(len(v) for v in index.values()) != n_inst, "instance gt index"),
                   (not all(np.isfinite(metrics[k]) for k in ("PQ", "mIoU", "AP")),
                    "non-finite PQ, mIoU or AP")]
        del eval_model
        semseg = os.path.join(root, "coco", "panoptic_semseg_val2017")
        pq = sem_pq.main(["--pred-dir", semseg, "--gt-dir", semseg, "--num-classes", "133"])
        log(f"(e) evaluate_pq_for_semantic_segmentation, prepared COCO maps against "
            f"themselves: PQ {pq['PQ']}")
        faults.append((pq["PQ"] != 100.0, f"self PQ {pq['PQ']}"))
    finally:
        with_dataset_root(None)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    seconds_phase = time.perf_counter() - t_phase
    log(f"phase 14: {seconds_phase:.1f} s")
    for is_bad, what in faults:
        if is_bad:
            raise AssertionError(f"ldm phase: {what}")
    return dict(seconds=seconds_phase, tiny_err=err_a,
                parity={k: e for k, (e, _) in errors.items()}, first_s=seconds[0],
                warm_s=warm_s, step_ms=step_ms, decode_ms=decode, peak_gib=peak_gib,
                counts=counts, launches=eval_launches)


# phase 15: the mesh's model axis over two ranks sharing the card over gloo
MESH_MODEL = 2


def frozen_bytes(model):
    """Bytes of the frozen towers' parameters this process holds."""
    from odise_torch.parallel import is_frozen_path

    return sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if is_frozen_path(tuple(n.split("."))))


class TimedGathers:
    """Inside ``with``, each all-gather of a sharded weight over the model
    axis timed from the host with a synchronize on either side, into
    ``ms``."""

    def __enter__(self):
        from odise_torch.parallel import mesh

        self.ms, self.plain = [], mesh._GatherShards.forward

        def timed(ctx, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.plain(ctx, *args)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        mesh._GatherShards.forward = staticmethod(timed)
        return self

    def __exit__(self, *exc):
        from odise_torch.parallel import mesh

        mesh._GatherShards.forward = staticmethod(self.plain)


def _mesh_rank(out_dir):
    """Phase 15 on this rank of a (data 1, model 2) mesh: (a) phase 3's
    FULL bf16 model, its towers sharded, serving the 1024-px request twice
    (the first, then a warm one), the forward kernel held to float64 on the
    inputs the request gave the first encoder layer; (b) phase 8's float32
    step at batch 2 against the one process's file (``full_step``), both
    kernels held to float64 on the inputs the step gave that layer."""
    import os

    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.parallel import create_mesh, shard_params

    _rank_tf32_off()
    mesh = create_mesh(data=1, model=MESH_MODEL)
    rank = mesh.rank
    out = {"device": str(torch.cuda.current_device())}

    # (a) the request
    train_labels, thing133 = vocabulary(80, 53, "category")
    model = build_category_odise("full", train_labels=train_labels, device="cuda",
                                 dtype=torch.bfloat16)
    pattern_fill_(model)
    whole = frozen_bytes(model)
    plan = shard_params(model, mesh)
    torch.cuda.empty_cache()
    out["sharded_leaves"] = len(plan)
    out["request_frozen_bytes"] = (frozen_bytes(model), whole)
    image = pattern_image(1024, "cuda")
    layer0 = Layer0Inputs(model)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    records, gathers = [], []
    with torch.inference_mode():
        for _ in range(2):
            with TimedGathers() as timer:
                records += serve(model, [(train_labels, thing133)], image, train_labels)
            gathers.append((len(timer.ms), sum(timer.ms)))
    out["request_launches"] = launch_counts()
    out["request_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["request_ms"] = [r["ms"] for r in records]
    out["logit_sum"] = [r["logit_sum"] for r in records]
    out["gathers"] = gathers
    layer0.hook.remove()
    src, pos, ref_points, levels = layer0.first[tuple(SHAPES)]
    with torch.inference_mode():
        v, loc, attn = layer0.layer.self_attn.sampling_inputs(src + pos, ref_points, src,
                                                              levels)
        out["fwd_err"] = check_kernel(v, loc, attn, f"rank {rank}, sharded request's inputs, "
                                      "bfloat16")
    torch.save({"mask_cls": records[0]["mask_cls"].cpu(),
                "mask_pred": records[0]["mask_pred"].cpu()},
               os.path.join(out_dir, f"request{rank}.pt"))
    del model, layer0, records, src, pos, ref_points, v, loc, attn
    torch.cuda.empty_cache()

    # (b) the train step
    first = FirstTrainInputs()
    try:
        with TimedGathers() as timer:
            out["step"] = full_step("category", [0, 1],
                                    os.path.join(out_dir, "category_one.pt"), mesh)
    finally:
        first.hook.remove()
    out["step_gathers"] = (len(timer.ms), sum(timer.ms))
    v, loc, attn, levels = first.inputs
    gen = torch.Generator(device="cuda").manual_seed(5)
    out["step_fwd_err"] = check_kernel(v, loc, attn, f"rank {rank}, sharded step's inputs, "
                                       "float32", levels)
    out["bwd_err"] = check_backward(v, loc, attn, f"rank {rank}, sharded step's inputs, "
                                    "float32", levels, gen)[0]
    with open(os.path.join(out_dir, f"mesh{rank}.json"), "w") as f:
        json.dump(out, f)


def mesh_phase():
    """Phase 15: the mesh's ``model`` axis (``odise_torch/parallel/
    mesh.py``) at FULL on two ranks sharing card 0 over gloo, each holding
    half of every tower leaf JAX's rule shards, against one unsharded
    process on the same pattern weights: (a) phase 3's bf16 1024-px
    request, ``mask_cls`` and ``mask_pred`` within 1e-3 of the process's
    largest magnitude (the largest difference printed) and the checksum
    within 1e-3 of ``LOGIT_SUMS``; (b) phase 8's float32 step at batch 2 (``full_step``:
    the process's assignment and points), metrics within 1e-4 and
    gradients within 1e-3 as phase 13 (b), both ranks bitwise equal; each
    kernel held to float64 on the inputs the ranks' runs gave it; 6
    forward launches a request, 6 + 6 a step. Per rank: the frozen bytes
    held against the whole, peak memory, request and step ms, the
    gathers' count and ms."""
    import os
    import shutil

    from odise_torch.engine.launch import launch
    from odise_torch.model_zoo.factory import build_category_odise

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "output", "chip_smoke_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    _rank_tf32_off()

    # the one process: (a)'s request and (b)'s step, unsharded
    train_labels, thing133 = vocabulary(80, 53, "category")
    model = build_category_odise("full", train_labels=train_labels, device="cuda",
                                 dtype=torch.bfloat16)
    pattern_fill_(model)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        one_req = serve(model, [(train_labels, thing133)] * 2, pattern_image(1024, "cuda"),
                        train_labels)
    one_req_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    one_out = {k: one_req[0][k].float().cpu() for k in ("mask_cls", "mask_pred")}
    one_req_ms = ", ".join(f"{q['ms']:.1f}" for q in one_req)
    del model, one_req
    torch.cuda.empty_cache()
    one = full_step("category", [0, 1])
    torch.save({k: one.pop(k) for k in ("grads", "draws", "matched", "points")},
               os.path.join(root, "category_one.pt"))
    torch.cuda.empty_cache()
    seconds_one = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    launch(_mesh_rank, MESH_MODEL, dist_url=f"file://{root}/mesh", args=(root,),
           backend="gloo", device="cuda:0")
    seconds_ranks = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(root, f"mesh{r}.json"))) for r in range(MESH_MODEL)]
    outs = [torch.load(os.path.join(root, f"request{r}.pt")) for r in range(MESH_MODEL)]
    faults = []
    want = LOGIT_SUMS[len(train_labels)]
    for r, (x, o) in enumerate(zip(ranks, outs)):
        diff = {k: float((o[k].float() - one_out[k]).abs().max()) for k in one_out}
        held, whole = x["request_frozen_bytes"]
        log(f"(a) rank {r}: {x['sharded_leaves']} tower leaves sharded, frozen towers "
            f"{held / 2 ** 30:.3f} of {whole / 2 ** 30:.3f} GiB held; requests "
            + ", ".join(f"{ms:.1f}" for ms in x["request_ms"])
            + f" ms (the one process {one_req_ms} ms); gathers a request "
            + ", ".join(f"{n} in {ms:.1f} ms" for n, ms in x["gathers"])
            + f"; peak {x['request_peak_gib']:.2f} GiB (the one process "
            f"{one_req_peak:.2f}); launches {x['request_launches']}; logit_sum "
            f"{x['logit_sum'][0]:.6e} (recorded {want:.6e}); largest difference from the "
            f"one process: mask_cls {diff['mask_cls']:.3e}, mask_pred {diff['mask_pred']:.3e}")
        faults += [(not all(abs(ls - want) <= 1e-3 * want for ls in x["logit_sum"]),
                    f"(a) rank {r} logit_sum {x['logit_sum']}"),
                   (not all(diff[k] <= 1e-3 * float(one_out[k].abs().max()) for k in diff),
                    f"(a) rank {r} differs from the one process: {diff}"),
                   (tuple(x["request_launches"]) != (12, 0),
                    f"(a) rank {r} launches {x['request_launches']}"),
                   (not 2 * held < 1.01 * whole, f"(a) rank {r} holds {held} of {whole}")]
        st = x["step"]
        rel = {k: abs(st["metrics"][k] - v) / max(abs(v), 1e-30)
               for k, v in one["metrics"].items()}
        worst_metric = max(rel.items(), key=lambda kv: kv[1])
        held, whole = st["frozen_bytes"]
        log(f"(b) rank {r}: frozen towers {held / 2 ** 30:.3f} of {whole / 2 ** 30:.3f} GiB "
            f"held; step {st['ms']:.1f} ms (the one process {one['ms']:.1f} ms), gathers "
            f"{x['step_gathers'][0]} in {x['step_gathers'][1]:.1f} ms; peak "
            f"{st['peak_gib']:.2f} GiB (the one process {one['peak_gib']:.2f}); launches "
            f"{st['launches']}; total_loss {st['metrics']['total_loss']:.6e} (the one process "
            f"{one['metrics']['total_loss']:.6e}), largest relative metric difference "
            f"{worst_metric[1]:.3g} ({worst_metric[0]}); gradients' worst "
            f"{st['grad_worst'][0]:.3g} of the bound ({st['grad_worst'][1]}); its own "
            f"auction matched {st['differ']['matched']} and its own sampling chose other "
            f"points for {st['differ']['points']} of {st['valid']} (layer, valid target) "
            f"pairs; draws {st['draws']}, unequal {st['draws_unequal']}")
        faults += [(worst_metric[1] > PARALLEL_METRIC_RTOL, f"(b) rank {r} metric {worst_metric}"),
                   (st["grad_worst"][0] > 1, f"(b) rank {r} gradients {st['grad_worst']}"),
                   (st["draws"] == 0 or st["draws_unequal"], f"(b) rank {r} draws"),
                   (tuple(st["launches"]) != (6, 6), f"(b) rank {r} launches {st['launches']}"),
                   (not 2 * held < 1.01 * whole, f"(b) rank {r} holds {held} of {whole}")]
    faults += [(ranks[0]["step"]["grad_digest"] != ranks[1]["step"]["grad_digest"]
                or ranks[0]["step"]["param_digest"] != ranks[1]["step"]["param_digest"],
                "(b) the ranks' gradients or parameters differ")]
    seconds = time.perf_counter() - t_phase
    log(f"phase 15: the one process {seconds_one:.1f} s, the two ranks {seconds_ranks:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    for bad, what in faults:
        if bad:
            raise AssertionError(f"mesh phase: {what}")
    return dict(seconds=seconds, fwd_err=max(max(x["fwd_err"], x["step_fwd_err"]) for x in ranks),
                bwd_err=max(x["bwd_err"] for x in ranks),
                launches={"request_per_rank": [x["request_launches"] for x in ranks],
                          "step_per_rank": [x["step"]["launches"] for x in ranks]},
                request_ms=[x["request_ms"] for x in ranks],
                step_ms=[x["step"]["ms"] for x in ranks])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.ops.ms_deform_attn import (backward_plan, launch, launch_plan,
                                                ms_deform_attn)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    clock = [time.perf_counter()]

    def phase_done(n):
        now = time.perf_counter()
        log(f"phase {n} took {now - clock[0]:.1f} s")
        clock[0] = now

    # 1. build
    build_kernels()
    phase_done(1)

    # 2. kernel vs plain at the main-path shapes and the extreme buckets' levels
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = []
    for shapes in (SHAPES, WIDE, TALL):
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("random", "out_of_range", "pixel_centres"):
                errs.append(check_kernel(*deform_inputs(kind, dtype, gen, shapes),
                                         f"{shapes}, {kind}, {str(dtype)[6:]}", shapes))
    Lq = sum(h * w for h, w in WIDE)
    plan = launch_plan(1, Lq, HEADS, HEAD_DIM, torch.bfloat16, len(WIDE), POINTS)
    log(f"launch plan at {Lq} queries (1024x2560 bucket, bf16): {plan}, {plan.warps} warps")
    # the backward kernel: the main path's levels at batch 2 (among them
    # where a fresh encoder samples), samples spread so wide that most
    # corners of a level larger than the window miss it, a generic level and
    # point count, and far-out locations
    bwd_errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("random", "out_of_range", "pixel_centres", "encoder_start"):
            bwd_errs.append(check_backward(
                *deform_inputs(kind, dtype, gen, batch=2),
                f"{SHAPES}, batch 2, {kind}, {str(dtype)[6:]}", SHAPES, gen)[0])
        err, counts = check_backward(
            *deform_inputs("spread", dtype, gen, SPREAD, batch=2),
            f"{SPREAD}, batch 2, spread, {str(dtype)[6:]}", SPREAD, gen)
        bwd_errs.append(err)
        if not counts.in_shared_share[-1] < 0.5:
            raise AssertionError("the spread case summed most corners on chip")
        bwd_errs.append(check_backward(
            *deform_inputs("random", dtype, gen, GENERIC, batch=2, points=3),
            f"{GENERIC}, 3 points, batch 2, {str(dtype)[6:]}", GENERIC, gen)[0])
        check_backward_far_out(dtype, gen)
    phase_done(2)

    # 3. the main path: FULL width, bf16, four 1024-px requests
    train_labels, thing133 = vocabulary(80, 53, "category")
    t0 = time.perf_counter()
    model = build_category_odise("full", train_labels=train_labels,
                                 device="cuda", dtype=torch.bfloat16)
    n_params = pattern_fill_(model)
    torch.cuda.synchronize()
    log(f"FULL model: {n_params / 1e9:.3f} B parameters, built and filled in "
        f"{time.perf_counter() - t0:.1f} s")
    vocab20 = vocabulary(12, 8, "other")
    # the 4th request repeats the 3rd: it separates a vocabulary's first-use
    # cost from its steady cost
    requests = [(train_labels, thing133), (train_labels, thing133), vocab20, vocab20]
    image = pattern_image(1024, "cuda")

    layer0 = Layer0Inputs(model)
    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = 0
    with torch.inference_mode():
        records = serve(model, requests, image, train_labels)
    launches = ms_deform_attn.launches
    layer0.hook.remove()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, r in enumerate(records):
        log(f"request {i}: {r['ms']:.1f} ms, K={r['K']}, logit_sum {r['logit_sum']:.6e}, "
            f"sem_sum {r['sem_sum']:.6e}, segments {r['segments']}")
    log(f"peak memory allocated: {peak_gib:.2f} GiB; deform-attn launches {launches}")
    if launches != 6 * len(requests):
        raise AssertionError(f"{launches} kernel launches for {len(requests)} "
                             f"images; expected 6 per image")
    if records[0]["logit_sum"] != records[1]["logit_sum"]:
        log("note: two identical requests gave different checksums "
            f"({records[0]['logit_sum']!r} vs {records[1]['logit_sum']!r})")
    for r in records:
        want = LOGIT_SUMS[r["K"]]
        if not abs(r["logit_sum"] - want) <= 1e-3 * want:
            raise AssertionError(f"K={r['K']} logit_sum {r['logit_sum']:.6e} is not "
                                 f"within 1e-3 of the recorded {want:.6e}")
    del records
    phase_done(3)

    # 4. the kernel on the main path's own inputs (first encoder layer)
    if layer0.levels != [SHAPES] * len(requests):
        raise AssertionError(f"unexpected main-path level shapes {layer0.levels}")
    main_path, (v, loc, attn) = kernel_on_inputs(layer0, SHAPES,
                                                 "main-path inputs, bfloat16")
    if v.dtype != torch.bfloat16:
        raise AssertionError(f"the main path ran the kernel in {v.dtype}")
    errs.append(main_path["max_abs_err"])
    B, Lq, H, L, P = loc.shape[:5]
    plan = launch_plan(B, Lq, H, v.shape[3], v.dtype, L, P)
    log(f"main-path launch plan: {plan}, {plan.warps} warps")
    with torch.inference_mode():
        generic = plan._replace(specialised=False)
        same = torch.equal(launch(v, SHAPES, loc, attn, generic),
                           ms_deform_attn(v, SHAPES, loc, attn))
        generic_ms = time_cold(lambda: launch(v, SHAPES, loc, attn, generic))
        generic_warm_ms = time_warm(lambda: launch(v, SHAPES, loc, attn, generic))
    log(f"generic variant on the same inputs: {generic_ms:.4f} ms cold, "
        f"{generic_warm_ms:.4f} ms warm; output bitwise equal to the main "
        f"path's variant: {same}")
    if not same:
        raise AssertionError("the generic variant's output differs from the "
                             "main path's variant on the same inputs")
    phase_done(4)

    # 5. one more warm K=133 request under the profiler
    in_place = profile_request(lambda: serve(model, [requests[0]], image, train_labels))
    names = sorted({name for name, _ in in_place})
    log(f"deform attn launched in the request as {names}")
    ran = [m.groups() for m in map(KERNEL_ARGS.search, names) if m]
    if len(in_place) != 6 or len(names) != 1 or len(ran) != 1:
        raise AssertionError(f"the profiler saw {len(in_place)} {KERNEL} launches "
                             f"under {len(names)} names in one request, expected 6 "
                             "under one name with readable template arguments")
    elem_type, elems, levels, points = ran[0]
    vector_bytes = ELEMENT_BYTES[elem_type] * int(elems)
    if (elem_type, vector_bytes, levels, points) != ("__nv_bfloat16", 16, "3", "4"):
        raise AssertionError("the main path did not run 16-byte bf16 chunks in "
                             "the variant for 3 levels of 4 points")
    in_place_ms = sum(ms for _, ms in in_place) / len(in_place)
    log(f"deform attn in place: {sum(ms for _, ms in in_place):.4f} ms over "
        f"{len(in_place)} launches, {in_place_ms:.4f} ms per launch, "
        f"{vector_bytes}-byte chunks")
    del layer0
    phase_done(5)

    # 6. small-input reference: TINY on the card (kernel) vs on the CPU (plain)
    tiny_labels, tiny_thing = vocabulary(2, 1, "tiny")
    cpu_model = build_category_odise("tiny", train_labels=tiny_labels, device="cpu",
                                     backbone_in_size=(128, 128))
    gpu_model = build_category_odise("tiny", train_labels=tiny_labels, device="cuda",
                                     backbone_in_size=(128, 128))
    gpu_model.load_state_dict(cpu_model.state_dict())
    tiny_req = [(tiny_labels, tiny_thing)]
    with torch.no_grad():
        rc = serve(cpu_model, tiny_req, pattern_image(128, "cpu"), tiny_labels)[0]
        rg = serve(gpu_model, tiny_req, pattern_image(128, "cuda"), tiny_labels)[0]
    for name in ("mask_cls", "mask_pred"):
        err = float((rg[name].cpu() - rc[name]).abs().max())
        log(f"TINY card vs CPU {name}: max_abs_err {err:.3e} (tolerance 1e-3)")
        if not err <= 1e-3:  # float32 through ~100 layers, other sum orders
            raise AssertionError(f"TINY {name} on the card disagrees with the CPU")
    del cpu_model, gpu_model
    phase_done(6)

    # 7. the evaluation path at any image size, both FULL models
    from odise_torch.data.build import coco_panoptic_thing_mask, get_openseg_labels

    records = eval_records()
    coco = tuple(tuple(l) for l in get_openseg_labels("coco_panoptic", True))
    coco_thing = coco_panoptic_thing_mask()
    largest, launches_eval = eval_category(model, records, coco, coco_thing)
    del model
    torch.cuda.empty_cache()
    launches_eval += eval_caption(records, coco, coco_thing, image)
    phase_done(7)

    # 8. training: FULL CategoryODISE and CaptionODISE steps, TINY card vs CPU
    torch.cuda.empty_cache()
    train = train_category(train_labels)
    bwd_errs.append(train["bwd"]["max_abs_err"])
    tiny_train_card_vs_cpu()
    train_caption()
    phase_done(8)

    # 9. the train and eval CLI at FULL width: train, resume, evaluate
    cli = train_net_phase()
    phase_done(9)

    # 10. learning: the synthetic convergence run, both variants
    conv = convergence_phase()
    errs.append(conv["max_abs_err"]["fwd"])
    bwd_errs.append(conv["max_abs_err"]["bwd"])
    phase_done(10)

    # 11. the reference's checkpoint layouts: model zoo, FULL parity, demo
    torch.cuda.empty_cache()
    ref_w = reference_weights_phase()
    errs.append(ref_w["kernel"]["max_abs_err"])
    phase_done(11)

    # 12. the shipped COCO recipe from files: train and evaluate through the CLI
    torch.cuda.empty_cache()
    data = dataset_phase()
    log(f"phase 12: first step {data['first_ms']:.1f} ms, warm {data['warm_ms']:.1f} ms "
        f"(median of steps 2 to 4), loader's host share of a warm step "
        f"{data['host_share']:.3f}, {data['s_per_img'] * 1e3:.1f} ms an eval image, peak "
        f"{data['peak_gib']:.2f} GiB")
    phase_done(12)

    # 13. two ranks: the collectives, a FULL step against one process, the CLI
    torch.cuda.empty_cache()
    par = parallel_phase()
    log(f"phase 13: {par['seconds']:.1f} s")
    phase_done(13)

    # 14. SD's text-to-image sampling, analyze_model, the dataset scripts
    torch.cuda.empty_cache()
    ldm = ldm_phase()
    phase_done(14)

    # 15. the mesh's model axis: the towers sharded over two ranks
    torch.cuda.empty_cache()
    mesh = mesh_phase()
    errs.append(mesh["fwd_err"])
    bwd_errs.append(mesh["bwd_err"])
    phase_done(15)

    log(card_line())
    bwd_plan = backward_plan(2, sum(h * w for h, w in SHAPES), HEADS, HEAD_DIM, torch.bfloat16,
                             POINTS)
    print(json.dumps({"kernels": [{
        "name": "ms_deform_attn", "route": "cuda",
        "source": "odise_torch/csrc/ms_deform_attn.cu",
        "replaces": "odise_tpu/ops/pallas/ms_deform_attn_kernel.py:157",
        "launches": launches, "max_abs_err": max(errs + [largest["max_abs_err"]]),
        "ms": main_path["ms"], "warm_ms": main_path["warm_ms"], "in_place_ms": in_place_ms,
        "vector_bytes": vector_bytes, "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"], "library_ms": None,
        "launches_eval": launches_eval,
        "launches_train": train["launches"][0],
        "launches_train_net": {k: v[0] for k, v in cli["launches"].items()},
        "launches_dataset_train_net": data["launches"][0],
        "launches_parallel": {"step_per_rank": {k: [ln[0] for ln in v["launches"]]
                                                for k, v in par["steps"].items()},
                              "train_net_per_rank": [c["launches"][0] for c in par["cli"]]},
        "launches_reference_weights": {"parity": ref_w["parity_launches"],
                                       "demo": [r["launches"] for r in ref_w["demo"]]},
        "reference_weights_512px_f32": {k: ref_w["kernel"][k] for k in (
            "max_abs_err", "ms", "warm_ms", "plain_ms", "bound_ms", "bound_by")},
        "launches_prepared_ade20k_eval": ldm["launches"][0],
        "launches_mesh": {"request_per_rank": [ln[0] for ln in
                                               mesh["launches"]["request_per_rank"]],
                          "step_per_rank": [ln[0] for ln in mesh["launches"]["step_per_rank"]]},
        "in_place_train_ms": train["fwd_in_place_ms"],
        "bucket_shapes_checked": [SHAPES, WIDE, TALL],
        "largest_bucket": largest}, {
        "name": "ms_deform_attn_bwd", "route": "cuda",
        "source": "odise_torch/csrc/ms_deform_attn.cu",
        "replaces": "odise_tpu/ops/pallas/ms_deform_attn_kernel.py:285 (XLA VJP)",
        "launches": train["launches"][1], "max_abs_err": max(bwd_errs),
        "ms": train["bwd"]["ms"], "warm_ms": train["bwd"]["warm_ms"],
        "in_place_ms": train["bwd_in_place_ms"], "vector_bytes": train["bwd_vector_bytes"],
        "plain_ms": train["bwd"]["plain_ms"],
        "bound_ms": train["bwd"]["bound_ms"], "bound_by": train["bwd"]["bound_by"],
        "library_ms": None, "smem_bytes": bwd_plan.smem_bytes,
        "global_reductions": train["bwd"]["global_reductions"],
        "direct_reductions": train["bwd"]["direct_reductions"],
        "in_shared_share": train["bwd"]["in_shared_share"],
        "encoder_start": {k: train["bwd_encoder_start"][k] for k in (
            "ms", "warm_ms", "plain_ms", "bound_ms", "global_reductions",
            "direct_reductions", "in_shared_share")},
        "train_batch": 2,
        "train_first_step_ms": train["first_ms"], "train_warm_step_ms": train["warm_ms"],
        "train_peak_gib": train["peak_gib"],
        "launches_train_net": {k: v[1] for k, v in cli["launches"].items()},
        "launches_dataset_train_net": data["launches"][1],
        "launches_prepared_ade20k_eval": ldm["launches"][1],
        "launches_mesh": {"step_per_rank": [ln[1] for ln in mesh["launches"]["step_per_rank"]]},
        "launches_parallel": {"step_per_rank": {k: [ln[1] for ln in v["launches"]]
                                                for k, v in par["steps"].items()},
                              "train_net_per_rank": [c["launches"][1] for c in par["cli"]]}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
