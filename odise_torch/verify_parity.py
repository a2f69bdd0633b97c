"""Per-stage parity of the port against a capture of the reference or of
the JAX package (counterpart of ``tools/verify_parity.py``).

    python -m odise_torch.verify_parity --ref ref_acts.npz \\
        --sd-ckpt sd-v1-3.ckpt --clip-ckpt clip.pth --odise-ckpt odise.pth

captures the port's stages on the same input (``capture_activations``: the
ramp image or ``--image``), holds each against the file's under
``TOLERANCES`` (relative to the reference's largest magnitude), and, where
the file has a ``panoptic`` map, the port's map against it (>= 95% of the
pixels). Exit code 0 iff every stage passes. A capture of the reference
needs its tensors channel-last ([B, H, W, C]).

    python -m odise_torch.verify_parity --self-check

needs no weights: TINY with the CLIP head from a seeded start; the
trainable weights round-trip through the port's ``Checkpointer`` and must
give bit-identical stages and panoptic maps, and the evaluation's
statistics on the device must give the host's metrics on ground truth made
from the model's own predictions.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from .capture_activations import (build_with_weights, capture_activations, load_image,
                                  ramp_image)
from .models.inference import panoptic_inference, semantic_inference

# per-stage relative tolerance for bf16-scale agreement with the reference:
# the frozen towers' taps tightly, the decoder heads (9 layers) looser
TOLERANCES = [
    ("tap_", 2e-2),
    ("backbone_", 3e-2),
    ("head_", 5e-2),
    # CLIP-head ensembled log-probs: error compounds through two softmaxes
    ("clip_", 5e-2),
]


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    """max|a - b| / max|b| (max|a| where b is all zero)."""
    denom = np.abs(b).max()
    if denom == 0:
        return float(np.abs(a).max())
    return float(np.abs(a - b).max() / denom)


def diff_captures(ours: Mapping, ref: Mapping,
                  tolerances: Sequence[Tuple[str, float]] = TOLERANCES) -> bool:
    """Print each shared stage's relative error beside its tolerance (the
    first prefix of ``tolerances`` that matches, else 1e-2); True iff all
    pass and the shapes agree."""
    ok = True
    print(f"{'stage':28s} {'shape':20s} {'max rel err':>12s}  verdict")
    for key in sorted(set(ours) & set(ref)):
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        if a.shape != b.shape:
            print(f"{key:28s} {str(list(a.shape)):20s} SHAPE MISMATCH ref={list(b.shape)}")
            ok = False
            continue
        tol = next((t for p, t in tolerances if key.startswith(p)), 1e-2)
        e = rel_err(a, b)
        ok &= e <= tol
        print(f"{key:28s} {str(list(a.shape)):20s} {e:12.2e}  "
              f"{'ok' if e <= tol else f'FAIL (tol {tol:g})'}")
    missing = sorted(set(ref) - set(ours) - {"panoptic"})
    if missing:
        print(f"reference-only keys not compared: {missing}")
    return ok


def eval_mask_cls(model, img: np.ndarray):
    """(mask_cls, mask_pred) of ``forward_eval`` on one [H, W, 3] image
    with a synthetic vocabulary: the model's training labels, raw text
    embeds on a linspace, no CLIP head."""
    device = next(model.parameters()).device
    K = len(model.train_labels)
    clip_dim = model.category_head.null_embed.shape[-1]
    text = np.linspace(-1, 1, K * clip_dim).reshape(K, clip_dim).astype(np.float32)
    with torch.no_grad():
        return model.forward_eval(
            torch.from_numpy(np.asarray(img, np.float32)[None]).to(device),
            torch.from_numpy(text).to(device), model.train_labels)


def fuse_panoptic(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> np.ndarray:
    """The panoptic id map of one image's eval outputs (every label a
    thing, overlap threshold 0.8), fused on the CPU."""
    thing = torch.ones((mask_cls.shape[-1] - 1,), dtype=torch.bool)
    pan = panoptic_inference(mask_cls[0].float().cpu(), mask_pred[0].float().cpu(), thing,
                             object_mask_threshold=0.0, overlap_threshold=0.8)
    return pan.panoptic_seg.numpy()


def panoptic_map(model, img: np.ndarray) -> np.ndarray:
    """``fuse_panoptic`` of ``eval_mask_cls``'s outputs."""
    return fuse_panoptic(*eval_mask_cls(model, img))


def panoptic_agreement(ours: np.ndarray, ref: np.ndarray) -> float:
    """Pixel agreement invariant to segment ids: each reference segment
    counts the pixels of its most overlapping segment of ours."""
    agree = 0
    for rid in np.unique(ref):
        _, counts = np.unique(ours[ref == rid], return_counts=True)
        agree += int(counts.max())
    return agree / ref.size


def compare_panoptic(ours: np.ndarray, ref: np.ndarray,
                     min_agreement: float = 0.95) -> bool:
    if ours.shape != ref.shape:
        print(f"panoptic shape mismatch: {ours.shape} vs {ref.shape}")
        return False
    frac = panoptic_agreement(ours, ref)
    print(f"panoptic map agreement: {frac:.4f} (threshold {min_agreement})")
    return frac >= min_agreement


def vocab_capture(model, img: np.ndarray, ref: Mapping) -> dict:
    """The port's ``clip_mask_cls`` on the reference capture's own
    vocabulary embeddings (``vocab_labels``, ``vocab_text_raw`` and, for
    the CLIP head, ``vocab_clip_text``), which isolates the vision side."""
    from .models.odise import category_overlapping_mask

    device = next(model.parameters()).device
    labels = tuple(tuple(l) for l in json.loads(
        np.asarray(ref["vocab_labels"]).tobytes().decode()))
    text_raw = torch.as_tensor(np.asarray(ref["vocab_text_raw"], np.float32), device=device)
    clip_text = overlap = None
    if "vocab_clip_text" in ref and getattr(model, "clip_head", None) is not None:
        clip_text = torch.as_tensor(np.asarray(ref["vocab_clip_text"], np.float32),
                                    device=device)
        overlap = torch.from_numpy(category_overlapping_mask(model.train_labels, labels)
                                   ).to(device)
    with torch.no_grad():
        mask_cls, _ = model.forward_eval(
            torch.from_numpy(np.asarray(img, np.float32)[None]).to(device), text_raw,
            labels, clip_text, labels if clip_text is not None else None, overlap)
    return {"clip_mask_cls": mask_cls.float().cpu().numpy()}


def metrics_self_check() -> bool:
    """The evaluation's statistics on the device against the host's, on two
    images whose ground truth is the TINY model's own fused prediction, so
    that the metrics are high and their equality says something."""
    from .data.synthetic import SYNTH_LABELS, SYNTH_THING
    from .evaluation.run import evaluate_open_vocab
    from .model_zoo.factory import build_category_odise
    from .models.wrapper import OpenPanopticInference, build_open_vocabulary

    thing = np.asarray(SYNTH_THING)
    torch.manual_seed(0)
    model = build_category_odise("tiny", train_labels=SYNTH_LABELS, with_clip_head=False,
                                 device="cpu")
    # with random weights the queries' masks overlap so much that the
    # overlap rule drops every segment, and the null class wins every
    # query: either leaves PQ 0/0 on both paths, vacuously equal
    model.overlap_threshold = 0.0
    with torch.no_grad():
        model.category_head.null_embed.neg_()
    vocab = build_open_vocabulary(model, SYNTH_LABELS, thing_mask=thing,
                                  with_clip_head=False)
    infer = OpenPanopticInference(model, vocab)
    rng = np.random.RandomState(0)
    records = []
    for i in range(2):
        img = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
        mask_cls, mask_pred = infer(torch.from_numpy(img[None]).float() / 255.0)
        pan = panoptic_inference(mask_cls[0], mask_pred[0], vocab.thing_mask,
                                 object_mask_threshold=0.0, overlap_threshold=0.0)
        pan_seg = pan.panoptic_seg.cpu().numpy().astype(np.uint32)
        cats = pan.segment_category.cpu().numpy()
        sem = semantic_inference(mask_cls[0], mask_pred[0]).argmax(0)
        records.append({
            "image": img, "image_id": i, "pan_seg": pan_seg,
            "sem_seg": sem.cpu().numpy().astype(np.uint8),
            "segments_info": [{"id": s + 1, "category_id": int(cats[s]), "iscrowd": 0}
                              for s in range(int(pan.num_segments))
                              if (pan_seg == s + 1).any()]})
    kw = dict(labels=SYNTH_LABELS, thing_mask=thing, short_side=64, max_size=128)
    dev = evaluate_open_vocab(infer, records, device_stats=True, **kw)
    host = evaluate_open_vocab(infer, records, device_stats=False, **kw)
    ok = True
    print(f"{'metric':16s} {'device-stat':>12s} {'host':>12s}  verdict")
    for k in sorted(set(dev) & set(host)):
        if not isinstance(dev[k], float) or k in ("s_per_img",):
            continue
        good = bool(np.isclose(dev[k], host[k], rtol=1e-5, atol=1e-6))
        ok &= good
        print(f"{k:16s} {dev[k]:12.4f} {host[k]:12.4f}  {'ok' if good else 'FAIL'}")
    nontrivial = dev.get("PQ", 0.0) > 50.0 and dev.get("mIoU", 0.0) > 50.0
    if not nontrivial:
        print(f"metrics not non-trivial: PQ={dev.get('PQ')} mIoU={dev.get('mIoU')}")
    return ok and nontrivial


def self_check() -> bool:
    """Round-trip TINY's trainable weights through the ``Checkpointer``:
    the stages and panoptic maps must come back bit-identical; then
    ``metrics_self_check``."""
    from .engine.checkpoint import Checkpointer
    from .engine.train_loop import is_frozen_path

    img = ramp_image(64)
    model = build_with_weights("tiny", with_clip_head=True, device="cpu")
    ours = capture_activations(model, img)
    pan_a = panoptic_map(model, img)
    # another seed, then the first model's frozen towers (a checkpoint
    # leaves them out) and zeros for every trainable parameter
    again = build_with_weights("tiny", with_clip_head=True, seed=1, device="cpu")
    first = dict(model.named_parameters())
    with torch.no_grad():
        for n, p in again.named_parameters():
            if is_frozen_path(tuple(n.split("."))):
                p.copy_(first[n])
            else:
                p.zero_()
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save("parity", first, step=0)
        ck.load(ck.get_checkpoint_file(), dict(again.named_parameters()))
    ok = diff_captures(ours, capture_activations(again, img), [("", 0.0)])
    ok &= compare_panoptic(panoptic_map(again, img), pan_a, min_agreement=1.0)
    ok &= metrics_self_check()
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ref", default="", help="reference-side capture .npz")
    ap.add_argument("--scale", default="full", choices=["tiny", "full"])
    ap.add_argument("--image", default="", help="input image (else the fixed ramp)")
    ap.add_argument("--sd-ckpt", default="")
    ap.add_argument("--clip-ckpt", default="")
    ap.add_argument("--clip-head-ckpt", default="")
    ap.add_argument("--odise-ckpt", default="")
    ap.add_argument("--clip-head", action="store_true",
                    help="include the CLIP head (captures clip_mask_cls)")
    ap.add_argument("--self-check", action="store_true",
                    help="weight-free self-consistency at TINY on the CPU")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not CUDA")
    args = ap.parse_args(argv)

    if args.self_check:
        ok = self_check()
        print("self-check:", "PASS" if ok else "FAIL")
        sys.exit(0 if ok else 1)
    if not args.ref:
        ap.error("--ref is required (or use --self-check)")
    S = 64 if args.scale == "tiny" else 512
    img = load_image(args.image, S) if args.image else ramp_image(S)
    model = build_with_weights(
        args.scale, sd_ckpt=args.sd_ckpt, clip_ckpt=args.clip_ckpt,
        odise_ckpt=args.odise_ckpt, clip_head_ckpt=args.clip_head_ckpt,
        with_clip_head=args.clip_head, device="cpu" if args.cpu else None)
    ours = capture_activations(model, img)
    ref = dict(np.load(args.ref))
    if "vocab_text_raw" in ref:
        ours.update(vocab_capture(model, img, ref))
    ok = diff_captures(ours, ref)
    if "panoptic" in ref:
        ok &= compare_panoptic(panoptic_map(model, img), ref["panoptic"])
    print("parity:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
