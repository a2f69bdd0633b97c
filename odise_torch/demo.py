"""Open-vocabulary panoptic segmentation demo (counterpart of
``demo/demo.py``).

    python -m odise_torch.demo --input img.jpg --output out_dir \\
        --vocab "black pickup truck, pickup truck; blue sky, sky" \\
        [--config-file odise_torch/configs/Panoptic/odise_label_coco_50e.py] \\
        [--init-from CHECKPOINT] [a.b.c=value ...]

Builds the merged vocabulary (``--vocab`` synonym groups, ``--caption``
nouns, then the builtin COCO, ADE and LVIS labels), the config's model on
``train.device`` (CUDA in the shipped configs; ``train.device=cpu`` runs on
the CPU), and segments each image (``segment``: short side resized to
``--image-size``, padded to a multiple of 64, the open-vocabulary forward,
panoptic fusion, cropped back), writing an overlay per input; with
``--video-input`` it writes ``video_out.mp4``. PIL and cv2 are imported
only where files are read and written.

``--init-from`` takes a released ODISE checkpoint (its keys start with
``sem_seg_head.``; converted by ``model_zoo.convert``) or one the port's
``Checkpointer`` wrote (a dict with ``params``), and raises on any other
file.
"""

from __future__ import annotations

import argparse
import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .config import apply_overrides, load_config, resolve
from .data.build import get_openseg_labels
from .data.transforms import resize_image
from .engine.checkpoint import Checkpointer
from .model_zoo.convert import install_odise_trainable, load_torch_state_dict
from .models.inference import panoptic_inference
from .models.wrapper import OpenPanopticInference, OpenVocabulary, build_open_vocabulary
from .train_net import build_model
from .utils.file_io import get_local_path
from .utils.visualizer import Visualizer

DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "configs", "Panoptic",
                              "odise_label_coco_50e.py")
BUILTIN_LABELS = {"COCO": "coco_panoptic", "ADE": "ade20k_150", "LVIS": "lvis_1203"}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", default=DEFAULT_CONFIG)
    p.add_argument("--input", nargs="+", default=[])
    p.add_argument("--video-input", default="", help="video file (or webcam id)")
    p.add_argument("--output", default="demo_out")
    p.add_argument("--vocab", default="",
                   help="semicolon-separated synonym lists, comma within")
    p.add_argument("--caption", default="", help="extract extra nouns from caption")
    p.add_argument("--label", nargs="+", default=["COCO"], choices=list(BUILTIN_LABELS),
                   help="builtin vocabularies")
    p.add_argument("--init-from", default="", help="checkpoint to load")
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="dotted config overrides: a.b.c=value")
    return p.parse_args(argv)


def caption_nouns(caption: str) -> List[str]:
    """The caption's nouns by nltk's tagger; without nltk or its data, the
    words longer than two letters."""
    try:
        import nltk

        tokens = nltk.word_tokenize(caption)
        return [w for w, pos in nltk.pos_tag(tokens) if pos.startswith("NN")]
    except (ImportError, LookupError):
        return [w for w in caption.split() if len(w) > 2]


def build_demo_vocab(args) -> tuple:
    """(synonym groups, thing flags): ``--vocab`` groups, ``--caption``
    nouns (things), then the builtin labels in ``--label`` order (COCO's
    first 80 are things, ADE's and LVIS's all)."""
    classes, things = [], []
    for group in args.vocab.split(";") if args.vocab else []:
        syns = [s.strip() for s in group.split(",") if s.strip()]
        if syns:
            classes.append(syns)
            things.append(True)
    for noun in caption_nouns(args.caption) if args.caption else []:
        classes.append([noun])
        things.append(True)
    for key in args.label:
        labels = get_openseg_labels(BUILTIN_LABELS[key], prompt_engineered=True)
        classes.extend(labels)
        things.extend(i < 80 if key == "COCO" else True for i in range(len(labels)))
    return classes, np.asarray(things)


def colorize(pan_seg: np.ndarray, seed: int = 7) -> np.ndarray:
    rng = np.random.RandomState(seed)
    palette = rng.randint(0, 255, (int(pan_seg.max()) + 1, 3), dtype=np.uint8)
    palette[0] = 0
    return palette[pan_seg]


class Segmented(NamedTuple):
    image: torch.Tensor             # [h, w, 3] uint8, the resized input
    panoptic_seg: torch.Tensor      # [h, w] int32 segment ids (0 = void)
    segment_category: torch.Tensor  # [Q] int32 category of segment id-1
    num_segments: int
    mask_cls: torch.Tensor          # [1, Q, K+1] the model's outputs, padded
    mask_pred: torch.Tensor         # [1, Q, H64, W64]


@torch.no_grad()
def segment(model, vocab: OpenVocabulary, image, image_size: int = 1024,
            overlap_threshold: float = 0.0) -> Segmented:
    """Panoptic segmentation of one [H, W, 3] uint8 image (numpy, or a
    tensor on any device): its short side
    resized to ``image_size`` (bilinear, as cv2's), zero-padded to a
    multiple of 64, ``OpenPanopticInference`` over ``vocab``, panoptic
    fusion (object threshold 0, as the demo sets it), cropped to the
    resized size."""
    device = next(model.parameters()).device
    img = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.array(image))
    img = img.to(device)
    H, W = img.shape[:2]
    scale = image_size / min(H, W)
    nh, nw = int(H * scale + 0.5), int(W * scale + 0.5)
    resized = resize_image(img, nh, nw)
    h64, w64 = -(-nh // 64) * 64, -(-nw // 64) * 64
    padded = torch.zeros((1, h64, w64, 3), dtype=torch.float32, device=device)
    padded[0, :nh, :nw] = resized.float() / 255.0
    mask_cls, mask_pred = OpenPanopticInference(model, vocab)(padded)
    pan = panoptic_inference(mask_cls[0], mask_pred[0], vocab.thing_mask,
                             object_mask_threshold=0.0,
                             overlap_threshold=overlap_threshold)
    return Segmented(resized, pan.panoptic_seg[:nh, :nw], pan.segment_category,
                     int(pan.num_segments), mask_cls, mask_pred)


def _read_checkpoint_kind(path: str) -> str:
    """"port" for a file the port's ``Checkpointer`` wrote, "reference" for
    a released ODISE state dict; raises otherwise."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("params"), dict):
        return "port"
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if isinstance(obj, dict) and any(str(k).startswith("sem_seg_head.") for k in obj):
        return "reference"
    raise ValueError(f"{path}: neither an ODISE checkpoint (sem_seg_head.* keys) "
                     "nor one the port's Checkpointer wrote (a dict with 'params')")


def load_init(model, path: str) -> str:
    """Install ``--init-from`` into ``model``; returns the file's kind."""
    path = get_local_path(path)
    kind = _read_checkpoint_kind(path)
    if kind == "reference":
        install_odise_trainable(model, load_torch_state_dict(path))
    else:
        Checkpointer(os.path.dirname(path) or ".").load(path, dict(model.named_parameters()))
    return kind


def build_demo_model(args):
    """(model, overlap threshold) from ``--config-file`` and the dotted
    overrides, with the demo's thresholds (overlap 0 where the config has
    one; CLIP head alpha 0.35, beta 0.65) and ``--init-from`` installed."""
    cfg = load_config(args.config_file)
    if args.opts:
        apply_overrides(cfg, [o for o in args.opts if "=" in o])
    cfg = resolve(cfg)
    if "overlap_threshold" in cfg.model:
        cfg.model.overlap_threshold = 0.0
    overlap_threshold = cfg.model.get("overlap_threshold", 0.0)
    if cfg.model.get("clip_head") is not None:
        cfg.model.clip_head.alpha = 0.35
        cfg.model.clip_head.beta = 0.65
    model = build_model(cfg)
    if args.init_from:
        load_init(model, args.init_from)
    return model, overlap_threshold


def _run_video(args, model, vocab, overlap_threshold) -> None:
    import cv2

    src = int(args.video_input) if args.video_input.isdigit() else args.video_input
    cap = cv2.VideoCapture(src)
    writer = None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out = segment(model, vocab, cv2.cvtColor(frame, cv2.COLOR_BGR2RGB),
                      args.image_size, overlap_threshold)
        resized = out.image.cpu().numpy()
        overlay = (0.5 * resized + 0.5 * colorize(out.panoptic_seg.cpu().numpy())
                   ).astype(np.uint8)
        if writer is None:
            writer = cv2.VideoWriter(os.path.join(args.output, "video_out.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     cap.get(cv2.CAP_PROP_FPS) or 24,
                                     (resized.shape[1], resized.shape[0]))
        writer.write(cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
    if writer is not None:
        writer.release()
    cap.release()


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    model, overlap_threshold = build_demo_model(args)
    labels, thing_flags = build_demo_vocab(args)
    print(f"Vocabulary: {len(labels)} categories")
    vocab = build_open_vocabulary(model, labels, thing_mask=thing_flags,
                                  with_clip_head=model.clip_head is not None)
    os.makedirs(args.output, exist_ok=True)
    if args.video_input:
        _run_video(args, model, vocab, overlap_threshold)
        return
    from PIL import Image

    for path in args.input:
        img = np.asarray(Image.open(path).convert("RGB"))
        out = segment(model, vocab, img, args.image_size, overlap_threshold)
        cats = out.segment_category.cpu().numpy()
        vis = Visualizer(out.image.cpu().numpy(), class_names=[l[0] for l in labels])
        overlay = vis.draw_panoptic_seg(out.panoptic_seg.cpu().numpy(), cats,
                                        out.num_segments)
        out_path = os.path.join(args.output, os.path.basename(path))
        Image.fromarray(overlay).save(out_path)
        names = [labels[c][0] for c in cats[:out.num_segments]]
        print(f"{path}: {out.num_segments} segments -> {out_path}; categories: {names}")


if __name__ == "__main__":
    main()
