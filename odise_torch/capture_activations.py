"""Per-stage activations for weight parity (counterpart of
``tools/capture_activations.py``).

    python -m odise_torch.capture_activations --out acts.npz \\
        [--sd-ckpt sd-v1-3.ckpt --clip-ckpt clip.pth --odise-ckpt odise.pth] \\
        [--clip-head-ckpt clip336.pth] [--image img.jpg] [--scale tiny|full] [--cpu]

Builds CategoryODISE at a named scale with the given checkpoints installed
over a seeded start and saves, for one image (the fixed ramp by default),
the stages the JAX tool saves under the same keys and in its layout
(channel-last): ``tap_{i}`` (VAE encoder, UNet and VAE decoder taps),
``backbone_{s2..s5}``, ``head_{pred_logits,pred_masks,mask_embed,
logit_scale}`` and, with the CLIP head, ``clip_mask_cls``.
``odise_torch.verify_parity`` compares such a file with the reference's or
the JAX package's.
"""

from __future__ import annotations

import argparse
from typing import Mapping, Union

import numpy as np
import torch

from .model_zoo.convert import (install_clip_weights, install_odise_trainable,
                                install_sd_weights, load_torch_state_dict)
from .model_zoo.factory import build_category_odise

Checkpoint = Union[str, Mapping]


def ramp_image(S: int) -> np.ndarray:
    """Deterministic [S, S, 3] ramp in [0, 1] (channels y/S, x/S,
    (x+y)/2S), reproducible on the reference side."""
    yy, xx = np.mgrid[0:S, 0:S]
    return np.stack([yy / S, xx / S, (yy + xx) / (2 * S)], -1).astype(np.float32)


def _state(ckpt: Checkpoint) -> Mapping:
    return load_torch_state_dict(ckpt) if isinstance(ckpt, str) else ckpt


def build_with_weights(scale: str, *, sd_ckpt: Checkpoint = "",
                       clip_ckpt: Checkpoint = "", odise_ckpt: Checkpoint = "",
                       clip_head_ckpt: Checkpoint = "", with_clip_head: bool = False,
                       num_labels: int = 16, seed: int = 0, device=None,
                       backbone_in_size=None):
    """CategoryODISE at ``scale`` in float32 on ``device`` (default CUDA), seeded from
    ``seed``, with each given checkpoint installed (``backbone_in_size``
    as the factory takes it). A checkpoint is a file
    path or a state dict in memory. ``clip_head_ckpt`` is the CLIP head's
    own (336-px) checkpoint; without it the head takes ``clip_ckpt``'s
    vision tower, as the JAX tool does, which fits only where both towers
    have one shape (``convert.install_clip_weights``)."""
    labels = tuple((f"c{i}",) for i in range(num_labels))
    torch.manual_seed(seed)
    model = build_category_odise(scale, train_labels=labels, with_clip_head=with_clip_head,
                                 use_checkpoint=False, slide_training=False,
                                 backbone_in_size=backbone_in_size, device=device)
    if sd_ckpt:
        install_sd_weights(model, _state(sd_ckpt))
    if clip_ckpt:
        install_clip_weights(model, _state(clip_ckpt),
                             clip_head_state=_state(clip_head_ckpt) if clip_head_ckpt else None)
    if odise_ckpt:
        install_odise_trainable(model, _state(odise_ckpt))
    return model


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().cpu().numpy()


def clip_vocabulary(clip_dim: int, K: int = 4):
    """The synthetic vocabulary of ``clip_mask_cls``: K labels, raw text
    embeds on a linspace, CLIP text embeds their cosine, alternate labels
    seen in training."""
    labels = tuple((f"v{i}",) for i in range(K))
    text_raw = np.linspace(-1.0, 1.0, K * clip_dim, dtype=np.float32).reshape(K, clip_dim)
    return labels, text_raw, np.cos(text_raw).astype(np.float32), np.asarray([1, 0] * (K // 2))


@torch.no_grad()
def capture_activations(model, img: np.ndarray) -> dict:
    """Per-stage activations (numpy, float32, channel-last) on one
    [H, W, 3] float image in [0, 1]."""
    device = next(model.parameters()).device
    x = torch.from_numpy(np.asarray(img, np.float32)[None]).to(device)
    nchw = x.permute(0, 3, 1, 2)
    captures = {}
    for i, t in enumerate(model.backbone.feature_extractor(nchw)):
        captures[f"tap_{i}"] = _nhwc(t)
    for k, v in model.backbone(nchw, training=False).items():
        captures[f"backbone_{k}"] = _nhwc(v)
    out = model.forward_features(x, training=False)
    for k in ("pred_logits", "pred_masks", "mask_embed", "logit_scale"):
        captures[f"head_{k}"] = out[k].float().cpu().numpy()
    if getattr(model, "clip_head", None) is not None:
        labels, text_raw, clip_text, overlap = clip_vocabulary(
            model.category_head.null_embed.shape[-1])
        mask_cls, _ = model.forward_eval(
            x, torch.from_numpy(text_raw).to(device), labels,
            torch.from_numpy(clip_text).to(device), labels,
            torch.from_numpy(overlap).to(device))
        captures["clip_mask_cls"] = mask_cls.float().cpu().numpy()
    return captures


def load_image(path: str, S: int) -> np.ndarray:
    """An image file as [S, S, 3] float32 in [0, 1] (PIL, cv2)."""
    import cv2
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"))
    return cv2.resize(img, (S, S)).astype(np.float32) / 255.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="activations.npz")
    ap.add_argument("--scale", default="full", choices=["tiny", "full"])
    ap.add_argument("--image", default="", help="input image (else the fixed ramp)")
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--sd-ckpt", default="")
    ap.add_argument("--clip-ckpt", default="")
    ap.add_argument("--clip-head-ckpt", default="")
    ap.add_argument("--odise-ckpt", default="")
    ap.add_argument("--clip-head", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not CUDA")
    args = ap.parse_args(argv)

    S = args.image_size if args.scale == "full" else 64
    img = load_image(args.image, S) if args.image else ramp_image(S)
    model = build_with_weights(
        args.scale, sd_ckpt=args.sd_ckpt, clip_ckpt=args.clip_ckpt,
        odise_ckpt=args.odise_ckpt, clip_head_ckpt=args.clip_head_ckpt,
        with_clip_head=args.clip_head, device="cpu" if args.cpu else None)
    captures = capture_activations(model, img)
    np.savez_compressed(args.out, **captures)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k}{list(v.shape)}" for k, v in list(captures.items())[:8]) + ", ...")


if __name__ == "__main__":
    main()
