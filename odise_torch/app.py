"""The demo app's inference (counterpart of ``demo/app.py``).

    python -m odise_torch.app [a.b.c=value ...]

Everything but the page is here without gradio: the examples gallery
(``list_examples``), the model of a dropdown choice (``build_inference``,
cached), the category checkboxes (``checkbox_to_label_args``) and an image
to its panoptic overlay (``run_inference``, through ``demo.segment`` at
short side 512). ``main`` imports gradio inside itself and, without it,
says so and returns, as the JAX app does; the dotted overrides go to the
models' configs (``train.device=cpu`` runs them on the CPU).
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

TITLE = "ODISE: Open-Vocabulary Panoptic Segmentation"
DESCRIPTION = """ODISE segments an image into panoptic masks and classifies
each mask against CLIP text embeddings of *arbitrary* category names — edit
the vocabulary below and resubmit; no retraining involved. Pick builtin
category lists (COCO / ADE / LVIS) and add your own comma-separated synonym
lists separated by semicolons, e.g. `Mt. Fuji; sky, clouds`."""
ARTICLE = """Runs the PyTorch port on one NVIDIA card: frozen Stable-Diffusion
feature backbone, Mask2Former-style decoder with hand-written CUDA
deformable attention, CLIP-head ensembling, panoptic fusion."""

CATEGORY_CHOICES = ["COCO (133 categories)", "ADE (150 categories)",
                    "LVIS (1203 categories)"]

# the repository's example images, beside the JAX app's
EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "demo", "examples")

# image file -> (extra vocabulary, category lists, model) of the gallery
EXAMPLE_PRESETS = {
    "coco.jpg": ("", [CATEGORY_CHOICES[0]], "ODISE(Label)"),
    "ade.jpg": ("", [CATEGORY_CHOICES[1]], "ODISE(Label)"),
    "ego4d.jpg": ("Mt. Fuji; sky", [CATEGORY_CHOICES[0]], "ODISE(Label)"),
}

_CONFIGS = os.path.join(os.path.dirname(__file__), "configs", "Panoptic")
MODEL_CONFIGS = {
    "ODISE(Label)": os.path.join(_CONFIGS, "odise_label_coco_50e.py"),
    "ODISE(Caption)": os.path.join(_CONFIGS, "odise_caption_coco_50e.py"),
}

# the JAX app's panoptic fusion: object threshold 0, the default overlap
OVERLAP_THRESHOLD = 0.8
IMAGE_SIZE = 512


def list_examples() -> List[list]:
    """[image path, extra vocabulary, category lists, model] per example
    image (.jpg, .jpeg, .png) in ``EXAMPLES_DIR``, by name."""
    rows = []
    if os.path.isdir(EXAMPLES_DIR):
        for name in sorted(os.listdir(EXAMPLES_DIR)):
            if name.lower().endswith((".jpg", ".jpeg", ".png")):
                vocab, cats, mdl = EXAMPLE_PRESETS.get(
                    name, ("", [CATEGORY_CHOICES[0]], "ODISE(Label)"))
                rows.append([os.path.join(EXAMPLES_DIR, name), vocab, cats, mdl])
    return rows


@functools.lru_cache(maxsize=2)
def build_inference(model_name: str, opts: Tuple[str, ...] = ()):
    """The model of a dropdown choice, built from its config with the
    dotted ``opts`` applied, overlap threshold 0 where the config has one; the checkpoint named by
    ``$ODISE_TPU_DEMO_CKPT`` installed where it is set (``demo.load_init``).
    Cached: the app's two models stay built."""
    from .config import apply_overrides, load_config, resolve
    from .demo import load_init
    from .train_net import build_model

    cfg = load_config(MODEL_CONFIGS[model_name])
    if opts:
        apply_overrides(cfg, list(opts))
    cfg = resolve(cfg)
    if "overlap_threshold" in cfg.model:  # the shipped configs have one
        cfg.model.overlap_threshold = 0.0
    model = build_model(cfg)
    ckpt = os.environ.get("ODISE_TPU_DEMO_CKPT", "")
    if ckpt:
        load_init(model, ckpt)
    return model


def checkbox_to_label_args(category_list: Optional[Sequence[str]]) -> List[str]:
    """Checked category lists -> ``demo --label`` names; COCO when none."""
    out = []
    for c in category_list or []:
        for tag in ("COCO", "ADE", "LVIS"):
            if tag in c:
                out.append(tag)
    return out or ["COCO"]


def run_inference(image: np.ndarray, vocab_text: str, category_list,
                  model_name: str = "ODISE(Label)", alpha: Optional[float] = None,
                  beta: Optional[float] = None, opts: Tuple[str, ...] = ()) -> np.ndarray:
    """An [H, W, 3] uint8 image -> its panoptic overlay [h, w, 3] uint8 at
    short side 512, over the extra vocabulary and the checked lists;
    ``alpha`` and ``beta`` set the CLIP head's ensemble exponents (on the
    cached model, as the JAX app sets them)."""
    from .demo import build_demo_vocab, segment
    from .models.wrapper import build_open_vocabulary
    from .utils.visualizer import Visualizer

    model = build_inference(model_name, tuple(opts))
    if model.clip_head is not None:
        if alpha is not None:
            model.clip_head.alpha = float(alpha)
        if beta is not None:
            model.clip_head.beta = float(beta)
    labels, thing_flags = build_demo_vocab(argparse.Namespace(
        vocab=vocab_text or "", caption="", label=checkbox_to_label_args(category_list)))
    vocab = build_open_vocabulary(model, labels, thing_mask=thing_flags,
                                  with_clip_head=model.clip_head is not None)
    out = segment(model, vocab, np.asarray(image), IMAGE_SIZE, OVERLAP_THRESHOLD)
    vis = Visualizer(out.image.cpu().numpy(), class_names=[l[0] for l in labels])
    return vis.draw_panoptic_seg(out.panoptic_seg.cpu().numpy(),
                                 out.segment_category.cpu().numpy(), out.num_segments)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="dotted config overrides: a.b.c=value")
    opts = tuple(ap.parse_args(argv).opts)
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed; use python -m odise_torch.demo for CLI inference.")
        return

    def predict(image, vocab_text, category_list, model_name, alpha, beta):
        return run_inference(image, vocab_text, category_list, model_name, alpha, beta, opts)

    with gr.Blocks(title=TITLE) as demo:
        gr.Markdown(f"<h1 style='text-align: center'>{TITLE}</h1>")
        gr.Markdown(DESCRIPTION)
        with gr.Row():
            with gr.Column(scale=3, variant="panel"):
                inp = gr.Image(label="input")
                model_name = gr.Dropdown(label="Model", choices=list(MODEL_CONFIGS),
                                         value="ODISE(Label)")
                vocab = gr.Textbox(label="Extra Vocabulary",
                                   placeholder="black pickup truck, pickup truck; blue sky")
                cats = gr.CheckboxGroup(choices=CATEGORY_CHOICES, value=[CATEGORY_CHOICES[0]],
                                        label="Category to use")
                with gr.Row():
                    alpha = gr.Slider(0.0, 1.0, value=0.3, step=0.05,
                                      label="alpha (seen-category CLIP weight)")
                    beta = gr.Slider(0.0, 1.0, value=0.7, step=0.05,
                                     label="beta (novel-category CLIP weight)")
                with gr.Row():
                    clear_btn = gr.Button("Clear")
                    submit_btn = gr.Button("Submit", variant="primary")
            with gr.Column(scale=2):
                out = gr.Image(label="Panoptic Segmentation")
                gr.Examples(examples=list_examples(), inputs=[inp, vocab, cats, model_name],
                            examples_per_page=5)
        gr.Markdown(ARTICLE)
        submit_btn.click(predict, [inp, vocab, cats, model_name, alpha, beta], out)
        clear_btn.click(
            lambda: (None, "", [CATEGORY_CHOICES[0]], "ODISE(Label)", 0.3, 0.7, None),
            [], [inp, vocab, cats, model_name, alpha, beta, out])
    demo.launch()


if __name__ == "__main__":
    main()
