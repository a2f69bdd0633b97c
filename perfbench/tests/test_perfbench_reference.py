"""The plain reference against the port (``odise_torch``) at TINY on the
CPU, both in float32 on the same seeded weights: the eval outputs agree to
rounding, and so do three train steps once both take the same assignment
(the port solves the matching by its auction, the reference exactly)."""

import pytest
import torch

from perfbench.common import weights
from perfbench.common.compare import rel_l2
from perfbench.reference import build as rbuild
from perfbench.reference import evaluate, labels as rlabels

LABELS = rlabels.coco_panoptic_labels()[:6]


@pytest.fixture(autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("kind", ["category", "caption"])
def test_eval_outputs_match_the_port(kind):
    from odise_torch.model_zoo.factory import build_caption_odise, build_category_odise
    from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary

    build = build_category_odise if kind == "category" else build_caption_odise
    port = build("tiny", device="cpu", train_labels=LABELS)
    ref = rbuild.build(kind, "tiny", train_labels=LABELS, device="cpu")
    assert weights.specs(port) == weights.specs(ref)
    weights.fill_(port, 2 ** 33 + 3)
    weights.fill_(ref, 2 ** 33 + 3)
    img = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    p_cls, p_pred = OpenPanopticInference(port, build_open_vocabulary(port, LABELS))(img)
    r_cls, r_pred = evaluate.outputs(ref, LABELS, img)
    assert rel_l2(p_cls, r_cls) < 1e-5 and rel_l2(p_pred, r_pred) < 1e-5


def test_seeded_weights_follow_their_rules():
    ref = rbuild.build("category", "tiny", train_labels=LABELS, device="cpu")
    n = weights.fill_(ref, 7)
    assert n == sum(p.numel() for p in ref.parameters())
    named = dict(ref.named_parameters())
    w = named["sem_seg_head.pixel_decoder.input_proj_0.weight"]
    fan_in = w[0].numel()
    assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.2
    scale = named["sem_seg_head.transformer_predictor.post_mask_embed.logit_scale"]
    assert float(scale) == pytest.approx(2.659260, abs=1e-5)
    again = rbuild.build("category", "tiny", train_labels=LABELS, device="cpu")
    weights.fill_(again, 7)
    assert all(torch.equal(p, named[k]) for k, p in again.named_parameters())
