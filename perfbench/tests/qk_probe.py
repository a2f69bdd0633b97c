"""Why the program's self-attention q and k gradients read 2 to 5 times the
reference's in the train cell: the port's masked decoder at full width
(hidden 256, 100 queries, 8 heads, 9 layers, small feature maps) in bf16
compute with float32 parameters against float32, on the same seeded
weights and inputs, with the float32 run's attention masks handed to the
bf16 run, under a fixed random loss over every layer's outputs. Prints, for
some layers, each attention projection's gradient norm on both sides.
Runs on the CPU in about a minute:

    python3 perfbench/tests/qk_probe.py
"""
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from odise_torch.models.decoder import transformer_decoder as td  # noqa: E402
from perfbench.common import weights  # noqa: E402

torch.set_num_threads(4)


def build(dtype):
    m = td.ODISEMultiScaleMaskedTransformerDecoder(
        hidden_dim=256, num_queries=100, nheads=8, dim_feedforward=2048, dec_layers=9,
        mask_dim=256, num_classes=1, in_channels=256, class_embed=td.PseudoClassEmbed(1),
        post_mask_embed=None, dtype=dtype)
    m.float()
    weights.fill_(m, 2 ** 31 + 5)
    return m


g = torch.Generator().manual_seed(3)
B = 4
x = [torch.randn(B, 256, s, s, generator=g) for s in (8, 16, 32)]
mf = torch.randn(B, 256, 64, 64, generator=g)
Rm = torch.randn(10, B, 100, 64, 64, generator=g)
Rc = torch.randn(10, B, 100, 2, generator=g)
cls = td.ODISEMultiScaleMaskedTransformerDecoder
orig = cls.__dict__["_threshold_attn_mask"].__func__
rec = []

def run(dtype, replay):
    m = build(dtype)
    if replay:
        it = iter(rec)
        cls._threshold_attn_mask = staticmethod(lambda z: next(it))
    else:
        cls._threshold_attn_mask = staticmethod(lambda z: rec.append(orig(z)) or rec[-1])
    out = m([t.to(dtype) for t in x], mf.to(dtype), training=True)
    layers = out["aux_outputs"] + [out]
    loss = sum((l["pred_masks"].float() * Rm[i]).sum() / Rm[i].numel()
               + (l["pred_logits"].float() * Rc[i]).sum() / Rc[i].numel()
               for i, l in enumerate(layers))
    loss.backward()
    cls._threshold_attn_mask = staticmethod(orig)
    return {n: p.grad.double() for n, p in m.named_parameters() if p.grad is not None}


g32 = run(torch.float32, False)
g16 = run(torch.bfloat16, True)
med = statistics.median(float(v.norm()) for v in g32.values())
print(f"median leaf gradient norm (float32) {med:.3g}")
for i in (0, 3, 6, 8):
    for kind in ("self", "cross"):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            n = f"{kind}_{i}.attn.{p}.weight"
            a, b = g32[n], g16[n]
            print(f"{n:28s} f32 {float(a.norm()):.3g} bf16 {float(b.norm()):.3g} "
                  f"ratio {float(b.norm()/a.norm()):.3f} rel diff {float((b-a).norm()/a.norm()):.3f}")
