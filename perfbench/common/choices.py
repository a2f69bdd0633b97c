"""The program's discrete choices, taken where it makes them, for the
reference to follow (``perfbench/reference/decisions.py`` says why).

``install(choices)`` wraps the port's five choice points: the masked
decoder's attention-mask threshold, the mask pooling's hard threshold, the
CLIP head's patch-mask threshold, the matcher's assignment and the
criterion's importance-sampled points. While ``choices.sink`` is set, each
choice goes to it as the program made it (the whole batch; the mask
pooling's is the same comparison on the same tensor, made again), and
``choices.on_assignment(cost, assignment)``, where set, sees each
assignment with the cost it was made from; with no sink the wrappers only
pass through.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional

import torch


class Choices:
    def __init__(self):
        self.sink: Optional[Callable[[torch.Tensor], None]] = None
        self.on_assignment: Optional[Callable[[torch.Tensor, torch.Tensor], None]] = None

    def take(self, t: torch.Tensor) -> None:
        if self.sink is not None:
            self.sink(t)


def install(choices: Choices) -> Callable[[], None]:
    """Wrap the choice points; returns the function that unwraps them."""
    td = importlib.import_module("odise_torch.models.decoder.transformer_decoder")
    ad = importlib.import_module("odise_torch.models.clip.adapter")
    mt = importlib.import_module("odise_torch.losses.matcher")
    sc = importlib.import_module("odise_torch.losses.set_criterion")
    cls = td.ODISEMultiScaleMaskedTransformerDecoder
    saved = (cls.__dict__["_threshold_attn_mask"], td.mask_pooling, ad._token_masked,
             mt.assign_from_cost, sc.get_uncertain_point_coords_with_randomness)
    attn, pool, token, match, points = saved[0].__func__, *saved[1:]

    def attn_mask(mask_logits_hw):
        out = attn(mask_logits_hw)
        choices.take(out)
        return out

    def mask_pooling(x, mask, hard=True, threshold=0.5):
        if hard and choices.sink is not None:
            choices.take(torch.sigmoid(mask.detach()) > threshold)
        return pool(x, mask, hard, threshold)

    def token_masked(mask_logits, patch_size, num_image_tokens):
        out = token(mask_logits, patch_size, num_image_tokens)
        choices.take(out)
        return out

    def assign_from_cost(cost):
        out = match(cost)
        choices.take(out)
        if choices.on_assignment is not None:
            choices.on_assignment(cost, out)
        return out

    def uncertain_points(*args, **kwargs):
        out = points(*args, **kwargs)
        choices.take(out)
        return out

    cls._threshold_attn_mask = staticmethod(attn_mask)
    (td.mask_pooling, ad._token_masked, mt.assign_from_cost,
     sc.get_uncertain_point_coords_with_randomness) = (mask_pooling, token_masked,
                                                       assign_from_cost, uncertain_points)

    def undo():
        cls._threshold_attn_mask = saved[0]
        (td.mask_pooling, ad._token_masked, mt.assign_from_cost,
         sc.get_uncertain_point_coords_with_randomness) = saved[1:]

    return undo
