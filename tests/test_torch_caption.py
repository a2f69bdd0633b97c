"""The port's CaptionODISE against the JAX package's (TINY, float32, CPU):
the same perturbed parameters through ``load_flax_params``, the same
numpy image and token ids; and the factory's defaults.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_tpu.data.build import get_openseg_labels  # noqa: E402
from odise_tpu.model_zoo.factory import build_caption_odise as jax_build  # noqa: E402
from odise_tpu.models.odise import CaptionODISE as JCaptionODISE  # noqa: E402
from odise_torch.model_zoo.factory import build_caption_odise  # noqa: E402
from odise_torch.model_zoo.from_jax import load_flax_params  # noqa: E402
from odise_torch.models.clip.tokenizer import tokenize  # noqa: E402
from odise_torch.models.odise import CaptionODISE  # noqa: E402

from .test_torch_towers import perturbed_params  # noqa: E402
from .torch_threads import one_thread  # noqa: F401,E402

SIZE = 128  # as in tests/test_torch_model.py: no one-value GroupNorm groups
VOCAB = (("cat", "feline"), ("dog",), ("grass",))


@pytest.fixture(scope="module")
def caption_outputs():
    jm = jax_build("tiny", backbone_in_size=(SIZE, SIZE))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, 2, 77), jnp.int32), method=JCaptionODISE.init_full))
    params = perturbed_params(shapes, seed=21)
    pm = build_caption_odise("tiny", device="cpu", backbone_in_size=(SIZE, SIZE))
    load_flax_params(pm, params)

    rng = np.random.RandomState(22)
    img = rng.rand(1, SIZE, SIZE, 3).astype(np.float32)
    tokens = tokenize([s for syns in VOCAB for s in syns])
    prompted = tokenize([f"a photo of a {syns[0]}." for syns in VOCAB])
    words = tokenize(["cat", "dog", "grass", "cat"]).reshape(2, 2, 77)
    overlap = np.array([1, 0, 1], np.int32)
    clip_labels = tuple((s[0],) for s in VOCAB)

    def j_eval(p, x, tok, ptok, wtok, ovl):
        trunk = jm.apply(p, x, method=JCaptionODISE.forward_eval_trunk)
        text = jm.apply(p, tok, method=JCaptionODISE.encode_vocab)
        clip_text = jm.apply(p, ptok, method=JCaptionODISE.encode_vocab)
        words = jm.apply(p, wtok, method=JCaptionODISE.encode_words)
        head_in = {k: v for k, v in trunk.items() if k != "mask_pred"}
        mask_cls = jm.apply(p, head_in, text, VOCAB, clip_text, clip_labels, ovl,
                            method=JCaptionODISE.forward_eval_head)
        no_clip = jm.apply(p, head_in, text, VOCAB,
                           method=JCaptionODISE.forward_eval_head)
        return trunk, words, mask_cls, no_clip

    j = jax.jit(j_eval)(params, jnp.asarray(img), jnp.asarray(tokens),
                        jnp.asarray(prompted), jnp.asarray(words), jnp.asarray(overlap))
    with torch.no_grad():
        trunk = pm.forward_eval_trunk(torch.from_numpy(img))
        text = pm.encode_vocab(torch.from_numpy(tokens).long())
        clip_text = pm.encode_vocab(torch.from_numpy(prompted).long())
        p_words = pm.encode_words(torch.from_numpy(words).long())
        mask_cls = pm.forward_eval_head(trunk, text, VOCAB, clip_text, clip_labels,
                                        torch.from_numpy(overlap))
        no_clip = pm.forward_eval_head(trunk, text, VOCAB)
    return dict(jax=j, port=(trunk, p_words, mask_cls, no_clip))


def test_caption_trunk_matches_jax(caption_outputs):
    """The trunk dict, binary pred_logits included, at 1e-4 (float32 through
    SD, the deformable encoder and the masked decoder)."""
    j, p = caption_outputs["jax"][0], caption_outputs["port"][0]
    assert set(p) == set(j) == {"mask_embed", "logit_scale", "pred_logits",
                                "clip_mask_embed", "mask_pred"}
    assert p["pred_logits"].shape == (1, 10, 2)
    assert p["mask_pred"].shape == (1, 10, SIZE, SIZE)
    for k in j:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("index,name", [(1, "encode_words"), (2, "head with CLIP"),
                                        (3, "head without CLIP")])
def test_caption_head_matches_jax(caption_outputs, index, name):
    """encode_words [2, 2, D] and mask_cls [1, Q, K+1] with and without the
    CLIP-head ensemble, at 1e-4."""
    j, p = caption_outputs["jax"][index], caption_outputs["port"][index]
    assert tuple(p.shape) == tuple(np.shape(j))
    assert p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4, err_msg=name)


def test_build_caption_odise_defaults():
    """CUDA unless asked for the CPU; FULL trains on COCO panoptic's
    prompt-engineered labels, as the JAX factory's default; one class in the
    mask decoder; the fusion settings of the JAX model."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_caption_odise("tiny")
    model = build_caption_odise("full", device="meta", dtype=torch.bfloat16)
    assert isinstance(model, CaptionODISE)
    assert model.train_labels == tuple(tuple(l) for l in get_openseg_labels("coco_panoptic", True))
    assert model.sem_seg_head.transformer_predictor.class_embed.num_classes == 1
    assert model.word_head.word_proj.weight.shape == (256, 768)
    jm = jax_build("full")
    for field in ("object_mask_threshold", "overlap_threshold", "test_topk_per_image",
                  "num_queries"):
        assert getattr(model, field) == getattr(jm, field), field
