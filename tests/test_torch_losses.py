"""The port's training losses and the transformer decoder's training branch
against the JAX package on the same numpy inputs (CPU, float32).

JAX draws the criterion's random points with ``jax.random``, which torch
cannot reproduce; the port draws every one through
``odise_torch.losses.matcher.draw_uniform``. These tests replace that one
function with JAX's own draws, recomputed from the same keys as the JAX
code splits them (``split(rng, 2L)``; per layer ``split(rngs[2i], B)`` for
the matching points and ``split(rngs[2i+1])`` for the candidates and the
random top-up).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_tpu.losses import grounding as jg  # noqa: E402
from odise_tpu.losses import matcher as jm  # noqa: E402
from odise_torch.losses import grounding as pg  # noqa: E402
from odise_torch.losses import matcher as pm  # noqa: E402

from .test_torch_towers import jax_and_port  # noqa: E402

# the packages re-export functions under their modules' names
jsc = importlib.import_module("odise_tpu.losses.set_criterion")
psc = importlib.import_module("odise_torch.losses.set_criterion")


def jax_criterion_draws(rng, n_layers, batch, n_masks, cfg):
    """(kind, layer) -> JAX's draws for one ``set_criterion`` call."""
    rngs = jax.random.split(rng, 2 * n_layers)
    n_sampled = int(cfg.num_points * cfg.oversample_ratio)
    n_unc = int(cfg.importance_sample_ratio * cfg.num_points)
    out = {}
    for i in range(n_layers):
        keys = jax.random.split(rngs[2 * i], batch)
        out[("match", i)] = np.concatenate([np.asarray(jax.random.uniform(
            k, (1, cfg.num_points, 2))) for k in keys])
        k1, k2 = jax.random.split(rngs[2 * i + 1])
        out[("oversample", i)] = np.asarray(jax.random.uniform(k1, (n_masks, n_sampled, 2)))
        out[("random", i)] = np.asarray(jax.random.uniform(
            k2, (n_masks, cfg.num_points - n_unc, 2)))
    return out


def inject(monkeypatch, draws):
    """Make the port's criterion draw ``draws`` (a dict, or a list of dicts
    taken in turn, one per criterion call)."""
    queue = list(draws) if isinstance(draws, list) else [draws]
    seen = set()

    def draw_uniform(generator, shape, device, kind, layer):
        if (kind, layer) in seen:  # a new criterion call begins
            queue.pop(0)
            seen.clear()
        seen.add((kind, layer))
        x = queue[0][(kind, layer)]
        assert tuple(x.shape) == tuple(shape), (kind, layer, x.shape, shape)
        return torch.from_numpy(np.array(x)).to(device)

    monkeypatch.setattr(pm, "draw_uniform", draw_uniform)


B, Q, K, T = 2, 6, 3, 3
CFG = dict(num_classes=K, num_points=20)


@pytest.fixture(scope="module")
def criterion_case():
    rng = np.random.RandomState(0)
    layers = [dict(pred_logits=rng.randn(B, Q, K + 1).astype(np.float32) * 2,
                   pred_masks=rng.randn(B, Q, 8, 8).astype(np.float32) * 3)
              for _ in range(3)]
    gt_masks = rng.rand(B, T, 16, 16) > 0.6
    labels = rng.randint(0, K, (B, T)).astype(np.int32)
    valid = np.array([[True, True, False], [True, False, True]])
    key = jax.random.PRNGKey(5)
    cfg = jsc.CriterionConfig(**CFG)

    def j_total(layer_arrays):
        outs = dict(layer_arrays[0])
        outs["aux_outputs"] = [dict(l) for l in layer_arrays[1:]]
        targets = {"labels": jnp.asarray(labels), "masks": jnp.asarray(gt_masks),
                   "valid": jnp.asarray(valid)}
        losses = jsc.set_criterion(outs, targets, key, cfg)
        return sum(losses.values()), losses

    j_layers = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    (total, losses), grads = jax.jit(jax.value_and_grad(j_total, has_aux=True))(j_layers)
    cost = jax.jit(lambda l: jm.match_cost_matrix(
        l["pred_logits"], l["pred_masks"], jnp.asarray(labels),
        jnp.asarray(gt_masks, jnp.float32), jnp.asarray(valid),
        jax.random.split(key, 6)[0], num_points=cfg.num_points))(j_layers[0])
    draws = jax_criterion_draws(key, 3, B, B * T, cfg)
    return dict(layers=layers, gt_masks=gt_masks, labels=labels, valid=valid,
                total=float(total), losses={k: float(v) for k, v in losses.items()},
                grads=jax.tree_util.tree_map(np.asarray, grads), cost=np.asarray(cost),
                draws=draws)


def _port_targets(c):
    return {"labels": torch.from_numpy(c["labels"]).long(),
            "masks": torch.from_numpy(c["gt_masks"]), "valid": torch.from_numpy(c["valid"])}


def test_match_cost_matrix_matches_jax(criterion_case, monkeypatch):
    """Class, point-sampled BCE and dice costs with the invalid target's
    penalty, on JAX's points: 1e-5 relative to the largest cost."""
    c = criterion_case
    inject(monkeypatch, c["draws"])
    l0 = c["layers"][0]
    cost = pm.match_cost_matrix(
        torch.from_numpy(l0["pred_logits"]), torch.from_numpy(l0["pred_masks"]),
        torch.from_numpy(c["labels"]).long(), torch.from_numpy(c["gt_masks"]),
        torch.from_numpy(c["valid"]), num_points=CFG["num_points"], layer=0).numpy()
    np.testing.assert_allclose(cost, c["cost"], rtol=0,
                               atol=1e-5 * float(np.abs(c["cost"]).max()))
    # the invalid targets' column sits above every real entry of its image
    for b in range(B):
        bad = ~c["valid"][b]
        assert (cost[b][:, bad] > cost[b][:, ~bad].max()).all()


def test_set_criterion_losses_and_gradients_match_jax(criterion_case, monkeypatch):
    """Every loss of the final and the two aux layers (the same matching,
    the same importance-sampled points), and the gradients for every
    layer's class and mask logits: losses 1e-5 relative, gradients 1e-5 of
    their largest entry (float32 sums in another order)."""
    c = criterion_case
    inject(monkeypatch, c["draws"])
    leaves = [{k: torch.from_numpy(v).requires_grad_() for k, v in l.items()}
              for l in c["layers"]]
    outs = dict(leaves[0])
    outs["aux_outputs"] = leaves[1:]
    losses = psc.set_criterion(outs, _port_targets(c), psc.CriterionConfig(**CFG))
    assert sorted(losses) == sorted(c["losses"])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), c["losses"][k], rtol=1e-5, err_msg=k)
    sum(losses.values()).backward()
    for i, (leaf, want) in enumerate(zip(leaves, c["grads"])):
        for k in ("pred_logits", "pred_masks"):
            w = want[k]
            np.testing.assert_allclose(leaf[k].grad.numpy(), w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=f"layer {i} {k}")


def test_importance_sampling_keeps_jax_tie_order():
    """Equal uncertainties (a constant mask) select the candidates in index
    order, as ``lax.top_k`` does, then append the random points."""
    n_points, ratio = 8, 0.75
    cand = np.random.RandomState(1).rand(2, 24, 2).astype(np.float32)
    rand = np.random.RandomState(2).rand(2, 2, 2).astype(np.float32)
    draws = {"oversample": cand, "random": rand}
    orig = pm.draw_uniform
    pm.draw_uniform = lambda g, shape, device, kind, layer: torch.from_numpy(draws[kind])
    try:
        pts = psc.get_uncertain_point_coords_with_randomness(
            torch.zeros(2, 5, 5), n_points, 3.0, ratio).numpy()
    finally:
        pm.draw_uniform = orig
    assert np.array_equal(pts, np.concatenate([cand[:, :6], rand], axis=1))


@pytest.fixture(scope="module")
def grounding_case():
    rng = np.random.RandomState(3)
    Bg, Qg, Kw, C = 3, 5, 4, 8
    layers = [dict(mask_embed=rng.randn(Bg, Qg, C).astype(np.float32),
                   logit_scale=np.float32(7.5 + i)) for i in range(3)]
    word = rng.randn(Bg, Kw, C).astype(np.float32)
    valid = np.array([[1, 1, 0, 0], [0, 0, 0, 0], [1, 0, 1, 1]], bool)
    cfg = jg.GroundingConfig(collect_mode=None)

    def j_total(me, we):
        outs = dict(mask_embed=me[0], word_embed=we, logit_scale=layers[0]["logit_scale"],
                    aux_outputs=[dict(mask_embed=m, logit_scale=l["logit_scale"])
                                 for m, l in zip(me[1:], layers[1:])])
        losses = jg.mask_grounding_criterion(outs, jnp.asarray(valid), cfg)
        return sum(losses.values()), losses

    me = [jnp.asarray(l["mask_embed"]) for l in layers]
    (_, losses), grads = jax.jit(jax.value_and_grad(j_total, argnums=(0, 1), has_aux=True))(
        me, jnp.asarray(word))
    return dict(layers=layers, word=word, valid=valid,
                losses={k: float(v) for k, v in losses.items()},
                grads=jax.tree_util.tree_map(np.asarray, grads))


def test_grounding_loss_and_gradients_match_jax(grounding_case):
    """The symmetric InfoNCE of the final and the aux layers (an image
    without words included, the aux layers taking the final word embeds),
    and its gradients for the mask and word embeds: 1e-5 relative."""
    c = grounding_case
    me = [torch.from_numpy(l["mask_embed"]).requires_grad_() for l in c["layers"]]
    we = torch.from_numpy(c["word"]).requires_grad_()
    ls = [torch.tensor(l["logit_scale"]) for l in c["layers"]]
    outs = dict(mask_embed=me[0], word_embed=we, logit_scale=ls[0],
                aux_outputs=[dict(mask_embed=m, logit_scale=l) for m, l in zip(me[1:], ls[1:])])
    losses = pg.mask_grounding_criterion(outs, torch.from_numpy(c["valid"]))
    assert sorted(losses) == sorted(c["losses"]) == [
        "loss_mask_word", "loss_mask_word_0", "loss_mask_word_1"]
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), c["losses"][k], rtol=1e-5, err_msg=k)
    sum(losses.values()).backward()
    (g_me, g_we) = c["grads"]
    for got, want in zip([m.grad for m in me] + [we.grad], list(g_me) + [g_we]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_transformer_decoder_training_outputs_match_jax():
    """``training=True``: every layer's class and mask logits and
    PooledMaskEmbed outputs (mask_embed, mask_pooled_features, logit_scale),
    final and aux, against the JAX decoder at TINY widths with the same
    perturbed parameters. 1e-4: float32 through 3 decoder layers whose
    attention masks come from the previous layer's logits."""
    from odise_tpu.models.decoder import transformer_decoder as jtd
    from odise_torch.models.decoder import transformer_decoder as ptd

    hidden, n_cls = 32, 3
    kw = dict(hidden_dim=hidden, num_queries=10, nheads=4, dim_feedforward=64,
              dec_layers=3, mask_dim=hidden, num_classes=n_cls, in_channels=hidden)
    jdec = jtd.ODISEMultiScaleMaskedTransformerDecoder(
        **kw, class_embed=jtd.PseudoClassEmbed(num_classes=n_cls),
        post_mask_embed=jtd.PooledMaskEmbed(hidden_dim=hidden, mask_dim=hidden,
                                            projection_dim=hidden))
    pdec = ptd.ODISEMultiScaleMaskedTransformerDecoder(
        **kw, class_embed=ptd.PseudoClassEmbed(n_cls),
        post_mask_embed=ptd.PooledMaskEmbed(hidden, hidden, hidden))
    rng = np.random.RandomState(4)
    xs = [rng.randn(2, h, w, hidden).astype(np.float32) for h, w in ((3, 4), (6, 8), (12, 16))]
    mf = rng.randn(2, 24, 32, hidden).astype(np.float32)
    args = ([jnp.asarray(x) for x in xs], jnp.asarray(mf))
    params, fn = jax_and_port(jdec, pdec, *args, seed=11, training=True)
    want = fn(params, *args)
    got = pdec([torch.from_numpy(np.moveaxis(x, -1, 1).copy()) for x in xs],
               torch.from_numpy(np.moveaxis(mf, -1, 1).copy()), training=True)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 3
    pairs = [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"]))
    for i, (g, w) in enumerate(pairs):
        keys = {"pred_logits", "pred_masks", "mask_embed", "mask_pooled_features",
                "logit_scale"}
        assert keys <= set(g) and keys <= set(w)
        for k in sorted(keys):
            np.testing.assert_allclose(g[k].detach().numpy(), np.asarray(w[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"layer {i} {k}")
