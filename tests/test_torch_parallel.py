"""The port over two processes (``torch.distributed`` over gloo, on the CPU)
against the JAX package's one global step and evaluation.

Each case starts its ranks with ``odise_torch.engine.launch`` on the CPU,
meeting at a file under the test's temporary directory; the ranks' work is
this module's ``_rank_*`` functions, which write what they computed to a
file the test then reads. Nothing of JAX runs in the ranks: the test
process computes the JAX side, or reads it from a reference file.

* World size 1: every helper is the local path and touches no backend.
* The loader's per-host slices against ``odise_tpu.data.loader``.
* The grounding loss's gathered negatives ("diff" and "concat") against the
  JAX criterion under ``shard_map`` over two CPU devices.
* The whole TINY train step, category and caption ("diff"), on two ranks of
  one image each, against the JAX global step at a batch of 2 kept in
  ``tests/data/torch_train_reference.npz`` (``tests/test_torch_train.py``).
* Accumulation across ranks, against one process.
* Rank-sharded evaluation: ``do_test`` on two ranks against the JAX
  package's ``tools/train_net.do_test`` on the same records and weights,
  kept in ``tests/data/torch_parallel_reference.npz`` (its model
  initialisation alone takes minutes on a CPU), which

      JAX_PLATFORMS=cpu python -m tests.test_torch_parallel

  writes; the file keeps a fingerprint of its inputs and the JAX packages'
  versions, and loading it checks both. And ``evaluate_open_vocab`` over
  two ranks on model outputs that follow the gt, against the JAX package's
  composition of the same steps.
* ``train_net --num-gpus 2`` on the CPU, with ``--resume``, the
  convergence run on two ranks, and the launcher's refusals.
"""

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REF = Path(__file__).with_name("data") / "torch_parallel_reference.npz"
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "odise_torch", "configs", "Panoptic")
WORLD = 2
# torch's default intra-op threads in a fresh process: the count that
# tests/test_torch_train.py::test_train_step_matches_jax runs at
DEFAULT_THREADS = torch.get_num_threads()
# the evaluation case: TINY CategoryODISE on 4 synthetic 64-px records
EVAL_RECORDS = dict(n=4, size=64, seed=7)
EVAL_PARAM_SEED = 31
EVAL_SIZES = dict(short_side=64, max_size=128)


# ---------------------------------------------------------------- the ranks


def _run_ranks(tmp_path, fn, *args):
    """``fn(*args)`` in WORLD gloo ranks on the CPU, each on one intra-op
    thread unless ``fn`` sets others; each returns a value that is saved to
    a file. Returns the values in rank order."""
    from odise_torch.engine.launch import launch

    out = tmp_path / f"ranks_{fn.__name__}"
    out.mkdir()
    # the ranks' idle threads sleep: WORLD x DEFAULT_THREADS threads
    # spinning on the machine's cores (``_rank_steps``) take four times as long
    wait_policy = os.environ.get("OMP_WAIT_POLICY")
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    try:
        launch(_rank_entry, WORLD, dist_url=f"file://{out}/rendezvous", device="cpu",
               args=(fn, str(out), args))
    finally:
        if wait_policy is None:
            del os.environ["OMP_WAIT_POLICY"]
        else:
            os.environ["OMP_WAIT_POLICY"] = wait_policy
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rank_entry(fn, out, args):
    from odise_torch.parallel import get_rank

    torch.set_num_threads(1)  # the suite runs files in parallel processes
    torch.save(fn(*args), os.path.join(out, f"rank{get_rank()}.pt"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _install_draws(draws):
    """Make the criterion draw from ``draws``: a dict (kind, layer) -> array,
    or a callable ``(shape, kind, layer) -> array``."""
    from odise_torch.losses import matcher

    def draw_uniform(generator, shape, device, kind, layer):
        x = draws(shape, kind, layer) if callable(draws) else draws[(kind, layer)]
        assert tuple(x.shape) == tuple(shape), (kind, layer, x.shape, shape)
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    matcher.draw_uniform = draw_uniform


class RowDraws:
    """Draws whose rows are fixed by (kind, layer, row): the k-th call of a
    (kind, layer) with n rows takes rows k*n .. k*n + n - 1. Two runs that
    ask for the same rows in any split get the same points."""

    def __init__(self):
        self.calls = {}

    def __call__(self, shape, kind, layer):
        k = self.calls.get((kind, layer), 0)
        self.calls[(kind, layer)] = k + 1
        n = shape[0]
        seed = {"match": 1, "oversample": 2, "random": 3}[kind] * 10 ** 6 + layer * 10 ** 4
        return np.stack([np.random.RandomState(seed + k * n + j).rand(*shape[1:])
                         for j in range(n)]).astype(np.float32)


# ---------------------------------------------------------------- 1. world size 1


def test_world_size_one_is_the_local_path():
    """Without a process group (the counterparts of tests/test_multihost.py's
    single-process cases): rank 0 of 1, the main process; the barrier
    returns; ``gather_pickled`` gives ``[obj]``; the mean all-reduce and the
    gather leave their inputs as they are; the criterion's row draws are
    its plain draws. ``global_batch_from_local`` has no counterpart: each
    rank keeps its local batch."""
    from odise_torch.losses import matcher
    from odise_torch.parallel import multihost as mh

    assert not torch.distributed.is_initialized()
    assert (mh.get_world_size(), mh.get_rank(), mh.is_main_process()) == (1, 0, True)
    mh.sync_global_devices("noop")
    obj = {"a": np.arange(3), "b": "text"}
    out = mh.gather_pickled(obj)
    assert len(out) == 1 and out[0] is obj
    x = torch.arange(6.0).reshape(2, 3)
    mh.all_reduce_mean_([x])
    assert torch.equal(x, torch.arange(6.0).reshape(2, 3))
    assert mh.all_gather_rows(x, True) is x and mh.all_gather_rows(x, False) is x
    assert torch.equal(mh.all_reduce_sum(x), x)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(matcher.draw_rows(g1, (2, 5, 2), "cpu", "match", 0),
                       matcher.draw_uniform(g2, (2, 5, 2), "cpu", "match", 0))


def test_launch_at_world_size_one_runs_here():
    from odise_torch.engine.launch import launch

    assert launch(max, 1, args=(3, 5), device="cpu") == 5
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- 2. the loader


@pytest.mark.parametrize("host_id", [0, 1])
def test_loader_host_slices_match_jax(host_id):
    """``build_train_loader(num_hosts=2, host_id=h)`` against the JAX
    package's loader with the same arguments: three batches of 2 per host
    (a total of 4), the same records in the same order with the same flips,
    scales and crops (targets equal, images within one uint8 level, as
    ``tests/test_torch_train.py`` holds one host)."""
    from odise_tpu.data import dataset_mapper as jdm
    from odise_tpu.data import loader as jl
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_train_loader
    from odise_torch.data.synthetic import make_shapes_records

    records = make_shapes_records(6, size=96, seed=2, with_captions=True, vary=True)
    kw = dict(image_size=64, max_instances=4, with_captions=True, num_words=3,
              word_dropout=0.3)
    hosts = dict(num_hosts=2, host_id=host_id, seed=5)
    ours = build_train_loader(records, COCOPanopticDatasetMapper(device="cpu", **kw), 4,
                              **hosts)
    theirs = jl.build_train_loader(records, jdm.COCOPanopticDatasetMapper(**kw), 4, **hosts)
    for _ in range(3):
        got, want = next(ours), next(theirs)
        assert sorted(got) == sorted(want) and got["image"].shape[0] == 2
        for k in ("gt_labels", "gt_masks", "gt_valid", "word_tokens", "word_valid"):
            assert np.array_equal(got[k].numpy(), want[k]), k
        assert float(np.abs(got["image"].numpy() - want["image"]).max()) <= 1 / 255 + 1e-6
    with pytest.raises(ValueError, match="does not split"):
        next(build_train_loader(records, None, 3, num_hosts=2))


def test_loader_hosts_share_out_the_stream():
    """Host h takes indices h, h + 2, ... of the one-host sampler's stream."""
    from odise_torch.data.loader import build_train_loader

    records = [{"i": i} for i in range(5)]

    def mapper(rec, rng):
        return {"i": torch.tensor(rec["i"])}

    one = build_train_loader(records, mapper, 1, seed=3)
    stream = [int(next(one)["i"][0]) for _ in range(12)]
    for h in (0, 1):
        loader = build_train_loader(records, mapper, 4, num_hosts=2, host_id=h, seed=3)
        got = [int(i) for _ in range(3) for i in next(loader)["i"]]
        assert got == stream[h::2], (h, got, stream)


# ---------------------------------------------------------------- 3. the grounding loss

G_B, G_Q, G_K, G_C, G_SCALE = 4, 4, 3, 8, 10.0   # the union batch of tests/test_losses.py


def grounding_inputs():
    """tests/test_losses.py's concat-mode inputs (two images a rank, the
    second image without a caption), and an auxiliary layer."""
    rng = np.random.RandomState(2)
    me = rng.randn(G_B, G_Q, G_C).astype(np.float32)
    we = rng.randn(G_B, G_K, G_C).astype(np.float32)
    aux = rng.randn(G_B, G_Q, G_C).astype(np.float32)
    valid = np.repeat((np.arange(G_B) != 1)[:, None], G_K, axis=1)
    return me, we, aux, valid


def _rank_grounding(inputs):
    """Each mode's loss on this rank's two images and its gradients with
    respect to this rank's mask, word and auxiliary mask embeddings."""
    from odise_torch.losses.grounding import GroundingConfig, mask_grounding_criterion
    from odise_torch.parallel import get_rank

    b = G_B // WORLD
    rows = slice(get_rank() * b, (get_rank() + 1) * b)
    out = {}
    for mode in ("diff", "concat"):
        me, we, aux = (torch.tensor(x[rows], requires_grad=True) for x in inputs[:3])
        scale = torch.tensor(G_SCALE)
        outs = {"mask_embed": me, "word_embed": we, "logit_scale": scale,
                "aux_outputs": [{"mask_embed": aux, "logit_scale": scale}]}
        losses = mask_grounding_criterion(outs, torch.from_numpy(inputs[3][rows]),
                                          GroundingConfig(collect_mode=mode))
        total = sum(losses.values())
        total.backward()
        out[mode] = (float(total), [x.grad.numpy() for x in (me, we, aux)])
    return out


@pytest.fixture(scope="module")
def grounding_ranks(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("grounding"), _rank_grounding,
                      grounding_inputs())


@pytest.mark.parametrize("mode", ["diff", "concat"])
def test_grounding_negatives_match_jax_shard_map(mode, grounding_ranks):
    """The grounding loss on two ranks of two images each (one image
    without a caption), with an auxiliary layer: the ranks' mean loss and
    each rank's gradients for its own mask, word and auxiliary embeddings
    against the JAX criterion under ``shard_map`` over two CPU devices
    (``axis_name="data"``), differentiated through the sum of the devices'
    losses: 1e-5 relative. Under "diff" a rank's gradient holds every
    rank's loss through the gather; under "concat" its own loss alone."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from odise_tpu.losses.grounding import GroundingConfig, mask_grounding_criterion

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def per_device(me, we, aux, v):
        scale = jnp.asarray(G_SCALE)
        outs = {"mask_embed": me, "word_embed": we, "logit_scale": scale,
                "aux_outputs": [{"mask_embed": aux, "logit_scale": scale}]}
        losses = mask_grounding_criterion(outs, v, GroundingConfig(collect_mode=mode),
                                          axis_name="data")
        return jax.lax.psum(sum(losses.values()), "data")

    summed = shard_map(per_device, mesh=mesh, in_specs=(P("data"),) * 4, out_specs=P())
    me, we, aux, valid = grounding_inputs()
    loss, grads = jax.jit(jax.value_and_grad(summed, argnums=(0, 1, 2)))(
        jnp.asarray(me), jnp.asarray(we), jnp.asarray(aux), jnp.asarray(valid))
    got = [r[mode] for r in grounding_ranks]
    np.testing.assert_allclose(np.mean([g[0] for g in got]), float(loss) / WORLD, rtol=1e-5)
    b = G_B // WORLD
    for rank, (_, rank_grads) in enumerate(got):
        for name, g, want in zip(("mask", "word", "aux"), rank_grads, grads):
            want = np.asarray(want)[rank * b:(rank + 1) * b]
            assert float(np.abs(want).max()) > 1e-3
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
                                       err_msg=f"rank {rank} {name}")


# ---------------------------------------------------------------- 4, 5. the train step


def _step_once(case, rows):
    """One train step of the TINY port model in ``case`` on the rows
    ``rows`` of its batch; returns its metrics, trainable gradients (after
    the clip) and trainable parameters after AdamW. The criterion draws
    from ``case["draws"]`` (``RowDraws`` where None) for this step only."""
    from odise_torch.engine import (make_caption_train_step, make_category_train_step,
                                    make_optimizer, partition_params)
    from odise_torch.losses import CriterionConfig, matcher
    from odise_torch.model_zoo.factory import build_caption_odise, build_category_odise

    caption = case["tag"] == "caption"
    build = build_caption_odise if caption else build_category_odise
    model = build("tiny", device="cpu", **case["build"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    trainable, _ = partition_params(model)
    opt = make_optimizer(trainable, **case["opt"])
    cfg = CriterionConfig(**case["crit"])
    if caption:
        step = make_caption_train_step(model, opt, cfg, grad_clip=case["clip"],
                                       accum_steps=case["accum"])
    else:
        step = make_category_train_step(model, opt, cfg, torch.from_numpy(case["text"]),
                                        case["build"]["train_labels"], grad_clip=case["clip"],
                                        accum_steps=case["accum"])
    batch = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    for k in ("gt_labels", "word_tokens"):
        if k in batch:
            batch[k] = batch[k].long()
    plain = matcher.draw_uniform
    _install_draws(RowDraws() if case["draws"] is None else case["draws"])
    try:
        metrics = step(batch, None)
    finally:
        matcher.draw_uniform = plain
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy().copy() for n, p in trainable.items()},
            "params": {n: p.detach().numpy().copy() for n, p in trainable.items()}}


def _rank_steps(cases):
    """Each case's step on this rank's rows (``case["rows"][rank]``), on
    ``case["threads"]`` intra-op threads."""
    from odise_torch.parallel import get_rank

    out = []
    for case in cases:
        torch.set_num_threads(case["threads"])
        out.append(_step_once(case, case["rows"][get_rank()]))
    return out


@pytest.fixture(scope="module")
def train_ref():
    """tests/test_torch_train.py's reference file, checked as it checks it."""
    from . import test_torch_train as tt

    with np.load(tt.REF) as f:
        ref = {k: f[k] for k in f.files}
    assert str(ref["meta/versions"]) == tt.jax_versions()
    shapes = {tag: tt._shapes(ref, tag) for tag in tt.PARAM_SEED}
    assert str(ref["meta/fingerprint"]) == tt.fingerprint(shapes)
    return ref


def _case(ref, tag, batch, draws, accum=1, rows=None):
    from . import test_torch_train as tt

    model = tt._port_model(ref, tag)
    caption = tag == "caption"
    return dict(tag=tag, state={k: v.numpy() for k, v in model.state_dict().items()},
                build=dict(train_labels=tt.LABELS, with_clip_head=False, use_checkpoint=False,
                           slide_training=False, backbone_in_size=(tt.SIZE, tt.SIZE)),
                opt=tt.OPT, crit=dict(num_classes=1 if caption else len(tt.LABELS), **tt.CRIT),
                clip=tt.CLIP, text=tt.text_embed_raw(), batch=batch, draws=draws,
                accum=accum, rows=rows, threads=1)


@pytest.fixture(scope="module")
def step_ranks(train_ref, tmp_path_factory):
    """The ranks' steps: (category, caption) on JAX's draws, each rank one
    image of ``step_batch``; then on ``RowDraws``, two ranks of one image,
    and two ranks of two images with ``accum_steps=2``. Every case runs on
    one thread a rank, as the one-process port steps it is held to here
    do; category and caption run again as ``jax_category`` and
    ``jax_caption`` on ``DEFAULT_THREADS`` a rank, as the one-process step
    that ``test_train_step_matches_jax`` holds to JAX runs."""
    import jax

    from . import test_torch_train as tt
    from .test_torch_losses import jax_criterion_draws
    from odise_torch.losses import CriterionConfig

    draws = jax_criterion_draws(jax.random.PRNGKey(tt.STEP_KEY), 4, tt.B, tt.B * tt.T,
                                CriterionConfig(**tt.CRIT))
    cases = {tag: _case(train_ref, tag, tt.step_batch(tag == "caption"), draws,
                        rows=[[0], [1]]) for tag in ("category", "caption")}
    cases["ranks_of_one"] = _case(train_ref, "category", tt.step_batch(False), None,
                                  rows=[[0], [1]])
    cases["accum_ranks"] = _case(train_ref, "category", tt.step_batch(False, n=4), None,
                                 accum=2, rows=[[0, 1], [2, 3]])
    for tag in ("category", "caption"):
        cases[f"jax_{tag}"] = dict(cases[tag], threads=DEFAULT_THREADS)
    results = _run_ranks(tmp_path_factory.mktemp("steps"), _rank_steps, list(cases.values()))
    return cases, {name: [r[i] for r in results] for i, name in enumerate(cases)}


def _ranks_agree(got):
    """Both ranks' gradients and updated parameters bitwise equal."""
    for what in ("grads", "params"):
        for name, v in got[0][what].items():
            assert np.array_equal(v, got[1][what][name]), (what, name)
    assert got[0]["metrics"] == got[1]["metrics"]


@pytest.mark.parametrize("tag", ["category", "caption"])
def test_two_rank_step_matches_jax_global_step(tag, step_ranks, train_ref):
    """One TINY step on two ranks of one image each (3 and 2 valid targets,
    so a rank-local target count or class-weight sum fails), the criterion's
    draws JAX's for the batch of 2 sliced by rank, the caption step's
    negatives gathered with gradients ("diff"): against the JAX package's
    one step on the batch of 2 (tests/data/torch_train_reference.npz) at
    ``test_train_step_matches_jax``'s tolerances, on its thread count
    (``DEFAULT_THREADS`` a rank): the mean over the ranks of every loss and
    metric 1e-4 relative; the parameters after AdamW within 1e-5 where JAX's
    gradient is at least 100 eps, else 2 lr; the all-reduced gradients
    within 1e-2 of each tensor's largest entry, or 1e-6 of the set's
    largest. (The backbone projections' gradients, which their
    normalisations all but cancel, are float32 noise of the summation
    order near 1e-2 in both packages: on this 8-core CPU the caption
    step's ``backbone/proj_6`` convolutions measure 1.02e-2 to 1.43e-2 at
    1, 2 and 6 threads a rank and under 0.6e-2 at 3, 4 and 8; the rank
    split itself is held much closer in
    ``test_two_ranks_equal_one_process_on_the_union``.) Both ranks'
    gradients and parameters bitwise equal."""
    from . import test_torch_train as tt

    cases, results = step_ranks
    got = results[f"jax_{tag}"]
    _ranks_agree(got)
    ref = train_ref
    want = {k[len(tag) + 8:]: float(v) for k, v in ref.items()
            if k.startswith(f"{tag}/metric/")}
    assert sorted(got[0]["metrics"]) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[0]["metrics"][k], w, rtol=1e-4, atol=1e-7, err_msg=k)
    scale = min(1.0, tt.CLIP / want["grad_norm"])
    grads = tt._tree(ref, f"{tag}/grad/")
    assert set(got[0]["grads"]) == {tt._port_name(p) for p in grads}
    tt._close_tree(got[0]["grads"], {p: g * scale for p, g in grads.items()}, 1e-2, "grad",
                   floor=1e-6)
    for path, w in tt._tree(ref, f"{tag}/new/").items():
        name = tt._port_name(path)
        strong = np.abs(tt.flax_leaf_to_torch(path, grads[path]) * scale) >= 100 * 1e-8
        diff = np.abs(got[0]["params"][name] - tt.flax_leaf_to_torch(path, w))
        bound = np.where(strong, 1e-5, 2 * tt.OPT["lr"] + 1e-6)
        assert (diff <= bound).all(), ("/".join(path), float((diff - bound).max()))


def _close_steps(got, want, rel, param_tol, losses=None, grad_rel=None):
    """Two port steps alike: the metrics named in ``losses`` (every one
    where None) within ``rel`` relative; each gradient within ``grad_rel``
    (default ``rel``) of its tensor's largest entry or 1e-6 of the set's largest (a gradient that
    vanishes in exact arithmetic is float32 noise); each parameter within
    ``param_tol`` where the gradient is at least 100 eps, else 2 lr (AdamW's
    first step divides noise by noise there)."""
    from . import test_torch_train as tt

    keys = sorted(want["metrics"]) if losses is None else losses
    for k in keys:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=rel, atol=1e-9,
                                   err_msg=k)
    if losses is not None:
        return
    grad_rel = rel if grad_rel is None else grad_rel
    top = max(float(np.abs(g).max()) for g in want["grads"].values())
    for name, g in want["grads"].items():
        atol = max(grad_rel * float(np.abs(g).max()), 1e-6 * top)
        np.testing.assert_allclose(got["grads"][name], g, rtol=0, atol=atol,
                                   err_msg=f"grad {name}")
        strong = np.abs(g) >= 100 * 1e-8
        diff = np.abs(got["params"][name] - want["params"][name])
        bound = np.where(strong, param_tol, 2 * tt.OPT["lr"] + 1e-6)
        assert (diff <= bound).all(), (name, float((diff - bound).max()))


@pytest.mark.parametrize("tag", ["category", "caption"])
def test_two_ranks_equal_one_process_on_the_union(tag, step_ranks):
    """The two-rank step of ``test_two_rank_step_matches_jax_global_step``,
    on one thread a rank, against the port's own one-process step on both
    images with the same draws, on one thread: every metric 1e-5 relative,
    gradients 1e-3 of each tensor's largest entry (the worst measured
    5e-5), parameters 1e-6 (float32; the ranks sum their images' gradients
    in another order than one batch does, and normalisations that cancel a
    gradient amplify that)."""
    cases, results = step_ranks
    _close_steps(results[tag][0], _step_once(cases[tag], [0, 1]), 1e-5, 1e-6, grad_rel=1e-3)


def test_accumulation_and_ranks(step_ranks):
    """Accumulation over ranks, with ``RowDraws`` (each image's points fixed
    whatever the split).

    Two ranks of one image against one process with ``accum_steps=2`` on
    the same two images: both normalise the mask losses by the mean target
    count, 2.5 (3 and 2 valid targets), so every mask and dice loss agrees
    within 1e-6 relative. The class loss does not, by design: the ranks
    normalise it by the union's class weights, as JAX's one global step
    does, while accumulation normalises each micro-batch by its own, as
    JAX's accumulation does (ROADMAP C29); the ranks are held to the union
    step instead, as in ``test_two_ranks_equal_one_process_on_the_union``.

    Two ranks of two images with ``accum_steps=2`` against one process with
    ``accum_steps=2`` on the four images ordered micro-step by micro-step,
    rank by rank (rank 0's first, rank 1's first, rank 0's second, rank
    1's second): micro-step i of the ranks is the union of their i-th
    micro-batches, counted and normalised together. The same tolerances;
    both ranks bitwise equal."""
    cases, results = step_ranks
    ranks = results["ranks_of_one"]
    _ranks_agree(ranks)
    case = cases["ranks_of_one"]
    accum = _step_once(dict(case, accum=2), [0, 1])
    mask_losses = [k for k in accum["metrics"] if k.startswith(("loss_mask", "loss_dice"))]
    assert len(mask_losses) == 8
    _close_steps(ranks[0], accum, 1e-6, None, losses=mask_losses)
    assert abs(ranks[0]["metrics"]["loss_ce"] / accum["metrics"]["loss_ce"] - 1) > 1e-4
    _close_steps(ranks[0], _step_once(case, [0, 1]), 1e-5, 1e-6, grad_rel=1e-3)

    got = results["accum_ranks"]
    _ranks_agree(got)
    _close_steps(got[0], _step_once(cases["accum_ranks"], [0, 2, 1, 3]), 1e-5, 1e-6,
                 grad_rel=1e-3)


# ---------------------------------------------------------------- 6. sharded evaluation


def eval_records():
    from odise_torch.data.synthetic import make_shapes_records

    return make_shapes_records(EVAL_RECORDS["n"], size=EVAL_RECORDS["size"],
                               seed=EVAL_RECORDS["seed"])


def _eval_cfg(config_dict, dataset_name):
    from odise_torch.data.synthetic import SYNTH_LABELS

    return config_dict(dataloader=config_dict(
        wrapper=config_dict(labels=[list(label) for label in SYNTH_LABELS],
                            dataset_name=dataset_name, semantic_on=True, panoptic_on=True,
                            instance_on=True),
        eval_short_side=EVAL_SIZES["short_side"], eval_max_size=EVAL_SIZES["max_size"]))


def eval_fingerprint(shapes):
    """sha256 of the evaluation case's inputs: its constants, the records
    and the perturbed parameters of ``shapes``."""
    from odise_torch.data.synthetic import SYNTH_LABELS

    from .test_torch_train import _flat
    from .test_torch_towers import perturbed_params

    h = hashlib.sha256(repr((EVAL_RECORDS, EVAL_PARAM_SEED, EVAL_SIZES,
                             SYNTH_LABELS)).encode())

    def add(name, x):
        x = np.ascontiguousarray(x)
        h.update(f"{name} {x.dtype} {x.shape}".encode())
        h.update(x.tobytes())

    for i, rec in enumerate(eval_records()):
        for k in ("image", "pan_seg", "sem_seg"):
            add(f"record {i} {k}", rec[k])
        h.update(repr(rec["segments_info"]).encode())
    params = perturbed_params(shapes, seed=EVAL_PARAM_SEED)["params"]
    for path, v in sorted(_flat(params)):
        add("/".join(path), v)
    return h.hexdigest()


def _jax_eval_model():
    from odise_tpu.model_zoo.factory import build_category_odise
    from odise_torch.data.synthetic import SYNTH_LABELS

    return build_category_odise("tiny", train_labels=SYNTH_LABELS, with_clip_head=False,
                                use_checkpoint=False, slide_training=False)


def write_reference():
    """The JAX package's ``tools/train_net.do_test`` on the evaluation case,
    written to REF with the parameters' shapes, a fingerprint of the inputs
    and the JAX packages' versions."""
    import sys
    import tempfile

    import jax
    import jax.numpy as jnp

    from odise_tpu.config import ConfigDict
    from odise_tpu.data.catalog import DatasetCatalog, MetadataCatalog
    from odise_tpu.data.synthetic import make_shapes_records, synth_categories
    from odise_torch.data.synthetic import SYNTH_LABELS

    from .test_torch_train import _flat, jax_versions
    from .test_torch_towers import perturbed_params

    sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))
    import train_net

    model = _jax_eval_model()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((len(SYNTH_LABELS), 16)),
        method=type(model).init_full))
    params = perturbed_params(shapes, seed=EVAL_PARAM_SEED)
    with tempfile.TemporaryDirectory() as d:
        records = make_shapes_records(d, EVAL_RECORDS["n"], size=EVAL_RECORDS["size"],
                                      seed=EVAL_RECORDS["seed"])
        DatasetCatalog.register("_parallel_eval", lambda: records)
        MetadataCatalog.get("_parallel_eval").set(ignore_label=255,
                                                  categories=synth_categories())
        result = train_net.do_test(_eval_cfg(ConfigDict, "_parallel_eval"), model,
                                   params)["main"]
    out = {f"metric/{k}": np.asarray(float(v)) for k, v in result.items()
           if k != "s_per_img"}
    out["meta/shapes"] = np.asarray(json.dumps(
        {"/".join(path): list(s.shape) for path, s in _flat(shapes["params"])}))
    out["meta/fingerprint"] = np.asarray(eval_fingerprint(shapes))
    out["meta/versions"] = np.asarray(jax_versions())
    np.savez_compressed(REF, **out)
    print(result)
    print(f"wrote {REF} ({REF.stat().st_size / 1e3:.1f} kB)")


def _rank_do_test(state, records):
    from odise_torch import train_net
    from odise_torch.config import ConfigDict
    from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from odise_torch.data.synthetic import SYNTH_LABELS, synth_categories
    from odise_torch.model_zoo.factory import build_category_odise

    DatasetCatalog.register("_parallel_eval", lambda: records)
    MetadataCatalog.get("_parallel_eval").set(ignore_label=255, categories=synth_categories())
    model = build_category_odise("tiny", train_labels=SYNTH_LABELS, with_clip_head=False,
                                 use_checkpoint=False, slide_training=False, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return train_net.do_test(_eval_cfg(ConfigDict, "_parallel_eval"), model)["main"]


def test_two_rank_do_test_matches_jax(tmp_path):
    """``train_net.do_test`` on two ranks (records 0 and 2 on rank 0, 1 and 3
    on rank 1; ``dataloader.eval_multihost`` on by default) with TINY
    CategoryODISE on seeded weights: both ranks return the same metrics, over
    all 4 images, equal within 1e-5 relative to the JAX package's
    ``tools/train_net.do_test`` on the same records and weights in one
    process (tests/test_multihost.py's contract)."""
    import jax
    import jax.numpy as jnp

    from odise_torch.data.synthetic import SYNTH_LABELS
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.model_zoo.from_jax import load_flax_params

    from .test_torch_train import _nest, jax_versions
    from .test_torch_towers import perturbed_params

    with np.load(REF) as f:
        ref = {k: f[k] for k in f.files}
    rerun = "rerun `JAX_PLATFORMS=cpu python -m tests.test_torch_parallel`"
    assert str(ref["meta/versions"]) == jax_versions(), f"{REF.name}: other versions; {rerun}"
    shapes = {"params": _nest((tuple(k.split("/")), jax.ShapeDtypeStruct(tuple(v), jnp.float32))
                              for k, v in json.loads(str(ref["meta/shapes"])).items())}
    assert str(ref["meta/fingerprint"]) == eval_fingerprint(shapes), (
        f"{REF.name} was made from other inputs; {rerun}")
    model = build_category_odise("tiny", train_labels=SYNTH_LABELS, with_clip_head=False,
                                 use_checkpoint=False, slide_training=False, device="cpu")
    load_flax_params(model, perturbed_params(shapes, seed=EVAL_PARAM_SEED))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    got = _run_ranks(tmp_path, _rank_do_test, state, eval_records())
    got = [{k: v for k, v in r.items() if k != "s_per_img"} for r in got]
    assert got[0] == got[1]
    want = {k[7:]: float(v) for k, v in ref.items() if k.startswith("metric/")}
    assert sorted(got[0]) == sorted(want) and got[0]["images"] == want["images"] == 4
    assert want["mIoU"] > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[0][k], w, rtol=1e-5, atol=1e-7, err_msg=k)


class _Outputs:
    """``infer`` that hands out fixed model outputs in call order."""

    def __init__(self, outputs):
        self.outputs = iter(outputs)
        self.model = type("Model", (), dict(object_mask_threshold=0.0, overlap_threshold=0.8,
                                            test_topk_per_image=100))()

    def __call__(self, images):
        return tuple(torch.from_numpy(o) for o in next(self.outputs))


def _rank_injected_eval(records, outputs, labels, thing):
    """evaluate_open_vocab over the ranks: this rank is given the outputs of
    its records, every WORLD-th from its rank on."""
    from odise_torch.evaluation.run import evaluate_open_vocab
    from odise_torch.parallel import get_rank

    return {ds: evaluate_open_vocab(
        _Outputs(outputs[get_rank()::WORLD]), records, labels=labels, thing_mask=thing,
        device_stats=ds, short_side=128, max_size=320, across_ranks=True)
        for ds in (True, False)}


def test_two_rank_evaluation_of_outputs_matches_jax(tmp_path):
    """``evaluate_open_vocab(across_ranks=True)`` on two ranks, over
    tests/test_torch_eval.py's three records (one in a 128x256 bucket, one
    without gt) and model outputs that follow the gt, on the device path and
    on the host path: both ranks return the JAX package's composition of
    ``do_test``'s steps over all three records, every metric equal but for
    float32 summation order (1e-12 relative), PQ, mIoU and AP above 20."""
    import jax.numpy as jnp

    from . import test_torch_eval as tev

    records = tev._records()
    outputs = tev._outputs(records)
    got = _run_ranks(tmp_path, _rank_injected_eval, records, outputs, tev.LABELS,
                     tev.SYNTH_THING)
    for ds in (True, False):
        want = tev._jax_task(records, tev._Injected(outputs, tev._Model(), jnp.asarray), ds)
        ranks = [{k: v for k, v in r[ds].items() if k != "s_per_img"} for r in got]
        assert ranks[0] == ranks[1]
        assert sorted(ranks[0]) == sorted(want) and ranks[0]["images"] == 3
        for k, w in want.items():
            np.testing.assert_allclose(ranks[0][k], w, rtol=1e-12, err_msg=(ds, k))
        assert ranks[0]["PQ"] > 20 and ranks[0]["mIoU"] > 20 and ranks[0]["AP"] > 20



# ---------------------------------------------------------------- 7. the CLI


def _log_lines(path, pattern):
    with open(path) as f:
        return [line for line in f if pattern in line]


def test_train_net_on_two_cpu_ranks_and_resume(tmp_path, monkeypatch):
    """``python -m odise_torch.train_net --num-gpus 2 train.device=cpu`` on
    the TINY synthetic config: 2 steps at a total batch of 2 (one image a
    rank), checkpoints every step, the final evaluation shared out over the
    ranks (3 images); then ``--resume`` to 3 steps on two ranks with
    ``dataloader.eval_multihost=False``, so that rank 0 evaluates all 3
    images alone while rank 1 waits. Only rank 0 writes ``config.yaml``,
    ``metrics.json``, the checkpoints and ``log.txt``; rank 1 logs to
    ``log.txt.rank1``. Both ranks resume at iteration 2 with the
    optimizer's count 2, and ``metrics.json`` holds iterations 0, 1 and 2
    once each."""
    from odise_torch import train_net

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' threads
    out = tmp_path / "run"
    common = ["--config-file", os.path.join(CONFIGS, "odise_label_tiny_synth.py"),
              "--output", str(out), "--num-gpus", "2", "--max-eval-images", "3"]
    opts = ["train.device=cpu", "train.eval_period=2", "train.checkpointer.period=1"]
    assert train_net.main(common + ["--dist-url", f"file://{tmp_path}/rendezvous_train"]
                          + opts + ["train.max_iter=2"]) is None
    assert sorted(os.listdir(out)) == ["checkpoints", "config.yaml", "log.txt", "log.txt.rank1",
                                       "metrics.json"]
    assert sorted(os.listdir(out / "checkpoints")) == [
        "last_checkpoint", "model_0000000.pth", "model_best.pth", "model_final.pth"]
    assert train_net.main(common + ["--resume", "--dist-url",
                                    f"file://{tmp_path}/rendezvous_resume"]
                          + opts + ["train.max_iter=3", "dataloader.eval_multihost=False"]
                          ) is None
    rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [0, 1, 2]
    assert all(r["grad_norm"] > 0 for r in rows)
    assert torch.load(out / "checkpoints" / "model_final.pth", weights_only=True)["step"] == 3
    main_log, rank1_log = out / "log.txt", out / "log.txt.rank1"
    for log, rank in ((main_log, 0), (rank1_log, 1)):
        assert len(_log_lines(log, f"Rank {rank} of 2")) == 2
        assert len(_log_lines(log, "Rank")) == 2
        assert len(_log_lines(log, "Starting at iteration 2, optimizer update count 2")) == 1
    # both ranks evaluated in the first run, rank 0 alone in the second
    assert len(_log_lines(main_log, "Task main:")) == 2
    assert len(_log_lines(rank1_log, "Task main:")) == 1
    assert len(_log_lines(main_log, "Saved checkpoint")) >= 4
    assert not _log_lines(rank1_log, "Saved checkpoint")
    assert not _log_lines(rank1_log, "config saved")
    # the copypaste table's header and values: each evaluation saw all 3
    # images, shared out in the first run and on rank 0 alone in the second
    lines = [line.split("copypaste: ")[1].strip().split(",")
             for line in _log_lines(main_log, "copypaste: ")]
    tables = [(head, lines[i + 1]) for i, head in enumerate(lines) if "images" in head]
    assert len(tables) == 2
    for header, values in tables:
        assert float(values[header.index("images")]) == 3


def test_convergence_run_on_two_ranks(monkeypatch):
    """Three steps of the caption convergence run on two ranks, its
    grounding negatives gathered over them ("diff"), one image a rank, the
    evaluation before and after shared out over two val images: finite,
    and every rank's result rank 0's."""
    from odise_torch.convergence import run_convergence

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' threads
    r = run_convergence(variant="caption", steps=3, batch=2, n_train=4, n_val=2,
                        num_points=32, collect_mode="diff", device="cpu", world_size=2,
                        dataset_name="_conv_two_ranks")
    assert r["world_size"] == 2
    assert r["metrics_before"]["images"] == r["metrics_after"]["images"] == 2
    assert np.isfinite(r["loss_first10_mean"]) and r["loss_last10_mean"] > 0

# ---------------------------------------------------------------- 8. the refusals


def test_launcher_refusals(tmp_path, monkeypatch):
    """No card: CUDA is refused, nothing falls back to the CPU, and
    ``train_net --num-gpus 2`` writes nothing. Fewer cards than processes
    raises; two ranks share a card only with the card and gloo both asked
    for (NCCL refuses two ranks on one card); NCCL does not run on the CPU."""
    from odise_torch import train_net
    from odise_torch.engine.launch import launch, rank_device

    argv = ["--config-file", os.path.join(CONFIGS, "odise_label_tiny_synth.py"), "--output",
            str(tmp_path / "out"), "--num-gpus", "2"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: launch(max, 2, args=(1, 2)), lambda: train_net.main(argv)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    assert not (tmp_path / "out").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for run in (lambda: launch(max, 2, args=(1, 2)), lambda: train_net.main(argv),
                lambda: launch(max, 2, args=(1, 2), device="cuda")):
        with pytest.raises(RuntimeError, match="2 processes on this machine need 2 cards"):
            run()
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="NCCL refuses that"):
            launch(max, 2, args=(1, 2), device="cuda:0", backend=backend)
    with pytest.raises(ValueError, match="NCCL refuses that"):
        train_net.main(argv + ["train.device=cuda:0"])
    with pytest.raises(RuntimeError, match="there is no cuda:1"):
        rank_device("cuda:1", 0, 2, "gloo")
    with pytest.raises(ValueError, match="only gloo runs there"):
        rank_device("cpu", 0, 2, "nccl")
    assert rank_device("cuda:0", 1, 2, "gloo") == (torch.device("cuda", 0), "gloo")
    assert rank_device("cuda", 0, 1, None) == (torch.device("cuda", 0), "nccl")
    assert not (tmp_path / "out").exists()


def _rank_fails():
    from odise_torch.parallel import get_rank, sync_global_devices

    if get_rank() == 1:
        raise ValueError("rank 1 fails")
    sync_global_devices("never passed")


def test_a_failing_rank_fails_the_launch(tmp_path):
    """A rank that raises makes ``launch`` raise, with the other rank
    stopped while it waits for it (whichever of the two is reported)."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails|remote worker"):
        _run_ranks(tmp_path, _rank_fails)


if __name__ == "__main__":
    write_reference()
