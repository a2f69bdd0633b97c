"""The diffusion process (``odise_torch/diffusion``) and Stable Diffusion's
sampler (``odise_torch/models/sd/ldm.py``) against the JAX package on the
CPU.

Schedules and respacing are float64 numpy on both sides and must agree
exactly, errors included. Every ``GaussianDiffusion`` method runs on the
same seeded numpy inputs and the same model function, written once in jnp
and once in torch, over every mean type, variance type and loss type;
float32 on both sides, so the tolerance is ``TOL`` of the largest
magnitude. The samplers' noise is JAX's own draw, handed to the port.
TINY ``LatentDiffusion`` is held to the stored JAX run
(``tests/test_torch_ldm.py``) before its final clip.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odise_tpu.diffusion as jd
import odise_torch.diffusion as pd
from odise_torch.diffusion import gaussian as pg
from .torch_threads import one_thread  # noqa: F401,E402

TOL = 1e-5  # float32 through a few dozen operations
# the bound's decoder term at t = 0 takes the log of a difference of two
# CDFs near its 1e-12 floor when the variance is small: the two packages'
# tanh differ there in the last bits (1.4e-4 measured, learned_range)
TOL_BOUND = 1e-3
T = 20  # with the cosine schedule: at 20 steps the linear one reaches beta 1
SHAPE = (3, 2, 4, 4)  # [B, C, H, W]


def close(port, jax_value, tol=TOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(jax_value)
    assert port.shape == ref.shape
    err = float(np.abs(port - ref).max()) / max(1.0, float(np.abs(ref).max()))
    assert err <= tol, err


class ModelFn:
    """x -> tanh(w * x + b * t / T) per channel, doubled to 2C channels
    (the second half in [-1, 1]) for a learned variance; the timesteps it
    saw are kept."""

    def __init__(self, learned: bool, seed: int = 0):
        rng = np.random.RandomState(seed)
        c = SHAPE[1] * (2 if learned else 1)
        self.w = (0.5 + rng.rand(1, c, 1, 1)).astype(np.float32)
        self.b = rng.randn(1, c, 1, 1).astype(np.float32)
        self.learned, self.seen = learned, []

    def _x(self, x, cat):
        return cat([x, x], 1) if self.learned else x

    def jax(self, x, t, **kw):
        if not isinstance(t, jax.core.Tracer):  # inside a scan it is traced
            self.seen.append(np.asarray(t))
        tt = jnp.asarray(t, jnp.float32).reshape(-1, 1, 1, 1) / T
        return jnp.tanh(jnp.asarray(self.w) * self._x(x, jnp.concatenate)
                        + jnp.asarray(self.b) * tt)

    def torch(self, x, t, **kw):
        self.seen.append(t.numpy())
        tt = t.float().reshape(-1, 1, 1, 1) / T
        return torch.tanh(torch.from_numpy(self.w) * self._x(x, torch.cat)
                          + torch.from_numpy(self.b) * tt)


def inputs(seed=0, shape=SHAPE):
    rng = np.random.RandomState(seed)
    x0 = np.clip(rng.randn(*shape), -1, 1).astype(np.float32)
    xt = rng.randn(*shape).astype(np.float32)
    noise = rng.randn(*shape).astype(np.float32)
    t = np.asarray([0, T // 2, T - 1], np.int32)[: shape[0]]
    return x0, xt, noise, t


def pair(t_np, *arrays):
    """(jax arrays, torch tensors) of numpy inputs; t as int32 / int64."""
    j = [jnp.asarray(a) for a in arrays] + [jnp.asarray(t_np)]
    p = [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(t_np.astype(np.int64))]
    return j, p


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("name", ["linear", "cosine", "ldm_linear"])
@pytest.mark.parametrize("steps", [1000, 50, 7])
def test_schedules_equal_jax(name, steps):
    p = pd.get_named_beta_schedule(name, steps)
    j = jd.get_named_beta_schedule(name, steps)
    assert p.dtype == np.float64 and np.array_equal(p, j)


FORMS = [(1000, "ddim50"), (1000, "ddim10"), (1000, "ldm_ddim50"), (1000, "ldm_ddim3"),
         (1000, "ldm_ddim2"), (1000, "ldm_ddim1000"), (100, "ddim25"), (1000, "10"),
         (1000, "10,15,20"), (100, [5, 10]), (300, "1,2,3"), (20, [20])]


@pytest.mark.parametrize("num,counts", FORMS, ids=[f"{n}-{c}" for n, c in FORMS])
def test_space_timesteps_equal_jax(num, counts):
    assert pd.space_timesteps(num, counts) == jd.space_timesteps(num, counts)


ERRORS = [(NotImplementedError, lambda m: m.get_named_beta_schedule("quadratic", 10)),
          (ValueError, lambda m: m.space_timesteps(10, "ddim6")),
          (ValueError, lambda m: m.space_timesteps(10, "ldm_ddim6")),
          (ValueError, lambda m: m.space_timesteps(10, "6,6")),
          (ValueError, lambda m: m.space_timesteps(10, [11]))]


@pytest.mark.parametrize("kind,call", ERRORS, ids=range(len(ERRORS)))
def test_schedule_errors_equal_jax(kind, call):
    with pytest.raises(kind) as jax_error:
        call(jd)
    with pytest.raises(kind) as port_error:
        call(pd)
    assert str(port_error.value) == str(jax_error.value)


# ------------------------------------------------------------- GaussianDiffusion

COMBOS = list(itertools.product(pg.MEAN_TYPES, pg.VAR_TYPES, pg.LOSS_TYPES))


def _diffusions(mean_type, var_type, loss_type, schedule="cosine"):
    betas = jd.get_named_beta_schedule(schedule, T)
    kw = dict(mean_type=mean_type, var_type=var_type, loss_type=loss_type)
    return jd.GaussianDiffusion(betas=betas, **kw), pd.GaussianDiffusion(betas, **kw)


@pytest.mark.parametrize("mean_type,var_type,loss_type", COMBOS,
                         ids=["-".join(c) for c in COMBOS])
def test_gaussian_methods_equal_jax(mean_type, var_type, loss_type):
    """Every method of the process on the same inputs: q's mean, variance
    and sample, the posterior, the three predictors, p's mean and
    variance (clipped and not, with a denoising function), an ancestral
    step, DDIM steps with eta 0 and 0.5 and the reverse step, the bound's
    terms and the training losses."""
    jdiff, pdiff = _diffusions(mean_type, var_type, loss_type)
    for name in ("alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2", "sqrt_recipm1_alphas_cumprod"):
        assert np.array_equal(getattr(pdiff, name), getattr(jdiff, name))
    learned = var_type.startswith("learned")
    model = ModelFn(learned)
    x0, xt, noise, t_np = inputs()
    (jx0, jxt, jn, jt), (px0, pxt, pn, pt) = pair(t_np, x0, xt, noise)

    for a, b in zip(pdiff.q_mean_variance(px0, pt), jdiff.q_mean_variance(jx0, jt)):
        close(a, b)
    close(pdiff.q_sample(px0, pt, pn), jdiff.q_sample(jx0, jt, jn))
    for a, b in zip(pdiff.q_posterior_mean_variance(px0, pxt, pt),
                    jdiff.q_posterior_mean_variance(jx0, jxt, jt)):
        close(a, b)
    close(pdiff._predict_xstart_from_eps(pxt, pt, pn), jdiff._predict_xstart_from_eps(jxt, jt, jn))
    close(pdiff._predict_eps_from_xstart(pxt, pt, px0),
          jdiff._predict_eps_from_xstart(jxt, jt, jx0))
    close(pdiff._predict_xstart_from_xprev(pxt, pt, px0),
          jdiff._predict_xstart_from_xprev(jxt, jt, jx0))

    for clip, denoised in ((True, None), (False, None), (True, "half")):
        pfn = None if denoised is None else (lambda x: 0.5 * x)
        jfn = None if denoised is None else (lambda x: 0.5 * x)
        p = pdiff.p_mean_variance(model.torch, pxt, pt, clip, pfn)
        j = jdiff.p_mean_variance(model.jax, jxt, jt, clip, jfn)
        assert sorted(p) == sorted(j)
        for k in p:
            close(p[k], j[k])

    step_rng = jax.random.PRNGKey(3)
    j = jdiff.p_sample(model.jax, jxt, jt, step_rng)
    jnoise = jax.random.normal(step_rng, xt.shape, jnp.float32)
    p = pdiff.p_sample(model.torch, pxt, pt, noise=torch.from_numpy(np.asarray(jnoise)))
    for k in ("sample", "pred_xstart"):
        close(p[k], j[k])
    for eta in (0.0, 0.5):
        j = jdiff.ddim_sample(model.jax, jxt, jt, step_rng, eta=eta)
        p = pdiff.ddim_sample(model.torch, pxt, pt, eta=eta,
                              noise=torch.from_numpy(np.asarray(jnoise)))
        for k in ("sample", "pred_xstart"):
            close(p[k], j[k])
    t_rev = np.asarray([0, 5, T - 2], np.int32)
    j = jdiff.ddim_reverse_sample(model.jax, jxt, jnp.asarray(t_rev))
    p = pdiff.ddim_reverse_sample(model.torch, pxt, torch.from_numpy(t_rev.astype(np.int64)))
    close(p["sample"], j["sample"])

    close(pdiff._vb_terms_bpd(model.torch, px0, pxt, pt)["output"],
          jdiff._vb_terms_bpd(model.jax, jx0, jxt, jt)["output"], TOL_BOUND)
    j = jdiff.training_losses(model.jax, jx0, jt, None, noise=jn)
    p = pdiff.training_losses(model.torch, px0, pt, noise=pn)
    assert sorted(p) == sorted(j)
    for k in p:
        close(p[k], j[k], TOL if k == "mse" else TOL_BOUND)


@pytest.mark.parametrize("var_type", ["learned", "learned_range"])
def test_learned_variance_bound_trains_only_the_variance(var_type):
    """With a learned variance, the bound's term in ``training_losses``
    reaches the variance half of the output and not the mean half (the
    JAX package's ``stop_gradient``); the mse reaches only the mean."""
    _, pdiff = _diffusions("eps", var_type, "mse")
    x0, _, noise, t_np = inputs()
    out = torch.randn((SHAPE[0], 2 * SHAPE[1], *SHAPE[2:]), generator=torch.Generator()
                      .manual_seed(0)).tanh().requires_grad_(True)
    t = torch.from_numpy(t_np.astype(np.int64))
    terms = pdiff.training_losses(lambda x, tt: out, torch.from_numpy(x0), t,
                                  noise=torch.from_numpy(noise))
    (g_vb,) = torch.autograd.grad(terms["vb"].sum(), out, retain_graph=True)
    (g_mse,) = torch.autograd.grad(terms["mse"].sum(), out)
    C = SHAPE[1]
    assert float(g_vb[:, :C].abs().max()) == 0 and float(g_vb[:, C:].abs().max()) > 0
    assert float(g_mse[:, C:].abs().max()) == 0 and float(g_mse[:, :C].abs().max()) > 0


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_sampling_loops_equal_jax(loop):
    """Both loops over every timestep, on JAX's own draws (its key split as
    its loop splits it), for an eps model with a fixed-large variance
    (ancestral) and DDIM at eta 0.5."""
    jdiff, pdiff = _diffusions("eps", "fixed_large", "mse")
    model = ModelFn(False)
    rng = jax.random.PRNGKey(7)
    kw = {"eta": 0.5} if loop == "ddim_sample_loop" else {}
    j = getattr(jdiff, loop)(model.jax, SHAPE, rng, **kw)
    rng, init_rng = jax.random.split(rng)
    start = np.asarray(jax.random.normal(init_rng, SHAPE))
    steps = [torch.from_numpy(np.asarray(jax.random.normal(r, SHAPE, jnp.float32)))
             for r in jax.random.split(rng, T)]
    p = getattr(pdiff, loop)(model.torch, SHAPE, noise=torch.from_numpy(start),
                             step_noise=steps, **kw)
    close(p, j, 1e-4)  # 20 steps of float32
    # the port's own draws: a generator makes the same sample twice
    g = [torch.Generator().manual_seed(1) for _ in range(2)]
    a, b = (getattr(pdiff, loop)(model.torch, SHAPE, generator=x, **kw) for x in g)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


# ------------------------------------------------------------- SpacedDiffusion


@pytest.mark.parametrize("respacing", ["ddim5", "ldm_ddim4", "3,2"])
def test_spaced_diffusion_equals_jax(respacing):
    """The respaced betas and map, and p's mean through the map: the model
    sees the original timesteps, as in JAX."""
    betas = jd.get_named_beta_schedule("cosine", T)
    use = jd.space_timesteps(T, respacing)
    jdiff = jd.SpacedDiffusion(use, betas, var_type="fixed_large")
    pdiff = pd.SpacedDiffusion(use, betas, var_type="fixed_large")
    assert np.array_equal(pdiff.timestep_map, jdiff.timestep_map)
    assert np.array_equal(pdiff.betas, jdiff.betas) and pdiff.original_num_steps == T
    n = pdiff.num_timesteps
    x0, xt, noise, _ = inputs()
    t_np = np.asarray([0, n // 2, n - 1], np.int32)
    (jxt, jt), (pxt, pt) = pair(t_np, xt)
    jm, pm = ModelFn(False), ModelFn(False)
    close(pdiff.p_mean_variance(pm.torch, pxt, pt)["mean"],
          jdiff.p_mean_variance(jm.jax, jxt, jt)["mean"])
    assert np.array_equal(pm.seen[0], jdiff.timestep_map[t_np])
    assert np.array_equal(jm.seen[0], jdiff.timestep_map[t_np])


def test_spaced_kl_maps_each_timestep_once():
    """The kl loss wraps the model and re-enters ``p_mean_variance``
    through the bound: the guard keeps t from being mapped twice, in both
    packages, and the losses agree."""
    kw = dict(steps=T, noise_schedule="cosine", use_kl=True, timestep_respacing="ddim5")
    jdiff, pdiff = jd.create_gaussian_diffusion(**kw), pd.create_gaussian_diffusion(**kw)
    x0, _, noise, _ = inputs()
    t_np = np.asarray([0, 2, 4], np.int32)
    (jx0, jn, jt), (px0, pn, pt) = pair(t_np, x0, noise)
    jm, pm = ModelFn(False), ModelFn(False)
    close(pdiff.training_losses(pm.torch, px0, pt, noise=pn)["loss"],
          jdiff.training_losses(jm.jax, jx0, jt, None, noise=jn)["loss"], 1e-4)
    want = jdiff.timestep_map[t_np]
    assert len(pm.seen) == 1 and np.array_equal(pm.seen[0], want)
    assert len(jm.seen) == 1 and np.array_equal(jm.seen[0], want)


def test_spaced_timestep_out_of_range_raises():
    """An index outside the respaced process raises in the port; JAX's
    ``jnp.take`` returns something for it without a word."""
    pdiff = pd.create_gaussian_diffusion(steps=T, timestep_respacing="ddim5")
    jdiff = jd.create_gaussian_diffusion(steps=T, timestep_respacing="ddim5")
    x = np.zeros((1, *SHAPE[1:]), np.float32)
    jm, pm = ModelFn(False), ModelFn(False)
    jdiff._wrap(jm.jax)(jnp.asarray(x), jnp.asarray([7]))  # 7 of 5 steps: no error
    with pytest.raises(IndexError, match="outside"):
        pdiff._wrap(pm.torch)(torch.from_numpy(x), torch.tensor([7]))
    with pytest.raises(IndexError, match="outside"):
        pdiff._wrap(pm.torch)(torch.from_numpy(x), torch.tensor([-1]))
    assert pm.seen == []


FLAGS = [{}, dict(learn_sigma=True), dict(learn_sigma=True, sigma_small=True),
         dict(sigma_small=True), dict(use_kl=True), dict(predict_xstart=True),
         dict(learn_sigma=True, rescale_learned_sigmas=True),
         dict(noise_schedule="cosine", timestep_respacing="ddim4", rescale_timesteps=True),
         dict(noise_schedule="ldm_linear", timestep_respacing=[3, 2])]


@pytest.mark.parametrize("flags", FLAGS, ids=range(len(FLAGS)))
def test_create_gaussian_diffusion_flags_equal_jax(flags):
    jdiff = jd.create_gaussian_diffusion(steps=T, **flags)
    pdiff = pd.create_gaussian_diffusion(steps=T, **flags)
    assert (pdiff.mean_type, pdiff.var_type, pdiff.loss_type) == (
        jdiff.mean_type, jdiff.var_type, jdiff.loss_type)
    assert np.array_equal(pdiff.timestep_map, jdiff.timestep_map)
    assert np.array_equal(pdiff.betas, jdiff.betas)


def test_unknown_types_raise():
    betas = pd.get_named_beta_schedule("linear", T)
    for kw in (dict(mean_type="v"), dict(var_type="fixed"), dict(loss_type="l1")):
        with pytest.raises(ValueError):
            pd.GaussianDiffusion(betas, **kw)
    with pytest.raises(ValueError):
        pd.GaussianDiffusion(np.zeros(3))


# ------------------------------------------------------------- resampling


def test_loss_second_moment_resampler_equals_jax():
    """``update_state`` over batches with repeated timesteps (consecutive
    slots, in batch order) and ``weights`` before and after every timestep
    has its full history, against JAX; ``sample``'s importance weights are
    1 / (T p[t]) of those weights."""
    T_small, K = 6, 3
    diff = pd.GaussianDiffusion(pd.get_named_beta_schedule("cosine", T_small))
    jdiff = jd.GaussianDiffusion(betas=jd.get_named_beta_schedule("cosine", T_small))
    ps = pd.LossSecondMomentResampler(diff, history_per_term=K)
    js = jd.LossSecondMomentResampler(jdiff, history_per_term=K)
    pstate, jstate = ps.init_state(), js.init_state()
    rng = np.random.RandomState(0)
    assert np.array_equal(ps.weights(pstate).numpy(), np.asarray(js.weights(jstate)))
    for i in range(8):
        ts = rng.randint(0, T_small, 5).astype(np.int32)
        ts[1] = ts[0]  # a repeat inside the batch
        losses = rng.rand(5).astype(np.float32)
        pstate = ps.update_state(pstate, torch.from_numpy(ts.astype(np.int64)),
                                 torch.from_numpy(losses))
        jstate = js.update_state(jstate, jnp.asarray(ts), jnp.asarray(losses))
        assert np.array_equal(pstate["history"].numpy(), np.asarray(jstate["history"]))
        assert np.array_equal(pstate["counts"].numpy(), np.asarray(jstate["counts"]))
        close(ps.weights(pstate), js.weights(jstate), 1e-6)
    assert bool((pstate["counts"] >= K).all())  # warmed: not uniform any more
    w = np.asarray(js.weights(jstate))
    assert not np.allclose(w, 1 / T_small)
    idx, weights = ps.sample(torch.Generator().manual_seed(0), 64, pstate)
    p = w / w.sum()
    assert idx.dtype == torch.int64 and int(idx.min()) >= 0 and int(idx.max()) < T_small
    np.testing.assert_allclose(weights.numpy(), 1 / (T_small * p[idx.numpy()]), rtol=1e-5)


def test_uniform_sampler_and_names():
    diff = pd.GaussianDiffusion(pd.get_named_beta_schedule("linear", T))
    s = pd.create_named_schedule_sampler("uniform", diff)
    idx, weights = s.sample(torch.Generator().manual_seed(0), 16)
    assert idx.shape == (16,) and torch.equal(weights, torch.ones(16))
    assert isinstance(pd.create_named_schedule_sampler("loss-second-moment", diff),
                      pd.LossSecondMomentResampler)
    with pytest.raises(NotImplementedError):
        pd.create_named_schedule_sampler("loss-first-moment", diff)
    with pytest.raises(NotImplementedError):
        jd.create_named_schedule_sampler("loss-first-moment", diff)


def test_exports_equal_jax():
    assert pd.__all__ == jd.__all__


# ------------------------------------------------------------- LatentDiffusion


def test_tiny_latent_diffusion_equals_stored_jax_run():
    """TINY ``LatentDiffusion`` (widths 32, 32, 64 x 2; 3 DDIM steps, 8x8
    latents) from the reference-layout weights through the port's
    converter, on the stored tokens and starting latent: both embeddings,
    each step's guided eps and latent and the decoded image before the
    clip within ``tests/test_torch_ldm.py``'s tolerances of the JAX run;
    ``forward_test`` is that image clipped, [1, 3, 64, 64] in [0, 1]."""
    from tests.test_torch_ldm import ldm_parity

    errors, captures, model = ldm_parity("tiny", "cpu")
    assert sorted(errors) == sorted(["cond", "uncond", "image"] + [
        f"{k}_{i}" for k in ("eps", "latent") for i in range(3)])
    missed = {k: v for k, v in errors.items() if not v[0] <= v[1]}
    assert not missed, missed
    from tests.test_torch_ldm import REFERENCE

    ref = np.load(REFERENCE)
    img = model.forward_test(torch.from_numpy(ref["tiny/tokens"]),
                             noise=torch.from_numpy(ref["tiny/noise"]))
    assert img.shape == (1, 3, 64, 64)
    assert torch.equal(img, ((torch.from_numpy(captures["image"]) + 1) / 2).clamp(0, 1))


def test_latent_diffusion_loads_the_jax_tree():
    """A flax tree of the JAX ``LatentDiffusion``'s scopes goes in through
    ``load_flax_params``: JAX's converter's tree equals the port's own
    install tensor for tensor; the JAX module's init makes no VAE encoder
    (its sampler never encodes), so a tree from it leaves exactly the
    encoder and ``quant_conv`` unfilled; an install missing a tower raises."""
    import odise_tpu.model_zoo.convert as jconv

    from odise_torch.model_zoo.convert import install_ldm_weights
    from odise_torch.model_zoo.from_jax import load_flax_params, load_flax_subtree
    from odise_torch.models.sd.ldm import build_latent_diffusion
    from tests.test_torch_ldm import TEXT_PREFIX, ldm_inputs

    state, _ = ldm_inputs("tiny")
    text = {k[len(TEXT_PREFIX):]: v for k, v in state.items() if k.startswith(TEXT_PREFIX)}
    tree = {"vae": jconv.convert_sd_vae(state), "unet": jconv.convert_sd_unet(state),
            "text_encoder": jconv.convert_clip_text(text, layers=2)}
    a, b = (build_latent_diffusion("tiny", device="cpu") for _ in range(2))
    load_flax_params(a, {"params": tree})
    install_ldm_weights(b, dict(state))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    no_encoder = dict(tree, vae={k: v for k, v in tree["vae"].items()
                                 if k not in ("encoder", "quant_conv")})
    unfilled = load_flax_subtree(build_latent_diffusion("tiny", device="cpu"), no_encoder)
    assert unfilled and all(n.startswith(("vae.encoder.", "vae.quant_conv.")) for n in unfilled)
    with pytest.raises(KeyError, match="text_encoder"):
        install_ldm_weights(b, {k: v for k, v in state.items()
                                if not k.startswith(TEXT_PREFIX)})


def test_latent_clipping_quirk():
    """Reference-side quirk kept as it is (ROADMAP C30): each DDIM step of
    ``forward_test`` clips the predicted x_0 to [-1, 1] in latent space,
    where SD's scaled latents spread like a unit normal. On a latent of
    spread 3 with a model predicting eps = 0, the step's x_0 is x_t /
    sqrt(alpha_bar) clipped to [-1, 1], in both packages, and differs from
    the unclipped step; ``LatentDiffusion.sample`` takes the clipped one."""
    from odise_torch.models.sd.ldm import LatentDiffusion

    betas = jd.get_named_beta_schedule("ldm_linear", 1000)
    use = jd.space_timesteps(1000, "ldm_ddim2")
    jdiff, pdiff = jd.SpacedDiffusion(use, betas), pd.SpacedDiffusion(use, betas)
    x = 3 * np.random.RandomState(0).randn(1, 4, 8, 8).astype(np.float32)
    t = np.asarray([1], np.int32)
    (jx, jt), (px, pt) = pair(t, x)
    zero = {"jax": lambda x, t: jnp.zeros_like(x), "torch": lambda x, t: torch.zeros_like(x)}
    j = jdiff.ddim_sample(zero["jax"], jx, jt, clip_denoised=True)
    p = pdiff.ddim_sample(zero["torch"], px, pt, clip_denoised=True)
    close(p["pred_xstart"], j["pred_xstart"])
    close(p["sample"], j["sample"])
    acp = pdiff.alphas_cumprod[1]
    np.testing.assert_allclose(p["pred_xstart"].numpy(),
                               np.clip(x / np.sqrt(acp), -1, 1), rtol=1e-5, atol=1e-6)
    assert float(p["pred_xstart"].abs().max()) == 1.0
    free = pdiff.ddim_sample(zero["torch"], px, pt, clip_denoised=False)
    assert float((free["sample"] - p["sample"]).abs().max()) > 1.0

    model = LatentDiffusion(model_channels=32, vae_ch=32, context_dim=64, sd_text_layers=2,
                            ddim_steps=2)
    calls = []
    ddim = model.diffusion.ddim_sample
    model.diffusion.ddim_sample = lambda *a, **k: calls.append(k) or ddim(*a, **k)
    model.sample(torch.zeros((1, 77), dtype=torch.long), noise=torch.from_numpy(x))
    assert [c.get("clip_denoised") for c in calls] == [True, True]
