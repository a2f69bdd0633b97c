"""Stable Diffusion's text-to-image sampling (``odise_torch.models.sd.ldm``)
against the JAX package's ``LatentDiffusion`` on the same weights: the
stored JAX side and the port-side run that is held to it, TINY on the CPU
(``tests/test_torch_diffusion.py``) and FULL on the card
(``chip_smoke.py`` phase 14 (b), ``tests/test_torch_cuda.py``).

The weights are SD v1.3 in the reference's layout, drawn from a seed as
``tests/test_torch_convert.py::reference_state_dicts`` draws them (at
FULL the same tensors as its ``sd`` dict), and go through each package's
own converter. One prompt, guidance 7.5, the starting latent drawn by
JAX's ``forward_test`` from ``PRNGKey(0)`` (stored, so that the port
starts from it); float32 on both sides.

The JAX side: this module run as a script,

    JAX_PLATFORMS=cpu python -m tests.test_torch_ldm [tiny] [full]

builds the JAX module, converts the weights, runs its ``embed_text``,
``apply_model_with_guidance``, the respaced process's ``ddim_sample`` and
``decode_from_latent`` (each jitted; the module's eager ``init`` runs the
whole sampling loop op by op, about a minute at TINY), checks at TINY that
they compose to its jitted ``forward_test``, and writes
``tests/data/torch_ldm_reference.npz``: the tokens, the starting latent,
the guided eps and the latent after each step, summaries (shape, sum,
sum |x|, max |x|, a strided sample) of both embeddings and of the decoded
image before the clip, the sha256 of every input and the jax, flax and
numpy versions, checked on load. TINY: widths 32 (UNet), 32 (VAE), 64 x 2
(text), 3 DDIM steps, 8x8 latents (64-px image). FULL: SD v1.3's widths,
2 DDIM steps, 64x64 latents (512-px image); some 4 minutes and 14 GB on
an 8-core CPU.
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odise_torch.models.sd.ldm import SCALES  # noqa: E402
from tests.test_torch_convert import (  # noqa: E402
    _openai_text, _unet, _vae, fill, jax_versions, sd_spec, summarize)
from .torch_threads import one_thread  # noqa: F401,E402

REFERENCE = Path(__file__).with_name("data") / "torch_ldm_reference.npz"
PROMPT = "a photograph of an astronaut riding a horse"
GUIDANCE = 7.5
NOISE_SEED = 0
# the port's widths at each scale, and the run's DDIM steps and latent size
ARCH = {"tiny": dict(SCALES["tiny"], ddim_steps=3, latent=(8, 8)),
        "full": dict(SCALES["full"], ddim_steps=2, latent=(64, 64))}
TEXT_PREFIX = "cond_stage_model.transformer."
# the largest error over a stored array (its sample for a summary)
# relative to JAX's largest magnitude: the embeddings and the first step's
# eps 1e-4, everything after 1e-3, as FULL parity holds the towers
# (tests/test_torch_convert.py)
TOL_FIRST, TOL_AFTER = 1e-4, 1e-3
SUMMARIZED = ("cond", "uncond", "image")


def ldm_spec(scale: str) -> dict:
    """SD v1 (UNet, VAE, OpenAI-layout text encoder) at ``scale``'s widths
    in the reference's layout; at FULL, ``sd_spec("full")``."""
    a = ARCH[scale]
    sp: dict = {}
    _unet(sp, a["model_channels"], a["context_dim"])
    _vae(sp, a["vae_ch"])
    _openai_text(sp, TEXT_PREFIX, a["context_dim"], a["sd_text_layers"], a["context_dim"])
    return sp


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).data).hexdigest()


def ldm_inputs(scale: str):
    """(SD state, name -> sha256 of every input: the tensors, the tokens,
    the starting latent where the reference is stored)."""
    state, shas = fill(ldm_spec(scale))
    return state, {f"sd/{k}": v for k, v in shas.items()}


def tokens() -> np.ndarray:
    from odise_torch.models.clip.tokenizer import tokenize

    return tokenize([PROMPT]).astype(np.int64)


def tolerance(key: str) -> float:
    return TOL_FIRST if key in ("cond", "uncond", "eps_0") else TOL_AFTER


# ---------------------------------------------------------------------------
# the JAX side (imported lazily: the card's machine has no JAX)
# ---------------------------------------------------------------------------


def leaf_shapes(tree) -> dict:
    """'a/b/c' -> shape of every leaf of a flax tree."""
    import jax

    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_run(scale: str, state: dict) -> dict:
    """The JAX package's sampling of ``PROMPT`` at ``scale`` on ``state``
    (consumed), float32: arrays in the port's NCHW layout."""
    import jax
    import jax.numpy as jnp

    import odise_tpu.model_zoo.convert as jconv
    from odise_tpu.diffusion import SpacedDiffusion, get_named_beta_schedule, space_timesteps
    from odise_tpu.models.clip.tokenizer import tokenize as jtokenize
    from odise_tpu.models.sd.ldm import LatentDiffusion

    a = ARCH[scale]
    latent_hw = a["latent"]

    class Sized(LatentDiffusion):
        @property
        def latent_image_size(self):
            return latent_hw

    model = Sized(model_channels=a["model_channels"], vae_ch=a["vae_ch"],
                  context_dim=a["context_dim"], sd_text_layers=a["sd_text_layers"],
                  ddim_steps=a["ddim_steps"], guidance_scale=GUIDANCE)
    text = {k[len(TEXT_PREFIX):]: state.pop(k) for k in list(state)
            if k.startswith(TEXT_PREFIX)}
    params = {"text_encoder": jconv.convert_clip_text(text, layers=a["sd_text_layers"])}
    del text
    params["unet"] = jconv.convert_sd_unet(state)
    params["vae"] = jconv.convert_sd_vae(state)
    state.clear()
    tok = jnp.asarray(tokens().astype(np.int32))
    rng = jax.random.PRNGKey(NOISE_SEED)
    # the module's init makes no VAE encoder (forward_test never encodes);
    # the converter's tree holds it besides
    mine, theirs = (leaf_shapes(t) for t in (
        params, jax.eval_shape(lambda: model.init(rng, tok, rng))["params"]))
    assert all(mine.get(k) == v for k, v in theirs.items()), "the tree does not fit"
    assert all(k.startswith(("vae/encoder/", "vae/quant_conv/")) for k in set(mine) - set(theirs))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    del params

    def method(name):
        return jax.jit(lambda v, *args: model.apply(v, *args, method=getattr(Sized, name)))

    embed, guided, decode = (method("embed_text"), method("apply_model_with_guidance"),
                             method("decode_from_latent"))
    diffusion = SpacedDiffusion(
        use_timesteps=space_timesteps(1000, f"ldm_ddim{a['ddim_steps']}"),
        betas=get_named_beta_schedule("ldm_linear", 1000))
    # forward_test's own draw
    noise = jax.random.normal(jax.random.split(rng)[1], (1, *latent_hw, 4), jnp.float32)
    cond = embed(variables, tok)
    uncond = embed(variables, jnp.broadcast_to(jnp.asarray(jtokenize([""])), tok.shape))
    out = {"cond": cond, "uncond": uncond, "noise": noise}
    latent = noise
    for k, t_scalar in enumerate(range(diffusion.num_timesteps - 1, -1, -1)):
        seen = []

        def model_fn(x, t):
            seen.append(guided(variables, x, t, cond, uncond))
            return seen[-1]

        latent = diffusion.ddim_sample(model_fn, latent, jnp.full((1,), t_scalar, jnp.int32),
                                       clip_denoised=True)["sample"]
        out[f"eps_{k}"], out[f"latent_{k}"] = seen[0], latent
    out["image"] = decode(variables, latent)
    if scale == "tiny":  # the composition is the module's own sampler
        final = jax.jit(lambda v: model.apply(v, tok, rng))(variables)
        want = jnp.clip((out["image"] + 1.0) / 2.0, 0.0, 1.0)
        assert float(jnp.abs(final - want).max()) <= 1e-5, "forward_test differs"
    nchw = {k: np.asarray(v, np.float32) for k, v in out.items()}
    return {k: (v.transpose(0, 3, 1, 2) if v.ndim == 4 else v) for k, v in nchw.items()}


def write_reference(scales) -> None:
    """Run the JAX side at each of ``scales`` and write ``REFERENCE``,
    keeping the other scale's entries of an existing file."""
    out = {}
    if REFERENCE.exists():
        out = {k: v for k, v in np.load(REFERENCE).items()
               if k.split("/")[0] not in scales and k != "meta/versions"}
    out["meta/versions"] = np.asarray(jax_versions())
    for scale in scales:
        state, shas = ldm_inputs(scale)
        run = jax_run(scale, state)
        out[f"{scale}/tokens"] = tokens()
        shas["tokens"] = sha(tokens())
        shas["noise"] = sha(run["noise"])
        for key, value in run.items():
            if key in SUMMARIZED:
                for field, v in summarize(value).items():
                    out[f"{scale}/{key}/{field}"] = v
            else:
                out[f"{scale}/{key}"] = value
        for key, s in shas.items():
            out[f"{scale}/sha256/{key}"] = np.asarray(s)
        print(f"{scale}: {len(run)} arrays, {len(shas)} inputs")
    REFERENCE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(REFERENCE, **out)
    print(f"wrote {REFERENCE} ({REFERENCE.stat().st_size} bytes)")


# ---------------------------------------------------------------------------
# the port against the stored JAX side
# ---------------------------------------------------------------------------


def load_reference(scale: str, shas: dict) -> dict:
    """The stored JAX side at ``scale`` (keys without the scale), after
    checking that it was made from exactly ``shas``' tensors, these tokens
    and its own stored latent."""
    ref = {k[len(scale) + 1:]: v for k, v in np.load(REFERENCE).items()
           if k.startswith(scale + "/")}
    shas = dict(shas, tokens=sha(tokens()), noise=sha(ref["noise"]))
    stored = {k[len("sha256/"):]: str(v) for k, v in ref.items() if k.startswith("sha256/")}
    if stored != shas:
        bad = sorted(k for k in set(stored) | set(shas) if stored.get(k) != shas.get(k))
        raise AssertionError(f"{REFERENCE.name} [{scale}] was made from other inputs "
                             f"({len(bad)} differ, e.g. {bad[:3]}); rerun "
                             "python -m tests.test_torch_ldm")
    return ref


class Recorder:
    """Records, on a ``LatentDiffusion``, the embeddings, each step's
    guided eps and latent and the decoded image while ``sample`` runs."""

    def __init__(self, model):
        self.model, self.out = model, {}
        embed, guided = model.embed_text, model.apply_model_with_guidance
        ddim = model.diffusion.ddim_sample
        steps = []

        def embed_text(tok):
            e = embed(tok)
            self.out["uncond" if "cond" in self.out else "cond"] = e
            return e

        def apply_model_with_guidance(*args):
            eps = guided(*args)
            self.out[f"eps_{len(steps)}"] = eps
            return eps

        def ddim_sample(*args, **kw):
            latent = ddim(*args, **kw)
            self.out[f"latent_{len(steps)}"] = latent["sample"]
            steps.append(None)
            return latent

        model.embed_text = embed_text
        model.apply_model_with_guidance = apply_model_with_guidance
        model.diffusion.ddim_sample = ddim_sample

    def remove(self):
        for name in ("embed_text", "apply_model_with_guidance"):
            delattr(self.model, name)
        del self.model.diffusion.ddim_sample


def build_port(scale: str, state: dict, device, dtype=torch.float32):
    """The port's ``LatentDiffusion`` at ``scale`` with ``state``
    (consumed) installed through its converter."""
    from odise_torch.model_zoo.convert import install_ldm_weights
    from odise_torch.models.sd.ldm import build_latent_diffusion

    a = ARCH[scale]
    model = build_latent_diffusion(scale, device=device, dtype=dtype,
                                   ddim_steps=a["ddim_steps"], guidance_scale=GUIDANCE)
    model.latent_image_size = a["latent"]
    install_ldm_weights(model, state)
    state.clear()
    return model


def port_run(model, ref: dict) -> dict:
    """The port's ``sample`` from the stored tokens and latent, with every
    stage the reference stored, as float32 numpy."""
    device = next(model.parameters()).device
    rec = Recorder(model)
    try:
        image = model.sample(torch.from_numpy(ref["tokens"]).to(device),
                             noise=torch.from_numpy(ref["noise"]))
    finally:
        rec.remove()
    out = {k: v.float().cpu().numpy() for k, v in rec.out.items()}
    out["image"] = image.float().cpu().numpy()
    return out


def ldm_errors(captures: dict, ref: dict) -> dict:
    """key -> (largest error relative to JAX's largest magnitude,
    tolerance) for every stage the reference stored."""
    out = {}
    for key in captures:
        mine = captures[key]
        if key in SUMMARIZED:
            r = {f: ref[f"{key}/{f}"] for f in ("shape", "abs_max", "sample")}
            got = summarize(mine)
            if tuple(got["shape"]) != tuple(r["shape"]):
                raise AssertionError(f"{key}: shape {got['shape']}, JAX {r['shape']}")
            err = float(np.abs(got["sample"] - r["sample"]).max() / r["abs_max"])
        else:
            if mine.shape != ref[key].shape:
                raise AssertionError(f"{key}: shape {mine.shape}, JAX {ref[key].shape}")
            err = float(np.abs(mine - ref[key]).max() / np.abs(ref[key]).max())
        out[key] = (err, tolerance(key))
    return out


def ldm_parity(scale: str, device, made=None):
    """Build the port at ``scale`` on ``device`` from the generated SD
    state (``made``: ``ldm_inputs(scale)``'s result, consumed), run it
    from the stored inputs and return (key -> (error, tolerance), the
    captures, the model)."""
    state, shas = made if made is not None else ldm_inputs(scale)
    ref = load_reference(scale, shas)
    model = build_port(scale, state, device)
    captures = port_run(model, ref)
    return ldm_errors(captures, ref), captures, model


# ---------------------------------------------------------------------------
# tests of the reference file and the weights' way in
# ---------------------------------------------------------------------------


def test_full_spec_is_the_sd_checkpoint():
    """At FULL the generated LDM weights are ``reference_state_dicts``'s SD
    v1.3 state, tensor for tensor (same keys, shapes and draws)."""
    assert ldm_spec("full") == sd_spec("full")


def test_reference_file_names_its_inputs():
    """Both scales are stored, with the inputs' hashes, the JAX versions
    and every stage a check reads; TINY's hashes match what is drawn here."""
    ref = np.load(REFERENCE)
    assert "jax" in str(ref["meta/versions"])
    for scale, a in ARCH.items():
        for k in range(a["ddim_steps"]):
            assert ref[f"{scale}/eps_{k}"].shape == (1, 4, *a["latent"])
            assert ref[f"{scale}/latent_{k}"].shape == (1, 4, *a["latent"])
        assert tuple(ref[f"{scale}/image/shape"]) == (1, 3, 8 * a["latent"][0],
                                                       8 * a["latent"][1])
    load_reference("tiny", ldm_inputs("tiny")[1])


def test_full_key_set_fills_every_tower():
    """The FULL SD key set (zero-stride arrays: shapes without memory)
    fills every tensor of a FULL ``LatentDiffusion`` on the meta device
    through ``ldm_install``; without the text encoder's keys its tower is
    left unfilled, which ``install`` refuses (``test_torch_diffusion.py``
    installs at TINY)."""
    from tests.test_torch_convert import zero_stride

    from odise_torch.model_zoo.convert import ldm_install
    from odise_torch.model_zoo.from_jax import match_flax_tree
    from odise_torch.models.sd.ldm import LatentDiffusion

    with torch.device("meta"):
        model = LatentDiffusion()
    keys = zero_stride(ldm_spec("full"))
    what = ldm_install(model, keys)
    matched, unfilled = match_flax_tree(model, what.tree)
    assert unfilled == [] and what.towers == ("vae", "unet", "text_encoder")
    assert sum(int(np.prod(v.shape)) for _, v in matched) > 1_000_000_000
    no_text = {k: v for k, v in keys.items() if not k.startswith(TEXT_PREFIX)}
    what = ldm_install(model, no_text)
    _, unfilled = match_flax_tree(model, what.tree)
    assert "text_encoder" in what.towers and unfilled
    assert all(n.startswith("text_encoder.") for n in unfilled)


if __name__ == "__main__":
    write_reference(tuple(sys.argv[1:]) or ("tiny", "full"))
