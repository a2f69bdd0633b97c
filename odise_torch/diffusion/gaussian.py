"""Gaussian diffusion (counterpart of ``odise_tpu/diffusion/gaussian.py``):
DDPM's forward and reverse processes, DDIM sampling, the variational
bound, the training losses, and the respaced process.

The schedule's constants are float64 numpy arrays, gathered as float32 at
each call, as the JAX package's ``_extract`` gathers them. Tensors are
laid out with their channels on axis 1 where it matters (a learned
variance is split off there, as in the JAX package). Noise comes from an
explicit ``torch.Generator`` on the tensors' device, or is passed in.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .schedules import get_named_beta_schedule, space_timesteps

__all__ = ["GaussianDiffusion", "SpacedDiffusion", "create_gaussian_diffusion",
           "normal_kl", "approx_standard_normal_cdf", "discretized_gaussian_log_likelihood"]

MEAN_TYPES = ("eps", "xstart", "prev_x")
VAR_TYPES = ("fixed_small", "fixed_large", "learned", "learned_range")
LOSS_TYPES = ("mse", "rescaled_mse", "kl", "rescaled_kl")


def _extract(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] in float32, shaped to broadcast against a tensor of ``ndim``
    dimensions."""
    out = torch.as_tensor(arr, dtype=torch.float32, device=t.device)[t]
    return out.reshape(t.shape + (1,) * (ndim - t.dim()))


def _randn(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two diagonal Gaussians (nats per element)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of images in [-1, 1] discretized to 256 bins (DDPM)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


class GaussianDiffusion:
    """The diffusion process of a beta schedule.

    ``mean_type`` in {"eps", "xstart", "prev_x"}: what the model predicts;
    ``var_type`` in {"fixed_small", "fixed_large", "learned",
    "learned_range"}; ``loss_type`` in {"mse", "rescaled_mse", "kl",
    "rescaled_kl"}. A model is called as ``model(x, t, **model_kwargs)``.
    """

    def __init__(self, betas, mean_type: str = "eps", var_type: str = "fixed_small",
                 loss_type: str = "mse"):
        for name, value, allowed in (("mean_type", mean_type, MEAN_TYPES),
                                     ("var_type", var_type, VAR_TYPES),
                                     ("loss_type", loss_type, LOSS_TYPES)):
            if value not in allowed:
                raise ValueError(f"{name} {value!r} is not one of {allowed}")
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-d array in (0, 1]")
        self.betas = betas
        self.mean_type, self.var_type, self.loss_type = mean_type, var_type, loss_type
        self.num_timesteps = int(betas.shape[0])

        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        self.alphas_cumprod = acp
        self.alphas_cumprod_prev = acp_prev
        self.alphas_cumprod_next = np.append(acp[1:], 0.0)
        self.sqrt_alphas_cumprod = np.sqrt(acp)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - acp)
        self.log_one_minus_alphas_cumprod = np.log(1.0 - acp)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / acp)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / acp - 1.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        self.posterior_variance = post_var
        self.posterior_log_variance_clipped = np.log(np.append(post_var[1], post_var[1:]))
        self.posterior_mean_coef1 = betas * np.sqrt(acp_prev) / (1.0 - acp)
        self.posterior_mean_coef2 = (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)

    # ------------------------------------------------------------ q(x_t | x_0)

    def q_mean_variance(self, x_start, t):
        n = x_start.dim()
        mean = _extract(self.sqrt_alphas_cumprod, t, n) * x_start
        variance = _extract(1.0 - self.alphas_cumprod, t, n)
        log_variance = _extract(self.log_one_minus_alphas_cumprod, t, n)
        return mean, variance, log_variance

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Diffuse x_start to timestep t (float32 coefficients)."""
        n = x_start.dim()
        return (_extract(self.sqrt_alphas_cumprod, t, n) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t, n) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        n = x_t.dim()
        mean = (_extract(self.posterior_mean_coef1, t, n) * x_start
                + _extract(self.posterior_mean_coef2, t, n) * x_t)
        var = _extract(self.posterior_variance, t, n)
        log_var = _extract(self.posterior_log_variance_clipped, t, n)
        return mean, var, log_var

    # ------------------------------------------------------------ conversions

    def _predict_xstart_from_eps(self, x_t, t, eps):
        n = x_t.dim()
        return (_extract(self.sqrt_recip_alphas_cumprod, t, n) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, n) * eps)

    def _predict_eps_from_xstart(self, x_t, t, xstart):
        n = x_t.dim()
        return ((_extract(self.sqrt_recip_alphas_cumprod, t, n) * x_t - xstart)
                / _extract(self.sqrt_recipm1_alphas_cumprod, t, n))

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        n = x_t.dim()
        c1 = _extract(1.0 / self.posterior_mean_coef1, t, n)
        c2 = _extract(self.posterior_mean_coef2 / self.posterior_mean_coef1, t, n)
        return c1 * xprev - c2 * x_t

    # ------------------------------------------------------------ p(x_{t-1} | x_t)

    def p_mean_variance(self, model: Callable, x, t, clip_denoised: bool = True,
                        denoised_fn: Optional[Callable] = None,
                        model_kwargs: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """The model's mean, variance, log-variance and predicted x_0 at
        (x, t). ``clip_denoised`` clips the predicted x_0 to [-1, 1]."""
        model_output = model(x, t, **(model_kwargs or {}))
        n = x.dim()
        if self.var_type in ("learned", "learned_range"):
            model_output, model_var_values = torch.chunk(model_output, 2, dim=1)
            if self.var_type == "learned":
                model_log_variance = model_var_values
            else:
                min_log = _extract(self.posterior_log_variance_clipped, t, n)
                max_log = _extract(np.log(self.betas), t, n)
                frac = (model_var_values + 1.0) / 2.0
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            if self.var_type == "fixed_large":
                var = np.append(self.posterior_variance[1], self.betas[1:])
                logvar = np.log(var)
            else:
                var, logvar = self.posterior_variance, self.posterior_log_variance_clipped
            model_variance = _extract(var, t, n)
            model_log_variance = _extract(logvar, t, n)

        def process_xstart(xs):
            if denoised_fn is not None:
                xs = denoised_fn(xs)
            return xs.clamp(-1.0, 1.0) if clip_denoised else xs

        if self.mean_type == "prev_x":
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        else:
            if self.mean_type == "xstart":
                pred_xstart = process_xstart(model_output)
            else:
                pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    @staticmethod
    def _nonzero_mask(t, x):
        return (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))

    def p_sample(self, model, x, t, generator: Optional[torch.Generator] = None,
                 clip_denoised: bool = True, denoised_fn=None, model_kwargs=None,
                 noise: Optional[torch.Tensor] = None):
        """One ancestral step x_t -> x_{t-1}; ``noise`` is drawn from
        ``generator`` unless given."""
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        if noise is None:
            noise = _randn(x.shape, x, generator)
        sample = (out["mean"] + self._nonzero_mask(t, x)
                  * torch.exp(0.5 * out["log_variance"]) * noise)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def _loop(self, step, shape, generator, noise, step_noise):
        img = noise if noise is not None else torch.randn(
            shape, generator=generator,
            device=None if generator is None else generator.device)
        for i, t_scalar in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=img.device)
            img = step(img, t, None if step_noise is None else step_noise[i])["sample"]
        return img

    def p_sample_loop(self, model, shape, generator: Optional[torch.Generator] = None,
                      noise=None, clip_denoised: bool = True, denoised_fn=None,
                      model_kwargs=None, step_noise: Optional[Sequence[torch.Tensor]] = None):
        """Ancestral sampling over every timestep, from ``noise`` (drawn
        from ``generator``, on its device, unless given); ``step_noise[i]``
        is the i-th step's noise (drawn unless given)."""
        return self._loop(
            lambda img, t, n: self.p_sample(model, img, t, generator, clip_denoised,
                                            denoised_fn, model_kwargs, noise=n),
            shape, generator, noise, step_noise)

    # ------------------------------------------------------------ DDIM

    def ddim_sample(self, model, x, t, generator: Optional[torch.Generator] = None,
                    clip_denoised: bool = True, denoised_fn=None, model_kwargs=None,
                    eta: float = 0.0, noise: Optional[torch.Tensor] = None):
        """One DDIM step x_t -> x_{t-1}; with ``eta`` > 0 it adds noise of
        scale sigma (drawn from ``generator`` unless given)."""
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        n = x.dim()
        alpha_bar = _extract(self.alphas_cumprod, t, n)
        alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, n)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                  + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        if eta > 0:
            if noise is None:
                noise = _randn(x.shape, x, generator)
            sample = sample + self._nonzero_mask(t, x) * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model, x, t, clip_denoised: bool = True,
                            denoised_fn=None, model_kwargs=None):
        """Deterministic DDIM encoding x_t -> x_{t+1}."""
        out = self.p_mean_variance(model, x, t, clip_denoised, denoised_fn, model_kwargs)
        n = x.dim()
        eps = ((_extract(self.sqrt_recip_alphas_cumprod, t, n) * x - out["pred_xstart"])
               / _extract(self.sqrt_recipm1_alphas_cumprod, t, n))
        alpha_bar_next = _extract(self.alphas_cumprod_next, t, n)
        sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                  + torch.sqrt(1 - alpha_bar_next) * eps)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(self, model, shape, generator: Optional[torch.Generator] = None,
                         noise=None, clip_denoised: bool = True, denoised_fn=None,
                         model_kwargs=None, eta: float = 0.0,
                         step_noise: Optional[Sequence[torch.Tensor]] = None):
        """DDIM sampling over every timestep (noise as ``p_sample_loop``)."""
        return self._loop(
            lambda img, t, n: self.ddim_sample(model, img, t, generator, clip_denoised,
                                               denoised_fn, model_kwargs, eta, noise=n),
            shape, generator, noise, step_noise)

    # ------------------------------------------------------------ losses

    def _vb_terms_bpd(self, model, x_start, x_t, t, clip_denoised: bool = True,
                      model_kwargs=None):
        """The variational bound's term at t in bits per dimension: the KL
        to the true posterior, or at t = 0 the decoder's NLL."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model, x_t, t, clip_denoised, None, model_kwargs)
        kl = _batch_mean(normal_kl(true_mean, true_log_var, out["mean"],
                                   out["log_variance"])) / math.log(2.0)
        decoder_nll = _batch_mean(-discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])) / math.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl),
                "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model, x_start, t, generator: Optional[torch.Generator] = None,
                        model_kwargs=None, noise=None) -> Dict[str, torch.Tensor]:
        """Per-sample losses at timesteps t: "loss", and "mse" and "vb"
        where the loss type has them. With a learned variance the bound
        trains only the variance: the mean's prediction is detached."""
        model_kwargs = model_kwargs or {}
        if noise is None:
            noise = _randn(x_start.shape, x_start, generator)
        x_t = self.q_sample(x_start, t, noise)
        terms: Dict[str, torch.Tensor] = {}
        if self.loss_type in ("kl", "rescaled_kl"):
            terms["loss"] = self._vb_terms_bpd(model, x_start, x_t, t, False,
                                               model_kwargs)["output"]
            if self.loss_type == "rescaled_kl":
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model(x_t, t, **model_kwargs)
        if self.var_type in ("learned", "learned_range"):
            model_output, model_var_values = torch.chunk(model_output, 2, dim=1)
            frozen_out = torch.cat([model_output.detach(), model_var_values], dim=1)
            terms["vb"] = self._vb_terms_bpd(lambda *_a, **_k: frozen_out, x_start, x_t, t,
                                             False, model_kwargs)["output"]
            if self.loss_type == "rescaled_mse":
                terms["vb"] = terms["vb"] * self.num_timesteps / 1000.0
        if self.mean_type == "prev_x":
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        else:
            target = x_start if self.mean_type == "xstart" else noise
        terms["mse"] = _batch_mean((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms


class _SpacedModel:
    """A model whose timesteps are mapped to the original process's
    (``SpacedDiffusion._wrap``); an index outside the map raises."""

    def __init__(self, model: Callable, timestep_map: np.ndarray):
        self.model, self.timestep_map = model, timestep_map

    def __call__(self, x, t, **kw):
        n = len(self.timestep_map)
        if t.numel() and not (0 <= int(t.min()) and int(t.max()) < n):
            raise IndexError(f"timesteps {t.tolist()} outside the respaced process's {n}")
        mapped = torch.as_tensor(self.timestep_map, device=t.device)[t]
        return self.model(x, mapped, **kw)


class SpacedDiffusion(GaussianDiffusion):
    """The process over a subset of a base process's timesteps: the betas
    are recomputed so that consecutive kept steps keep their cumulative
    alphas, and the model sees the original timesteps."""

    def __init__(self, use_timesteps, betas, **kwargs):
        use = {int(t) for t in use_timesteps}
        base = GaussianDiffusion(betas=np.asarray(betas), **kwargs)
        last_alpha_cumprod = 1.0
        new_betas, timestep_map = [], []
        for i, alpha_cumprod in enumerate(base.alphas_cumprod):
            if i in use:
                new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
                last_alpha_cumprod = alpha_cumprod
                timestep_map.append(i)
        self.timestep_map = np.asarray(timestep_map, dtype=np.int64)
        self.original_num_steps = len(betas)
        super().__init__(betas=np.asarray(new_betas), **kwargs)

    def _wrap(self, model):
        # the kl loss wraps the model, then _vb_terms_bpd calls
        # p_mean_variance, which would map t a second time
        return model if isinstance(model, _SpacedModel) else _SpacedModel(
            model, self.timestep_map)

    def p_mean_variance(self, model, *args, **kwargs):
        return super().p_mean_variance(self._wrap(model), *args, **kwargs)

    def training_losses(self, model, *args, **kwargs):
        return super().training_losses(self._wrap(model), *args, **kwargs)


def create_gaussian_diffusion(*, steps: int = 1000, learn_sigma: bool = False,
                              sigma_small: bool = False, noise_schedule: str = "linear",
                              use_kl: bool = False, predict_xstart: bool = False,
                              rescale_timesteps: bool = False,
                              rescale_learned_sigmas: bool = False,
                              timestep_respacing="") -> SpacedDiffusion:
    """The reference's flags to a ``SpacedDiffusion``;
    ``rescale_timesteps`` is read by nothing, as in the JAX package."""
    del rescale_timesteps
    if use_kl:
        loss_type = "rescaled_kl"
    elif rescale_learned_sigmas:
        loss_type = "rescaled_mse"
    else:
        loss_type = "mse"
    if learn_sigma:
        var_type = "learned" if sigma_small else "learned_range"
    else:
        var_type = "fixed_small" if sigma_small else "fixed_large"
    return SpacedDiffusion(
        use_timesteps=space_timesteps(steps, timestep_respacing or [steps]),
        betas=get_named_beta_schedule(noise_schedule, steps),
        mean_type="xstart" if predict_xstart else "eps", var_type=var_type,
        loss_type=loss_type)
