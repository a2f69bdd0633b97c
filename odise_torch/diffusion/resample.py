"""Importance sampling of diffusion timesteps (counterpart of
``odise_tpu/diffusion/resample.py``). The loss history of
``LossSecondMomentResampler`` is a dict of tensors that the caller holds
and passes, as the JAX package carries it in the train state.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["ScheduleSampler", "UniformSampler", "LossSecondMomentResampler",
           "create_named_schedule_sampler"]


class ScheduleSampler:
    """Draws timesteps for training and the importance weights that keep
    the loss unbiased."""

    num_timesteps: int

    def weights(self, state: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, generator: Optional[torch.Generator], batch_size: int,
               state: Optional[Dict[str, torch.Tensor]] = None):
        """(timesteps [batch_size] int64, weights [batch_size] float32):
        timesteps drawn from ``generator`` with probability p proportional
        to ``weights(state)``, weight 1 / (T p[t])."""
        w = self.weights(state)
        p = w / w.sum()
        indices = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return indices, 1.0 / (p.shape[0] * p[indices])


class UniformSampler(ScheduleSampler):
    def __init__(self, diffusion):
        self.num_timesteps = diffusion.num_timesteps

    def weights(self, state=None):
        return torch.ones((self.num_timesteps,), dtype=torch.float32)


class LossSecondMomentResampler(ScheduleSampler):
    """Weights proportional to sqrt(E[loss^2]) per timestep over the last
    ``history_per_term`` losses of each, mixed with ``uniform_prob`` of the
    uniform; uniform until every timestep has that many. The state is
    {"history": [T, K] float32, "counts": [T] int32}."""

    def __init__(self, diffusion, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.num_timesteps = diffusion.num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        return {"history": torch.zeros((self.num_timesteps, self.history_per_term),
                                       dtype=torch.float32, device=device),
                "counts": torch.zeros((self.num_timesteps,), dtype=torch.int32, device=device)}

    def weights(self, state=None):
        if state is None:
            return torch.ones((self.num_timesteps,), dtype=torch.float32)
        history = state["history"]
        uniform = torch.full((self.num_timesteps,), 1.0 / self.num_timesteps,
                             dtype=torch.float32, device=history.device)
        if not bool((state["counts"] >= self.history_per_term).all()):
            return uniform
        w = torch.sqrt((history ** 2).mean(dim=-1))
        w = w / w.sum().clamp(min=1e-12)
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps

    def update_state(self, state: Dict[str, torch.Tensor], ts: torch.Tensor,
                     losses: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A new state with the batch's losses written into each timestep's
        ring of the last ``history_per_term``, in batch order (a timestep
        drawn twice fills two consecutive slots)."""
        history, counts = state["history"].clone(), state["counts"].clone()
        for t, loss in zip(ts.tolist(), losses.to(history.dtype)):
            history[t, int(counts[t]) % self.history_per_term] = loss
            counts[t] += 1
        return {"history": history, "counts": counts}


def create_named_schedule_sampler(name: str, diffusion) -> ScheduleSampler:
    if name == "uniform":
        return UniformSampler(diffusion)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(diffusion)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
