"""AdamW with the JAX package's weight-decay rule, its step schedule and
optax's global-norm clip (counterpart of ``odise_tpu/engine/optimizer.py``).

The update is optax's ``chain(clip_by_global_norm, adamw)`` in optax's
order of operations: the moments, their bias corrections from the update
count, ``mu_hat / (sqrt(nu_hat) + eps)``, plus ``weight_decay * param``
where the rule allows decay, times the learning rate of the step counted
from 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple, Union

import torch

__all__ = ["AdamW", "clip_by_global_norm_", "decays", "global_norm",
           "make_optimizer", "multistep_lr"]


def decays(name: str, param: torch.Tensor) -> bool:
    """Whether weight decay applies to a parameter: 2-D and larger kernels,
    not norms, biases or embeddings. ``name`` is the port's parameter name,
    whose last part stands for the flax leaf (``weight`` is a kernel, a
    norm's ``scale`` or an ``embedding``; a raw parameter keeps its name).
    A 2-D ``weight`` is taken for a kernel: the trainable set holds no
    embedding table."""
    if param.dim() < 2:
        return False
    leaf = name.rsplit(".", 1)[-1]
    return not any(s in leaf for s in ("bias", "scale", "embedding"))


def multistep_lr(base_lr: float, milestones: Sequence[int] = (), gamma: float = 0.1,
                 warmup_steps: int = 0, warmup_factor: float = 1e-3
                 ) -> Callable[[int], float]:
    """lr * gamma^(milestones passed), with a linear warmup from
    ``warmup_factor``; ``step`` counts completed updates from 0."""

    def schedule(step: int) -> float:
        mult = 1.0
        for m in milestones:
            mult *= gamma if step >= m else 1.0
        warm = 1.0
        if warmup_steps > 0:
            alpha = min(max(step / warmup_steps, 0.0), 1.0)
            warm = warmup_factor * (1 - alpha) + alpha
        return base_lr * mult * warm

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's ``clip_by_global_norm``, in place: the gradients are kept
    where ``norm < max_norm``, else scaled by ``max_norm / norm`` as
    ``(g / norm) * max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


class AdamW(torch.optim.Optimizer):
    """optax's ``adamw`` over ``p.grad``. Each param group carries
    ``weight_decay``; ``lr`` is a number or a schedule of the update count.
    One count serves every parameter, as optax keeps one, and it is part of
    the state: ``state_dict()`` carries it, so a resumed run goes on with
    the schedule and the bias corrections where the saved one stopped."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]] = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(betas=betas, eps=eps, weight_decay=weight_decay))
        self.schedule = lr if callable(lr) else (lambda step: lr)
        self.count = 0

    def state_dict(self) -> dict:
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        self.count = count

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        lr = float(self.schedule(self.count))
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
                mu, nu = state["mu"], state["nu"]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * g ** 2 + b2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p.float()
                p.copy_(p.float() + (-lr) * u)


def make_optimizer(named_params: Dict[str, torch.Tensor], *, lr: float = 1e-4,
                   weight_decay: float = 0.05, milestones: Sequence[int] = (),
                   gamma: float = 0.1, warmup_steps: int = 0,
                   warmup_factor: float = 1e-3) -> AdamW:
    """AdamW over the trainable parameters ``named_params`` (name ->
    parameter): decay on the kernels ``decays`` picks, the step schedule
    where milestones or a warmup are given. The global-norm clip belongs to
    the train step (``engine.train_loop``), which knows the norm."""
    schedule = (multistep_lr(lr, milestones, gamma, warmup_steps, warmup_factor)
                if (milestones or warmup_steps) else lr)
    decay = [p for n, p in named_params.items() if decays(n, p)]
    other = [p for n, p in named_params.items() if not decays(n, p)]
    groups = [g for g in (dict(params=decay, weight_decay=weight_decay),
                          dict(params=other, weight_decay=0.0)) if g["params"]]
    return AdamW(groups, lr=schedule)
