"""AdamW in one pass with the NaN-step guard folded in (port of cinema_tpu/train/fused_optim.py,
``fused_adamw`` and its ``update_with_guard``).

The JAX package computes this update in plain ``jnp`` outside any Pallas
kernel, so plain torch is its port. Per parameter:

    g'  = where(ok, g * min(1, clip / ||g||), 0)      # clip + NaN sanitize
    mu' = mu + okf * (1 - b1) * (g'  - mu)
    nu' = nu + okf * (1 - b2) * (g'^2 - nu)
    p'  = p - okf * lr_t * scale_p * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)

``ok`` stays a tensor on the device and ``okf`` in {0, 1} makes the guarded
step exact: parameters, moments and count are left as they were, and the
host never reads a value back. Beyond the JAX package, a finite loss whose
gradient norm is not finite is guarded too: CineMA leaves a view with a
NaN loss out of its mean, but that view's backward still yields 0 * NaN. One global norm serves the clip and the
``grad_norm`` metric. The learning rate is taken at the count before the
increment (optax.scale_by_schedule) and the bias correction at the count
after it (optax.scale_by_adam); a guarded step does not advance the count.

Parameters and moments are updated in place. The tensors of one role go
through ``torch._foreach_*`` calls, a few launches for the whole model
instead of a few per parameter.

Gradient accumulation (``accum_steps`` k > 1) takes the place of
``optax.MultiSteps``: each call adds g / k of a finite micro-batch to an
f32 buffer, the k-th finite one applies the update above to the mean, and
a micro-batch with a non-finite loss is skipped whole.

Distributed runs (``parallel.mesh.Parallel``) pass the norm of the whole
gradient over the ranks (``global_norm``) and, under FSDP, the local shards
that a step updates (``params`` of :meth:`FusedAdamW.step`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch


@dataclass
class FusedAdamWState:
    """count: updates applied (int32 scalar); mu, nu: moments, one per parameter;
    acc, mini_step: the accumulated mean gradient and the micro-batches in it (accumulation only)."""

    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    acc: List[torch.Tensor] = field(default_factory=list)
    mini_step: Optional[torch.Tensor] = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu, "acc": self.acc, "mini_step": self.mini_step}

    def load_state_dict(self, state: dict) -> None:
        self.count.copy_(state["count"])
        for name in ("mu", "nu", "acc"):
            have, new = getattr(self, name), state[name]
            if len(have) != len(new):
                raise ValueError(f"Optimizer state {name} has {len(new)} tensors, expected {len(have)}.")
            for dst, src in zip(have, new):
                dst.copy_(src)
        if self.mini_step is not None:
            self.mini_step.copy_(state["mini_step"])


class FusedAdamW:
    """See the module docstring. ``params`` are updated in place by :meth:`step`."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        schedule: Callable[[torch.Tensor], torch.Tensor],
        b1: float = 0.9,
        b2: float = 0.95,
        eps: float = 1e-8,
        weight_decay: float = 0.05,
        wd_mask: Optional[Sequence[bool]] = None,
        clip_grad: Optional[float] = None,
        scales: Optional[Sequence[float]] = None,
        accum_steps: int = 1,
        global_norm: Optional[Callable[[Sequence[torch.Tensor]], torch.Tensor]] = None,
    ) -> None:
        """
        Args:
            params: the parameters, in a fixed order.
            schedule: count (tensor) -> learning rate (tensor).
            wd_mask: per parameter, whether weight decay applies (default: ndim > 1).
            clip_grad: global-norm clip (None or <= 0 disables).
            scales: per parameter LR scale (layer decay x freeze); 0 freezes.
            accum_steps: micro-batches per update.
            global_norm: gradients -> the norm of the whole gradient (default: of the tensors given).
        """
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_grad = clip_grad if clip_grad is not None and clip_grad > 0 else None
        self.accum_steps = int(accum_steps)
        self.global_norm = _global_norm if global_norm is None else global_norm
        wd_mask = [p.ndim > 1 for p in self.params] if wd_mask is None else list(wd_mask)
        scales = [1.0] * len(self.params) if scales is None else [float(s) for s in scales]
        # per parameter: the LR scale, and the decay the update adds to it
        self.scales = scales
        self.decays = [weight_decay if use and weight_decay else 0.0 for use in wd_mask]

    def init(self) -> FusedAdamWState:
        device = self.params[0].device
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in self.params]  # noqa: E731
        state = FusedAdamWState(count=torch.zeros((), dtype=torch.int32, device=device), mu=zeros(), nu=zeros())
        if self.accum_steps > 1:
            state.acc = zeros()
            state.mini_step = torch.zeros((), dtype=torch.int32, device=device)
        return state

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], state: FusedAdamWState, ok: torch.Tensor,
             params: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """One call per (micro-)batch: accumulate where configured, update with the guard.

        Args:
            grads: one gradient per parameter.
            ok: bool scalar tensor, False for a batch whose loss is not finite.
            params: the tensors to update, in the order of ``self.params`` (default: those).

        Returns:
            the global norm of ``grads`` (a tensor; not finite for a bad batch).
        """
        if self.accum_steps == 1:
            return self.update_with_guard(grads, state, ok, params)
        gnorm = self.global_norm(grads)
        ok = ok & torch.isfinite(gnorm)
        zero = torch.zeros((), device=ok.device)
        clean = [torch.where(ok, g.float(), zero) for g in grads]
        torch._foreach_add_(state.acc, clean, alpha=1.0 / self.accum_steps)
        apply = ok & (state.mini_step == self.accum_steps - 1)
        self.update_with_guard(state.acc, state, apply, params)
        torch._foreach_mul_(state.acc, 1.0 - apply.float())
        state.mini_step.copy_(torch.where(apply, 0, state.mini_step + ok.to(torch.int32)))
        return gnorm

    @torch.no_grad()
    def update_with_guard(
        self, grads: Sequence[torch.Tensor], state: FusedAdamWState, ok: torch.Tensor,
        params: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """The update of the module docstring, in place; returns the global gradient norm."""
        params = self.params if params is None else list(params)
        gnorm = self.global_norm(grads)
        ok = ok & torch.isfinite(gnorm)
        okf = ok.float()
        cscale = okf
        if self.clip_grad is not None:
            cscale = cscale * torch.clamp(self.clip_grad / torch.clamp(gnorm, min=1e-12), max=1.0)
        zero = torch.zeros((), device=ok.device)
        # where(ok, ...) sanitizes what 0 * NaN would keep, in the gradients and in the clip scale
        cscale = torch.where(ok, cscale, zero)
        gc = [torch.where(ok, g.float(), zero) for g in grads]
        torch._foreach_mul_(gc, cscale)

        lr_t = self.schedule(state.count).float()
        state.count.add_(ok.to(state.count.dtype))
        c = torch.clamp(state.count.float(), min=1.0)
        bc1 = 1.0 - self.b1**c
        bc2 = 1.0 - self.b2**c

        # mu += okf (1 - b1) (g - mu); nu += okf (1 - b2) (g^2 - nu)
        d_mu = torch._foreach_sub(gc, state.mu)
        torch._foreach_mul_(d_mu, okf * (1.0 - self.b1))
        torch._foreach_add_(state.mu, d_mu)
        torch._foreach_mul_(gc, gc)
        torch._foreach_sub_(gc, state.nu)
        torch._foreach_mul_(gc, okf * (1.0 - self.b2))
        torch._foreach_add_(state.nu, gc)

        # update = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, torch._foreach_mul(params, self.decays))
        torch._foreach_mul_(update, okf * lr_t)
        torch._foreach_mul_(update, self.scales)
        torch._foreach_sub_(params, update)
        return gnorm


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in float32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([g.float() for g in grads])))
