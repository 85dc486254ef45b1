"""Optimizer and LR schedule: SGD with poly decay, the reference recipe.

Counterpart of ``acr_wsss_tpu/utils/schedule.py`` (an optax chain), with
the same semantics on ``torch.optim.SGD``:

* lr(k) = base_lr * clip(1 - k / max_step, 0, 1) ** power, read at the
  pre-increment update count k (``:20-34``; reference
  ``tool/torchutils.py:22-26``);
* weight decay is added to the gradient before momentum
  (``optax.add_decayed_weights`` before ``optax.sgd``), which is torch
  SGD's ``weight_decay``; momentum 0 means none;
* ``reference_quirk`` swaps momentum and weight decay, as the reference's
  ``PolyOptimizer`` does by passing weight_decay into SGD's momentum slot
  (``:62-63``);
* global-norm clipping runs first (``optax.clip_by_global_norm``:
  g / norm * max_norm when norm >= max_norm);
* ``accum_steps`` > 1 averages the gradient over that many calls and
  updates on the last one (``optax.MultiSteps``, Welford mean); the poly
  schedule counts updates, not calls.

``state_dict`` / ``load_state_dict`` carry everything a resumed run needs:
SGD's momentum buffers and lr, the schedule's position, the counters and
the accumulation buffers of an accumulation in progress.

Under FSDP or a model axis the parameters are shards: clipping takes the
norm of the one-device model over all of them
(``parallel.sharding.global_norm``: a part cut over the model axis adds
its squares over the model ranks, a replicated parameter counts once),
``state_dict`` gives the momentum and accumulation buffers in the
one-device layout (``parallel.sharding.full_like``, a collective), and
``load_state_dict`` takes that layout and keeps this rank's share
(``parallel.sharding.shard_like``).
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from acr_wsss_tpu_torch.parallel.sharding import full_like, global_norm, shard_like


def poly_factor(step: int, max_step: int, power: float = 0.9) -> float:
    """clip(1 - step / max_step, 0, 1) ** power."""
    frac = min(max(1.0 - step / max_step, 0.0), 1.0)
    return frac ** power


class PolySGD:
    """SGD + poly decay + optional clipping and gradient accumulation.

    ``step()`` reads each parameter's ``.grad`` (one micro-batch), and
    returns True when it updated the parameters. Gradients are cleared
    after every call."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, max_step: int,
                 weight_decay: float = 5e-4, momentum: float = 0.9, power: float = 0.9,
                 reference_quirk: bool = False, clip_grad_norm: float = 0.0,
                 accum_steps: int = 1):
        if reference_quirk:
            momentum, weight_decay = weight_decay, 0.0
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        self.sgd = torch.optim.SGD(self.params, lr=lr, momentum=momentum,
                                   weight_decay=weight_decay)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.sgd, lambda k: poly_factor(k, max_step, power))
        self.clip_grad_norm = clip_grad_norm
        self.accum_steps = max(int(accum_steps), 1)
        self.mini_step = 0
        self.updates = 0
        self._acc: List[torch.Tensor] = []

    @property
    def lr(self) -> float:
        """The lr of the next update."""
        return self.sgd.param_groups[0]["lr"]

    @torch.no_grad()
    def step(self) -> bool:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.accum_steps > 1:
            if self.mini_step == 0:
                self._acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                self.zero_grad()
                return False
            self.mini_step = 0
            grads = self._acc
        if self.clip_grad_norm:
            norm = global_norm(grads, self.params)
            if norm >= self.clip_grad_norm:
                grads = [(g / norm) * self.clip_grad_norm for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.sgd.step()
        self.schedule.step()
        self.updates += 1
        self.zero_grad()
        return True

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """Restore it into a PolySGD built over the same parameters in the
        same order: SGD keys its state by parameter index. Tensors come in
        the one-device layout (a collective when parameters are sharded:
        every rank calls it)."""
        sgd = self.sgd.state_dict()
        sgd["state"] = {i: {k: full_like(v, self.params[i]) if isinstance(v, torch.Tensor)
                            else v for k, v in entry.items()}
                        for i, entry in sgd["state"].items()}
        return {"sgd": sgd, "schedule": self.schedule.state_dict(),
                "mini_step": self.mini_step, "updates": self.updates,
                "acc": ([full_like(a, p) for a, p in zip(self._acc, self.params)]
                        if self.mini_step else [])}

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(self._shard_state(state["sgd"]))
        self.schedule.load_state_dict(state["schedule"])
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])
        self._acc = [shard_like(a, p).to(p.device) for a, p in zip(state["acc"], self.params)]

    def _shard_state(self, sgd_state: dict) -> dict:
        """SGD's state with each full tensor cut to its parameter's
        placement (a no-op for plain parameters)."""
        per_param = {i: {k: shard_like(v, self.params[i]) if isinstance(v, torch.Tensor)
                         else v for k, v in entry.items()}
                     for i, entry in sgd_state["state"].items()}
        return {**sgd_state, "state": per_param}


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, max_step: int,
                   weight_decay: float = 5e-4, momentum: float = 0.9, power: float = 0.9,
                   reference_quirk: bool = False, clip_grad_norm: float = 0.0,
                   accum_steps: int = 1) -> PolySGD:
    """SGD + poly decay over ``params``, the arguments of the JAX
    ``make_optimizer`` (``max_step`` counts optimizer updates)."""
    return PolySGD(params, lr, max_step, weight_decay, momentum, power,
                   reference_quirk, clip_grad_norm, accum_steps)
