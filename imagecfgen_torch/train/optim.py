"""The port's optimiser: optax's Adam over a list of parameters, its moments
in one flat buffer each, and its state by parameter name.

:class:`Adam` computes ``optax.adam``'s update in float32:
``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g² + b2 nu``, then
``p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``, eps
outside the root. ``weight_decay`` makes it ``optax.adamw``: the decoupled
``p -= lr * (update + weight_decay * p)`` on every parameter, ``p`` as it
was before the step. The gradients are concatenated into one vector and each
moment lives in one buffer for all the parameters (the JAX package's
``flat_adam`` storage), so a step is a few large kernels and one
multi-tensor add into the parameters, whatever their number: the GAN step
is bound by its launches. ``mu_dtype=torch.bfloat16``
(``optax.adam(mu_dtype=...)``) stores the first moment rounded to bfloat16;
the update uses this step's float32 value.

Under data parallelism (``mesh``, a ``parallel.DataMesh``) each rank's
gradient is of its shard's mean loss; the flat gradient vector is averaged
over the ranks (one all-reduce an update) before the moments see it, as
GSPMD's gradient all-reduce does in the JAX package.

A checkpoint (and ``core.convert``) holds the state by parameter name:
``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``, optax's
``ScaleByAdamState`` with the port's parameter names and layouts, ``mu`` in
its stored type.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import torch

Named = Iterable[Tuple[str, torch.nn.Parameter]]


def assign_grads(params: List[torch.nn.Parameter], loss: torch.Tensor) -> None:
    """``p.grad = d loss / d p`` for exactly ``params``. A parameter the loss
    does not reach raises here (``torch.autograd.grad`` refuses it) instead
    of being skipped by the optimiser without a word. Each gradient takes
    its parameter's (contiguous) layout, as ``backward()`` would store it:
    cuDNN hands back channels-last kernel gradients, and the multi-tensor
    ops need one layout per tensor list."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g.contiguous()


class Adam:
    """``optax.adam(lr, b1, b2, eps, mu_dtype=...)`` on ``params`` (updated
    in place from their ``.grad``); with ``weight_decay``,
    ``optax.adamw(lr, b1, b2, eps, weight_decay=...)`` (no mask); with
    ``mesh``, on the gradients averaged over its ranks."""

    def __init__(self, params: Sequence[torch.nn.Parameter], lr: float,
                 betas: Tuple[float, float], eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.float32, weight_decay: float = 0.0,
                 mesh=None):
        self.params = list(params)
        self.mesh = mesh
        self.lr, (self.b1, self.b2), self.eps = lr, tuple(betas), eps
        self.weight_decay = weight_decay
        self.count = 0
        self.sizes = [p.numel() for p in self.params]
        dev = self.params[0].device
        self.mu = torch.zeros(sum(self.sizes), dtype=mu_dtype, device=dev)
        self.nu = torch.zeros(sum(self.sizes), device=dev)

    def _per_param(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [t.view_as(p) for t, p in zip(flat.split(self.sizes), self.params)]

    @torch.no_grad()
    def step(self) -> None:
        g = torch.cat([p.grad.reshape(-1) for p in self.params])
        if self.mesh is not None:
            self.mesh.average_(g)
        self.count += 1
        b1, b2 = self.b1, self.b2
        mu = torch.mul(g, 1 - b1).add_(self.mu.float(), alpha=b1)
        self.nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        den = torch.div(self.nu, 1 - b2 ** self.count).sqrt_().add_(self.eps)
        upd = torch.div(mu, 1 - b1 ** self.count).div_(den)
        self.mu = mu.to(self.mu.dtype)  # rounded to the stored type
        upd = self._per_param(upd)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-self.lr)

    def moments(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """``(mu, nu)``, one view of the buffers per parameter, in its
        shape."""
        return self._per_param(self.mu), self._per_param(self.nu)


def _check_named(opt: Adam, named: Named) -> List[Tuple[str, torch.nn.Parameter]]:
    named = list(named)
    if len(named) != len(opt.params) or any(p is not q for (_, p), q in zip(named, opt.params)):
        raise ValueError("the named parameters are not the optimiser's, in its order")
    return named


def adam_state(opt: Adam, named: Named) -> Dict:
    """The optimiser's step count and moments by parameter name (zeros
    before the first update); ``named`` lists its parameters in order."""
    named = _check_named(opt, named)
    mu, nu = opt.moments()
    return {"count": opt.count,
            "mu": {n: m.clone() for (n, _), m in zip(named, mu)},
            "nu": {n: v.clone() for (n, _), v in zip(named, nu)}}


def load_adam_state(opt: Adam, named: Named, state: Mapping) -> None:
    """Set the optimiser's step count and moments from :func:`adam_state`'s
    form. The moments take the optimiser's device and stored types: a
    bfloat16 ``mu`` read back as float32 (the JAX package's files) is cast
    back, exactly."""
    named = _check_named(opt, named)
    missing = [n for n, _ in named if n not in state["mu"] or n not in state["nu"]]
    extra = [n for n in state["mu"] if n not in dict(named)]
    if missing or extra:
        raise KeyError(f"Adam state: missing {missing}, unexpected {extra}")
    mu, nu = opt.moments()
    for (n, p), m, v in zip(named, mu, nu):
        src_m, src_v = state["mu"][n], state["nu"][n]
        if src_m.shape != p.shape or src_v.shape != p.shape:
            raise ValueError(f"Adam state of {n}: {tuple(src_m.shape)}, parameter {tuple(p.shape)}")
        m.copy_(src_m.detach())
        v.copy_(src_v.detach())
    opt.count = int(state["count"])
