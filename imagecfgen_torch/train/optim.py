"""What the trainers share around ``torch.optim.Adam``: gradients assigned
for exactly the parameters an update owns, and Adam's state by parameter
name, for checkpoints and for carrying an optax state across.

``torch.optim.Adam`` keys its state by parameter object; a checkpoint (and
``core.convert``) wants it by name: ``{"count": int, "mu": {name: tensor},
"nu": {name: tensor}}``, optax's ``ScaleByAdamState`` with the port's
parameter names and layouts.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import torch

Named = Iterable[Tuple[str, torch.nn.Parameter]]


def assign_grads(params: List[torch.nn.Parameter], loss: torch.Tensor) -> None:
    """``p.grad = d loss / d p`` for exactly ``params``. A parameter the loss
    does not reach raises here (``torch.autograd.grad`` refuses it) instead
    of being skipped by the optimiser without a word. Each gradient takes
    its parameter's (contiguous) layout, as ``backward()`` would store it:
    cuDNN hands back channels-last kernel gradients, and Adam's multi-tensor
    path needs one layout per tensor list."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g.contiguous()


def adam_state(opt: torch.optim.Adam, named: Named) -> Dict:
    """The optimiser's step count and moments by parameter name (zeros
    before the first update)."""
    named = list(named)
    steps = {int(opt.state[p]["step"]) for _, p in named if p in opt.state}
    if len(steps) > 1:
        raise ValueError(f"parameters of one optimiser at different steps: {sorted(steps)}")
    mu = {n: opt.state[p]["exp_avg"].clone() if p in opt.state else torch.zeros_like(p)
          for n, p in named}
    nu = {n: opt.state[p]["exp_avg_sq"].clone() if p in opt.state else torch.zeros_like(p)
          for n, p in named}
    return {"count": steps.pop() if steps else 0, "mu": mu, "nu": nu}


def load_adam_state(opt: torch.optim.Adam, named: Named, state: Mapping) -> None:
    """Set the optimiser's step count and moments from :func:`adam_state`'s
    form; the moments take each parameter's device and type."""
    named = list(named)
    missing = [n for n, _ in named if n not in state["mu"] or n not in state["nu"]]
    extra = [n for n in state["mu"] if n not in dict(named)]
    if missing or extra:
        raise KeyError(f"Adam state: missing {missing}, unexpected {extra}")
    for n, p in named:
        mu, nu = state["mu"][n], state["nu"][n]
        if mu.shape != p.shape or nu.shape != p.shape:
            raise ValueError(f"Adam state of {n}: {tuple(mu.shape)}, parameter {tuple(p.shape)}")
        opt.state[p] = {
            # the step lives on the host, as torch.optim.Adam keeps it
            "step": torch.tensor(float(state["count"]), dtype=torch.float32),
            "exp_avg": mu.detach().to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu.detach().to(p.device, p.dtype).clone(),
        }
