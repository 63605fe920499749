"""The MLE loop the attribute SCMs' ``fit`` share: Adam on a negative mean
log-likelihood over device-resident rows, one permutation per epoch.

``steps`` counts epochs, as in the JAX package: every epoch draws a
permutation of the rows on the device, cuts it into full batches and takes
one Adam step per batch.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch

from .graph import tree_map


def leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def trainable_copy(tree, device):
    """The tree with every leaf a fresh leaf tensor on ``device`` that
    requires a gradient."""
    return tree_map(lambda t: t.detach().to(device).clone().requires_grad_(True), tree)


def fit_mle(
    trainable,
    state,
    data: torch.Tensor,
    batch_loss: Callable,
    steps: int,
    batch_size: int,
    learning_rate: float,
    rng: Optional[torch.Generator],
    perms: Optional[Iterable[torch.Tensor]] = None,
    log_every: int = 0,
    tag: str = "attribute-scm",
) -> Tuple[object, object]:
    """Fit the leaves of ``trainable`` (leaf tensors that require gradients)
    in place; returns ``(trainable, state)`` detached.

    ``batch_loss(trainable, state, batch) -> (loss, new_state)``; ``data``
    is ``(n, ...)`` on the device, ``n`` a multiple of ``batch_size``.
    ``rng`` seeds the generator of the per-epoch permutations, which lives
    on the data's device; ``perms`` gives them instead, one index tensor per
    epoch (for a test that must shuffle as another package did)."""
    n = data.shape[0]
    nb = n // batch_size
    # optax.adam(lr): betas 0.9 and 0.999, eps 1e-8, as torch.optim.Adam's defaults
    opt = torch.optim.Adam(leaves(trainable), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=data.device)
    gen.manual_seed(int(torch.randint(0, 2 ** 62, (1,), generator=rng)))
    perms = iter(perms) if perms is not None else None
    for step in range(steps):
        if perms is not None:
            perm = torch.as_tensor(next(perms)).to(data.device)
        else:
            perm = torch.randperm(n, generator=gen, device=data.device)
        batches = data[perm].reshape(nb, batch_size, *data.shape[1:])
        total = torch.zeros((), device=data.device)
        for i in range(nb):
            loss, state = batch_loss(trainable, state, batches[i])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            state = tree_map(lambda t: t.detach(), state)
            total += loss.detach()
        if log_every and (step + 1) % log_every == 0:
            print(f"[{tag}] step {step + 1}/{steps} nll={(total / nb).item():.4f}")
    return tree_map(lambda t: t.detach(), trainable), state
