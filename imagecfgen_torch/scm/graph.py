"""Causal DAG engine (port of ``imagecfgen_tpu/scm/graph.py``).

``sample`` (ancestral, holding observed nodes fixed), ``log_prob``
(per-node conditional likelihoods), ``recover_noise`` (abduction) and
``sample_cf`` (complete the observation by sampling, abduct all exogenous
noise, regenerate under the intervention). The topology is resolved on the
host with a deterministic sort; contexts concatenate the parents in sorted
name order, categorical parents one-hot.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .module import CausalModule


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class CausalGraph:
    def __init__(self):
        self.modules: Dict[str, CausalModule] = {}
        self._adj: Dict[str, set] = {}
        self._adj_rev: Dict[str, set] = {}

    # ------------------------------------------------------------ topology

    def add_node(self, name: str, module: CausalModule) -> None:
        self.modules[name] = module
        self._adj.setdefault(name, set())
        self._adj_rev.setdefault(name, set())

    def add_edge(self, u: str, v: str) -> None:
        assert u in self.modules and v in self.modules, "add nodes first"
        self._adj[u].add(v)
        self._adj_rev[v].add(u)

    def parents(self, v: str) -> List[str]:
        return sorted(self._adj_rev[v])

    def top_sort(self) -> List[str]:
        """Kahn's algorithm; deterministic (sorted) tie-breaking."""
        indeg = {v: len(self._adj_rev[v]) for v in self.modules}
        ready = sorted([v for v, d in indeg.items() if d == 0])
        out: List[str] = []
        while ready:
            n = ready.pop(0)
            out.append(n)
            for m in sorted(self._adj[n]):
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(out) != len(self.modules):
            raise ValueError("graph has a cycle")
        return out

    # ------------------------------------------------------------ params

    def init(self, rng: Optional[torch.Generator] = None, device=None) -> Tuple[Dict, Dict]:
        """Parameters and state of every node, in sorted-name order."""
        params, state = {}, {}
        for v in sorted(self.modules):
            params[v], state[v] = self.modules[v].init(rng)
        to = lambda t: t.to(device)  # noqa: E731
        return tree_map(to, params), tree_map(to, state)

    # ------------------------------------------------------------ contexts

    def _context(self, v: str, obs: Mapping[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """Concatenate parent values (one-hot for categorical parents)."""
        cols = []
        for u in self.parents(v):
            mu = self.modules[u]
            val = obs[u]
            if mu.categorical:
                cols.append(F.one_hot(val.reshape(-1).long(), mu.n_categories).float())
            else:
                cols.append(val.reshape(val.shape[0], -1).float())
        if not cols:
            return None
        return torch.cat(cols, dim=1)

    # ------------------------------------------------------------ inference

    def _observed(self, obs) -> List[str]:
        return [v for v in self.modules if v in obs and all(u in obs for u in self.parents(v))]

    def log_prob(self, params, state, obs: Mapping[str, torch.Tensor], train: bool = False):
        """Per-node conditional log-likelihoods for the observed nodes whose
        parents are all observed."""
        lp, new_state = {}, dict(state)
        for v in self._observed(obs):
            ctx = self._context(v, obs)
            lp[v], new_state[v] = self.modules[v].log_prob(params[v], state[v], obs[v], ctx, train=train)
        return lp, new_state

    def recover_noise(self, params, state, rng, obs: Mapping[str, torch.Tensor],
                      noise: Optional[Mapping[str, torch.Tensor]] = None):
        """Abduction for every fully-observed node; ``noise`` injects the
        prior draw that the abduction of chosen nodes conditions (the
        Gumbels of a conditional categorical)."""
        noise = noise or {}
        return {
            v: self.modules[v].recover_noise(
                params[v], state[v], rng, obs[v], self._context(v, obs), noise.get(v))
            for v in self._observed(obs)
        }

    def sample(
        self,
        params,
        state,
        rng: Optional[torch.Generator],
        obs_in: Optional[Mapping[str, torch.Tensor]] = None,
        n: int = 1,
        device=None,
        noise: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        """Ancestral sampling, holding any given nodes fixed; ``noise``
        injects the exogenous draw of chosen nodes."""
        obs = dict(obs_in or {})
        if obs:
            first = next(iter(obs.values()))
            n, device = first.shape[0], first.device
        noise = noise or {}
        for v in self.top_sort():
            if v in obs:
                continue
            ctx = self._context(v, obs)
            obs[v] = self.modules[v].sample(params[v], state[v], rng, ctx, n, device, noise.get(v))
        return obs

    def sample_cf(
        self,
        params,
        state,
        rng: Optional[torch.Generator],
        obs: Mapping[str, torch.Tensor],
        interventions: Mapping[str, torch.Tensor],
        noise: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        """Abduct-act-predict (``noise``: injected abduction draws, as for
        ``recover_noise``):

        1. complete partial observations by ancestral sampling,
        2. abduct exogenous noise for every node,
        3. regenerate through the mutilated graph: intervened nodes take
           their forced values, all others are re-generated from their
           abducted noise under the new parent values.
        """
        obs = self.sample(params, state, rng, obs)
        noise = self.recover_noise(params, state, rng, obs, noise)
        out = dict(interventions)
        for v in self.top_sort():
            if v in out:
                continue
            ctx = self._context(v, out)
            out[v] = self.modules[v].generate(params[v], state[v], noise[v], ctx)
        return out
