"""Morpho-MNIST attribute SCM: thickness -> intensity, slant, digit
(port of ``imagecfgen_tpu/scm/mnist.py``).

- thickness:  N(0,1) -> BatchNorm flow -> Exp          (log-normal family)
- intensity | thickness: N(0,1) -> conditional affine -> Sigmoid ->
              Affine(i_min, i_max - i_min)
- slant:      N(0,1) -> spline -> Affine(s_min, s_range)
- digit:      empirical Categorical(10)

``fit`` trains the three continuous mechanisms by MLE with Adam(1e-2) over
``steps`` epochs of 10k-sample batches and fits the digit by its empirical
frequencies.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..flows.bijectors import (
    AffineT,
    BatchNormFlow,
    ConditionalAffineT,
    ExpT,
    LinearRationalSplineT,
    SigmoidT,
    SplineT,
)
from ..flows.distributions import FlowDist, Normal
from .fit import fit_mle, trainable_copy
from .graph import CausalGraph, tree_map
from .module import CategoricalCM, FlowCM


def build_mnist_graph(
    intensity_min: float,
    intensity_max: float,
    slant_min: float,
    slant_max: float,
    cond_hidden: Tuple[int, ...] = (32, 32),
    spline: str = "rq",
) -> CausalGraph:
    """``cond_hidden``/``spline`` select the mechanism architectures:
    ``spline="rq"`` is the rational-quadratic spline, ``"linear"`` the
    linear-rational one (pyro Spline's default order)."""
    g = CausalGraph()
    thickness = FlowCM(FlowDist.create(Normal(), [BatchNormFlow(dim=1), ExpT()]))
    intensity = FlowCM(
        FlowDist.create(
            Normal(),
            [
                ConditionalAffineT(context_dim=1, hidden=tuple(cond_hidden)),
                SigmoidT(),
                AffineT(float(intensity_min), float(intensity_max - intensity_min)),
            ],
        ),
        conditional=True,
    )
    spline_bij = LinearRationalSplineT(dim=1) if spline == "linear" else SplineT(dim=1)
    slant = FlowCM(
        FlowDist.create(
            Normal(), [spline_bij, AffineT(float(slant_min), float(slant_max - slant_min))]
        )
    )
    g.add_node("thickness", thickness)
    g.add_node("intensity", intensity)
    g.add_node("slant", slant)
    g.add_node("digit", CategoricalCM(10))
    g.add_edge("thickness", "intensity")
    return g


class MNISTAttributeSCM:
    """Graph + params/state bundle with fit, persistence and inference
    helpers."""

    CONT = ("thickness", "intensity", "slant")

    def __init__(self, graph: CausalGraph, params, state):
        self.graph = graph
        self.params = params
        self.state = state

    def to(self, device: DeviceLike) -> "MNISTAttributeSCM":
        move = lambda t: (t if torch.is_tensor(t) else torch.from_numpy(np.array(t))).to(device)  # noqa: E731
        return MNISTAttributeSCM(self.graph, tree_map(move, self.params), tree_map(move, self.state))

    # ------------------------------------------------------------ training

    @staticmethod
    def fit(
        attrs: Mapping[str, np.ndarray],
        steps: int = 2000,
        batch_size: int = 10_000,
        learning_rate: float = 1e-2,
        rng: Optional[torch.Generator] = None,
        log_every: int = 0,
        cond_hidden: Tuple[int, ...] = (32, 32),
        spline: str = "rq",
        device: DeviceLike = None,
    ) -> "MNISTAttributeSCM":
        """``attrs``: thickness/intensity/slant float arrays and int (or
        one-hot) digit labels. ``cond_hidden``/``spline`` select the
        mechanism architectures (see :func:`build_mnist_graph`). ``rng``
        seeds the initial parameters and the shuffles."""
        return MNISTAttributeSCM._fit(attrs, steps, batch_size, learning_rate, rng, log_every,
                                      cond_hidden, spline, device)

    @staticmethod
    def _fit(attrs, steps, batch_size, learning_rate, rng, log_every, cond_hidden, spline,
             device, init=None, perms: Optional[Iterable] = None) -> "MNISTAttributeSCM":
        """:meth:`fit`, with the draws replaceable: ``init`` is a ``(params,
        state)`` pair to start from, ``perms`` one permutation of the used
        rows per epoch."""
        device = resolve_device(device)
        t = np.asarray(attrs["thickness"], np.float32).reshape(-1, 1)
        i = np.asarray(attrs["intensity"], np.float32).reshape(-1, 1)
        s = np.asarray(attrs["slant"], np.float32).reshape(-1, 1)
        digit = np.asarray(attrs["digit"])
        if digit.ndim > 1:
            digit = digit.argmax(axis=1)

        graph = build_mnist_graph(i.min(), i.max(), s.min(), s.max(),
                                  cond_hidden=cond_hidden, spline=spline)
        params, state = graph.init(rng, device) if init is None else init
        params = tree_map(lambda v: torch.as_tensor(v).to(device), dict(params))
        state = tree_map(lambda v: torch.as_tensor(v).to(device), dict(state))
        params["digit"] = CategoricalCM.fit_params(torch.from_numpy(digit).to(device), 10)

        batch_size = min(batch_size, len(t))
        n_use = len(t) // batch_size * batch_size
        data = torch.from_numpy(np.concatenate([t, i, s], axis=1)[:n_use]).to(device)
        trainable = trainable_copy({k: params[k] for k in MNISTAttributeSCM.CONT}, device)

        def batch_loss(tr, st, batch):
            obs = {"thickness": batch[:, 0:1], "intensity": batch[:, 1:2], "slant": batch[:, 2:3]}
            lp, new_st = graph.log_prob({**params, **tr}, st, obs, train=True)
            return -(lp["thickness"] + lp["intensity"] + lp["slant"]).mean(), new_st

        trainable, state = fit_mle(trainable, state, data, batch_loss, steps, batch_size,
                                   learning_rate, rng, perms, log_every, "attribute-scm")
        params.update(trainable)
        return MNISTAttributeSCM(graph, params, state)

    # ------------------------------------------------------------ inference

    def sample(self, rng: Optional[torch.Generator], obs_in=None, n: int = 1, device=None):
        return self.graph.sample(self.params, self.state, rng, obs_in, n, device)

    def log_prob(self, obs):
        lp, _ = self.graph.log_prob(self.params, self.state, obs, train=False)
        return lp

    def recover_noise(self, rng, obs):
        return self.graph.recover_noise(self.params, self.state, rng, obs)

    def sample_cf(self, rng, obs, interventions):
        return self.graph.sample_cf(self.params, self.state, rng, obs, interventions)

    # ------------------------------------------------------------ persistence

    def state_dict(self) -> Dict:
        mods = self.graph.modules
        aff_i: AffineT = mods["intensity"].flow.chain.bijectors[2]
        aff_s: AffineT = mods["slant"].flow.chain.bijectors[1]
        cond: ConditionalAffineT = mods["intensity"].flow.chain.bijectors[0]
        spline_kind = (
            "linear"
            if isinstance(mods["slant"].flow.chain.bijectors[0], LinearRationalSplineT)
            else "rq"
        )
        return {
            "params": self.params,
            "state": self.state,
            "bounds": {
                "intensity": (aff_i.loc, aff_i.scale),
                "slant": (aff_s.loc, aff_s.scale),
            },
            "arch": {"cond_hidden": tuple(cond.hidden), "spline": spline_kind},
        }

    @staticmethod
    def from_state_dict(sd: Mapping, device: DeviceLike = None) -> "MNISTAttributeSCM":
        """Rebuild from ``state_dict()``; leaves may be tensors or numpy."""
        (i_lo, i_rng) = sd["bounds"]["intensity"]
        (s_lo, s_rng) = sd["bounds"]["slant"]
        arch = dict(sd.get("arch", {}))
        graph = build_mnist_graph(
            i_lo, i_lo + i_rng, s_lo, s_lo + s_rng,
            cond_hidden=tuple(arch.get("cond_hidden", (32, 32))),
            spline=arch.get("spline", "rq"),
        )
        return MNISTAttributeSCM(graph, sd["params"], sd["state"]).to(resolve_device(device))
