"""AudioMNIST attribute SCM: country -> {native_speaker, accent},
native_speaker -> accent; digit, age and gender are roots
(port of ``imagecfgen_tpu/scm/audio_mnist.py``).

Roots are empirical categoricals; ``native_speaker`` and ``accent`` are
conditional categoricals with MLP logits and Gumbel-max counterfactuals.
``fit`` trains the two conditional networks by MLE with Adam(1e-2) and fits
the roots by their empirical frequencies.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .fit import fit_mle, trainable_copy
from .graph import CausalGraph, tree_map
from .module import CategoricalCM, ConditionalCategoricalCM

CARDINALITIES = {
    "accent": 15,
    "age": 5,
    "country_of_origin": 13,
    "digit": 10,
    "gender": 2,
    "native_speaker": 2,
}


def build_audio_mnist_graph() -> CausalGraph:
    g = CausalGraph()
    g.add_node("country_of_origin", CategoricalCM(CARDINALITIES["country_of_origin"]))
    g.add_node(
        "native_speaker",
        ConditionalCategoricalCM(
            CARDINALITIES["native_speaker"],
            context_dim=CARDINALITIES["country_of_origin"],
            hidden=(128, 128, 128),
        ),
    )
    g.add_node(
        "accent",
        ConditionalCategoricalCM(
            CARDINALITIES["accent"],
            context_dim=CARDINALITIES["country_of_origin"] + CARDINALITIES["native_speaker"],
            hidden=(128, 64),
        ),
    )
    g.add_node("digit", CategoricalCM(CARDINALITIES["digit"]))
    g.add_node("age", CategoricalCM(CARDINALITIES["age"]))
    g.add_node("gender", CategoricalCM(CARDINALITIES["gender"]))
    g.add_edge("country_of_origin", "native_speaker")
    g.add_edge("country_of_origin", "accent")
    g.add_edge("native_speaker", "accent")
    return g


class AudioMNISTAttributeSCM:
    """Graph + params/state bundle with fit, persistence and inference
    helpers."""

    TRAINABLE = ("native_speaker", "accent")

    def __init__(self, graph: CausalGraph, params, state):
        self.graph = graph
        self.params = params
        self.state = state

    @staticmethod
    def fit(
        attrs: Mapping[str, np.ndarray],
        steps: int = 2000,
        batch_size: int = 10_000,
        learning_rate: float = 1e-2,
        rng: Optional[torch.Generator] = None,
        log_every: int = 0,
        device: DeviceLike = None,
    ) -> "AudioMNISTAttributeSCM":
        """``attrs``: int codes (or one-hots) per attribute. ``rng`` seeds
        the initial parameters and the shuffles."""
        return AudioMNISTAttributeSCM._fit(attrs, steps, batch_size, learning_rate, rng,
                                           log_every, device)

    @staticmethod
    def _fit(attrs, steps, batch_size, learning_rate, rng, log_every, device,
             init=None, perms: Optional[Iterable] = None) -> "AudioMNISTAttributeSCM":
        """:meth:`fit`, with the draws replaceable: ``init`` is a ``(params,
        state)`` pair to start from, ``perms`` one permutation of the used
        rows per epoch."""
        device = resolve_device(device)
        codes = {}
        for k in CARDINALITIES:
            v = np.asarray(attrs[k])
            codes[k] = (v.argmax(axis=1) if v.ndim > 1 else v).astype(np.int64)

        graph = build_audio_mnist_graph()
        params, state = graph.init(rng, device) if init is None else init
        params = tree_map(lambda v: torch.as_tensor(v).to(device), dict(params))
        state = tree_map(lambda v: torch.as_tensor(v).to(device), dict(state))
        for k in ("country_of_origin", "digit", "age", "gender"):
            params[k] = CategoricalCM.fit_params(torch.from_numpy(codes[k]).to(device),
                                                 CARDINALITIES[k])

        n = len(codes["country_of_origin"])
        batch_size = min(batch_size, n)
        n_use = n // batch_size * batch_size
        cols = ("country_of_origin", "native_speaker", "accent")
        data = torch.from_numpy(np.stack([codes[k][:n_use] for k in cols], axis=1)).to(device)
        trainable = trainable_copy({k: params[k] for k in AudioMNISTAttributeSCM.TRAINABLE}, device)

        def batch_loss(tr, st, batch):
            obs = {k: batch[:, j] for j, k in enumerate(cols)}
            lp, _ = graph.log_prob({**params, **tr}, st, obs)
            return -(lp["native_speaker"] + lp["accent"]).mean(), st

        trainable, state = fit_mle(trainable, state, data, batch_loss, steps, batch_size,
                                   learning_rate, rng, perms, log_every, "audio-scm")
        params.update(trainable)
        return AudioMNISTAttributeSCM(graph, params, state)

    def to(self, device: DeviceLike) -> "AudioMNISTAttributeSCM":
        move = lambda t: (t if torch.is_tensor(t) else torch.from_numpy(np.array(t))).to(device)  # noqa: E731
        return AudioMNISTAttributeSCM(self.graph, tree_map(move, self.params), tree_map(move, self.state))

    # ------------------------------------------------------------ inference

    def sample(self, rng: Optional[torch.Generator], obs_in=None, n: int = 1, device=None,
               noise=None):
        return self.graph.sample(self.params, self.state, rng, obs_in, n, device, noise)

    def log_prob(self, obs):
        lp, _ = self.graph.log_prob(self.params, self.state, obs)
        return lp

    def recover_noise(self, rng, obs, noise=None):
        return self.graph.recover_noise(self.params, self.state, rng, obs, noise)

    def sample_cf(self, rng, obs, interventions, noise=None):
        return self.graph.sample_cf(self.params, self.state, rng, obs, interventions, noise)

    # ------------------------------------------------------------ persistence

    def state_dict(self) -> Dict:
        return {"params": self.params, "state": self.state}

    @staticmethod
    def from_state_dict(sd: Mapping, device: DeviceLike = None) -> "AudioMNISTAttributeSCM":
        """Rebuild from ``state_dict()``; leaves may be tensors or numpy."""
        graph = build_audio_mnist_graph()
        return AudioMNISTAttributeSCM(graph, sd["params"], sd["state"]).to(resolve_device(device))
