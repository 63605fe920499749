"""AudioMNIST attribute SCM: country -> {native_speaker, accent},
native_speaker -> accent; digit, age and gender are roots
(port of ``imagecfgen_tpu/scm/audio_mnist.py``).

Roots are empirical categoricals; ``native_speaker`` and ``accent`` are
conditional categoricals with MLP logits and Gumbel-max counterfactuals.
This slice carries inference; the MLE fit comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
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
    """Graph + params/state bundle with persistence and inference helpers."""

    def __init__(self, graph: CausalGraph, params, state):
        self.graph = graph
        self.params = params
        self.state = state

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
