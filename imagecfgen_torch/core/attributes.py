"""Typed attribute specifications (port of ``imagecfgen_tpu/core/attributes.py``).

Conventions:

- a *batch of attributes* is a ``dict[str, torch.Tensor]``;
- categorical attributes are **one-hot** ``(B, n)`` float tensors;
- continuous attributes are ``(B,)`` or ``(B, 1)`` float tensors;
- iteration order is always ``sorted(names)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Attribute:
    """One named attribute: categorical with ``n_categories`` or continuous."""

    name: str
    n_categories: int = 0  # 0 -> continuous scalar

    @property
    def is_categorical(self) -> bool:
        return self.n_categories > 0


@dataclasses.dataclass(frozen=True)
class AttributeSpec:
    """An ordered collection of attributes describing a conditioning dict."""

    attributes: Tuple[Attribute, ...]

    @staticmethod
    def create(**kwargs: int) -> "AttributeSpec":
        """``AttributeSpec.create(digit=10, thickness=0, ...)`` — value is the
        number of categories, 0 meaning continuous."""
        return AttributeSpec(tuple(Attribute(k, v) for k, v in sorted(kwargs.items())))

    def __iter__(self):
        return iter(self.attributes)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.attributes)

    @property
    def categorical(self) -> Tuple[Attribute, ...]:
        return tuple(a for a in self.attributes if a.is_categorical)

    @property
    def continuous(self) -> Tuple[Attribute, ...]:
        return tuple(a for a in self.attributes if not a.is_categorical)


class AttributeScaler:
    """Min/max scaling of continuous attributes to [-1, 1]; categorical
    attributes pass through. Stats are plain numpy so they serialise."""

    def __init__(self, spec: AttributeSpec, mins: Mapping, maxs: Mapping):
        self.spec = spec
        self.mins = {k: np.asarray(v, np.float32) for k, v in mins.items()}
        self.maxs = {k: np.asarray(v, np.float32) for k, v in maxs.items()}

    @staticmethod
    def fit(spec: AttributeSpec, attrs: Mapping) -> "AttributeScaler":
        mins, maxs = {}, {}
        for a in spec.continuous:
            v = np.asarray(attrs[a.name])
            mins[a.name] = v.min(axis=0)
            maxs[a.name] = v.max(axis=0)
        return AttributeScaler(spec, mins, maxs)

    def _bounds(self, name: str, like: torch.Tensor):
        lo = torch.as_tensor(self.mins[name], dtype=torch.float32, device=like.device)
        hi = torch.as_tensor(self.maxs[name], dtype=torch.float32, device=like.device)
        return lo, hi

    def scale(self, attrs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(attrs)
        for a in self.spec.continuous:
            lo, hi = self._bounds(a.name, attrs[a.name])
            out[a.name] = 2.0 * (attrs[a.name] - lo) / (hi - lo) - 1.0
        return out

    def unscale(self, attrs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(attrs)
        for a in self.spec.continuous:
            lo, hi = self._bounds(a.name, attrs[a.name])
            out[a.name] = (attrs[a.name] + 1.0) / 2.0 * (hi - lo) + lo
        return out

    def state_dict(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {"mins": dict(self.mins), "maxs": dict(self.maxs)}

    @staticmethod
    def from_state_dict(spec: AttributeSpec, state: Mapping) -> "AttributeScaler":
        return AttributeScaler(spec, dict(state["mins"]), dict(state["maxs"]))


MNIST_SPEC = AttributeSpec.create(digit=10, thickness=0, intensity=0, slant=0)
