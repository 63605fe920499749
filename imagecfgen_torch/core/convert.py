"""Carry weights from the JAX package into the port.

Every function takes the JAX package's trees as nested dicts (and lists and
tuples) of numpy arrays — ``jax.device_get`` of a flax param tree or of an
attribute SCM's ``state_dict()`` — so this module needs neither JAX nor
flax. Layout changes:

- conv kernel HWIO -> ``(O, I, kH, kW)``;
- transposed-conv kernel HWIO -> ``(I, O, kH, kW)`` rotated by 180 degrees
  (the JAX transposed conv does not flip its kernel; ``F.conv_transpose2d``
  does);
- dense kernel ``(in, out)`` -> ``(out, in)``;
- ``attr_channels/embed_<name>/embedding`` and ``attr_vectors/embed_<name>``
  -> the tables of the same names;
- ``bn_i`` scale/bias (params) and mean/var (batch stats) -> ``bn_i``;
- attribute-SCM trees (flows, MLP layer lists ``[{"w": (in, out), "b"}]``,
  categorical logits) carry across leaf for leaf.

Parameters are float32 in both packages whatever a config's
``compute_dtype`` is (it only casts them for the forward), so nothing here
depends on it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..models.bigan import BiGAN, BiGANConfig
from ..models.classifier import ClassifierConfig, CNNClassifier
from ..ops.conv import kernel_from_hwio, kernel_transpose_from_hwio
from ..scm.audio_mnist import AudioMNISTAttributeSCM
from ..scm.mnist import MNISTAttributeSCM


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def plan_state_dict_from_jax(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """A flax ``PlanSequential`` param dict -> the port's state dict."""
    sd = {}
    for name, v in params.items():
        if name.startswith("bn_"):
            sd[f"{name}.scale"] = _t(v["scale"])
            sd[f"{name}.bias"] = _t(v["bias"])
            sd[f"{name}.mean"] = _t(batch_stats[name]["mean"])
            sd[f"{name}.var"] = _t(batch_stats[name]["var"])
        elif name.startswith("convT_") and name.endswith("_kernel"):
            sd[name] = kernel_transpose_from_hwio(_t(v))
        elif name.startswith("conv_") and name.endswith("_kernel"):
            sd[name] = kernel_from_hwio(_t(v))
        elif name.startswith("dense_") and name.endswith("_kernel"):
            sd[name] = _t(v).t().contiguous()
        else:
            sd[name] = _t(v)
    return sd


def encoder_state_dict_from_jax(params_E: Mapping) -> Dict[str, torch.Tensor]:
    sd = {f"trunk.{k}": v for k, v in plan_state_dict_from_jax(params_E["trunk"]).items()}
    for name, v in params_E.get("attr_channels", {}).items():
        sd[f"attr_channels.{name}"] = _t(v["embedding"])
    return sd


def generator_state_dict_from_jax(params_G: Mapping) -> Dict[str, torch.Tensor]:
    sd = {f"trunk.{k}": v for k, v in plan_state_dict_from_jax(params_G["trunk"]).items()}
    for name, v in params_G.get("attr_vectors", {}).items():
        sd[f"attr_vectors.{name}"] = _t(v)
    return sd


def bigan_params_from_jax(
    params_E: Mapping, params_G: Mapping, cfg: BiGANConfig, device: DeviceLike = None
) -> BiGAN:
    """A port ``BiGAN`` for ``cfg`` holding the JAX Encoder/Generator params."""
    model = BiGAN(cfg, device)
    model.encoder.load_state_dict(encoder_state_dict_from_jax(params_E))
    model.generator.load_state_dict(generator_state_dict_from_jax(params_G))
    return model


def scm_from_jax_state_dict(sd: Mapping, device: DeviceLike = None) -> MNISTAttributeSCM:
    """The numpy form of the JAX ``MNISTAttributeSCM.state_dict()`` -> the
    port's SCM (the trees have the same structure, leaf for leaf)."""
    return MNISTAttributeSCM.from_state_dict(sd, device)


def classifier_params_from_jax(
    params: Mapping, cfg: ClassifierConfig, device: DeviceLike = None
) -> CNNClassifier:
    """A port ``CNNClassifier`` for ``cfg`` holding the JAX classifier's
    params (its ``trunk`` tree)."""
    model = CNNClassifier(cfg, device)
    model.trunk.load_state_dict(plan_state_dict_from_jax(params["trunk"]))
    return model


def audio_scm_from_jax_state_dict(sd: Mapping, device: DeviceLike = None) -> AudioMNISTAttributeSCM:
    """The numpy form of the JAX ``AudioMNISTAttributeSCM.state_dict()`` ->
    the port's SCM (the MLP layer lists have the port's ``_mlp_init``
    layout, leaf for leaf)."""
    return AudioMNISTAttributeSCM.from_state_dict(sd, device)
