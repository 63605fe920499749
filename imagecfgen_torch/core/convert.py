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
- a whole ``GANState`` (``gan_state_from_jax``): the three modules, the step
  and both optax Adam states, each moment through the layout map of the
  parameter it belongs to, into ``train.gan_trainer.GANTrainer``'s
  ``state_dict()`` form;
- attribute-SCM trees (flows, MLP layer lists ``[{"w": (in, out), "b"}]``,
  categorical logits) carry across leaf for leaf.

Parameters are float32 in both packages whatever a config's
``compute_dtype`` is (it only casts them for the forward), so nothing here
depends on it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike
from ..models.bigan import BiGAN, BiGANConfig, Discriminator
from ..models.classifier import ClassifierConfig, CNNClassifier
from ..ops.conv import kernel_from_hwio, kernel_transpose_from_hwio
from ..scm.audio_mnist import AudioMNISTAttributeSCM
from ..scm.mnist import MNISTAttributeSCM


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def plan_state_dict_from_jax(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """A flax ``PlanSequential`` param dict -> the port's state dict.
    Without ``batch_stats`` only the parameters are mapped (an optimiser's
    moments have the parameters' tree, not the buffers')."""
    sd = {}
    for name, v in params.items():
        if name.startswith("bn_"):
            sd[f"{name}.scale"] = _t(v["scale"])
            sd[f"{name}.bias"] = _t(v["bias"])
            if batch_stats is not None:
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


def discriminator_state_dict_from_jax(
    params_D: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """The JAX ``Discriminator``'s params (and, when given, its
    ``batch_stats``; pass ``{}`` for a config without batch norm) -> the
    port's state dict."""
    sd = {}
    for part in ("dx", "dz", "dxz"):
        stats = None if batch_stats is None else batch_stats.get(part, {})
        for k, v in plan_state_dict_from_jax(params_D[part], stats).items():
            sd[f"{part}.{k}"] = v
    for name, v in params_D.get("attr_channels", {}).items():
        sd[f"attr_channels.{name}"] = _t(v["embedding"])
    return sd


def discriminator_from_jax(vars_D: Mapping, cfg: BiGANConfig, device: DeviceLike = None) -> Discriminator:
    """A port ``Discriminator`` for ``cfg`` holding the JAX ``vars_D``
    (``{"params": ..., "batch_stats": ...}``)."""
    model = Discriminator(cfg, device)
    model.load_state_dict(
        discriminator_state_dict_from_jax(vars_D["params"], vars_D.get("batch_stats", {})))
    return model


def _adam_from_optax(opt_state: Sequence, to_state_dict) -> Dict:
    """optax.adam's state ``(ScaleByAdamState(count, mu, nu), EmptyState())``
    (as a tuple or list of dicts) -> ``train.optim.adam_state``'s form.
    ``to_state_dict`` maps a tree shaped like the parameters to the port's
    names and layouts."""
    adam = opt_state[0]
    return {"count": int(np.asarray(adam["count"])), "mu": to_state_dict(adam["mu"]),
            "nu": to_state_dict(adam["nu"])}


def gan_state_from_jax(tree: Mapping) -> Dict:
    """The numpy form of a JAX ``GANState`` (or of the tree that
    ``save_bigan`` writes: ``params_E``, ``params_G``, ``vars_D``,
    ``opt_eg``, ``opt_d``, ``step``) -> the form that
    ``GANTrainer.load_state_dict`` takes. The JAX noise key is not carried:
    the two packages' random streams differ."""
    vars_D = tree["vars_D"]

    def eg(t):
        return {**{f"E.{k}": v for k, v in encoder_state_dict_from_jax(t["E"]).items()},
                **{f"G.{k}": v for k, v in generator_state_dict_from_jax(t["G"]).items()}}

    return {
        "E": encoder_state_dict_from_jax(tree["params_E"]),
        "G": generator_state_dict_from_jax(tree["params_G"]),
        "D": discriminator_state_dict_from_jax(vars_D["params"], vars_D.get("batch_stats", {})),
        "opt_eg": _adam_from_optax(tree["opt_eg"], eg),
        "opt_d": _adam_from_optax(tree["opt_d"], discriminator_state_dict_from_jax),
        "step": int(np.asarray(tree["step"])),
        "rng": None,
    }


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
