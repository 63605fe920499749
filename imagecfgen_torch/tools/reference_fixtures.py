"""Checkpoints in the original PyTorch ImageCFGen's (the reference's) format,
made from a seed, and the map that says where each of their tensors must
land in the port.

    obj, mapped = reference_checkpoint("mnist-bigan", seed=0)
    torch.save(obj, "mnist-bigan.tar")
    # ... python -m imagecfgen_torch.cli.convert_reference_checkpoint ...
    check_mapped(mapped, obj, {"E": state["E"], "G": state["G"], "D": state["D"]})

The state dicts have the reference's key names (``layers.{i}.weight``,
``dx.{i}.running_mean``, ``digit_embedding.0.weight``, ``seq`` indices of a
bare ``nn.Sequential``, ...) and torch layouts, one ``nn.Sequential`` index an
op of the plan, parameterless ops too. Every weight is drawn N(0, 1/fan-in),
so a forward's activations stay O(1). The map is written from the plans
alone, apart from the converter: a port tensor equals its reference tensor,
element for element, but for a linear layer after a flatten of a map larger
than 1x1 (its inputs reordered from (C, H, W) to (H, W, C)) and one that
feeds a reshape (its outputs reordered so).

The tests and ``chip_smoke.py`` (phase R) share these functions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# the checkpoint keys each kind is saved under, as the reference saves them
CLASSIFIER_KEY = {"mnist-clf": "clf", "morphomnist-oracle": "oracle", "audio-clf": "model", "whale-clf": "clf"}
# (E's and D's embedding key, G's) of each family, for attribute ``a``
EMBED_KEYS = {
    "mnist": lambda a: ("digit_embedding.0.weight", "digit_embedding.weight"),
    "moduledict": lambda a: (f"embedding_dict.{a}.0.weight", f"embedding_dict.{a}.weight"),
    "esrf": lambda a: ("has_boat_embedding.0.weight", "has_boat_embedding.weight"),
}
VAE_HEADS = {"mnist-vae": ("mean_linear", "log_var_linear"), "audio-vae": ("mean", "log_var"),
             "whale-vae": ("mean_linear", "log_var_linear")}


@dataclasses.dataclass(frozen=True)
class Mapped:
    """Reference tensor ``obj[ref_part][ref_key]`` lands at
    ``port[port_part][port_key]``; with ``perm``, reordered along ``dim``
    (``index_select(dim, perm)``)."""

    ref_part: str
    ref_key: str
    port_part: str
    port_key: str
    dim: int = 0
    perm: Optional[Tuple[int, ...]] = None


def _hwc_order(h: int, w: int, c: int) -> np.ndarray:
    """Index ``j`` of an (H, W, C)-ordered vector holds element ``order[j]``
    of the same values ordered (C, H, W)."""
    chw = np.arange(c * h * w).reshape(c, h, w)
    return np.stack([chw[:, i, j] for i in range(h) for j in range(w)]).reshape(-1)


class _Builder:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape, std) -> torch.Tensor:
        return torch.from_numpy(self.rng.normal(0.0, std, shape).astype(np.float32))

    def plan(self, plan, in_shape, sd: Dict, prefix: str, mapped: List[Mapped], ref_part: str,
             port_part: str, port_prefix: str) -> Tuple[int, ...]:
        """Draw the tensors of ``plan`` on an input of ``in_shape`` ((H, W, C)
        or (F,)) into ``sd`` under ``{prefix}{index}.``; returns the output
        shape."""
        shape, flat = tuple(in_shape), None
        conv_i = dense_i = bn_i = 0

        def put(seq, name, tensor, port_name, dim=0, perm=None):
            sd[f"{prefix}{seq}.{name}"] = tensor
            if port_name is not None:
                mapped.append(Mapped(ref_part, f"{prefix}{seq}.{name}", port_part, port_prefix + port_name, dim,
                                     None if perm is None else tuple(int(i) for i in perm)))

        for seq, op in enumerate(plan):
            kind = op[0]
            if kind in ("conv", "convT"):
                (h, w, c), (o, k, s, p) = shape, op[1:5]
                wshape = (o, c, k, k) if kind == "conv" else (c, o, k, k)
                put(seq, "weight", self.normal(wshape, 1.0 / np.sqrt(c * k * k)), f"{kind}_{conv_i}_kernel")
                put(seq, "bias", self.normal((o,), 0.1), f"{kind}_{conv_i}_bias")
                if kind == "conv":
                    h, w = ((d + 2 * p - k) // s + 1 for d in (h, w))
                else:
                    h, w = ((d - 1) * s - 2 * p + k + (op[5] if len(op) > 5 else 0) for d in (h, w))
                shape, conv_i = (h, w, o), conv_i + 1
            elif kind == "dense":
                n_in, o = int(np.prod(shape)), op[1]
                weight, bias = self.normal((o, n_in), 1.0 / np.sqrt(n_in)), self.normal((o,), 0.1)
                nxt = plan[seq + 1] if seq + 1 < len(plan) else None
                if flat is not None:  # the port reads the flattened map in (H, W, C) order
                    put(seq, "weight", weight, f"dense_{dense_i}_kernel", 1, _hwc_order(*flat))
                elif nxt is not None and nxt[0] == "reshape" and tuple(nxt[1][:2]) != (1, 1):
                    order = _hwc_order(*nxt[1])  # the port reshapes its outputs to (H, W, C)
                    put(seq, "weight", weight, f"dense_{dense_i}_kernel", 0, order)
                    put(seq, "bias", bias, f"dense_{dense_i}_bias", 0, order)
                    bias = None
                else:
                    put(seq, "weight", weight, f"dense_{dense_i}_kernel")
                if bias is not None:
                    put(seq, "bias", bias, f"dense_{dense_i}_bias")
                shape, flat, dense_i = (o,), None, dense_i + 1
            elif kind == "bn":
                c = shape[-1]
                put(seq, "weight", 1.0 + self.normal((c,), 0.1), f"bn_{bn_i}.scale")
                put(seq, "bias", self.normal((c,), 0.1), f"bn_{bn_i}.bias")
                put(seq, "running_mean", self.normal((c,), 0.1), f"bn_{bn_i}.mean")
                put(seq, "running_var",
                    torch.from_numpy(self.rng.uniform(0.5, 1.5, c).astype(np.float32)), f"bn_{bn_i}.var")
                put(seq, "num_batches_tracked", torch.tensor(1000), None)
                bn_i += 1
            elif kind == "flatten":
                if len(shape) == 3 and shape[:2] != (1, 1):
                    flat = shape
                shape = (int(np.prod(shape)),)
            elif kind == "reshape":
                shape = tuple(op[1])
            elif kind not in ("lrelu", "tanh", "sigmoid", "drop", "drop2d"):
                raise ValueError(f"unknown plan op {kind!r}")
        return shape

    def embeddings(self, cfg, sd: Dict, keys, which: int, mapped: List[Mapped], ref_part: str,
                   port_part: str, port_prefix: str, key_prefix: str = "") -> None:
        for a in cfg.attr_spec.categorical:
            key = key_prefix + keys(a.name)[which]
            sd[key] = self.normal((a.n_categories, cfg.embed_dim), 1.0)
            mapped.append(Mapped(ref_part, key, port_part, f"{port_prefix}embed_{a.name}"))


def _bigan(kind: str, seed: int, d: int):
    from ..models import bigan as configs

    cfg, keys = {
        "mnist-bigan": (lambda: configs.mnist_bigan_config(), EMBED_KEYS["mnist"]),
        "audio-bigan": (lambda: configs.audio_mnist_bigan_config(d=d), EMBED_KEYS["moduledict"]),
        "whale-bigan": (lambda: configs.whale_bigan_config(d=d), EMBED_KEYS["moduledict"]),
        "esrf-bigan": (lambda: configs.esrf_bigan_config(d=d), EMBED_KEYS["esrf"]),
    }[kind]
    cfg = cfg()
    b, mapped = _Builder(seed), []
    spec = cfg.attr_spec
    in_ch = cfg.image_channels + len(spec.categorical) + len(spec.continuous)
    g_in = cfg.latent_dim + cfg.embed_dim * len(spec.categorical) + len(spec.continuous)
    sd_E, sd_G, sd_D = {}, {}, {}
    b.plan(cfg.enc_plan, (*cfg.image_size, in_ch), sd_E, "layers.", mapped, "E_state_dict", "E", "trunk.")
    b.embeddings(cfg, sd_E, keys, 0, mapped, "E_state_dict", "E", "attr_channels.")
    b.plan(cfg.gen_plan, (1, 1, g_in) if cfg.gen_input == "spatial" else (g_in,), sd_G, "layers.", mapped,
           "G_state_dict", "G", "trunk.")
    b.embeddings(cfg, sd_G, keys, 1, mapped, "G_state_dict", "G", "attr_vectors.")
    dx = b.plan(cfg.dx_plan, (*cfg.image_size, in_ch), sd_D, "dx.", mapped, "D_state_dict", "D", "dx.")
    dz = b.plan(cfg.dz_plan, (1, 1, cfg.latent_dim), sd_D, "dz.", mapped, "D_state_dict", "D", "dz.")
    b.plan(cfg.dxz_plan, (1, 1, dx[-1] + dz[-1]), sd_D, "dxz.", mapped, "D_state_dict", "D", "dxz.")
    b.embeddings(cfg, sd_D, keys, 0, mapped, "D_state_dict", "D", "attr_channels.")
    return {"E_state_dict": sd_E, "G_state_dict": sd_G, "D_state_dict": sd_D}, mapped


def _vae(kind: str, seed: int, d: int):
    from ..models import vae as configs

    cfg, keys = {
        "mnist-vae": (lambda: configs.mnist_vae_config(), EMBED_KEYS["mnist"]),
        "audio-vae": (lambda: configs.audio_mnist_vae_config(d=d), EMBED_KEYS["moduledict"]),
        "whale-vae": (lambda: configs.whale_vae_config(d=d), EMBED_KEYS["moduledict"]),
    }[kind]
    cfg = cfg()
    b, mapped, sd = _Builder(seed), [], {}
    spec = cfg.attr_spec
    in_ch = cfg.image_channels + len(spec.categorical) + len(spec.continuous)
    g_in = cfg.latent_dim + cfg.embed_dim * len(spec.categorical) + len(spec.continuous)
    part = "vae_state_dict"
    out = b.plan(cfg.enc_plan + cfg.vae_trunk_tail, (*cfg.image_size, in_ch), sd, "encoder.layers.", mapped,
                 part, "module", "encoder.trunk.")
    for name, head in zip(VAE_HEADS[kind], ("mean_head", "log_var_head")):
        sd[f"encoder.{name}.weight"] = b.normal((cfg.latent_dim, out[-1], 1, 1), 1.0 / np.sqrt(out[-1]))
        sd[f"encoder.{name}.bias"] = b.normal((cfg.latent_dim,), 0.1)
        mapped += [Mapped(part, f"encoder.{name}.weight", "module", f"encoder.{head}.conv_0_kernel"),
                   Mapped(part, f"encoder.{name}.bias", "module", f"encoder.{head}.conv_0_bias")]
    b.embeddings(cfg, sd, keys, 0, mapped, part, "module", "encoder.attr_channels.", "encoder.")
    b.plan(cfg.gen_plan, (1, 1, g_in) if cfg.gen_input == "spatial" else (g_in,), sd, "decoder.layers.", mapped,
           part, "module", "decoder.trunk.")
    b.embeddings(cfg, sd, keys, 1, mapped, part, "module", "decoder.attr_vectors.", "decoder.")
    return {part: sd}, mapped


def _classifier(kind: str, seed: int, width: float, n_classes: int):
    from ..models import classifier as configs

    cfg = {
        "mnist-clf": configs.mnist_classifier_config,
        "morphomnist-oracle": configs.mnist_oracle_config,
        "audio-clf": lambda: configs.audio_mnist_classifier_config(n_classes, width=width),
        "whale-clf": lambda: configs.narw_classifier_config(width=width),
    }[kind]()
    key, mapped, sd = CLASSIFIER_KEY[kind], [], {}
    _Builder(seed).plan(cfg.plan, (*cfg.image_size, cfg.image_channels), sd, "", mapped, key, "module", "trunk.")
    return {key: sd}, mapped


def reference_checkpoint(kind: str, seed: int, d: int = 64, width: float = 1.0, n_classes: int = 10
                         ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], List[Mapped]]:
    """``(the checkpoint's dict, as torch.save takes it; the map of its
    tensors)`` for a state-dict kind of ``convert_reference_checkpoint``:
    ``d`` the spectrogram BiGANs' and VAEs' width, ``width`` and
    ``n_classes`` the spectrogram classifiers'. The port parts of the map
    are the converted file's trainer state: ``E``, ``G`` and ``D`` of a
    BiGAN, ``module`` of a VAE or classifier."""
    if kind.endswith("-bigan"):
        return _bigan(kind, seed, d)
    if kind.endswith("-vae"):
        return _vae(kind, seed, d)
    if kind in CLASSIFIER_KEY:
        return _classifier(kind, seed, width, n_classes)
    raise ValueError(f"no state-dict fixture for {kind!r}")


def check_mapped(mapped: List[Mapped], obj: Mapping, port: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    """Every mapped tensor of ``obj`` equals its port tensor in ``port``
    (``{port_part: state dict}``) bit for bit, under the map; raises
    ``AssertionError`` naming the first that does not. Returns the count."""
    for m in mapped:
        want = obj[m.ref_part][m.ref_key]
        if m.perm is not None:
            want = want.index_select(m.dim, torch.tensor(m.perm))
        got = port[m.port_part][m.port_key].detach().cpu()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{m.ref_part}[{m.ref_key}] -> {m.port_part}[{m.port_key}]: not equal")
    return len(mapped)
