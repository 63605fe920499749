"""Read checkpoints of the original PyTorch ImageCFGen (the "reference") into
the port (the port's own copy of the numpy half of
``tools/convert_reference_checkpoint.py``).

The reference saves in two conventions (SURVEY §5): state dicts, and whole
pickled modules. :func:`load_torch_tar` reads either. The functions below
map the weights onto the JAX package's parameter trees, as numpy arrays;
``core.convert``'s readers of those trees then carry them into the port's
modules, so the layouts cross the same tested path as a JAX file's.

Layout maps (reference -> JAX tree; the port's modules hold the reference's
own layouts again after ``core.convert``):

- ``Conv2d`` ``(O, I, kH, kW)`` -> HWIO;
- ``ConvTranspose2d`` ``(I, O, kH, kW)`` -> HWIO rotated by 180 degrees (the
  JAX transposed conv does not flip its kernel);
- ``Linear`` ``(O, I)`` -> ``(I, O)``; a linear layer after a flatten of a
  feature map larger than 1x1 has its inputs permuted from the reference's
  (C, H, W) order to (H, W, C), and one that feeds a reshape has its
  outputs permuted the same way (the reference unflattens to (C, H, W));
- ``Embedding`` tables unchanged;
- ``BatchNorm2d`` weight/bias -> scale/bias, running statistics -> the
  batch statistics.

Whole-module files are arbitrary pickles: loading one runs code from the
file. :func:`load_torch_tar` tries ``weights_only=True`` first and warns
before it falls back. The attribute SCM is pickled as live pyro objects; it
is read without pyro, through stand-in classes that keep each object's
pickled state (:class:`_PyroStub`), and :func:`attribute_scm_state_dict`
maps those tensors onto the port's flows.
"""
from __future__ import annotations

import importlib.util
import sys
import types
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Dict[str, object]

# ------------------------------------------------------------------ layouts


def conv_w(t) -> np.ndarray:
    """``(O, I, kH, kW)`` -> ``(kH, kW, I, O)``."""
    return np.transpose(np.asarray(t), (2, 3, 1, 0))


def convT_w(t) -> np.ndarray:
    """``(I, O, kH, kW)`` -> rotated by 180 degrees -> ``(kH, kW, I, O)``."""
    return np.ascontiguousarray(np.transpose(np.asarray(t)[:, :, ::-1, ::-1], (2, 3, 0, 1)))


def linear_w(t) -> np.ndarray:
    """``(O, I)`` -> ``(I, O)``."""
    return np.transpose(np.asarray(t), (1, 0))


def chw_to_hwc(h: int, w: int, c: int) -> np.ndarray:
    """The permutation that reorders a (C, H, W)-flattened vector as
    (H, W, C): ``v_hwc = v_chw[chw_to_hwc(h, w, c)]``."""
    return np.transpose(np.arange(h * w * c).reshape(c, h, w), (1, 2, 0)).reshape(-1)


def map_plan_params(plan, sd: Mapping[str, np.ndarray], prefix: str,
                    input_hw: Optional[Tuple[int, int]] = None) -> Tuple[Tree, Tree]:
    """Walk a plan against a reference ``nn.Sequential``'s state dict (keys
    ``{prefix}.{index}.{name}``), one index an op, parameterless ops too.
    Returns the JAX ``(params, batch_stats)`` of the plan.

    ``input_hw``: track the spatial shape through the plan, so that a dense
    layer after a flatten of a map larger than 1x1 gets its inputs permuted
    from (C, H, W) to (H, W, C)."""
    params: Tree = {}
    stats: Tree = {}
    seq_i = conv_i = bn_i = dense_i = 0
    plan = tuple(plan)
    hw = tuple(input_hw) if input_hw is not None else None
    flat_shape: Optional[Tuple[int, int, int]] = None  # (H, W, C) at a flatten

    def take(name):
        key = f"{prefix}.{seq_i}.{name}"
        if key not in sd:
            raise KeyError(f"missing {key}; have e.g. {list(sd)[:5]}")
        return np.asarray(sd[key])

    def reshape_perm(op_idx, n_out):
        # a dense op feeding a reshape to (h, w, c): the reference unflattens
        # its outputs channel-first, so permute its columns to (H, W, C)
        if op_idx + 1 < len(plan) and plan[op_idx + 1][0] == "reshape":
            h, w, c = plan[op_idx + 1][1]
            if h * w * c == n_out and (h, w) != (1, 1):
                return chw_to_hwc(h, w, c)
        return None

    for op_idx, op in enumerate(plan):
        kind = op[0]
        if kind in ("conv", "convT"):
            if kind == "conv":
                params[f"conv_{conv_i}_kernel"] = conv_w(take("weight"))
            else:
                params[f"convT_{conv_i}_kernel"] = convT_w(take("weight"))
            params[f"{kind}_{conv_i}_bias"] = take("bias")
            if hw is not None:
                k, s, p = op[2], op[3], op[4]
                if kind == "conv":
                    hw = tuple((d + 2 * p - k) // s + 1 for d in hw)
                else:
                    hw = tuple((d - 1) * s - 2 * p + k + (op[5] if len(op) > 5 else 0) for d in hw)
            conv_i += 1
        elif kind == "dense":
            w, b = linear_w(take("weight")), take("bias")
            if flat_shape is not None:
                w = w[chw_to_hwc(*flat_shape), :]
                flat_shape = None
            perm = reshape_perm(op_idx, w.shape[1])
            if perm is not None:
                w, b = w[:, perm], b[perm]
            params[f"dense_{dense_i}_kernel"] = w
            params[f"dense_{dense_i}_bias"] = b
            if hw is not None:
                hw = (1, 1)
            dense_i += 1
        elif kind == "bn":
            params[f"bn_{bn_i}"] = {"scale": take("weight"), "bias": take("bias")}
            stats[f"bn_{bn_i}"] = {"mean": take("running_mean"), "var": take("running_var")}
            bn_i += 1
        elif kind == "flatten":
            if hw is not None and hw != (1, 1):
                convs = [o for o in plan[:op_idx] if o[0] in ("conv", "convT")]
                if convs:  # the channels are the last conv's outputs
                    flat_shape = (hw[0], hw[1], convs[-1][1])
        elif kind == "reshape":
            if hw is not None:
                hw = tuple(op[1][:2])
        elif kind not in ("lrelu", "tanh", "sigmoid", "drop", "drop2d"):
            raise ValueError(f"unknown plan op {kind!r}")
        seq_i += 1  # every op holds an index of the reference's nn.Sequential
    return params, stats


# ------------------------------------------------------------------ loading


class _PyroStub:
    """Takes the pickled state of a pyro object, without pyro.

    Unpickling calls ``cls.__new__`` and ``__setstate__`` (or updates
    ``__dict__``), which keeps the pickled ``__dict__`` as it was: for an
    ``nn.Module`` subclass, its ``_parameters``, ``_buffers`` and
    ``_modules``. Attribute access falls through to those, so ``stub.nn.layers``
    reads as on a live module."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple):  # the (__dict__, __slots__) protocol
            for part in state:
                if part:
                    self.__dict__.update(part)
        elif isinstance(state, dict):
            self.__dict__.update(state)

    def __getattr__(self, name):
        d = self.__dict__
        for container in ("_parameters", "_buffers", "_modules"):
            c = d.get(container)
            if c is not None and name in c:
                return c[name]
        raise AttributeError(name)


class _StubModule(types.ModuleType):
    """A module whose unknown attributes are new :class:`_PyroStub`
    subclasses: ``pickle``'s ``find_class`` resolves any pyro class path."""

    def __init__(self, name):
        super().__init__(name)
        self.__path__ = []  # a package, so that submodule imports recurse

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        cls = type(name, (_PyroStub,), {"__module__": self.__name__})
        setattr(self, name, cls)
        return cls


class _CondTransformedDist:
    """Stand-in for pyro's ``ConditionalTransformedDistribution`` on
    ``torch.distributions``: ``condition(context)`` gives a
    ``TransformedDistribution`` (what the reference VAEs' ELBO calls).
    At module level, so that a file holding one unpickles."""

    def __init__(self, base_dist, transforms):
        self.base_dist = base_dist
        self.transforms = list(transforms)

    def condition(self, context):
        return torch.distributions.TransformedDistribution(
            self.base_dist, [t.condition(context) for t in self.transforms])


class _PyroStubFinder:
    """``sys.meta_path`` hook: importing ``pyro`` or any ``pyro.*`` module
    gives a :class:`_StubModule` (files name deep paths such as
    ``pyro.distributions.transforms.spline``)."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname == "pyro" or fullname.startswith("pyro."):
            return importlib.util.spec_from_loader(fullname, loader=self)
        return None

    def create_module(self, spec):
        return _StubModule(spec.name)

    def exec_module(self, module):
        pass


def install_reference_shims(reference_path: str = "") -> None:
    """Make a whole-module file unpicklable: the reference's sources on
    ``sys.path`` (when ``reference_path`` names them) and stand-ins for the
    packages they import that this host lacks (``pytorch_msssim``,
    ``torchaudio``, ``librosa``, ``pyro``). Known pyro classes that torch
    provides are preset; any other pyro class a file names becomes a
    :class:`_PyroStub`."""
    def shim(name, factory=types.ModuleType, **attrs):
        m = sys.modules.get(name)
        if m is None:
            m = sys.modules[name] = factory(name)
        for k, v in attrs.items():
            if k not in m.__dict__:
                setattr(m, k, v)
        return m

    shim("pytorch_msssim", ssim=lambda *a, **k: torch.tensor(0.0))
    ta = shim("torchaudio")
    ta.transforms = shim("torchaudio.transforms", Spectrogram=object, GriffinLim=object)
    shim("librosa", core=types.SimpleNamespace(resample=None), resample=None)
    if not any(type(f).__name__ == "_PyroStubFinder" for f in sys.meta_path):
        sys.meta_path.insert(0, _PyroStubFinder())
    py = shim("pyro", factory=_StubModule)
    pyd = shim("pyro.distributions", factory=_StubModule,
               MultivariateNormal=torch.distributions.MultivariateNormal,
               Normal=torch.distributions.Normal)
    pydt = shim("pyro.distributions.transforms", factory=_StubModule,
                AffineTransform=torch.distributions.transforms.AffineTransform)
    pydc = shim("pyro.distributions.conditional", factory=_StubModule,
                ConditionalTransform=type("ConditionalTransform", (), {}),
                ConditionalTransformedDistribution=_CondTransformedDist)
    py.distributions = pyd
    pyd.transforms = pydt
    pyd.conditional = pydc
    pyd.ConditionalTransformedDistribution = pydc.ConditionalTransformedDistribution
    if reference_path and reference_path not in sys.path:
        sys.path.insert(0, reference_path)


TRUST_WARNING = ("WARNING: {path} is not a plain state-dict checkpoint; falling back to "
                 "weights_only=False. Unpickling a whole-module checkpoint EXECUTES CODE from "
                 "the file — only convert checkpoints you trust.")


def load_torch_tar(path: str, reference_path: str = ""):
    """A reference checkpoint: with ``weights_only=True`` when it holds
    tensors only; else, after a warning on stderr, as a whole pickle under
    :func:`install_reference_shims` (which runs code from the file)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 - any refusal of the safe loader means "not a state dict"
        pass
    print(TRUST_WARNING.format(path=path), file=sys.stderr)
    install_reference_shims(reference_path)
    return torch.load(path, map_location="cpu", weights_only=False)


def to_numpy(sd: Mapping) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v) for k, v in sd.items()}


def state_dict_of(obj: Mapping, key_module: str, key_sd: str) -> Dict[str, np.ndarray]:
    """Either convention: ``obj[key_sd]`` a state dict, or ``obj[key_module]``
    a whole module."""
    if key_sd in obj:
        return to_numpy(obj[key_sd])
    if key_module in obj:
        return to_numpy(obj[key_module].state_dict())
    raise KeyError(f"neither {key_module} nor {key_sd} in checkpoint: {list(obj)}")


def seq_state_dict(obj: Mapping, keys: Sequence[str]) -> Dict[str, np.ndarray]:
    """The reference classifiers are bare ``nn.Sequential``s saved under one
    of several keys, as a state dict or whole; their keys come back as
    ``seq.{index}.{name}``."""
    for k in keys:
        if k in obj:
            v = obj[k]
            sd = to_numpy(v if isinstance(v, Mapping) else v.state_dict())
            return {f"seq.{kk}": vv for kk, vv in sd.items()}
    raise KeyError(f"none of {tuple(keys)} in checkpoint: {list(obj)}")


def load_spect_stats(stats_prefix: str, height: int) -> Tuple[np.ndarray, np.ndarray, bool]:
    """The reference's statistics, ``{prefix}_mean.npy`` and
    ``{prefix}_std.npy`` (one value a frequency row,
    ``classifiers/audio_mnist.py:200-219``), and True; without a prefix,
    zeros and ones of ``(height, 1)`` and False."""
    if stats_prefix:
        return np.load(stats_prefix + "_mean.npy"), np.load(stats_prefix + "_std.npy"), True
    return np.zeros((height, 1), np.float32), np.ones((height, 1), np.float32), False


# ------------------------------------------------------------------ BiGANs and VAEs

# each family's state-dict keys of an embedded attribute: (E's and D's, G's)
EmbedKeys = Callable[[str], Tuple[str, str]]


def embed_keys_mnist(attr: str) -> Tuple[str, str]:
    return "digit_embedding.0.weight", "digit_embedding.weight"


def embed_keys_moduledict(attr: str) -> Tuple[str, str]:
    return f"embedding_dict.{attr}.0.weight", f"embedding_dict.{attr}.weight"


def embed_keys_esrf(attr: str) -> Tuple[str, str]:
    return "has_boat_embedding.0.weight", "has_boat_embedding.weight"


def _channels(cfg, sd: Mapping, embed_keys: EmbedKeys) -> Tree:
    return {f"embed_{a.name}": {"embedding": np.asarray(sd[embed_keys(a.name)[0]])}
            for a in cfg.attr_spec.categorical}


def _vectors(cfg, sd: Mapping, embed_keys: EmbedKeys) -> Tree:
    return {f"embed_{a.name}": np.asarray(sd[embed_keys(a.name)[1]]) for a in cfg.attr_spec.categorical}


def bigan_tree(cfg, sd_E: Mapping, sd_G: Mapping, sd_D: Mapping, embed_keys: EmbedKeys
               ) -> Tuple[Tree, Tree, Tree]:
    """The reference's E, G and D state dicts -> the JAX ``(params_E,
    params_G, vars_D)`` of ``cfg``."""
    trunk_E, _ = map_plan_params(cfg.enc_plan, sd_E, "layers")
    trunk_G, _ = map_plan_params(cfg.gen_plan, sd_G, "layers")
    dx, dx_stats = map_plan_params(cfg.dx_plan, sd_D, "dx")
    dz, _ = map_plan_params(cfg.dz_plan, sd_D, "dz")
    dxz, _ = map_plan_params(cfg.dxz_plan, sd_D, "dxz")
    params_D = {"dx": dx, "dz": dz, "dxz": dxz, "attr_channels": _channels(cfg, sd_D, embed_keys)}
    return ({"trunk": trunk_E, "attr_channels": _channels(cfg, sd_E, embed_keys)},
            {"trunk": trunk_G, "attr_vectors": _vectors(cfg, sd_G, embed_keys)},
            {"params": params_D, "batch_stats": {"dx": dx_stats}})


def fresh_adam(params: Tree):
    """optax.adam's state before its first update, for a tree shaped like
    ``params``: ``(ScaleByAdamState(count 0, mu 0, nu 0), EmptyState())``."""
    def zeros(t):
        if isinstance(t, Mapping):
            return {k: zeros(v) for k, v in t.items()}
        return np.zeros(np.shape(t), np.float32)
    return ({"count": 0, "mu": zeros(params), "nu": zeros(params)}, {})


def bigan_train_tree(params_E: Tree, params_G: Tree, vars_D: Tree) -> Tree:
    """A JAX ``GANState``'s tree that warm-starts: the converted modules,
    fresh Adam states, step 0 (``_fresh_bigan_state`` of the JAX tool)."""
    return {"params_E": params_E, "params_G": params_G, "vars_D": vars_D,
            "opt_eg": fresh_adam({"E": params_E, "G": params_G}),
            "opt_d": fresh_adam(vars_D["params"]), "step": 0}


def vae_tree(cfg, sd: Mapping, head_names: Tuple[str, str], embed_keys: EmbedKeys) -> Tree:
    """A reference VAE's state dict (keys ``encoder.*`` and ``decoder.*``)
    -> the JAX ``{"encoder", "decoder"}`` params of ``cfg``;
    ``head_names``: the torch names of its mean and log-variance convs."""
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    trunk_E, _ = map_plan_params(cfg.enc_plan + cfg.vae_trunk_tail, enc, "layers")
    trunk_D, _ = map_plan_params(cfg.gen_plan, dec, "layers")

    def head(name):
        return {"conv_0_kernel": conv_w(enc[f"{name}.weight"]), "conv_0_bias": np.asarray(enc[f"{name}.bias"])}

    return {"encoder": {"trunk": trunk_E, "attr_channels": _channels(cfg, enc, embed_keys),
                        "mean_head": head(head_names[0]), "log_var_head": head(head_names[1])},
            "decoder": {"trunk": trunk_D, "attr_vectors": _vectors(cfg, dec, embed_keys)}}


def classifier_tree(cfg, sd: Mapping) -> Tree:
    """``seq_state_dict``'s keys -> the JAX classifier's ``{"trunk"}``."""
    params, _ = map_plan_params(cfg.plan, sd, "seq", input_hw=cfg.image_size)
    return {"trunk": params}


# ------------------------------------------------------------------ the attribute SCM


def _stub_tensors(stub) -> Dict[str, np.ndarray]:
    """Every parameter and buffer held by an unpickled module (or stub)."""
    out = {}
    for container in ("_parameters", "_buffers"):
        for k, v in (getattr(stub, container, None) or {}).items():
            if v is not None:
                out[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)
    return out


def _masked_linear_eff(layer) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(effective weight ``(O, I)``, bias, mask or None) of a pyro
    ``MaskedLinear``: its forward multiplies the weight by the mask
    (``pyro.nn.auto_reg_nn``), so the weight that acts is ``weight * mask``."""
    t = _stub_tensors(layer)
    w = t["weight"]
    mask = t.get("mask")
    if mask is not None:
        w = w * mask
    return w, t.get("bias", np.zeros(w.shape[0], np.float32)), mask


def _convert_cond_affine(caa) -> Tuple[list, Tuple[int, ...], Tuple[float, float]]:
    """pyro's ``ConditionalAffineAutoregressive`` (input_dim 1) -> the port's
    ``ConditionalAffineT`` MLP ``[{"w": (I, O), "b"}]``, its hidden widths
    and log-scale clip. The hypernet reads ``cat([context, x])``; for
    input_dim 1 the autoregressive mask zeroes every x column, so the net is
    MLP(context) -> (loc, log_scale). The context columns are read from the
    first layer's mask (any nonzero entry), not assumed."""
    layer_list = getattr(caa.nn, "layers", None)
    if layer_list is None:
        raise SystemExit("conditional affine hypernet has no layers")
    layers = list(layer_list._modules.values()) if hasattr(layer_list, "_modules") else list(layer_list)
    mlp = []
    for i, layer in enumerate(layers):
        w, b, mask = _masked_linear_eff(layer)
        if i == 0:
            if mask is None:
                raise SystemExit("first hypernet layer has no mask buffer")
            ctx_cols = np.where(mask.any(axis=0))[0]
            dead = np.setdiff1d(np.arange(w.shape[1]), ctx_cols)
            if dead.size and np.abs(w[:, dead]).max() != 0.0:
                raise SystemExit("the masked x columns of the first hypernet layer are not zero")
            w = w[:, ctx_cols]
        mlp.append({"w": np.ascontiguousarray(w.T), "b": b})
    if mlp[-1]["w"].shape[1] != 2:
        raise SystemExit(f"the hypernet gives {mlp[-1]['w'].shape[1]} outputs, not (loc, log_scale)")
    hidden = tuple(layer["w"].shape[1] for layer in mlp[:-1])
    clip = (float(getattr(caa, "log_scale_min_clip", -5.0)), float(getattr(caa, "log_scale_max_clip", 3.0)))
    return mlp, hidden, clip


def attribute_scm_state_dict(obj) -> Tuple[Dict, Dict]:
    """The reference's pickled MNIST attribute SCM (``{'graph':
    CausalModuleGraph}``, ``train_mnist_attribute_scm.py:32``) -> (the JAX
    ``MNISTAttributeSCM.state_dict()`` form in numpy, what the port's graph
    must hold: ``count_bins``, ``bound``, ``clip``, ``n_digit``). Raises
    ``SystemExit`` on other nodes or edges.

    - thickness: pyro ``BatchNorm`` + Exp; pyro keeps gamma unconstrained
      (``relu(gamma) + 1e-6`` acts), so ``log_gamma = log(relu(gamma) + 1e-6)``;
    - intensity | thickness: conditional affine + Sigmoid + Affine;
    - slant: pyro ``Spline`` (order ``linear`` -> the linear-rational spline,
      ``quadratic`` -> rational-quadratic) + Affine;
    - digit: a Categorical's ``probs`` (-> log, floored at 1e-12) or logits.
    """
    graph = obj["graph"] if isinstance(obj, Mapping) and "graph" in obj else obj
    mods = graph.modules
    expected = {"thickness", "intensity", "slant", "digit"}
    if set(mods) != expected:
        raise SystemExit(f"unexpected SCM nodes {sorted(mods)} (want {sorted(expected)})")
    edges = {(u, v) for u, vs in graph.adj.items() for v in vs}
    if edges != {("thickness", "intensity")}:
        raise SystemExit(f"unexpected SCM edges {sorted(edges)}")

    bn, _exp = list(mods["thickness"].td.transforms)
    bn_t = _stub_tensors(bn)
    if "gamma" in bn_t:
        log_gamma = np.log(np.maximum(bn_t["gamma"], 0.0) + 1e-6)
    elif "log_gamma" in bn_t:
        log_gamma = bn_t["log_gamma"]
    else:
        raise SystemExit(f"unrecognised BatchNorm params {sorted(bn_t)}")

    caa, _sig, aff_i = list(mods["intensity"].ctd.transforms)
    mlp, cond_hidden, clip = _convert_cond_affine(caa)

    sp, aff_s = list(mods["slant"].td.transforms)
    sp_t = _stub_tensors(sp)
    spline_kind = "linear" if getattr(sp, "order", "linear") == "linear" else "rq"
    spline = {"widths": sp_t["unnormalized_widths"], "heights": sp_t["unnormalized_heights"],
              "derivs": sp_t["unnormalized_derivatives"]}
    if spline_kind == "linear":
        spline["lambdas"] = sp_t["unnormalized_lambdas"]

    d = mods["digit"].d
    if "probs" in d.__dict__ or hasattr(d, "probs"):
        probs = np.asarray(d.__dict__.get("probs", getattr(d, "probs", None)))
        logits = np.log(np.maximum(probs.astype(np.float64), 1e-12))
    else:
        logits = np.asarray(d.logits)
    logits = np.asarray(logits, np.float32).reshape(-1)

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    i_lo, i_rng = float(np.asarray(aff_i.loc)), float(np.asarray(aff_i.scale))
    s_lo, s_rng = float(np.asarray(aff_s.loc)), float(np.asarray(aff_s.scale))
    sd = {
        "params": {
            "thickness": ({"log_gamma": f32(log_gamma), "beta": f32(bn_t["beta"])}, {}),
            "intensity": ({"mlp": [{"w": f32(m["w"]), "b": f32(m["b"])} for m in mlp]}, {}, {}),
            "slant": ({k: f32(v) for k, v in spline.items()}, {}),
            "digit": {"logits": logits},
        },
        "state": {
            "thickness": ({"mean": f32(bn_t["moving_mean"]), "var": f32(bn_t["moving_variance"])}, {}),
            "intensity": ({}, {}, {}),
            "slant": ({}, {}),
            "digit": {},
        },
        "bounds": {"intensity": (i_lo, i_rng), "slant": (s_lo, s_rng)},
        "arch": {"cond_hidden": cond_hidden, "spline": spline_kind},
    }
    need = {"count_bins": spline["widths"].shape[-1], "bound": float(getattr(sp, "bound", 3.0)),
            "clip": clip, "n_digit": logits.shape[0]}
    return sd, need
