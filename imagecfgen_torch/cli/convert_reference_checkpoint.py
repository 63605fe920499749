"""Convert a checkpoint of the original PyTorch ImageCFGen (the reference)
into the port's own files (port of ``tools/convert_reference_checkpoint.py``).

    python -m imagecfgen_torch.cli.convert_reference_checkpoint --kind KIND \
        --input reference.tar --output out.tar [--data-dir D] [--stats-prefix P] \
        [--attribute digit] [--reference-path SRC] [--device cuda|cpu]

Kinds, with the reference's save sites:

- ``mnist-bigan``: ``image_scms/mnist.py:302-313`` (state dicts) and
  ``train_mnist_image_scm.py:61-67`` (whole modules); ``--data-dir`` refits
  the attribute scaler on the training split;
- ``audio-bigan``, ``whale-bigan``, ``esrf-bigan``: ``audiomnist_bigan_score.py:33-37``,
  ``whale_cf_score.py:13-15``, ``esrf_acoustic.py:280-284``; the width ``d``
  is read from the first encoder conv, ``--stats-prefix`` names the
  spectrogram statistics;
- ``mnist-vae``, ``audio-vae``, ``whale-vae``: ``{'vae': module}`` or
  ``{'vae_state_dict': ...}``;
- ``mnist-clf`` (``{'clf'|'model'}``), ``morphomnist-oracle``
  (``{'oracle'}``), ``audio-clf`` (``{'model'}``, ``--attribute`` digit,
  gender, ... or subject), ``whale-clf`` (``{'clf'}``);
- ``attribute-scm``: the pyro-pickled MNIST attribute SCM, read without pyro.

The output is the port's format (``core.checkpoint.save_train_state``, magic
``ICFP``), written through the CLIs' shared savers: the port's CLIs read it,
the JAX package's do not. A BiGAN, VAE or classifier file holds fresh Adam
states and step 0, so that a training CLI warm-starts from it. Without
``--data-dir`` (``--stats-prefix``) the scaler (the statistics) is an
identity placeholder and the meta says ``scaler_valid`` (``stats_valid``)
false. Where the JAX tool fixes a width (the VAEs' ``d``, the spectrogram
classifiers' ``width``), the port reads it from the file's first conv.

Security: a state-dict file loads with ``torch.load(weights_only=True)``. A
whole-module file is an arbitrary pickle, and loading it runs code from the
file: the converter falls back to it only after the safe path fails, warns on
stderr, and needs the reference's sources on ``sys.path``
(``--reference-path``) for their classes.
"""
from argparse import ArgumentParser
import sys

import numpy as np

KINDS = ("mnist-bigan", "audio-bigan", "whale-bigan", "esrf-bigan", "mnist-vae", "audio-vae", "whale-vae",
         "mnist-clf", "morphomnist-oracle", "audio-clf", "whale-clf", "attribute-scm")

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--kind", choices=sorted(KINDS), required=True)
parser.add_argument("--input", required=True)
parser.add_argument("--output", required=True)
parser.add_argument("--data-dir", default="",
                    help="(mnist-bigan, mnist-vae) training npy dir to refit the attribute scaler")
parser.add_argument("--stats-prefix", default="",
                    help="(spectrogram kinds) path prefix of {prefix}_mean.npy/{prefix}_std.npy "
                         "per-row spectrogram stats")
parser.add_argument("--attribute", default="digit", help="(audio-clf) target attribute (or 'subject')")
parser.add_argument("--reference-path", default="",
                    help="directory of the reference's sources, for whole-module unpickling")
parser.add_argument("--device", type=str, default="cuda",
                    help="where the converted modules are built and checked: cuda (default) or cpu")


def _mnist_scaler(data_dir: str):
    from ..core.attributes import MNIST_SPEC, AttributeScaler

    if data_dir:
        from ..data.mnist import load_mnist_arrays

        return AttributeScaler.fit(MNIST_SPEC, load_mnist_arrays(data_dir, "train")[1])
    cont = ("thickness", "intensity", "slant")
    print("warning: no --data-dir; scaler saved with identity-ish bounds — refit before use "
          "(checkpoint is marked scaler_valid=false)")
    return AttributeScaler(MNIST_SPEC, {k: 0.0 for k in cont}, {k: 1.0 for k in cont})


def _stats(stats_prefix: str, height: int):
    import torch

    from ..core.reference import load_spect_stats
    from ..ops.spectral import SpectStats

    mean, std, valid = load_spect_stats(stats_prefix, height)
    if not valid:
        print("warning: no --stats-prefix; spectrogram stats saved as identity — recompute from data "
              "before eval (checkpoint is marked stats_valid=false)")
    return SpectStats(torch.as_tensor(np.asarray(mean)), torch.as_tensor(np.asarray(std))), valid


def _fresh_trainer_state(module):
    """A ``SupervisedTrainer.state_dict()`` before its first step: the
    module's state, zero Adam moments, step 0, no generator."""
    import torch

    named = [(n, p.detach().cpu()) for n, p in module.named_parameters()]
    return {"module": {k: v.detach().cpu() for k, v in module.state_dict().items()},
            "opt": {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in named},
                    "nu": {n: torch.zeros_like(p) for n, p in named}},
            "step": 0, "rng": None}


def _bigan(kind: str, obj, path_in: str, path_out: str, device, data_dir: str, stats_prefix: str) -> None:
    from ..core import reference as ref
    from ..core.convert import gan_state_from_jax
    from ..models import bigan as configs
    from .common import bigan_from_state, save_bigan, save_spect_trainer

    sd_E = ref.state_dict_of(obj, "E", "E_state_dict")
    sd_G = ref.state_dict_of(obj, "G", "G_state_dict")
    sd_D = ref.state_dict_of(obj, "D", "D_state_dict")
    if kind == "mnist-bigan":
        cfg, embed_keys = configs.mnist_bigan_config(), ref.embed_keys_mnist
    else:  # the reference constructors take a width: read it from E's first conv
        d = int(np.asarray(sd_E["layers.0.weight"]).shape[0])
        config_fn, embed_keys = {
            "audio-bigan": (configs.audio_mnist_bigan_config, ref.embed_keys_moduledict),
            "whale-bigan": (configs.whale_bigan_config, ref.embed_keys_moduledict),
            "esrf-bigan": (configs.esrf_bigan_config, ref.embed_keys_esrf),
        }[kind]
        cfg = config_fn(d=d)
    state = gan_state_from_jax(ref.bigan_train_tree(*ref.bigan_tree(cfg, sd_E, sd_G, sd_D, embed_keys)))
    bigan_from_state(state, cfg, device)  # every tensor loads into the port's modules
    if kind == "mnist-bigan":
        save_bigan(path_out, state, _mnist_scaler(data_dir),
                   meta={"converted_from": path_in, "scaler_valid": bool(data_dir)})
        return
    stats, valid = _stats(stats_prefix, cfg.image_size[0])
    meta_kind = {"audio-bigan": "bigan-audio-mnist", "whale-bigan": "bigan-whale", "esrf-bigan": "bigan-esrf"}[kind]
    save_spect_trainer(path_out, state, stats, meta_kind,
                       {"converted_from": path_in, "stats_valid": valid, "d": d})


def _vae(kind: str, obj, path_in: str, path_out: str, device, data_dir: str) -> None:
    from ..core import reference as ref
    from ..core.checkpoint import save_train_state
    from ..core.convert import vae_params_from_jax, vae_trainer_state_from_jax
    from ..models import vae as configs
    from .common import save_vae

    if "vae_state_dict" in obj:
        sd = ref.to_numpy(obj["vae_state_dict"])
    elif "vae" in obj:
        sd = ref.to_numpy(obj["vae"].state_dict())
    else:
        raise KeyError(f"neither vae nor vae_state_dict in checkpoint: {list(obj)}")
    meta = {"converted_from": path_in}
    if kind == "mnist-vae":
        cfg, heads, embed_keys = configs.mnist_vae_config(), ("mean_linear", "log_var_linear"), ref.embed_keys_mnist
    else:
        meta["d"] = int(np.asarray(sd["encoder.layers.0.weight"]).shape[0])
        if kind == "audio-vae":
            cfg, heads = configs.audio_mnist_vae_config(d=meta["d"]), ("mean", "log_var")
        else:
            cfg, heads = configs.whale_vae_config(d=meta["d"]), ("mean_linear", "log_var_linear")
        embed_keys = ref.embed_keys_moduledict
    params = ref.vae_tree(cfg, sd, heads, embed_keys)
    vae_params_from_jax(params, cfg, device)  # every tensor loads into the port's module
    state = vae_trainer_state_from_jax({"params": params, "opt": ref.fresh_adam(params), "step": 0})
    if kind == "mnist-vae":
        save_vae(path_out, state, _mnist_scaler(data_dir),
                 meta={**meta, "scaler_valid": bool(data_dir)})
    else:  # the reference's VAE files carry no spectrogram statistics, nor do these
        save_train_state(path_out, {"trainer": state},
                         meta={"kind": {"audio-vae": "vae-audio-mnist", "whale-vae": "vae-whale"}[kind],
                               "carries_rng": False, **meta})


def _classifier(kind: str, obj, path_in: str, path_out: str, device, stats_prefix: str,
                attribute: str) -> None:
    from ..core import reference as ref
    from ..core.convert import classifier_params_from_jax
    from ..models import classifier as configs
    from .common import save_classifier, save_spect_classifier

    keys = {"mnist-clf": ("clf", "model", "clf_state_dict"), "morphomnist-oracle": ("oracle", "model", "clf"),
            "audio-clf": ("model", "clf"), "whale-clf": ("clf", "model")}[kind]
    sd = ref.seq_state_dict(obj, keys)
    meta = {"converted_from": path_in}
    if kind in ("mnist-clf", "morphomnist-oracle"):
        cfg = configs.mnist_classifier_config() if kind == "mnist-clf" else configs.mnist_oracle_config()
        meta["kind"] = "mnist-clf" if kind == "mnist-clf" else "mnist-oracle"
    else:  # the width scales every channel count: read it from the first conv (32 channels at 1.0)
        width = float(np.asarray(sd["seq.0.weight"]).shape[0]) / 32.0
        if kind == "audio-clf":
            from ..scm.audio_mnist import CARDINALITIES

            n_classes = 60 if attribute == "subject" else CARDINALITIES[attribute]
            cfg = configs.audio_mnist_classifier_config(n_classes, width=width)
            meta.update(kind="audio-mnist-clf", attribute=attribute, n_classes=n_classes)
        else:
            cfg = configs.narw_classifier_config(width=width)
            meta["kind"] = "whale-clf"
        meta["width"] = width
    state = _fresh_trainer_state(classifier_params_from_jax(ref.classifier_tree(cfg, sd), cfg, device))
    if kind in ("mnist-clf", "morphomnist-oracle"):
        save_classifier(path_out, state, meta=meta)
        return
    stats, valid = _stats(stats_prefix, cfg.image_size[0])
    save_spect_classifier(path_out, state, stats, {**meta, "stats_valid": valid})


def _attribute_scm(obj, path_out: str, device) -> None:
    from ..core.convert import scm_from_jax_state_dict
    from ..core.reference import attribute_scm_state_dict
    from .common import save_attribute_scm

    sd, need = attribute_scm_state_dict(obj)
    scm = scm_from_jax_state_dict(sd, device)
    spline = scm.graph.modules["slant"].flow.chain.bijectors[0]
    if (spline.count_bins, spline.bound) != (need["count_bins"], need["bound"]):
        raise SystemExit("non-default pyro Spline hyperparameters "
                         f"(count_bins={need['count_bins']}, bound={need['bound']}) are not supported")
    if scm.graph.modules["intensity"].flow.chain.bijectors[0].log_scale_clip != need["clip"]:
        raise SystemExit(f"non-default log-scale clip {need['clip']} is not supported")
    if need["n_digit"] != 10:
        raise SystemExit(f"the digit node has {need['n_digit']} classes, not 10")
    save_attribute_scm(path_out, scm)
    cond = scm.graph.modules["intensity"].flow.chain.bijectors[0]
    print(f"wrote {path_out} (attribute-scm: BatchNorm+Exp / cond-affine{list(cond.hidden)} / "
          f"{sd['arch']['spline']}-spline K={need['count_bins']} / Categorical({need['n_digit']}))")


def convert(kind: str, path_in: str, path_out: str, device=None, data_dir: str = "", stats_prefix: str = "",
            attribute: str = "digit", reference_path: str = "") -> None:
    """One conversion, as the command line runs it."""
    from ..core.reference import load_torch_tar
    from ..device import resolve_device

    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; choose from {KINDS}")
    device = resolve_device(device)
    obj = load_torch_tar(path_in, reference_path)
    if kind == "attribute-scm":
        _attribute_scm(obj, path_out, device)
        return
    if kind.endswith("-bigan"):
        _bigan(kind, obj, path_in, path_out, device, data_dir, stats_prefix)
    elif kind.endswith("-vae"):
        _vae(kind, obj, path_in, path_out, device, data_dir)
    else:
        _classifier(kind, obj, path_in, path_out, device, stats_prefix, attribute)
    print(f"wrote {path_out}")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    convert(args.kind, args.input, args.output, args.device, data_dir=args.data_dir,
            stats_prefix=args.stats_prefix, attribute=args.attribute, reference_path=args.reference_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
