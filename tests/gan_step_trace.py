"""A BiGAN's first steps in both packages on the CPU, side by side: the
port's trainer and the JAX package's, from the same parameters (the JAX
CLI's initialisation at ``--seed``), on the training split the JAX CLI
trains on, with the same noise in both (``z`` from the key the JAX step
splits off, the dropout masks drawn with numpy and fed to both, the same
numpy permutation each epoch). Each step's D(G(z)) and D(E(x)) in both and
the relative distance ``|port - jax| / |jax|`` of E's, G's and D's
parameters are printed and written as JSON.

    python tests/gan_step_trace.py DIR [--steps 256] [--seed 0] [--out DIR/gan-step-trace.json]
    python tests/gan_step_trace.py --family audio [--d 64] [--init-std 0.01] [--steps 8] [--max-seconds 7200]
        [--out PATH] [--save-jax PATH]

``--family mnist`` (the default): the MNIST BiGAN at the CLI's settings
(batch 64, three D updates an E+G update, Adam 1e-4) on a battery's
training split in ``DIR`` (``mnist-{x,a}-train.npy``), scaled as the JAX CLI
scales it. ``--family audio``: the AudioMNIST BiGAN of the float32 identity
arm (``train_audio_mnist_bigan.py --d 64 --init-std 0.01``: batch 128, one D
update a step, Adam 1e-4 with betas (0.5, 0.9)) on the synthetic stand-in's
training spectrograms as that script prepares them; its D has no dropout.
Tracing stops after ``--steps`` steps or, once a step has ended, after
``--max-seconds``; the record says how many ran, with each step's seconds
in each package. ``--save-jax`` writes the JAX state at the end as the JAX
CLI writes its BiGAN (``save_audio_bigan``). JAX runs in exact float32 on
the CPU, jit on for each step (the masks are its arguments), the transposed
convs summed by phase as in ``tests/jax_cpu_battery.py``; a full-width MNIST
step takes about a second in each package on 8 cores.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
AUDIO = {"batch": 128, "learning_rate": 1e-4, "betas": (0.5, 0.9), "d_updates_per_g_update": 1}


def distance(want, have):
    """E's, G's and D's relative distance over their parameters (not D's
    batch-norm statistics), in float64."""
    out = {}
    for part in ("E", "G", "D"):
        names = [n for n in want[part] if not n.endswith((".mean", ".var"))]
        num = sum(float(((have[part][n].double() - want[part][n].double()) ** 2).sum()) for n in names)
        den = sum(float((want[part][n].double() ** 2).sum()) for n in names)
        out[part] = (num / den) ** 0.5
    return out


def mnist_setup(data_dir: str, seed: int):
    """(the JAX trainer and state, the port's trainer, images, attributes,
    header) of the MNIST BiGAN at its CLI's settings."""
    import jax

    from imagecfgen_tpu.cli.common import load_mnist_training_data, scale_attrs_np
    from imagecfgen_tpu.models import bigan as jbigan
    from imagecfgen_tpu.train import gan_trainer as jgt
    from imagecfgen_torch.models import bigan as tbigan
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    b, kw = 64, dict(learning_rate=1e-4, d_updates_per_g_update=3)
    x, attrs, scaler = load_mnist_training_data(data_dir, "train")
    a = scale_attrs_np(scaler, attrs)
    jtr = jgt.GANTrainer(jbigan.BiGAN(jbigan.mnist_bigan_config()), jgt.GANTrainConfig(batch_size=b, **kw))
    st = jtr.init_state(jax.random.PRNGKey(seed))
    tr = GANTrainer(tbigan.BiGAN(tbigan.mnist_bigan_config(), "cpu"), GANTrainConfig(batch_size=b, **kw),
                    device="cpu")
    return jtr, st, tr, x, a, {"seed": seed, "batch": b, **kw}


def audio_setup(seed: int, d: int = 64, init_std: float = 0.01, batch: int = AUDIO["batch"], data=None):
    """The same for the AudioMNIST BiGAN at the identity arm's flags, on
    ``data`` (the JAX package's ``AudioMNISTData``; the full stand-in when
    None). Also returns the spectrogram statistics and the data."""
    import jax

    from imagecfgen_tpu.cli.audio_common import load_audio_dataset, prepare_training_arrays
    from imagecfgen_tpu.models import bigan as jbigan
    from imagecfgen_tpu.train import gan_trainer as jgt
    from imagecfgen_torch.models import bigan as tbigan
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    data = load_audio_dataset(None) if data is None else data
    x, attrs, stats = prepare_training_arrays(data)
    kw = dict(learning_rate=AUDIO["learning_rate"], betas=AUDIO["betas"], batch_size=batch,
              d_updates_per_g_update=AUDIO["d_updates_per_g_update"])
    jcfg = dataclasses.replace(jbigan.audio_mnist_bigan_config(d=d), init_std=init_std)
    jtr = jgt.GANTrainer(jbigan.BiGAN(jcfg), jgt.GANTrainConfig(**kw))
    st = jtr.init_state(jax.random.PRNGKey(seed))
    tcfg = dataclasses.replace(tbigan.audio_mnist_bigan_config(d=d), init_std=init_std)
    tr = GANTrainer(tbigan.BiGAN(tcfg, "cpu"), GANTrainConfig(**kw), device="cpu")
    header = {"family": "audio", "seed": seed, "d": d, "init_std": init_std, "batch": batch,
              "learning_rate": kw["learning_rate"], "betas": list(kw["betas"]),
              "d_updates_per_g_update": kw["d_updates_per_g_update"]}
    return jtr, st, tr, x, {k: v.astype("float32") for k, v in attrs.items()}, header, stats, data


def trace(jtr, st, tr, x, attrs, seed: int, steps: int, max_seconds: float = float("inf"), log=print,
          timed: bool = False):
    """Both packages' steps from the JAX state ``st`` (loaded into ``tr``);
    returns (the rows, each with its seconds in each package when
    ``timed``, and the JAX state at the end)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax_cpu_battery import phase_conv_transpose2d
    from test_torch_gan_trainer import as_tree
    from test_torch_train_layers import MaskQueue, draw_masks

    from imagecfgen_tpu.models import layers as jlayers
    from imagecfgen_torch.core.convert import gan_state_from_jax

    saved = jlayers.conv_transpose2d, jlayers.channel_dropout
    jlayers.conv_transpose2d = phase_conv_transpose2d
    queue = MaskQueue()  # after the init, which runs D's dropout once
    jlayers.channel_dropout = queue

    def step(st, batch, masks):
        queue.masks = list(masks)  # tracers, taken in program order
        out = jtr.train_step(st, batch)
        assert not queue.masks
        return out

    try:
        jstep = jax.jit(step)
        tr.load_state_dict(gan_state_from_jax(as_tree(st)))
        D, b = tr.model.discriminator, tr.tcfg.batch_size
        sizes, latent = tr.d_batches(b), tr.model.cfg.latent_dim
        rng = np.random.default_rng(seed + 1000)
        per_epoch = len(x) // b
        rows, perm, t0 = [], None, time.perf_counter()
        for i in range(steps):
            if i % per_epoch == 0:
                perm = rng.permutation(len(x))
            idx = perm[(i % per_epoch) * b:(i % per_epoch + 1) * b]
            batch = {"image": x[idx], "attrs": {k: v[idx] for k, v in attrs.items()}}
            masks = [draw_masks(D, n, rng) for n in sizes]
            z = np.asarray(jax.random.normal(jax.random.split(st.rng, 9)[1], (b, 1, 1, latent)))
            t1 = time.perf_counter()
            st, ref = jstep(st, jax.tree_util.tree_map(jnp.asarray, batch),
                            [jnp.asarray(m) for fwd in masks for m in fwd])
            ref = {k: float(v) for k, v in ref.items()}  # waits for the step
            t2 = time.perf_counter()
            got = tr.train_step({"image": torch.from_numpy(batch["image"]),
                                 "attrs": {k: torch.from_numpy(v) for k, v in batch["attrs"].items()}},
                                z=torch.from_numpy(z), masks=[[torch.from_numpy(m) for m in fwd] for fwd in masks])
            got = {k: v.item() for k, v in got.items()}
            t3 = time.perf_counter()
            dist = distance(gan_state_from_jax(as_tree(st)), tr.state_dict())
            row = {"step": i + 1, "jax": [ref["D_score"], ref["EG_score"]],
                   "port": [got["D_score"], got["EG_score"]], "distance": dist}
            if timed:
                row["seconds"] = {"jax": t2 - t1, "port": t3 - t2}
            rows.append(row)
            log(json.dumps(row) + f" ({time.perf_counter() - t0:.0f} s)")
            if time.perf_counter() - t0 >= max_seconds:
                break
    finally:
        jlayers.conv_transpose2d, jlayers.channel_dropout = saved
    return rows, st


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dir", nargs="?", help="the MNIST battery's data directory (--family mnist)")
    p.add_argument("--family", choices=("mnist", "audio"), default="mnist")
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--d", type=int, default=64, help="--family audio: the channel multiplier")
    p.add_argument("--init-std", type=float, default=0.01, help="--family audio: the conv init std")
    p.add_argument("--max-seconds", type=float, default=float("inf"))
    p.add_argument("--out", default=None)
    p.add_argument("--save-jax", default=None, help="--family audio: write the JAX state here at the end")
    args = p.parse_args(argv)
    if args.family == "mnist" and not args.dir:
        p.error("--family mnist takes the battery's data directory")
    os.environ["IMAGECFGEN_PLATFORM"] = "cpu"
    sys.path[:0] = [REPO, HERE]
    import jax

    jax.config.update("jax_platforms", "cpu")
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.family == "mnist":
        jtr, st, tr, x, a, header = mnist_setup(args.dir, args.seed)
        rows, _ = trace(jtr, st, tr, x, a, args.seed, args.steps, args.max_seconds, log)
        out = args.out or os.path.join(args.dir, "gan-step-trace.json")
    else:
        jtr, st, tr, x, a, header, stats, data = audio_setup(args.seed, args.d, args.init_std)
        rows, st = trace(jtr, st, tr, x, a, args.seed, args.steps, args.max_seconds, log, timed=True)
        header["steps_traced"] = len(rows)
        out = args.out or "gan-step-trace-audio.json"
        if args.save_jax:
            from imagecfgen_tpu.cli.audio_common import save_audio_bigan

            save_audio_bigan(args.save_jax, st, stats, data, meta={"epoch": 0, "d": args.d})
    with open(out, "w") as f:
        json.dump({**header, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
