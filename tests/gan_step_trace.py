"""The MNIST BiGAN's first steps in both packages on the CPU, side by side:
the port's trainer and the JAX package's, from the same parameters (the JAX
CLI's initialisation at ``--seed``), on a battery's training split scaled as
the JAX CLI scales it, with the same noise in both (``z`` from the key the
JAX step splits off, the dropout masks drawn with numpy and fed to both, the
same numpy permutation each epoch), at the CLI's settings (batch 64, three
D updates an E+G update, Adam 1e-4). Each step's D(G(z)) and D(E(x)) in both
and the relative distance ``|port - jax| / |jax|`` of E's, G's and D's
parameters are printed and written as JSON.

    python tests/gan_step_trace.py DIR [--steps 256] [--seed 0] [--out DIR/gan-step-trace.json]

``DIR`` holds the battery's ``mnist-{x,a}-train.npy``. JAX runs in exact
float32 on the CPU, jit on for each step (the masks are its arguments), the
transposed convs summed by phase as in ``tests/jax_cpu_battery.py``; a full-
width step takes about a second in each package on 8 cores.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dir")
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.environ["IMAGECFGEN_PLATFORM"] = "cpu"
    sys.path[:0] = [REPO, HERE]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax_cpu_battery import phase_conv_transpose2d
    from test_torch_gan_trainer import as_tree
    from test_torch_train_layers import MaskQueue, draw_masks

    from imagecfgen_tpu.cli.common import load_mnist_training_data, scale_attrs_np
    from imagecfgen_tpu.models import bigan as jbigan
    from imagecfgen_tpu.models import layers as jlayers
    from imagecfgen_tpu.train import gan_trainer as jgt
    from imagecfgen_torch.core.convert import gan_state_from_jax
    from imagecfgen_torch.models import bigan as tbigan
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    jlayers.conv_transpose2d = phase_conv_transpose2d
    b, kw = 64, dict(learning_rate=1e-4, d_updates_per_g_update=3)
    x, attrs, scaler = load_mnist_training_data(args.dir, "train")
    a = scale_attrs_np(scaler, attrs)
    jtr = jgt.GANTrainer(jbigan.BiGAN(jbigan.mnist_bigan_config()), jgt.GANTrainConfig(batch_size=b, **kw))
    st = jtr.init_state(jax.random.PRNGKey(args.seed))
    queue = MaskQueue()  # after the init, which runs D's dropout once
    jlayers.channel_dropout = queue

    def step(st, batch, masks):
        queue.masks = list(masks)  # tracers, taken in program order
        out = jtr.train_step(st, batch)
        assert not queue.masks
        return out

    jstep = jax.jit(step)
    tr = GANTrainer(tbigan.BiGAN(tbigan.mnist_bigan_config(), "cpu"), GANTrainConfig(batch_size=b, **kw),
                    device="cpu")
    tr.load_state_dict(gan_state_from_jax(as_tree(st)))
    D = tr.model.discriminator
    sizes, latent = tr.d_batches(b), tr.model.cfg.latent_dim
    rng = np.random.default_rng(args.seed + 1000)
    per_epoch = len(x) // b

    def distance(want, have):
        out = {}
        for part in ("E", "G", "D"):
            names = [n for n in want[part] if not n.endswith((".mean", ".var"))]
            num = sum(float(((have[part][n].double() - want[part][n].double()) ** 2).sum()) for n in names)
            den = sum(float((want[part][n].double() ** 2).sum()) for n in names)
            out[part] = (num / den) ** 0.5
        return out

    rows, perm, t0 = [], None, time.perf_counter()
    for i in range(args.steps):
        if i % per_epoch == 0:
            perm = rng.permutation(len(x))
        idx = perm[(i % per_epoch) * b:(i % per_epoch + 1) * b]
        batch = {"image": x[idx], "attrs": {k: v[idx] for k, v in a.items()}}
        masks = [draw_masks(D, n, rng) for n in sizes]
        z = np.asarray(jax.random.normal(jax.random.split(st.rng, 9)[1], (b, 1, 1, latent)))
        st, ref = jstep(st, jax.tree_util.tree_map(jnp.asarray, batch), [jnp.asarray(m) for fwd in masks for m in fwd])
        got = tr.train_step({"image": torch.from_numpy(batch["image"]),
                             "attrs": {k: torch.from_numpy(v) for k, v in batch["attrs"].items()}},
                            z=torch.from_numpy(z), masks=[[torch.from_numpy(m) for m in fwd] for fwd in masks])
        dist = distance(gan_state_from_jax(as_tree(st)), tr.state_dict())
        row = {"step": i + 1, "jax": [float(ref["D_score"]), float(ref["EG_score"])],
               "port": [got["D_score"].item(), got["EG_score"].item()], "distance": dist}
        rows.append(row)
        print(json.dumps(row), f"({time.perf_counter() - t0:.0f} s)", flush=True)
    out = args.out or os.path.join(args.dir, "gan-step-trace.json")
    with open(out, "w") as f:
        json.dump({"seed": args.seed, "batch": b, **kw, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
