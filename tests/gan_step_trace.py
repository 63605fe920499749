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

    python tests/gan_step_trace.py --family audio --bisect [--d 64] [--out PATH]

``--bisect`` takes the audio trace's step 1 apart against float64
(:func:`bisect`): the same state, batch and ``z``; its three gradients (E and
G's on the label-swapped loss; D's on the real pair; D's on the fake pair
after D's first Adam update) each at one point, the float64 step's, rounded
to float32 for both packages. For each parameter tensor and gradient: each
package's relative distance from float64 and from the other, the elements
whose sign differs between the packages, the largest float64 |g| among them
and the rounding of that element's sum (:func:`sum_rounding`); for each
layer, the pre-activations on the other side of LeakyReLU's kink from
float64 in each package; and E's, G's and D's step-1 parameter distance
between the two packages' own steps, whole and outside the elements whose
Adam step turned. It writes ``bisect`` into the record at ``--out`` (the other
keys kept).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import weakref

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
AUDIO = {"batch": 128, "learning_rate": 1e-4, "betas": (0.5, 0.9), "d_updates_per_g_update": 1}
UNIT_ROUNDOFF = 2.0 ** -24  # float32's


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


_STEPS = weakref.WeakKeyDictionary()  # JAX trainer -> (its jitted step, the step's mask queue)


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
    if jtr not in _STEPS:  # one jitted step a trainer: a second trace reuses its compilation
        queue = MaskQueue()  # after the init, which runs D's dropout once

        def step(st, batch, masks):
            queue.masks = list(masks)  # tracers, taken in program order
            out = jtr.train_step(st, batch)
            assert not queue.masks
            return out

        _STEPS[jtr] = jax.jit(step), queue
    jstep, queue = _STEPS[jtr]
    jlayers.channel_dropout = queue

    try:
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


# ------------------------------------------------------------------ bisect

# For each of step 1's gradients, the towers that the backward crosses whole
# before it reaches a tower's own layers (from its last down). The E+G loss
# reaches E through D's z head on the real pair, G through D's x tower on
# the fake pair; D's two losses reach its x and z heads through the joint one.
DOWNSTREAM = {
    "EG": {"E.trunk": ["D_real.dz", "D_real.dxz"], "E.attr": ["E.trunk", "D_real.dz", "D_real.dxz"],
           "G.trunk": ["D_fake.dx", "D_fake.dxz"], "G.attr": ["G.trunk", "D_fake.dx", "D_fake.dxz"]},
    "D": {"D.dxz": [], "D.dx": ["D.dxz"], "D.dz": ["D.dxz"], "D.attr": ["D.dx", "D.dxz"]},
}


class LeakyReluRecorder:
    """A stand-in for a module's ``nn`` or ``F`` namespace that keeps the
    input of every ``leaky_relu`` (a pre-activation) in ``seen``; every other
    name is the namespace's own."""

    def __init__(self, namespace):
        self.namespace, self.seen = namespace, []

    def __getattr__(self, name):
        return getattr(self.namespace, name)

    def leaky_relu(self, x, *args, **kwargs):
        self.seen.append(x)
        return self.namespace.leaky_relu(x, *args, **kwargs)


def plan_layers(plan):
    """A plan's weight layers by the port's names (``conv_i`` and ``convT_i``
    counted together, ``dense_i`` apart), each with whether a LeakyReLU
    follows it before the next one."""
    out, conv_i, dense_i = [], 0, 0
    for op in plan:
        if op[0] in ("conv", "convT"):
            out.append([f"{op[0]}_{conv_i}", False])
            conv_i += 1
        elif op[0] == "dense":
            out.append([f"dense_{dense_i}", False])
            dense_i += 1
        elif op[0] == "lrelu" and out:
            out[-1][1] = True
    return out


def plan_forward(plan, params, h, records):
    """A plan's forward with the port's ops, in ``h``'s type (``params``:
    the ``PlanSequential``'s by name). Appends each weight layer's
    :func:`term_sums` record to ``records``, its output keeping its
    gradient."""
    import torch
    import torch.nn.functional as F

    from imagecfgen_torch.ops.conv import conv2d, conv_transpose2d

    names = iter(name for name, _ in plan_layers(plan))
    for op in plan:
        kind = op[0]
        if kind in ("conv", "convT", "dense"):
            name = next(names)
            if kind == "conv":
                def fn(x, w, op=op):
                    return conv2d(x, w, op[3], op[4])
            elif kind == "convT":
                def fn(x, w, op=op):
                    return conv_transpose2d(x, w, op[3], op[4], output_padding=op[5] if len(op) > 5 else 0)
            else:
                def fn(x, w):
                    return x @ w.t()
            w, bias = params[f"{name}_kernel"], params[f"{name}_bias"]
            y = F.linear(h, w, bias) if kind == "dense" else fn(h, w) + bias
            if y.requires_grad:
                y.retain_grad()
            x = h.detach()
            records.append((f"{name}_kernel", y, w, lambda t, fn=fn, x=x: fn(x.abs(), t),
                            lambda t, fn=fn, x=x: fn(torch.ones_like(x), t)))
            h = y
        elif kind == "lrelu":
            h = F.leaky_relu(h, op[1])
        elif kind == "tanh":
            h = torch.tanh(h)
        elif kind == "reshape":
            h = h.reshape(h.shape[0], *op[1])
        else:
            raise ValueError(f"no float64 forward of {op!r}")
    return h


def bigan_forwards(cfg):
    """E, G and D forwards of the port's BiGAN (``cfg`` without dropout or
    batch norm) in the type of ``p``, their parameters (``{"E": ..., "G":
    ..., "D": ...}`` by the modules' names). Each returns its output and
    ``{tower: records}``: :func:`plan_forward`'s for each plan, and each
    embedding's (``"<part>.attr"``) alike."""
    import torch

    spec, (h, w), (eh, ew) = cfg.attr_spec, cfg.image_size, cfg.embed_hw
    rows, cols = torch.arange(h) * eh // h, torch.arange(w) * ew // w

    def sub(params, prefix):
        return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}

    def channels(tables, x, attrs, records):
        chans = [x.to(next(iter(tables.values())).dtype)]
        for a in spec.categorical:
            def up(t, idx=torch.argmax(attrs[a.name], -1)):
                return t[idx].reshape(idx.shape[0], eh, ew, 1)[:, rows][:, :, cols]
            name = f"embed_{a.name}"
            c = torch.tanh(up(tables[name]))
            if c.requires_grad:
                c.retain_grad()
            records.append((name, c, tables[name], lambda t, up=up: torch.tanh(up(t)), up))
            chans.append(c)
        return torch.cat(chans, -1)

    def enc(p, x, attrs):
        rec = {"E.trunk": [], "E.attr": []}
        feats = channels(sub(p["E"], "attr_channels."), x, attrs, rec["E.attr"])
        out = plan_forward(cfg.enc_plan, sub(p["E"], "trunk."), feats, rec["E.trunk"])
        return out.reshape(out.shape[0], 1, 1, -1), rec

    def gen(p, z, attrs):
        rec, tables, vec = {"G.trunk": [], "G.attr": []}, sub(p["G"], "attr_vectors."), []
        for a in spec.categorical:
            name, one = f"embed_{a.name}", attrs[a.name].to(z.dtype)
            v = one @ tables[name]
            if v.requires_grad:
                v.retain_grad()
            rec["G.attr"].append((name, v, tables[name], lambda t, one=one: one @ t, lambda t, one=one: one @ t))
            vec.append(v)
        feats = torch.cat([z.reshape(z.shape[0], -1), *vec], -1)
        return plan_forward(cfg.gen_plan, sub(p["G"], "trunk."), feats, rec["G.trunk"]), rec

    def disc(p, x, z, attrs):
        rec = {"D.dx": [], "D.dz": [], "D.dxz": [], "D.attr": []}
        feats = channels(sub(p["D"], "attr_channels."), x, attrs, rec["D.attr"])
        dx = plan_forward(cfg.dx_plan, sub(p["D"], "dx."), feats, rec["D.dx"])
        dz = plan_forward(cfg.dz_plan, sub(p["D"], "dz."), z.reshape(z.shape[0], 1, 1, -1), rec["D.dz"])
        out = plan_forward(cfg.dxz_plan, sub(p["D"], "dxz."), torch.cat([dx, dz], -1), rec["D.dxz"])
        return out.reshape(out.shape[0], 1), rec

    return enc, gen, disc


def term_sums(records):
    """For each tensor of one tower's records ``(name, output, tensor,
    abs_map, count_map)``, gradients in place: element by element, the sum
    of the magnitudes of its gradient's terms and their number. A record's
    ``abs_map(t)`` is its output from ``t`` with each term's other factor
    taken by magnitude (a layer's input; an embedding's slope, through tanh
    itself, whose slope is positive), ``count_map(t)`` with each set to one,
    so the gradients of their sums weighted by ``|dy|`` and by ones are
    those sums and counts. A layer's bias takes ``|dy|`` itself."""
    import torch

    out = {}
    for name, y, w, abs_map, count_map in records:
        dy, t = y.grad.abs(), w.detach().clone().requires_grad_()
        sums = torch.autograd.grad((dy * abs_map(t)).sum(), t)[0]
        counts = torch.autograd.grad(count_map(t).sum(), t)[0]
        out[name] = (sums, counts)
        if name.endswith("_kernel"):
            lead = tuple(range(dy.dim() - 1))
            out[name[:-len("kernel")] + "bias"] = (dy.sum(lead), torch.full_like(dy.sum(lead), dy.numel() // dy.shape[-1]))
    return out


def sum_rounding(abs_sum, n):
    """The rounding of a float32 sum of ``n`` terms whose magnitudes sum to
    ``abs_sum``: ``sqrt(n) 2^-24 abs_sum`` (the probabilistic bound of
    Higham and Mary, 2019)."""
    return abs_sum * n ** 0.5 * UNIT_ROUNDOFF


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm()) if float(b.norm()) else float((a - b).norm())


def bisect(jtr, st, tr, x, attrs, header, *_, log=print) -> dict:
    """Step 1 of the audio trace taken apart against float64 (see the
    module's docstring); ``jtr``, ``st``, ``tr``, ``x``, ``attrs`` and
    ``header`` as :func:`audio_setup` returns them. Returns the entry."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax_cpu_battery import phase_conv_transpose2d
    from test_torch_gan_trainer import as_tree

    from imagecfgen_tpu.models import layers as jlayers
    from imagecfgen_tpu.train import gan_trainer as jgt
    from imagecfgen_torch.core.convert import (
        discriminator_state_dict_from_jax,
        encoder_state_dict_from_jax,
        gan_state_from_jax,
        generator_state_dict_from_jax,
    )
    from imagecfgen_torch.models import layers as tlayers
    from imagecfgen_torch.train.gan_trainer import bce_logits

    t0 = time.perf_counter()
    cfg, b, lr = tr.model.cfg, tr.tcfg.batch_size, tr.tcfg.learning_rate
    b1, b2 = tr.tcfg.betas
    model = tr.model
    if any(part.drop_specs or any(op[0] == "bn" for op in part.plan)
           for part in (model.discriminator.dx, model.discriminator.dz, model.discriminator.dxz)):
        raise ValueError("the bisection takes a D without dropout or batch norm (the audio BiGAN's)")
    rng = np.random.default_rng(header["seed"] + 1000)  # step 1's batch and z, as trace() draws them
    idx = rng.permutation(len(x))[:b]
    xb, ab = x[idx], {k: v[idx] for k, v in attrs.items()}
    z = np.asarray(jax.random.normal(jax.random.split(st.rng, 9)[1], (b, 1, 1, cfg.latent_dim)))
    init = {k: v for k, v in gan_state_from_jax(as_tree(st)).items() if k in ("E", "G", "D")}
    enc, gen, disc = bigan_forwards(cfg)
    towers = {"E.trunk": cfg.enc_plan, "G.trunk": cfg.gen_plan, "D.dx": cfg.dx_plan, "D.dz": cfg.dz_plan,
              "D.dxz": cfg.dxz_plan}

    def leaves(p):
        return {part: {k: v.detach().double().clone().requires_grad_() for k, v in p[part].items()}
                for part in p}

    def adam(p, g, m, v, t):
        """optax.adam's step ``t`` in float64 (eps 1e-8), the moments in place."""
        out = {}
        for k in p:
            m[k] = b1 * m.get(k, 0) + (1 - b1) * g[k]
            v[k] = b2 * v.get(k, 0) + (1 - b2) * g[k] ** 2
            out[k] = p[k].detach() - lr * (m[k] / (1 - b1 ** t)) / ((v[k] / (1 - b2 ** t)).sqrt() + 1e-8)
        return out

    X = torch.from_numpy(xb).double()
    A = {k: torch.from_numpy(v).double() for k, v in ab.items()}
    Z = torch.from_numpy(z).double()

    # ---- the float64 step: each gradient, its records and the next point
    f64, points = {}, {}
    p = leaves(init)
    ex, re_ = enc(p, X, A)
    gz, rg = gen(p, Z, A)
    dv, rdv = disc(p, X, ex, A)
    df, rdf = disc(p, gz, Z, A)
    (0.5 * (bce_logits(dv, 0) + bce_logits(df, 1))).backward()
    rec = {**re_, **rg, **{t.replace("D.", "D_real."): r for t, r in rdv.items()},
           **{t.replace("D.", "D_fake."): r for t, r in rdf.items()}}
    f64["EG"] = ({part: {k: v.grad.detach() for k, v in p[part].items()} for part in ("E", "G")}, rec)
    eg1 = {part: adam(p[part], f64["EG"][0][part], {}, {}, 1) for part in ("E", "G")}
    with torch.no_grad():
        ex1 = enc(eg1, X, A)[0]
        gz1 = gen(eg1, Z, A)[0]
    points["EG"] = {k: init[k] for k in ("E", "G", "D")}
    m, v = {}, {}
    for update, (xi, zi, target) in (("D_real", (X, ex1, 1)), ("D_fake", (gz1, Z, 0))):
        dpt = leaves({"D": init["D"]})["D"] if update == "D_real" else {
            k: t.clone().requires_grad_() for k, t in d1.items()}
        points[update] = {"D": {k: t.detach().float() for k, t in dpt.items()},
                          "inputs": (xi.float(), zi.float())}
        out, rec = disc({"D": dpt}, xi, zi, A)
        bce_logits(out, target).backward()
        f64[update] = ({"D": {k: t.grad.detach() for k, t in dpt.items()}}, rec)
        d1 = adam(dpt, f64[update][0]["D"], m, v, 1 if update == "D_real" else 2)
    log(f"float64 step ({time.perf_counter() - t0:.0f} s)")

    # ---- the port at the same points, its pre-activations recorded
    import copy

    port = copy.deepcopy(model)
    E, G, D = port.encoder, port.generator, port.discriminator
    recorder, saved_f = LeakyReluRecorder(tlayers.F), tlayers.F
    xf, af, zf = torch.from_numpy(xb), {k: torch.from_numpy(v) for k, v in ab.items()}, torch.from_numpy(z)
    ours = {}
    tlayers.F = recorder
    try:
        for update in ("EG", "D_real", "D_fake"):
            for part, sd in points[update].items():
                if part != "inputs":
                    getattr(port, {"E": "encoder", "G": "generator", "D": "discriminator"}[part]).load_state_dict(sd)
            recorder.seen = []
            if update == "EG":
                ex = E(xf, af, train=True)
                gz = G(zf, af, train=True)
                loss = 0.5 * (bce_logits(D(xf, ex, af, train=True, masks=[]), 0) +
                              bce_logits(D(gz, zf, af, train=True, masks=[]), 1))
                params = {"E": dict(E.named_parameters()), "G": dict(G.named_parameters())}
                order = ["E.trunk", "G.trunk", "D_real.dx", "D_real.dz", "D_real.dxz", "D_fake.dx", "D_fake.dz",
                         "D_fake.dxz"]
            else:
                xi, zi = points[update]["inputs"]
                loss = bce_logits(D(xi, zi, af, train=True, masks=[]), 1 if update == "D_real" else 0)
                params = {"D": dict(D.named_parameters())}
                order = ["D.dx", "D.dz", "D.dxz"]
            flat = [(part, k) for part in params for k in params[part]]
            grads = torch.autograd.grad(loss, [params[part][k] for part, k in flat])
            g = {part: {} for part in params}
            for (part, k), t in zip(flat, grads):
                g[part][k] = t
            ours[update] = (g, split_pre_acts([t.detach() for t in recorder.seen], order, towers))
    finally:
        tlayers.F = saved_f
    log(f"the port's gradients ({time.perf_counter() - t0:.0f} s)")

    # ---- JAX at the same points, its pre-activations recorded
    jrec, saved = LeakyReluRecorder(jlayers.nn), (jlayers.nn, jlayers.conv_transpose2d)
    jlayers.nn, jlayers.conv_transpose2d = jrec, phase_conv_transpose2d
    Em, Gm = jtr.model.encoder, jtr.model.generator
    key, bs = jax.random.PRNGKey(0), st.vars_D["batch_stats"]
    xj, aj, zj = jnp.asarray(xb), {k: jnp.asarray(v) for k, v in ab.items()}, jnp.asarray(z)

    def eg_loss(peg, pd):
        jrec.seen = []
        ex = Em.apply({"params": peg["E"]}, xj, aj, train=True, rngs={"dropout": key})
        gz = Gm.apply({"params": peg["G"]}, zj, aj, train=True)
        dv, _ = jtr._apply_D(pd, bs, xj, ex, aj, key)
        df, _ = jtr._apply_D(pd, bs, gz, zj, aj, key)
        return 0.5 * (jgt.bce_logits(dv, 0) + jgt.bce_logits(df, 1)), list(jrec.seen)

    def d_loss(pd, xi, zi, real):
        """D's loss on the pair, labelled real (1) or fake (0): one compilation for both."""
        jrec.seen = []
        d, _ = jtr._apply_D(pd, bs, xi, zi, aj, key)
        return jnp.where(real, jgt.bce_logits(d, 1), jgt.bce_logits(d, 0)), list(jrec.seen)

    theirs = {}
    try:
        (_, seen), g = jax.jit(jax.value_and_grad(eg_loss, has_aux=True))(
            {"E": st.params_E, "G": st.params_G}, st.vars_D["params"])
        theirs["EG"] = ({"E": encoder_state_dict_from_jax(jax.device_get(g["E"])),
                         "G": generator_state_dict_from_jax(jax.device_get(g["G"]))},
                        split_pre_acts([torch.from_numpy(np.asarray(t)) for t in seen], ours["EG"][1].keys(), towers))
        log(f"JAX's E+G gradient ({time.perf_counter() - t0:.0f} s)")
        dgrad = jax.jit(jax.value_and_grad(d_loss, has_aux=True))
        for update in ("D_real", "D_fake"):
            xi, zi = (jnp.asarray(t.numpy()) for t in points[update]["inputs"])
            (_, seen), g = dgrad(jax_params(points[update]["D"]), xi, zi, update == "D_real")
            theirs[update] = ({"D": discriminator_state_dict_from_jax(jax.device_get(g), {})},
                              split_pre_acts([torch.from_numpy(np.asarray(t)) for t in seen],
                                             ours[update][1].keys(), towers))
            log(f"JAX's {update} gradient ({time.perf_counter() - t0:.0f} s)")
    finally:
        jlayers.nn, jlayers.conv_transpose2d = saved

    # ---- layer by layer, tensor by tensor
    entry = {"seed": header["seed"], "d": header["d"], "batch": b, "layers": [], "tensors": []}
    for update in ("EG", "D_real", "D_fake"):
        grads64, rec = f64[update]
        truth = pre_acts_of(rec, towers)
        flips = {}
        for tower, layers in truth.items():
            for (name, want), (_, mine), (_, jx) in zip(layers, ours[update][1][tower], theirs[update][1][tower]):
                kink = want >= 0
                row = {"update": update, "tower": tower, "layer": name, "elements": want.numel(),
                       "error": {"jax": _rel(jx.double(), want), "port": _rel(mine.double(), want)},
                       "kink_flips": {"jax": int(((jx.reshape(-1) >= 0) != kink).sum()),
                                      "port": int(((mine.reshape(-1) >= 0) != kink).sum())}}
                entry["layers"].append(row)
                flips.setdefault(tower, []).append((name, row["kink_flips"]["jax"] + row["kink_flips"]["port"]))
        group = "EG" if update == "EG" else "D"
        for part, g64 in grads64.items():
            sums = {}
            for tower, records in rec.items():
                if tower.startswith(part + "."):
                    sums.update({f"{tower.split('.', 1)[1]}.{k}": s for k, s in term_sums(records).items()})
            for name, want in g64.items():
                tower = f"{part}.{name.split('.', 1)[0]}".replace("attr_channels", "attr").replace("attr_vectors", "attr")
                layer = name.split(".", 1)[1].rsplit("_", 1)[0]
                mine, jx = ours[update][0][part][name].double(), theirs[update][0][part][name].double()
                order = [n for n, _ in plan_layers(towers[tower])] if tower in towers else []
                above = order[order.index(layer):] if layer in order else []  # its own layer and those after it
                on_path = sum(c for n, c in flips.get(tower, []) if n in above) + sum(
                    c for t in DOWNSTREAM[group][tower] for _, c in flips.get(t, []))
                differs = torch.sign(mine) != torch.sign(jx)
                abs_sum, n = sums[f"{tower.split('.', 1)[1]}.{name.split('.', 1)[1]}"]
                bound = sum_rounding(abs_sum, n)
                over = differs & (want.abs() >= bound)
                worst = int(torch.argmax(torch.where(differs, want.abs(), torch.zeros_like(want))).item())
                entry["tensors"].append({
                    "update": update, "part": part, "tensor": name, "elements": want.numel(),
                    "jax": _rel(jx, want), "port": _rel(mine, want), "port_vs_jax": _rel(mine, jx),
                    "port_vs_jax_outside": float(((mine - jx) * ~differs).norm() / jx.norm()) if float(jx.norm()) else 0.0,
                    "kink_flips_on_path": on_path, "sign_differs": int(differs.sum()),
                    "max_abs_g": float(want.abs().reshape(-1)[worst]) if differs.any() else 0.0,
                    "rounding_at_max": float(bound.reshape(-1)[worst]) if differs.any() else 0.0,
                    "unexplained": int(over.sum())})
    log(f"compared ({time.perf_counter() - t0:.0f} s)")

    # ---- each package's own step 1: each tensor's parameter distance, whole
    # and outside the elements whose Adam step changed direction in one
    # package (an update of about lr; rounding alone moves one by far less)
    rows, st1 = trace(jtr, st, tr, x, attrs, header["seed"], 1, log=log)
    want, have = gan_state_from_jax(as_tree(st1)), tr.state_dict()
    entry["step1_parts"] = {}
    for part in ("E", "G", "D"):
        sums = [0.0, 0.0, 0.0, 0]  # |diff|^2, outside, |jax|^2, turned
        for name, j in want[part].items():
            j, p_, p0 = j.double(), have[part][name].double(), init[part][name].double()
            turned = ((p_ - p0) - (j - p0)).abs() > lr / 2
            diff = p_ - j
            sums = [sums[0] + float((diff ** 2).sum()), sums[1] + float(((diff * ~turned) ** 2).sum()),
                    sums[2] + float((j ** 2).sum()), sums[3] + int(turned.sum())]
        entry["step1_parts"][part] = {"distance": (sums[0] / sums[2]) ** 0.5, "outside": (sums[1] / sums[2]) ** 0.5,
                                      "direction_changed": sums[3]}
    entry["step1_distance"] = rows[0]["distance"]
    entry["seconds"] = time.perf_counter() - t0
    return entry


def split_pre_acts(seen, order, towers):
    """A recorder's pre-activations of one gradient's forwards, in forward
    order, as ``{tower: [(layer, flat tensor)]}`` for the towers of
    ``order`` (``"D_real.dx"`` reads ``"D.dx"``'s plan)."""
    out, at = {}, 0
    for tower in order:
        kinked = [name for name, k in plan_layers(towers[_plan_of(tower)]) if k]
        out[tower] = [(name, t.reshape(-1)) for name, t in zip(kinked, seen[at:at + len(kinked)])]
        at += len(kinked)
    if at != len(seen):
        raise ValueError(f"{len(seen)} pre-activations for {at} kinked layers")
    return out


def _plan_of(tower: str) -> str:
    return tower.replace("D_real.", "D.").replace("D_fake.", "D.")


def pre_acts_of(rec, towers):
    """The float64 records' kinked layers' outputs, as
    :func:`split_pre_acts` gives a package's."""
    out = {}
    for tower, records in rec.items():
        if tower.endswith(".attr"):
            continue
        kinked = {name for name, k in plan_layers(towers[_plan_of(tower)]) if k}
        out[tower] = [(r[0][:-len("_kernel")], r[1].detach().reshape(-1)) for r in records
                      if r[0][:-len("_kernel")] in kinked]
    return out


def jax_params(sd):
    """A port E, G or D state dict (no batch norm) -> the JAX module's
    params: HWIO conv kernels, a transposed conv's flipped back, (in, out)
    dense kernels, ``attr_channels``' tables under ``embedding``."""
    import numpy as np

    out = {}
    for name, v in sd.items():
        part, rest = name.split(".", 1)
        a = v.detach().cpu().numpy().astype(np.float32)
        if part == "attr_channels":
            a = {"embedding": a}
        elif rest.startswith("convT_") and rest.endswith("_kernel"):
            a = np.ascontiguousarray(np.flip(a.transpose(2, 3, 0, 1), (0, 1)))
        elif rest.endswith("_kernel"):
            a = a.transpose(2, 3, 1, 0) if rest.startswith("conv_") else np.ascontiguousarray(a.T)
        out.setdefault(part, {})[rest] = a
    return out


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
    p.add_argument("--bisect", action="store_true", help="--family audio: take step 1 apart against float64")
    args = p.parse_args(argv)
    if args.family == "mnist" and not args.dir:
        p.error("--family mnist takes the battery's data directory")
    if args.bisect and args.family != "audio":
        p.error("--bisect takes --family audio")
    os.environ["IMAGECFGEN_PLATFORM"] = "cpu"
    sys.path[:0] = [REPO, HERE]
    import jax

    jax.config.update("jax_platforms", "cpu")
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.bisect:
        out = args.out or "gan-step-trace-audio.json"
        got = bisect(*audio_setup(args.seed, args.d, args.init_std), log=log)
        record = {}
        if os.path.exists(out):
            with open(out) as f:
                record = json.load(f)
        with open(out, "w") as f:
            json.dump({**record, "bisect": got}, f)
        return 0
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
