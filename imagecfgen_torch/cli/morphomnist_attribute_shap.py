"""Attribute attributions of the generative classifiers: expected-gradients
SHAP values of the classifier's class probabilities with respect to the
conditioning attributes, marginalised over z (port of
``morphomnist_attribute_shap.py``).

    python -m imagecfgen_torch.cli.morphomnist_attribute_shap --data-dir D \
        --model-dir M [--limit 4] [--n-background 64] [--n-mc 8] [--n-steps 16] \
        [--device cuda|cpu]

F(a) = mean over ``--n-mc`` draws of z of softmax(classifier(G(z, a))), a
the 13 packed scaled attributes. For each of the first ``--limit`` test
rows, the SHAP value is E_{b, t}[(a - b) * dF/da at b + t (a - b)] over
``--n-steps`` background rows b (of ``--n-background`` drawn by
``numpy.random.default_rng(--seed)``) and t ~ U(0, 1): all steps and draws
in one batch, the Jacobian by ten ``autograd.grad`` calls. Writes
``{bigan,vae}_attribute_shap.npy`` (N, 10, 3) in the working directory: the
thickness, intensity and slant columns; the VAE's when ``mnist-vae.tar`` is
in the model directory. The draws (background indices, t, z) come from a
``torch.Generator`` seeded ``--seed`` for each model.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="mnist-data")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="mnist-bigan.tar")
parser.add_argument("--limit", "--samples", type=int, default=4)
parser.add_argument("--n-background", type=int, default=64)
parser.add_argument("--n-mc", type=int, default=8, help="z samples per eval")
parser.add_argument("--n-steps", type=int, default=16, help="interpolation samples")
parser.add_argument("--seed", type=int, default=42)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def unpack(a13):
    """The 13 packed columns -> the models' attribute dict."""
    return {"digit": a13[:, :10], "thickness": a13[:, 10], "intensity": a13[:, 11], "slant": a13[:, 12]}


def shap_draws(rng, n_steps: int, n_mc: int, n_background: int, latent: int):
    """``(background indices (S,), t (S,), z (S, M, 1, 1, latent))`` from
    ``rng``, in that order."""
    import torch

    bidx = torch.randint(0, n_background, (n_steps,), generator=rng, device=rng.device)
    ts = torch.rand(n_steps, generator=rng, device=rng.device)
    z = torch.randn((n_steps, n_mc, 1, 1, latent), generator=rng, device=rng.device)
    return bidx, ts, z


def expected_gradients(gen, clf, a13, bg, bidx, ts, z):
    """SHAP of ``a13`` (1, 13): E over the steps of (a - b) * dF/da at
    b + t (a - b), F the z-averaged class probabilities; ``(10, 13)``."""
    import torch

    base = bg[bidx]
    point = (base + ts[:, None] * (a13 - base)).detach().requires_grad_(True)
    s, m = z.shape[:2]
    img = gen(z.reshape(s * m, *z.shape[2:]), unpack(point.repeat_interleave(m, dim=0)))
    probs = torch.softmax(clf(img), dim=1).reshape(s, m, -1).mean(dim=1)
    jac = torch.stack([torch.autograd.grad(probs[:, j].sum(), point, retain_graph=j + 1 < probs.shape[1])[0]
                       for j in range(probs.shape[1])], dim=1)  # (S, 10, 13): row s of F reaches point s only
    return (jac * (a13 - base)[:, None, :]).mean(dim=0)


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import explainer_models, has_test_split, load_mnist_training_data, load_vae, scale_attrs
    from ..core.attributes import pack_mnist_attrs
    from ..models.vae import mnist_vae_config

    split = "test" if has_test_split(args.data_dir) else "train"
    x, attrs, scaler = load_mnist_training_data(args.data_dir, split)
    packed = pack_mnist_attrs(scale_attrs(scaler, attrs)).astype(np.float32)  # (N, 13)

    _, G, clf = explainer_models(os.path.join(args.model_dir, args.bigan),
                                 os.path.join(args.model_dir, "mnist_clf.tar"), device)
    generators = {"bigan": G}
    vae_path = os.path.join(args.model_dir, "mnist-vae.tar")
    if os.path.exists(vae_path):
        generators["vae"] = load_vae(vae_path, mnist_vae_config(), device)[0].decoder

    rng = np.random.default_rng(args.seed)
    bg = torch.from_numpy(packed[rng.permutation(len(packed))[: args.n_background]]).to(device)
    n = min(args.limit, len(packed))
    for name, gen in generators.items():
        out = np.zeros((n, 10, 3))
        draws = torch.Generator().manual_seed(args.seed)
        for i in range(n):
            bidx, ts, z = (t.to(device) for t in shap_draws(draws, args.n_steps, args.n_mc, bg.shape[0],
                                                            gen.cfg.latent_dim))
            a13 = torch.from_numpy(packed[i:i + 1]).to(device)
            out[i] = expected_gradients(gen, clf, a13, bg, bidx, ts, z)[:, [10, 11, 12]].cpu().numpy()
        np.save(f"{name}_attribute_shap.npy", out)
        print(f"saved {name}_attribute_shap.npy "
              f"(mean |shap|: {np.abs(out).mean(axis=(0, 1)).round(4)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
