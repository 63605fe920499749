"""Attribute-slider counterfactuals of one digit, rendered as a grid (port of
``mnist_mix_vae_gui.py``).

    python -m imagecfgen_torch.cli.mnist_mix_vae_gui --headless --data-dir D --model-dir M \
        [--image-index 0 | --original 3] [--target 8] [--output mnist-mix-gui.png] [--seed 42] \
        [--device cuda|cpu]

The JAX script opens a matplotlib window with sliders for thickness,
intensity and slant and one that mixes the digit's one-hot toward
``--target``; every movement re-solves the counterfactual. The machine with
the card has neither matplotlib nor a display, so the port renders only the
script's ``--headless`` figure: a 4 x 5 grid, the counterfactuals at five
positions of each attribute slider (the others at the digit's own values),
then five mixes, written with ``save_grid_png`` (grayscale, [-1, 1] -> 0 ..
255) while the panels' titles go to stdout. Without ``--headless`` it exits
with code 2. :class:`MixGui` holds what the window's callbacks compute:
``cf_image``, ``mix_image`` and ``update`` (what the window shows after a
slider moves).
"""
from argparse import ArgumentParser
import os
import sys
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--data-dir", type=str, default="")
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--image-index", type=int, default=0)
parser.add_argument("--original", type=int, default=None,
                    help="pick the first image of this digit (reference GUI semantics) instead of "
                         "--image-index, and enable the digit-mix slider")
parser.add_argument("--target", type=int, default=8, help="digit whose one-hot the mix slider morphs toward")
parser.add_argument("--headless", action="store_true",
                    help="render the grid of slider positions (the only mode of the port)")
parser.add_argument("--output", type=str, default="mnist-mix-gui.png")
parser.add_argument("--seed", type=int, default=42)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

CONTINUOUS = ("thickness", "intensity", "slant")


class MixGui:
    """One digit ``x`` (``(1, 28, 28, 1)`` in [-1, 1]) with its raw
    attributes, served by a ``CounterfactualEngine``: the digit's latent
    code is encoded once (for the mix), and each counterfactual encodes it
    again, as the engine does."""

    def __init__(self, engine, x: torch.Tensor, attrs: Mapping[str, torch.Tensor], target: int, seed: int):
        self.engine, self.x, self.attrs, self.target, self.seed = engine, x, dict(attrs), target, seed
        self.digit = int(attrs["digit"].argmax(dim=-1).reshape(-1)[0])
        self.values = {k: float(attrs[k].reshape(-1)[0]) for k in CONTINUOUS}
        scaler = engine.scaler
        self.ranges = {k: (float(scaler.mins[k]), float(scaler.maxs[k])) for k in CONTINUOUS}
        self.scaled = scaler.scale(self.attrs)
        with torch.no_grad():
            self.codes = engine.bigan.encoder(x, self.scaled)

    def cf_image(self, thickness: float, intensity: float, slant: float) -> np.ndarray:
        """``(28, 28)``: the counterfactual with the three attributes set."""
        dev = self.engine.device
        iv = {k: torch.tensor([[v]], dtype=torch.float32, device=dev)
              for k, v in zip(CONTINUOUS, (thickness, intensity, slant))}
        img, _ = self.engine.counterfactual(self.x, self.attrs, iv, rng=torch.Generator().manual_seed(self.seed))
        return img.reshape(28, 28).cpu().numpy()

    def mix_image(self, v: float) -> np.ndarray:
        """``(28, 28)``: the generator on the digit's code, its one-hot
        ``(1 - v) e_digit + v e_target``."""
        eye = torch.eye(10, device=self.engine.device)
        mixed = dict(self.scaled, digit=((1.0 - v) * eye[self.digit] + v * eye[self.target]).reshape(1, 10))
        with torch.no_grad():
            return self.engine.bigan.generator(self.codes, mixed).reshape(28, 28).cpu().numpy()

    def update(self, sliders: Mapping[str, float]) -> np.ndarray:
        """What the window shows after a slider moves: the mix while its
        slider (``mix``) is above 0, else the counterfactual at the three
        attribute sliders."""
        if sliders.get("mix", 0.0) > 0:
            return self.mix_image(sliders["mix"])
        return self.cf_image(*(sliders[k] for k in CONTINUOUS))

    def grid(self) -> Tuple[List[List[np.ndarray]], List[List[str]]]:
        """The headless figure's rows of images and their titles."""
        rows, titles = [], []
        for name in CONTINUOUS:
            lo, hi = self.ranges[name]
            vs = np.linspace(lo, hi, 5)
            rows.append([self.cf_image(**dict(self.values, **{name: float(v)})) for v in vs])
            titles.append([f"{name}={v:.1f}" for v in vs])
        vs = np.linspace(0.0, 1.0, 5)
        rows.append([self.mix_image(float(v)) for v in vs])
        titles.append([f"digit {self.digit}->{self.target} mix={v:.2f}" for v in vs])
        return rows, titles


def load_gui(data_dir: str, model_dir: str, image_index: int = 0, original=None, target: int = 8,
             seed: int = 42, device=None) -> MixGui:
    """The GUI of the script's flags: the digit from the test split (the
    training split when there is none), ``mnist-bigan.tar`` and
    ``mnist-attribute-scm.tar`` from ``model_dir`` (either package's files)."""
    from ..cf.engine import CounterfactualEngine
    from ..device import resolve_device
    from ..models.bigan import mnist_bigan_config
    from .common import bigan_from_state, has_test_split, load_attribute_scm, load_bigan, load_mnist_training_data

    device = resolve_device(device)
    x, attrs, _ = load_mnist_training_data(data_dir, "test" if has_test_split(data_dir) else "train")
    state, scaler, _ = load_bigan(os.path.join(model_dir, "mnist-bigan.tar"), device)
    scm = load_attribute_scm(os.path.join(model_dir, "mnist-attribute-scm.tar"), device)
    engine = CounterfactualEngine(bigan_from_state(state, mnist_bigan_config(), device), scm, scaler, device)
    if original is not None:
        matches = np.flatnonzero(np.asarray(attrs["digit"]).argmax(axis=1) == original)
        if not len(matches):
            raise SystemExit(f"no image of digit {original} in the split")
        image_index = int(matches[0])
    i = image_index
    one: Dict[str, torch.Tensor] = {k: torch.from_numpy(np.asarray(v)[i:i + 1]).to(device) for k, v in attrs.items()}
    return MixGui(engine, torch.from_numpy(x[i:i + 1]).to(device), one, target, seed)


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    if not args.headless:
        print("mnist_mix_vae_gui: the interactive window needs matplotlib and a display, which the port does "
              "not use; pass --headless for the grid of slider positions", file=sys.stderr)
        return 2
    from .common import save_grid_png

    gui = load_gui(args.data_dir, args.model_dir, args.image_index, args.original, args.target, args.seed,
                   args.device)
    rows, titles = gui.grid()
    save_grid_png(args.output, rows, [" | ".join(t) for t in titles],
                  "attribute sweeps + digit mix (headless GUI rendering)")
    print(f"saved {args.output}")
    return 0

if __name__ == "__main__":
    sys.exit(main())
