"""Quality of the 512^2 ESRF BiGAN (port of ``tools/esrf_quality.py``): the
ESRF family's only counterfactual evaluation.

    python -m imagecfgen_torch.cli.esrf_quality --model-dir M [--bigan esrf-bigan.tar] \
        [--batch-size 16] [--cf-distance 10] [--wav-dir W --label-csv L] [--device cuda|cpu]

Over the validation windows:

- the E -> G reconstruction's mean squared error and SSIM (images in
  [-1, 1], ``data_range`` 2);
- ``do(has_boat)``, flipped for every window (a boat added at
  ``--cf-distance``, or removed), as the ratio of linear-magnitude energy
  after and before, in the stand-in's rumble band (STFT rows 3-19, 23-156
  Hz at 7.8125 Hz a row: the 25-150 Hz harmonic stack of
  ``data/esrf.py``'s stand-in) and in a control band (rows 128-255, 1-2 kHz)
  that the intervention should leave alone; medians printed for both
  directions.

Each batch's ``E(x)`` is one ``fused_encoder`` launch on the card. The JAX
tool's liveness heartbeat (for its TPU's silent compiles) has no
counterpart here.
"""
from argparse import ArgumentParser
import os
import sys

parser = ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--model-dir", type=str, default="")
parser.add_argument("--bigan", type=str, default="esrf-bigan.tar")
parser.add_argument("--synthetic-recordings", type=int, default=24,
                    help="must match the training run's stand-in size")
parser.add_argument("--batch-size", type=int, default=16)
parser.add_argument("--cf-distance", type=float, default=10.0,
                    help="closest_boat used when intervening has_boat -> 1")
parser.add_argument("--wav-dir", type=str, default=None)
parser.add_argument("--label-csv", type=str, default=None)
parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

RUMBLE_ROWS = (3, 20)    # 23.4 - 156 Hz: the stand-in's harmonic stack
CONTROL_ROWS = (128, 256)  # 1 - 2 kHz: untouched by the intervention


def band_energy(spect, rows):
    """Mean linear-magnitude energy of STFT rows ``[rows[0], rows[1])`` of
    ``(B, F, T)`` log-spectrograms."""
    mag = spect[:, rows[0]:rows[1], :].exp()
    return (mag ** 2).mean(dim=(1, 2))


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device

    device = resolve_device(args.device)
    from .common import bigan_from_state
    from .whale_common import load_esrf_dataset, load_whale_bigan
    from ..models.bigan import esrf_bigan_config
    from ..ops.ssim import ssim

    data = load_esrf_dataset(args.wav_dir, args.label_csv, args.synthetic_recordings)
    state, stats, meta = load_whale_bigan(os.path.join(args.model_dir, args.bigan), device)
    model = bigan_from_state(state, esrf_bigan_config(d=meta.get("d", 64)), device).eval()
    cf_dist_scaled = 2 * args.cf_distance / 100.0 - 1.0
    mses, ssims, add_r, rem_r, add_c, rem_c = [], [], [], [], [], []
    done = 0
    with torch.no_grad():
        for batch in data.stream(batch_size=args.batch_size, mode="validation", shuffle=False, device=device):
            img = stats.spect_to_img(batch["audio"])[..., None]
            has_boat = torch.from_numpy(batch["has_boat"]).to(device)
            attrs = {"has_boat": has_boat, "closest_boat": torch.from_numpy(batch["closest_boat"]).to(device)}
            z = model.encoder(img, attrs)
            rec = model.generator(z, attrs)
            mse = ((rec - img) ** 2).mean(dim=(1, 2, 3))
            ss = ssim(rec, img, data_range=2.0, size_average=False)
            # flip has_boat for every window: add a boat at --cf-distance, or remove it
            cur = batch["has_boat"].argmax(axis=1)
            cf_attrs = {"has_boat": torch.from_numpy(np.eye(2, dtype=np.float32)[1 - cur]).to(device),
                        "closest_boat": torch.from_numpy(
                            np.where(cur == 0, cf_dist_scaled, -1.0).astype(np.float32)).to(device)}
            cf = model.generator(z, cf_attrs)
            orig, after = stats.img_to_spect(img[..., 0]), stats.img_to_spect(cf[..., 0])
            ratio_r = (band_energy(after, RUMBLE_ROWS) / band_energy(orig, RUMBLE_ROWS)).cpu().numpy()
            ratio_c = (band_energy(after, CONTROL_ROWS) / band_energy(orig, CONTROL_ROWS)).cpu().numpy()
            mses.append(mse.cpu().numpy())
            ssims.append(ss.cpu().numpy())
            add_r.append(ratio_r[cur == 0])
            rem_r.append(ratio_r[cur == 1])
            add_c.append(ratio_c[cur == 0])
            rem_c.append(ratio_c[cur == 1])
            done += len(cur)
            print(f"[esrf] {done} windows scored", flush=True)

    all_mse = np.concatenate(mses)
    add_r, rem_r = np.concatenate(add_r), np.concatenate(rem_r)
    add_c, rem_c = np.concatenate(add_c), np.concatenate(rem_c)
    print(f"validation windows: {len(all_mse)} (no-boat {len(add_r)}, boat {len(rem_r)})")
    print(f"reconstruction: mse={float(np.mean(all_mse)):.4f} ssim={float(np.mean(np.concatenate(ssims))):.4f}")
    if len(add_r):
        print(f"do(has_boat=1, d={args.cf_distance:g}): rumble-band energy ratio "
              f"median {np.median(add_r):.3f} (want > 1), control-band {np.median(add_c):.3f} (want ~ 1)")
    if len(rem_r):
        print(f"do(has_boat=0): rumble-band energy ratio median {np.median(rem_r):.3f} (want < 1), "
              f"control-band {np.median(rem_c):.3f} (want ~ 1)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
