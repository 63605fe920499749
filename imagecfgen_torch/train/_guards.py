"""Shared trainer sanity checks (the port's copy of
``imagecfgen_tpu/train/_guards.py``)."""
import sys


def resolve_batch(n: int, batch_size: int, multiple: int = 1) -> int:
    """Effective batch size for an ``n``-sample set.

    Epochs drop the partial remainder batch, so a dataset smaller than one
    batch would run zero steps and report NaN metrics while leaving the
    parameters untouched. Clamp to the largest batch that fits (a multiple
    of ``multiple``), with a loud warning.
    """
    if n >= batch_size:
        return batch_size
    clamped = n // multiple * multiple
    if clamped == 0:
        raise ValueError(
            f"dataset ({n} samples) cannot fill even one batch element per "
            f"device on a {multiple}-device data axis")
    print(
        f"[trainer] dataset ({n} samples) is smaller than one batch "
        f"({batch_size}); clamping batch size to {clamped} for this run",
        file=sys.stderr)
    return clamped


def require_full_batch(n: int, batch_size: int) -> None:
    """Once an epoch's batch size is fixed, every dataset fed to it must
    fill at least one batch (the epoch would otherwise run zero steps and
    report NaN)."""
    if n < batch_size:
        raise ValueError(
            f"dataset ({n} samples) is smaller than one batch ({batch_size}); "
            "the epoch would run zero steps and report NaN metrics "
            "— lower batch_size")
