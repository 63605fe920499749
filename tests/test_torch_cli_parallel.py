"""The training CLIs under a launcher, and the loaders that need spectrogram
statistics.

- ``train_mnist_image_scm --device cpu`` run by 2 gloo ranks (the group made
  the way ``torchrun`` makes it, then found by ``cli.common.data_parallel``)
  saves the checkpoint that one plain process saves, to the 1-vs-4
  tolerance of ``test_torch_data_parallel.py``; rank 0 alone prints and
  writes (its checkpoint and its epoch grid), the other rank's output
  directory stays empty;
- ``init_from_env`` refuses more NCCL ranks on a host than it has cards, and
  a plain run is one process with no group;
- the audio and whale BiGAN loaders refuse a model file without spectrogram
  statistics at load, with a ``KeyError`` that names the file (as the JAX
  loaders do), not an ``AttributeError`` later.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from imagecfgen_torch.parallel.launch import run_ranks

N_TRAIN, N_TEST, BATCH = 128, 32, 32


def narrow_bigan():
    from imagecfgen_torch.models import bigan
    from test_torch_data_parallel import narrow_config

    return narrow_config(bigan)


def train_cli(mesh, data, out):
    """``train_mnist_image_scm`` for one epoch through its ``main``, narrow
    BiGAN patched in; returns what this rank printed."""
    from imagecfgen_torch.cli import train_mnist_image_scm
    from imagecfgen_torch.models import bigan

    cfg = narrow_bigan()
    text = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(text):
        mp.setattr(bigan, "mnist_bigan_config", lambda: cfg)
        code = train_mnist_image_scm.main(["--data-dir", data, "--output-path", out, "--steps", "1",
                                           "--batch-size", str(BATCH), "--save-images-every", "1",
                                           "--device", "cpu"])
    assert code == 0
    return text.getvalue()


def cli_rank(mesh, data, root):
    return train_cli(mesh, data, f"{root}/rank{mesh.rank}")


def test_two_ranks_save_the_one_rank_checkpoint(tmp_path):
    from test_torch_cli_mnist import write_dataset

    from imagecfgen_torch.cli.common import load_bigan
    from imagecfgen_torch.parallel.mesh import data_mesh

    data = tmp_path / "data"
    write_dataset(data, N_TRAIN, N_TEST, 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = train_cli(data_mesh(None), str(data), str(tmp_path / "plain"))
        printed = run_ranks(cli_rank, 2, str(data), str(tmp_path), workdir=str(tmp_path), timeout=180)
    finally:
        torch.set_num_threads(threads)
    assert "epoch 1/1" in plain and "epoch 1/1" in printed[0] and printed[1] == ""
    assert sorted(p.name for p in (tmp_path / "rank0").iterdir()) == ["epoch-1.png", "mnist-bigan.tar"]
    assert not (tmp_path / "rank1").exists() or not any((tmp_path / "rank1").iterdir())
    want, _, want_meta = load_bigan(str(tmp_path / "plain" / "mnist-bigan.tar"), "cpu")
    got, _, got_meta = load_bigan(str(tmp_path / "rank0" / "mnist-bigan.tar"), "cpu")
    assert got_meta["epoch"] == want_meta["epoch"] == 1 and got["step"] == want["step"] == N_TRAIN // BATCH
    assert torch.equal(got["rng"], want["rng"])
    misses = size = 0
    for part in "EGD":
        for name, w in want[part].items():
            err = (got[part][name] - w).abs()
            misses += int((err > 2e-4 + 2e-3 * w.abs()).sum())
            size += w.numel()
            assert err.max().item() <= 2 * 1e-4 * got["opt_d"]["count"], f"{part}.{name}"
    assert misses <= size / 1000, f"{misses} of {size} elements off"


def test_more_nccl_ranks_than_cards_are_refused(monkeypatch):
    from imagecfgen_torch.parallel import mesh

    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks on this host ask for NCCL, one card each, and it has 1"):
        mesh.init_from_env("cuda")


def test_a_plain_run_is_one_process(monkeypatch):
    from imagecfgen_torch.cli.common import data_parallel

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    m, device = data_parallel("cpu")
    assert (m.group, m.rank, m.world, m.is_main, device) == (None, 0, 1, True, torch.device("cpu"))


@pytest.mark.parametrize("loader,kind", [("audio_common.load_audio_bigan", "jax"),
                                         ("audio_common.load_audio_bigan_model", "jax"),
                                         ("whale_common.load_whale_bigan", "jax"),
                                         ("audio_common.load_audio_bigan", "torch")])
def test_a_file_without_statistics_is_refused_at_load(loader, kind, tmp_path):
    import importlib

    from imagecfgen_torch.cli.common import MissingStatsError

    path = str(tmp_path / "bigan.tar")
    if kind == "jax":
        from imagecfgen_tpu.core.checkpoint import save_checkpoint

        save_checkpoint(path, {"params_E": {"w": np.zeros(2, np.float32)}}, meta={"kind": "bigan"})
    else:
        from imagecfgen_torch.core.checkpoint import save_train_state

        save_train_state(path, {"trainer": {"step": 0}}, meta={"kind": "bigan"})
    module, name = loader.split(".")
    load = getattr(importlib.import_module(f"imagecfgen_torch.cli.{module}"), name)
    with pytest.raises(MissingStatsError, match="holds no spectrogram statistics") as err:
        load(path, "cpu")
    assert isinstance(err.value, KeyError) and path in str(err.value)


def test_narrow_config_is_the_cli_tests():
    """The narrow BiGAN of the rank functions, which import no JAX, is
    ``test_torch_train_layers.narrow_config``'s, which the CLI tests use."""
    from test_torch_train_layers import narrow_config

    from imagecfgen_torch.models import bigan

    assert narrow_bigan() == narrow_config(bigan, "mnist")
