"""The port stands alone: no module of ``imagecfgen_torch``, and not
``chip_smoke.py``, imports JAX, flax, optax, msgpack or the JAX package; and
its entry points run on the card unless asked for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "imagecfgen_tpu")
SOURCES = sorted((REPO / "imagecfgen_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_banned_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_sources_cover_the_training_slice():
    """The file list above is a glob; pin that it reaches the trainers, the
    SCM fit loop and the checkpoint reader (which must decode msgpack without
    importing it)."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert {"imagecfgen_torch/train/gan_trainer.py", "imagecfgen_torch/train/clf_trainer.py",
            "imagecfgen_torch/train/optim.py", "imagecfgen_torch/train/_guards.py",
            "imagecfgen_torch/scm/fit.py", "imagecfgen_torch/core/checkpoint.py",
            "chip_smoke.py"} <= names


def test_port_imports_with_jax_blocked():
    """Import every port module, and chip_smoke, in a fresh interpreter in
    which the banned packages cannot be imported."""
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts) for p in SOURCES]
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import sys, importlib, importlib.abc\n"
        f"BANNED = {BANNED!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BANNED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BANNED]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _cpu_engine_parts():
    from imagecfgen_torch.core.attributes import MNIST_SPEC, AttributeScaler
    from imagecfgen_torch.models.bigan import BiGAN, mnist_bigan_config
    from imagecfgen_torch.scm.mnist import MNISTAttributeSCM, build_mnist_graph

    graph = build_mnist_graph(64.0, 255.0, -1.0, 1.0)
    scm = MNISTAttributeSCM(graph, *graph.init(None, "cpu"))
    scaler = AttributeScaler(MNIST_SPEC, {k: 0.0 for k in ("thickness", "intensity", "slant")},
                             {k: 1.0 for k in ("thickness", "intensity", "slant")})
    return BiGAN(mnist_bigan_config(64), "cpu"), scm, scaler


def test_engine_without_device_raises_when_no_gpu(monkeypatch):
    from imagecfgen_torch.cf.engine import CounterfactualEngine

    bigan, scm, scaler = _cpu_engine_parts()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CounterfactualEngine(bigan, scm, scaler)
    assert CounterfactualEngine(bigan, scm, scaler, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("builder", ["BiGAN", "Encoder", "Generator", "scm"])
def test_builders_without_device_raise_when_no_gpu(monkeypatch, builder):
    from imagecfgen_torch.models import bigan
    from imagecfgen_torch.scm.mnist import MNISTAttributeSCM, build_mnist_graph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if builder == "scm":
            graph = build_mnist_graph(64.0, 255.0, -1.0, 1.0)
            p, s = graph.init(None, "cpu")
            MNISTAttributeSCM.from_state_dict(MNISTAttributeSCM(graph, p, s).state_dict())
        else:
            getattr(bigan, builder)(bigan.mnist_bigan_config(64))


@pytest.mark.parametrize("entry", ["CNNClassifier", "audio_BiGAN", "audio_scm", "generator_score"])
def test_audio_slice_without_device_raises_when_no_gpu(monkeypatch, entry):
    from imagecfgen_torch.metrics.scores import generator_score
    from imagecfgen_torch.models.bigan import BiGAN, audio_mnist_bigan_config
    from imagecfgen_torch.models.classifier import CNNClassifier, audio_mnist_classifier_config
    from imagecfgen_torch.scm.audio_mnist import AudioMNISTAttributeSCM, build_audio_mnist_graph

    graph = build_audio_mnist_graph()
    scm = AudioMNISTAttributeSCM(graph, *graph.init(None, "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "CNNClassifier":
            CNNClassifier(audio_mnist_classifier_config(10, width=0.125))
        elif entry == "audio_BiGAN":
            BiGAN(audio_mnist_bigan_config(8, 64))
        elif entry == "audio_scm":
            AudioMNISTAttributeSCM.from_state_dict(scm.state_dict())
        else:
            generator_score(None, None, scm, None, None, n=4)


def test_resolve_device():
    from imagecfgen_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
