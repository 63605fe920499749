"""The port stands alone: no module of ``imagecfgen_torch``, and not
``chip_smoke.py``, imports JAX, flax, optax, msgpack or the JAX package, nor
matplotlib, PIL, pandas, tqdm or torchaudio (the machine with the card has
none of them); and its entry points run on the card unless asked for the
CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "imagecfgen_tpu", "matplotlib", "PIL",
          "pandas", "tqdm", "torchaudio")
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
    SCM fit loop, the checkpoint reader (which must decode msgpack without
    importing it), the explainers, the pixel baselines, the encoder
    fine-tuner and SSIM (whose JAX scripts write their CSVs with pandas)."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert {"imagecfgen_torch/train/gan_trainer.py", "imagecfgen_torch/train/clf_trainer.py",
            "imagecfgen_torch/train/optim.py", "imagecfgen_torch/train/_guards.py",
            "imagecfgen_torch/scm/fit.py", "imagecfgen_torch/core/checkpoint.py",
            "imagecfgen_torch/cf/explain.py", "imagecfgen_torch/cf/baselines.py",
            "imagecfgen_torch/cf/finetune.py", "imagecfgen_torch/ops/ssim.py",
            "chip_smoke.py"} <= names


def test_sources_cover_the_explainer_clis():
    """Pin that the glob reaches the ten CLIs of the explainer slice."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    clis = ("train_morphomnist_oracles", "mnist_cf_explain", "mnist_cf_comparisons", "make_mnist_cf_matrix",
            "show_cf_matrix", "mnist_oracle_scores", "morphomnist_cf_metrics", "finetune_mnist_bigan",
            "mnist_reconstructions", "morphomnist_attribute_shap")
    assert {f"imagecfgen_torch/cli/{m}.py" for m in clis} <= names


@pytest.mark.parametrize("entry", ["EncoderFinetuner", "mnist_cf_explain"])
def test_explainer_slice_without_device_raises_when_no_gpu(monkeypatch, entry, tmp_path):
    from imagecfgen_torch.cf.finetune import EncoderFinetuner, FinetuneConfig
    from imagecfgen_torch.cli import mnist_cf_explain
    from imagecfgen_torch.models.bigan import BiGAN, mnist_bigan_config

    model = BiGAN(mnist_bigan_config(64), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "EncoderFinetuner":
            EncoderFinetuner(model, FinetuneConfig())
        else:
            mnist_cf_explain.main(["--data-dir", str(tmp_path), "--model-dir", str(tmp_path)])


def test_sources_cover_the_audio_slice():
    """Pin that the glob reaches the AudioMNIST data path (STFT, statistics,
    resampling, the dataset, the CLIs' shared module) and its ten CLIs."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    clis = ("audio_common", "train_audio_mnist_attribute_scm", "train_audio_mnist_clf",
            "train_audio_mnist_bigan", "audiomnist_bigan_score", "audiomnist_generator_score",
            "test_audio_gan", "audiomnist_generate", "audio_mnist_reconstruction", "audiomnist_cf_eval",
            "audiomnist_cf_classifier_metric")
    assert {f"imagecfgen_torch/cli/{m}.py" for m in clis} <= names
    assert {"imagecfgen_torch/ops/stft.py", "imagecfgen_torch/ops/spectral.py",
            "imagecfgen_torch/ops/resample.py", "imagecfgen_torch/data/audio_mnist.py"} <= names


@pytest.mark.parametrize("entry", ["all_spectrograms", "GANTrainer_bf16"])
def test_audio_slice_entry_points_raise_when_no_gpu(monkeypatch, entry):
    from imagecfgen_torch.data.audio_mnist import AudioMNISTData
    from imagecfgen_torch.models.bigan import BiGAN, audio_mnist_bigan_config
    from imagecfgen_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    model = BiGAN(audio_mnist_bigan_config(2, 32, torch.bfloat16), "cpu") if entry != "all_spectrograms" else None
    data = AudioMNISTData(None, synthetic_runs=1) if entry == "all_spectrograms" else None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "all_spectrograms":
            data.all_spectrograms()
        else:
            GANTrainer(model, GANTrainConfig())


def test_sources_cover_the_last_mnist_and_audio_modules():
    """Pin that the glob reaches the unconditional GAN, its trainer, and the
    nine CLIs of the slice that ends MNIST and AudioMNIST (four figure CLIs
    drawn without matplotlib)."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    clis = ("display_thickness", "causal_graph_cf", "uncertainty_evolution", "cf_automatic_mix",
            "train_audio_mnist_vae", "audiomnist_vae_score", "audiomnist_vae_generator_score",
            "finetune_audio_mnist_bigan", "train_audio_gan")
    assert {f"imagecfgen_torch/cli/{m}.py" for m in clis} <= names
    assert {"imagecfgen_torch/models/gan.py", "imagecfgen_torch/train/uncond_gan_trainer.py",
            "imagecfgen_torch/tools/trunk_precision.py"} <= names


@pytest.mark.parametrize("entry", ["UncondGenerator", "UncondGANTrainer"])
def test_uncond_gan_without_device_raises_when_no_gpu(monkeypatch, entry):
    from imagecfgen_torch.models.gan import UncondGANConfig, UncondGenerator
    from imagecfgen_torch.train.uncond_gan_trainer import UncondGANTrainConfig, UncondGANTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "UncondGenerator":
            UncondGenerator(UncondGANConfig(d=2))
        else:
            UncondGANTrainer(UncondGANConfig(d=2), UncondGANTrainConfig())


def test_sources_cover_the_cli_slice():
    """Pin that the glob reaches the CLI layer and the data modules it
    reads through."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    clis = ("train_mnist_attribute_scm", "train_mnist_clf", "train_mnist_image_scm",
            "mnist_gan_counterfactuals", "mnist_bigan_score", "mnist_generator_score",
            "train_morphomnist_ae")
    assert {f"imagecfgen_torch/cli/{m}.py" for m in ("common", *clis)} <= names
    assert {"imagecfgen_torch/data/mnist.py", "imagecfgen_torch/data/synthetic_digits.py",
            "imagecfgen_torch/morphomnist/io.py"} <= names


def test_sources_cover_the_morpho_mnist_slice():
    """Pin that the glob reaches the Morpho-MNIST oracle, synthesis and
    measurement, the VAE and its trainer, and the nine CLIs of that slice,
    and that the oracle's C++ sources are the port's own."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    morpho = ("__init__", "_skeletonize", "engine", "io", "measure", "morpho", "perturb", "skeleton")
    clis = ("create_train_dataset", "create_test_dataset", "mnist_gan_measured_cf", "train_mnist_vae",
            "mnist_vae_measured_cf", "mnist_vae_counterfactuals", "mnist_vae_score",
            "mnist_vae_generator_score", "test_vae")
    assert {f"imagecfgen_torch/morphomnist/{m}.py" for m in morpho} <= names
    assert {f"imagecfgen_torch/cli/{m}.py" for m in clis} <= names
    assert {"imagecfgen_torch/data/morphomnist_synth.py", "imagecfgen_torch/metrics/measured.py",
            "imagecfgen_torch/models/vae.py", "imagecfgen_torch/train/vae_trainer.py"} <= names
    for name in ("morphometry", "skeletonize"):
        assert (REPO / "imagecfgen_torch" / "csrc" / f"{name}.cpp").is_file()
    for path in (REPO / "imagecfgen_torch" / "morphomnist").glob("*.py"):
        assert "native/" not in path.read_text(), path.name  # the JAX package's libraries


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


@pytest.mark.parametrize("entry", ["ConditionalVAE", "VAETrainer"])
def test_vae_without_device_raises_when_no_gpu(monkeypatch, entry):
    from imagecfgen_torch.models.vae import ConditionalVAE, mnist_vae_config
    from imagecfgen_torch.train.vae_trainer import VAETrainConfig, VAETrainer

    cfg = mnist_vae_config(64)
    model = ConditionalVAE(cfg, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "ConditionalVAE":
            ConditionalVAE(cfg)
        else:
            VAETrainer(model, VAETrainConfig())


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


def test_sources_cover_the_marine_slice():
    """Pin that the glob reaches the marine data paths, the CLIs' shared
    module and the nine marine CLIs (the ESRF CSV is read without pandas)."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    clis = ("whale_common", "train_whale_clf", "train_whale_bigan", "train_whale_vae", "whale_generator_score",
            "whale_cf_score", "finetune_whale_bigan", "train_esrf_bigan", "finetune_esrf_bigan", "esrf_quality")
    assert {f"imagecfgen_torch/cli/{m}.py" for m in clis} <= names
    assert {"imagecfgen_torch/data/whalecalls.py", "imagecfgen_torch/data/esrf.py"} <= names


@pytest.mark.parametrize("entry", ["whale_stream", "esrf_stream", "whale_BiGAN", "esrf_BiGAN", "whale_VAE"])
def test_marine_slice_entry_points_raise_when_no_gpu(monkeypatch, entry):
    from imagecfgen_torch.data.esrf import EsrfStation
    from imagecfgen_torch.data.whalecalls import WhaleCallData
    from imagecfgen_torch.models.bigan import BiGAN, esrf_bigan_config, whale_bigan_config
    from imagecfgen_torch.models.vae import ConditionalVAE, whale_vae_config

    whale = WhaleCallData(synthetic_clips_per_class=1)
    station = EsrfStation(synthetic_recordings=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "whale_stream":
            next(whale.stream())
        elif entry == "esrf_stream":
            next(station.stream())
        elif entry == "whale_BiGAN":
            BiGAN(whale_bigan_config(2, 32))
        elif entry == "esrf_BiGAN":
            BiGAN(esrf_bigan_config(2, 32))
        else:
            ConditionalVAE(whale_vae_config(2, 32))


def test_sources_cover_the_parallel_and_utility_modules():
    """Pin that the glob reaches data and spatial parallelism (their launcher
    too) and the profiling, logging and heartbeat utilities."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert {f"imagecfgen_torch/parallel/{m}.py" for m in ("__init__", "mesh", "spatial", "launch")} <= names
    assert {f"imagecfgen_torch/utils/{m}.py" for m in ("__init__", "profiling", "logging", "heartbeat")} <= names


def test_sources_cover_the_last_slice():
    """Pin that the glob reaches the reference-checkpoint converter (its
    library, its CLI and the fixtures that write reference-format files), the
    headless mix GUI and the plot helpers."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert {"imagecfgen_torch/core/reference.py", "imagecfgen_torch/cli/convert_reference_checkpoint.py",
            "imagecfgen_torch/tools/reference_fixtures.py", "imagecfgen_torch/cli/mnist_mix_vae_gui.py",
            "imagecfgen_torch/morphomnist/util.py"} <= names


@pytest.mark.parametrize("entry", ["convert_reference_checkpoint", "mnist_mix_vae_gui"])
def test_last_slice_entry_points_raise_when_no_gpu(monkeypatch, entry, tmp_path):
    from imagecfgen_torch.cli import convert_reference_checkpoint, mnist_mix_vae_gui
    from imagecfgen_torch.tools.reference_fixtures import reference_checkpoint

    torch.save(reference_checkpoint("mnist-clf", 0)[0], tmp_path / "ref.tar")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "convert_reference_checkpoint":
            convert_reference_checkpoint.main(["--kind", "mnist-clf", "--input", str(tmp_path / "ref.tar"),
                                               "--output", str(tmp_path / "out.tar")])
        else:
            mnist_mix_vae_gui.main(["--headless", "--data-dir", str(tmp_path), "--model-dir", str(tmp_path)])
    assert not (tmp_path / "out.tar").exists()


def test_sources_cover_the_quality_battery():
    """Pin that the glob reaches the quality battery."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert "imagecfgen_torch/tools/quality_battery.py" in names


def test_quality_battery_raises_when_no_gpu_before_any_stage(monkeypatch, tmp_path):
    """The battery asks for the card before its first stage (minutes of
    synthesis would come first otherwise) and writes nothing."""
    from imagecfgen_torch.tools import quality_battery

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_battery.main([str(tmp_path / "D"), "--hard"])
    assert not (tmp_path / "D").exists()


def test_sources_cover_the_audio_battery():
    """Pin that the glob reaches the AudioMNIST battery."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert "imagecfgen_torch/tools/audio_battery.py" in names


def test_audio_battery_raises_when_no_gpu_before_any_stage(monkeypatch, tmp_path):
    """The AudioMNIST battery runs on the card by default: without one it
    raises before its first stage and writes nothing."""
    from imagecfgen_torch.tools import audio_battery

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audio_battery.main([str(tmp_path / "D")])
    assert not (tmp_path / "D").exists()
