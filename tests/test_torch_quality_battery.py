"""The port's MNIST quality battery (``imagecfgen_torch/tools/quality_battery.py``):
its stages are ``tools/quality_battery.sh``'s command lines, a tiny run on
the CPU writes a complete record and resumes without redoing a stage, a
fresh run clears stale models, and ``compare`` holds a record to its bands."""
import contextlib
import copy
import os
import re
import shlex
import shutil
from pathlib import Path

import pytest
from imagecfgen_torch.tools import quality_battery as qb

REPO = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--train-glyphs", "32", "--test-glyphs", "32", "--epochs", "1", "--finetune-steps", "1",
        "--scm-steps", "1", "--clf-epochs", "1", "--vae-steps", "1", "--workers", "2"]


def shell_commands(hard: bool, fused: bool):
    """The shell script's python command lines as (script, argv), its arrays
    and defaults expanded for HARD and FUSED, ``$D`` left as ``DIR``."""
    text = (REPO / "tools" / "quality_battery.sh").read_text()
    arrays = {"NOISE": [], "SHIFT": [], "CF_SHIFT": [], "THROUGHPUT_FLAG": ["--throughput"] if fused else []}
    if hard:
        hard_block = text[text.index('if [ "$HARD" = "1" ]'):text.index("else")]
        for name, body in re.findall(r"^\s*(\w+)=\((.*)\)$", hard_block, re.M):
            arrays[name] = [re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", t) for t in shlex.split(body)]
    epochs = re.search(r"EPOCHS=\$\{EPOCHS:-(\d+)\}", text).group(1)
    out = []
    for line in text.replace("\\\n", " ").splitlines():
        m = re.search(r"\bpython (?:-u )?(\w+)\.py (.*)$", line)
        if not m:
            continue
        argv = []
        for tok in shlex.split(m.group(2)):
            arr = re.fullmatch(r"\$\{(\w+)\[@\]\}", tok)
            argv += arrays[arr.group(1)] if arr else [tok.replace("$D", "DIR").replace("$EPOCHS", epochs)]
        out.append((m.group(1), argv))
    return out


def port_commands(hard: bool, fused: bool, tmp_path):
    args = qb.parser.parse_args([str(tmp_path / "D"), *(["--hard"] if hard else []), *(["--fused"] if fused else [])])
    d, a = qb.data_dir(args), qb.arm_dir(args)
    out = []
    for stage in qb.stages(args):
        argv = [t.replace(a, "DIR").replace(d, "DIR") for t in stage.argv]
        if fused:  # the scores read DIR's SCM, classifier and VAE and the arm's BiGAN, named by a flag
            for flag in ("-m", "--image-model"):
                if flag in argv and argv[argv.index(flag) + 1] == "DIR/mnist-bigan.tar":
                    i = argv.index(flag)
                    del argv[i:i + 2]
        out.append((stage.cli, argv))
    return out


@pytest.mark.parametrize("hard,fused", [(False, False), (True, False), (True, True)],
                         ids=["clean", "hard", "hard_fused"])
def test_stages_are_the_shell_scripts_command_lines(hard, fused, tmp_path):
    shell, port = shell_commands(hard, fused), port_commands(hard, fused, tmp_path)
    assert [s for s, _ in shell] == [s for s, _ in port]
    for (script, want), (_, got) in zip(shell, port):
        assert got == want, script


def test_fused_arm_shares_the_default_arms_models(tmp_path):
    args = qb.parser.parse_args([str(tmp_path / "D"), "--hard", "--fused"])
    d, a = qb.data_dir(args), qb.arm_dir(args)
    assert a == d + "_fused"
    by_name = {s.name: s for s in qb.stages(args)}
    assert "--throughput" in by_name["bigan"].argv and by_name["bigan"].argv[
        by_name["bigan"].argv.index("--output-path") + 1] == a
    assert {n for n, s in by_name.items() if s.shared} == {"scm", "clf", "vae"}
    for n in ("scm", "clf", "vae"):
        assert by_name[n].argv[by_name[n].argv.index("--output-path") + 1] == d
    assert by_name["generator_score"].argv[-2:] == ["-m", os.path.join(a, "mnist-bigan.tar")]
    assert by_name["gan_measured_cf"].argv[-2:] == ["--image-model", os.path.join(a, "mnist-bigan.tar")]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One tiny hard battery on the CPU, then a --resume run of it."""
    root = tmp_path_factory.mktemp("battery")
    d = str(root / "D")
    assert qb.main([d, "--hard", *TINY]) == 0
    first = qb.load_record(os.path.join(d, qb.RECORD))
    mtimes = {f: os.path.getmtime(os.path.join(d, f)) for f in os.listdir(d) if f.endswith((".tar", ".npy"))}
    assert qb.main([d, "--hard", "--resume", *TINY]) == 0
    return d, first, mtimes, qb.load_record(os.path.join(d, qb.RECORD))


def test_tiny_run_writes_a_complete_record(tiny_run):
    d, record, _, _ = tiny_run
    names = [s.name for s in qb.stages(qb.parser.parse_args([d, "--hard", *TINY]))]
    assert list(record["stages"]) == names
    for name, entry in record["stages"].items():
        assert set(entry) >= {"cli", "argv", "seconds", "launches", "printed"}, name
        assert entry["launches"] == {"fused_encoder": 0, "fused_dense": 0}  # the CPU runs the plain versions
        assert "--device" not in entry["argv"] or entry["argv"][-2:] == ["--device", "cpu"]
    assert record["stages"]["bigan"]["printed"]["epochs"][0][0] == 1
    assert len(record["stages"]["bigan"]["printed"]["epochs"][0]) == 4
    for key in qb.JAX_HARD:
        assert record["scores"][key] is not None, key
    for key in ("bigan_measured_cf", "vae_measured_cf"):
        assert set(record["scores"][key]) == set(qb.ATTRIBUTES)
    result = qb.compare(record)
    assert all(r["port"] is not None for r in result["rows"])
    assert record["hard"] and record["shifts"]["held_out_shift"] == [1.5, 32.0, 0.4]


def test_resume_skips_every_finished_stage(tiny_run):
    d, first, mtimes, resumed = tiny_run
    assert len(resumed["runs"]) == 2
    assert {k: v["run"] for k, v in resumed["stages"].items()} == {k: 0 for k in first["stages"]}
    assert resumed["scores"] == first["scores"]
    for f, t in mtimes.items():
        assert os.path.getmtime(os.path.join(d, f)) == t, f


@pytest.mark.parametrize("arm", ["default", "fused"])
def test_fresh_run_removes_stale_models(arm, tiny_run, tmp_path):
    src = tiny_run[0]
    d = tmp_path / "D"
    d.mkdir()
    for f in ("mnist-x-train.npy", "mnist-a-train.npy", "mnist-x-test.npy", "mnist-a-test.npy"):
        shutil.copy(os.path.join(src, f), d / f)
    shared = ("mnist-vae.tar", "mnist_clf.tar", "mnist-attribute-scm.tar")
    own = ("mnist-bigan.tar", "mnist-bigan-finetuned-mse.tar", "mnist-bigan-finetuned-ssim.tar")
    a = Path(str(d) + ("_fused" if arm == "fused" else ""))
    a.mkdir(exist_ok=True)
    for f in shared:
        (d / f).write_bytes(b"stale")
    for f in own:
        (a / f).write_bytes(b"stale")
    flags = ["--fused"] if arm == "fused" else []
    assert qb.main([str(d), "--hard", *flags, *TINY, "--stages", "train_data"]) == 0
    assert not any((a / f).exists() for f in own)
    assert all((d / f).exists() for f in shared) == (arm == "fused")  # a fused run keeps DIR's models


def record_with(scores):
    return {"scores": copy.deepcopy(scores)}


def test_compare_passes_the_jax_record_and_a_record_inside_every_band():
    assert qb.compare(record_with(qb.JAX_HARD))["ok"]
    inside = copy.deepcopy(qb.JAX_HARD)
    for key, width in qb.ACCURACY_BANDS.items():
        inside[key] += 0.9 * width if key.startswith("bigan") else -0.9 * width
    inside["bigan_measured_cf"] = {k: v * 1.45 for k, v in inside["bigan_measured_cf"].items()}
    inside["bigan_measured_cf"]["intensity"] = 13.23 / 1.45
    inside["vae_measured_cf"] = {k: v / 1.45 for k, v in inside["vae_measured_cf"].items()}
    result = qb.compare(record_with(inside))
    assert result["ok"] and not result["missed"], result["missed"]


OUTSIDE = [(k, 1.2 * w) for k, w in qb.ACCURACY_BANDS.items()] + [
    (f"{m}_measured_cf.{a}", f) for m in ("bigan", "vae") for a in qb.ATTRIBUTES for f in (1.6, 1 / 1.6)]


@pytest.mark.parametrize("metric,move", OUTSIDE, ids=[f"{k}-{v:.3g}" for k, v in OUTSIDE])
def test_compare_names_a_metric_outside_its_band(metric, move):
    scores = copy.deepcopy(qb.JAX_HARD)
    if "." in metric:
        key, attr = metric.split(".")
        scores[key][attr] *= move
    else:
        scores[metric] -= move
    result = qb.compare(record_with(scores))
    assert not result["ok"] and metric in result["missed"]


@pytest.mark.parametrize("split", ["vae_above_bigan_cf", "vae_above_bigan_generated",
                                   "bigan_below_vae_intensity_error"])
def test_compare_names_a_broken_split(split):
    """The paper's split fails on its own, every band held: the bands of
    the two models do not overlap at these JAX values, so swap the models'
    numbers in a reference that has the split the other way."""
    ref = copy.deepcopy(qb.JAX_HARD)
    pairs = {"vae_above_bigan_cf": ("vae_cf_digit_accuracy", "bigan_cf_digit_accuracy"),
             "vae_above_bigan_generated": ("vae_generated_accuracy", "bigan_generated_accuracy")}
    if split in pairs:
        hi, lo = pairs[split]
        ref[hi], ref[lo] = ref[lo], ref[hi]
    else:
        ref["bigan_measured_cf"]["intensity"], ref["vae_measured_cf"]["intensity"] = 19.16, 13.23
    result = qb.compare(record_with(ref), reference=ref)
    assert result["missed"] == [split]


def test_compare_misses_what_a_record_lacks():
    result = qb.compare({"scores": {}})
    assert not result["ok"] and len(result["missed"]) == len(result["rows"])


def test_deltas_sit_beside_the_jax_fused_deltas():
    arm = record_with(qb.JAX_HARD_FUSED)
    got = qb.deltas(arm, record_with(qb.JAX_HARD))
    assert got["bigan_cf_digit_accuracy"]["port"] == pytest.approx(-0.0508)
    assert got["bigan_cf_digit_accuracy"]["jax"] == pytest.approx(-0.0508)
    assert got["bigan_measured_cf.intensity"]["jax"] == pytest.approx(10.39 - 13.23)
    assert set(got) == {"bigan_cf_digit_accuracy", "bigan_cf_digit_accuracy_finetuned", "bigan_generated_accuracy",
                        *(f"bigan_measured_cf.{a}" for a in qb.ATTRIBUTES)}


@pytest.mark.parametrize("line,want", [
    ("cf digit accuracy: 0.8467", {"cf digit accuracy": 0.8467}),
    ("vae generated-sample digit accuracy: 0.9810", {"vae generated-sample digit accuracy": 0.981}),
    ("median abs errors: {'thickness': 0.8929, 'intensity': 13.23, 'slant': 0.0788}",
     {"median abs errors": {"thickness": 0.8929, "intensity": 13.23, "slant": 0.0788}}),
    ("saved mnist-gan-measured-cf.png", {}),
])
def test_parse_score_reads_every_printed_number(line, want):
    assert qb.parse_score(line) == want


def test_parse_bigan_reads_each_epoch():
    text = ("epoch 1/600: D(G(z))=0.0700 D(E(x))=0.9230 (31.5 steps/s, step 128)\n"
            "epoch 2/600: D(G(z))=0.0701 D(E(x))=0.9680 (33.0 steps/s, step 256)\n")
    assert qb.parse_bigan(text) == {"epochs": [[1, 0.07, 0.923, 31.5], [2, 0.0701, 0.968, 33.0]]}


def test_report_prints_compare_and_deltas(tmp_path, capsys):
    import json

    paths = []
    for name, scores in (("default", qb.JAX_HARD), ("fused", {**qb.JAX_HARD, **qb.JAX_HARD_FUSED})):
        paths.append(str(tmp_path / f"{name}.json"))
        qb.write_record(paths[-1], {**record_with(scores), "fused": name == "fused"})
    assert qb.main(["--report", *paths]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["compare"]["ok"] and "deltas" not in lines[0]
    assert lines[1]["deltas"]["bigan_cf_digit_accuracy"]["port"] == pytest.approx(-0.0508)


# ------------------------------------- the JAX package's battery on the CPU


CONV_T = [  # (input h, w, channels in, out, kernel, stride, padding, output padding)
    (3, 3, 5, 4, 3, 2, 0, 0), (7, 7, 5, 4, 3, 2, 1, 0), (13, 13, 5, 4, 3, 2, 1, 0),  # the MNIST generator's
    (4, 6, 3, 4, 5, 2, 2, 1),  # the audio and marine generators'
    (5, 4, 3, 2, 2, 3, 0, 1), (25, 25, 3, 1, 4, 1, 0, 0)]


@pytest.mark.parametrize("h,w,c,o,k,s,p,op", CONV_T, ids=[f"k{c[4]}s{c[5]}p{c[6]}o{c[7]}-{c[0]}x{c[1]}" for c in CONV_T])
def test_phase_conv_transpose_is_the_jax_packages(h, w, c, o, k, s, p, op):
    """The CPU witness's transposed conv equals ``ops/conv.py``'s, value
    and both gradients, to float32 rounding."""
    import jax
    import numpy as np
    from jax_cpu_battery import phase_conv_transpose2d

    from imagecfgen_tpu.ops.conv import conv_transpose2d

    rng = np.random.default_rng(h * 100 + k)
    x, kernel = rng.normal(size=(2, h, w, c)).astype(np.float32), rng.normal(size=(k, k, c, o)).astype(np.float32)
    want, got = conv_transpose2d(x, kernel, s, p, op), phase_conv_transpose2d(x, kernel, s, p, op)
    dy = rng.normal(size=want.shape).astype(np.float32)
    grads = [jax.grad(lambda a, b: (f(a, b, s, p, op) * dy).sum(), (0, 1))(x, kernel)
             for f in (conv_transpose2d, phase_conv_transpose2d)]
    for ref, have in ((want, got), *zip(*grads)):
        np.testing.assert_allclose(np.asarray(have), np.asarray(ref), rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_jax_witness_runs_each_stage_through_the_jax_packages_script(tmp_path):
    names = [s.cli for s in qb.stages(qb.parser.parse_args([str(tmp_path), "--hard"]))]
    assert all((REPO / f"{name}.py").is_file() for name in names)


def test_jax_witness_reads_every_epoch():
    from jax_cpu_battery import per_epoch

    text = "epoch 1/100: -elbo=2456.58 (787.8 steps/s)\nsaved x\nepoch 2/100: -elbo=2403.19 (789.6 steps/s)\n"
    assert per_epoch(text) == [{"epoch": 1, "-elbo": 2456.58}, {"epoch": 2, "-elbo": 2403.19}]


RECORDS = REPO / "imagecfgen_torch" / "tools" / "battery_records"
RUNS = {"hard-600.json": [], "hard-600-fused.json": ["--fused"], "hard-600-seed1.json": ["--seed", "1"],
        "hard-10-rehearsal.json": ["--epochs", "10"],
        # where the BiGAN leaves chance: each seed at 20 epochs, then resumed to 30 and 40
        **{f"hard-{e}-seed{s}.json": ["--epochs", str(e), "--seed", str(s)] for e in (20, 30, 40) for s in range(4)},
        # more seeds at 40 epochs, trained there in one stage, for the rank test against the JAX package's
        **{f"hard-40-seed{s}.json": ["--epochs", "40", "--seed", str(s)] for s in range(4, 12)},
        # the same at 40 epochs with TF32 off, in a directory of their own (its data's entries came with the
        # data from .battery_torch_hard, and are not this run's)
        **{f"hard-40-f32-seed{s}.json": [".battery_torch_f32", "--epochs", "40", "--seed", str(s)] for s in range(12)}}


# the TPU-precision witness's arms (tests/tpu_default_precision.py), whose
# BiGAN stage a call's time limit cut: its command line is the first line of
# the stage's output, committed beside the record
WITNESS_RUNS = {"hard-440-tpu-precision.json": [], "hard-440-tpu-precision-seed1.json": ["--seed", "1"],
                "hard-560-tpu-precision.json": []}


@pytest.mark.parametrize("name", [*RUNS, *WITNESS_RUNS])
def test_committed_records_ran_the_drivers_command_lines(name, monkeypatch):
    """Each stage a committed record ran has the command line the battery
    gives it now, relative to the directory the record was made in."""
    import json

    import tpu_default_precision as tdp

    monkeypatch.chdir(REPO)
    record = json.loads((RECORDS / name).read_text())
    witness = name in WITNESS_RUNS
    with (tdp.witness_driver() if witness else contextlib.nullcontext(qb)) as driver:
        args = driver.parser.parse_args(["--hard", *(WITNESS_RUNS[name] if witness else RUNS[name])])
        base = os.path.join(os.getcwd(), "")
        want = {s.name: [t[len(base):] if t.startswith(base) else t for t in s.argv] + ["--device", "cuda"] * s.device
                for s in driver.stages(args)}
    ran = {k: v["argv"] for k, v in record["stages"].items() if "argv" in v}
    if (RUNS.get(name) or [""])[0] == ".battery_torch_f32":
        ran = {k: v for k, v in ran.items() if k not in ("train_data", "test_data")}
    if witness:
        assert record["tpu_precision"] == tdp.SEMANTICS and "bigan" not in ran
        head = (RECORDS / name.replace(".json", "-bigan.log")).read_text().splitlines()[0].split()
        assert head[:3] == ["===", "bigan:", "train_mnist_image_scm"]
        ran["bigan"] = [re.sub(r"^/.*/(?=\.battery_torch_hard)", "", t) for t in head[3:]]
    assert "bigan" in ran and ran == {k: want[k] for k in ran}


@pytest.fixture(scope="module")
def jax_model_dir(tmp_path_factory):
    """A narrow JAX BiGAN, attribute SCM and classifier saved by the JAX
    package's functions, and the port's objects read from those files."""
    import dataclasses

    import jax
    import numpy as np
    from test_torch_clf_trainer import redraw
    from test_torch_gan_trainer import jax_state
    from test_torch_train_layers import narrow_config, narrow_plan

    from imagecfgen_tpu.cf.engine import CounterfactualEngine as JEngine
    from imagecfgen_tpu.cli import common as jcommon
    from imagecfgen_tpu.core import checkpoint as jckpt
    from imagecfgen_tpu.core.attributes import MNIST_SPEC as J_SPEC
    from imagecfgen_tpu.core.attributes import AttributeScaler as JScaler
    from imagecfgen_tpu.models import bigan as jbigan
    from imagecfgen_tpu.models import classifier as jclf
    from imagecfgen_tpu.scm.mnist import MNISTAttributeSCM as JSCM
    from imagecfgen_tpu.scm.mnist import build_mnist_graph as j_build
    from imagecfgen_torch.cf.engine import CounterfactualEngine
    from imagecfgen_torch.cli.common import bigan_from_state, load_attribute_scm, load_bigan, load_classifier
    from imagecfgen_torch.models import bigan as tbigan
    from imagecfgen_torch.models import classifier as tclf

    d = tmp_path_factory.mktemp("jax_models")
    _, st, rng = jax_state("mnist", 0, {})
    n = 48
    attrs = {"thickness": rng.uniform(1, 5, n).astype(np.float32), "intensity": rng.uniform(64, 255, n).astype(np.float32),
             "slant": rng.uniform(-0.6, 0.6, n).astype(np.float32),
             "digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]}
    x = rng.uniform(-1, 1, (n, 28, 28, 1)).astype(np.float32)
    jscaler = JScaler.fit(J_SPEC, attrs)
    jcommon.save_bigan(str(d / "mnist-bigan.tar"), st, jscaler)
    i, s = attrs["intensity"], attrs["slant"]
    graph = j_build(i.min(), i.max(), s.min(), s.max())
    jscm = JSCM(graph, *jax.device_get(graph.init(jax.random.PRNGKey(1))))
    jcommon.save_attribute_scm(str(d / "mnist-attribute-scm.tar"), jscm)
    narrow_clf = lambda mod: dataclasses.replace(  # noqa: E731
        mod.mnist_classifier_config(), plan=narrow_plan(mod.mnist_classifier_config().plan, 8, keep_last=False))
    jm_clf = jclf.CNNClassifier(narrow_clf(jclf))
    cparams = redraw(jm_clf.init(jax.random.PRNGKey(2), x[:2])["params"], rng)
    jckpt.save_checkpoint(str(d / "mnist_clf.tar"), {"params": cparams}, meta={"kind": "mnist-clf"})
    jeng = JEngine(jbigan.BiGAN(narrow_config(jbigan, "mnist")), st.params_E, st.params_G, jscm, jscaler)
    state, scaler, _ = load_bigan(str(d / "mnist-bigan.tar"), "cpu")
    scm = load_attribute_scm(str(d / "mnist-attribute-scm.tar"), "cpu")
    teng = CounterfactualEngine(bigan_from_state(state, narrow_config(tbigan, "mnist"), "cpu"), scm, scaler, "cpu")
    tclf_fn = load_classifier(str(d / "mnist_clf.tar"), narrow_clf(tclf), "cpu")
    return d, x, attrs, (jeng, lambda im: jm_clf.apply({"params": cparams}, im)), (teng, tclf_fn)


def test_cross_score_takes_the_jax_scripts_cf_draws(jax_model_dir):
    """The port's CF score on the JAX model, with the draws the JAX script's
    key chain gives (a split a batch, three a round), prints what the JAX
    score prints, batch after batch."""
    import jax
    import jax.numpy as jnp
    import torch
    from jax_cpu_battery import injected_cf_score

    from imagecfgen_tpu.metrics import scores as jscores
    from imagecfgen_torch.metrics import scores

    _, x, attrs, (jeng, jclf_fn), (teng, tclf_fn) = jax_model_dir
    shift = dict(zip(("thickness", "intensity", "slant"), qb.HELD_OUT_SHIFT))
    rng, port = jax.random.PRNGKey(0), injected_cf_score(scores.cf_effectiveness_score, 0)
    for i in range(0, len(x), 16):
        xb, ab = x[i:i + 16], {k: v[i:i + 16] for k, v in attrs.items()}
        rng, k = jax.random.split(rng)
        want = jscores.cf_effectiveness_score(jeng, jclf_fn, jnp.asarray(xb), {k2: jnp.asarray(v) for k2, v in ab.items()},
                                              k, mc_rounds=2, held_out_shift=shift)
        got = port(teng, tclf_fn, torch.from_numpy(xb), ab, torch.Generator().manual_seed(7), mc_rounds=2,
                   held_out_shift=shift)
        assert f"{got:.4f}" == f"{want:.4f}"


def test_cross_score_takes_the_jax_scripts_generator_draws(jax_model_dir):
    import jax
    import torch
    from jax_cpu_battery import injected_generator_score

    from imagecfgen_tpu.metrics import scores as jscores
    from imagecfgen_torch.metrics import scores

    d, _, _, (jeng, jclf_fn), (teng, tclf_fn) = jax_model_dir
    want = jscores.generator_score(lambda z, a: jeng.bigan.generator.apply({"params": jeng.params_G}, z, a),
                                   jclf_fn, jeng.scm, jeng.scaler, jax.random.PRNGKey(3), n=64, latent_dim=32)
    port = injected_generator_score(scores.generator_score, 3, str(d / "mnist-attribute-scm.tar"))
    got = port(teng.bigan.generator, tclf_fn, teng.scm, teng.scaler, torch.Generator().manual_seed(7), n=64,
               latent_dim=32, device="cpu")
    assert f"{got:.4f}" == f"{want:.4f}"
