"""The AudioMNIST identity metric (``audiomnist_cf_classifier_metric``) of the
JAX script and of the port's CLI on the same files, by value: a model
directory that the JAX package wrote at a small size (the BiGAN and VAE at
d = 2, the 60-way subject classifier at width 0.0625, on the synthetic
stand-in cut to 4 subjects), scored by both with the JAX script's latents
injected into the port (``tests/identity_cross_score.py``). Every row's
subject logits agree, so both name the same subject for every row of the
``bigan``, ``vae`` and ``bigan_int`` lines and print the same lines.

The weights (:func:`scorer_models`) make every part of the metric matter:
the generators' images vary with their latents and the classifier's
subjects with its input, among the 4 subjects the data holds, and no row's
top-two logits lie within 1e-3 of each other, so no row sits on a tie that
float32 sums could break either way."""
import os

import identity_cross_score as ics
import numpy as np
import pytest
from test_torch_cli_audio import jax_models, one_thread, small_data  # noqa: F401  (fixtures)

import fault_verdicts as fv
from imagecfgen_tpu.core import checkpoint as jckpt


@pytest.fixture(scope="module")
def scorer_models(jax_models, tmp_path_factory):  # noqa: F811
    """``jax_models``' files, changed: the BiGAN generator's and the VAE
    decoder's transposed-conv kernels tripled and their biases zero (each
    stride-2 layer otherwise shrinks the signal until the bias sets the
    image), and the classifier's biases zero, its head's kernel a hundred
    times larger and the biases of subjects 5-60 at -100."""
    out = tmp_path_factory.mktemp("identity") / "models"
    out.mkdir()

    def changed(name, trunk_of, change):
        tree, meta = jckpt.load_checkpoint(str(jax_models / name))
        change(trunk_of(tree))
        jckpt.save_checkpoint(str(out / name), tree, meta=meta)

    def louder_convt(trunk):
        for k in [k for k in trunk if k.startswith("convT_")]:
            trunk[k] = trunk[k] * (3.0 if k.endswith("_kernel") else 0.0)

    def head(trunk):
        for k in [k for k in trunk if k.endswith("_bias")]:
            trunk[k] = trunk[k] * 0.0
        trunk["dense_1_kernel"] = trunk["dense_1_kernel"] * 100.0
        trunk["dense_1_bias"][4:] = -100.0

    changed("audio-mnist-bigan.tar", lambda t: t["params_G"]["trunk"], louder_convt)
    changed("audio-mnist-vae.tar", lambda t: t["params"]["decoder"]["trunk"], louder_convt)
    changed("audio-mnist-subject-clf.tar", lambda t: t["params"]["trunk"], head)
    assert sorted(os.listdir(out)) == ["audio-mnist-bigan.tar", "audio-mnist-subject-clf.tar", "audio-mnist-vae.tar"]
    return out


def test_jax_script_and_port_cli_name_the_same_subjects(scorer_models):
    run = ics.cross_score(str(scorer_models), "audio-mnist-subject-clf.tar", log=lambda s: None)
    assert run["min_margin"] >= 1e-3
    hits = {}
    for name in ("bigan", "vae", "bigan_int"):
        line = run["lines"][name]
        assert line["jax"] == line["port"] and line["disagree"] == 0, name
        assert line["jax"][1] == 360  # 40 validation clips, nine of each ten a digit
        assert line["max_logit_gap"] <= 1e-3, name
        hits[name], total = line["jax"]
        assert run["printed"]["jax"][name] == run["printed"]["port"][name] == round(hits[name] / total, 4)
    assert len(set(hits.values())) > 1 and all(0 < h < 360 for h in hits.values())
    assert fv.identity_scorer_verdict(run["lines"]) == "agree"


def test_margin_is_the_top_two_gap():
    np.testing.assert_allclose(ics.margin(np.array([[1.0, 3.0, 2.5], [0.0, -1.0, 0.0]])), [0.5, 0.0])
