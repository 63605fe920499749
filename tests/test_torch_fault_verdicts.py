"""The decision rules of the batteries' open faults (``tests/fault_verdicts.py``),
each held inside and outside its bounds, and ``--report`` on the committed
records."""
import json

import pytest

import fault_verdicts as fv


@pytest.mark.parametrize("cf,want", [
    ({20: [0.5, 0.6, 0.7, 0.9], 30: [0.9] * 4, 40: [0.9] * 4}, 20),
    ({20: [0.49, 0.6, 0.7, 0.9], 30: [0.5, 0.6, 0.7, 0.9], 40: [0.9] * 4}, 30),
    ({20: [0.2] * 4, 30: [0.9, 0.9, 0.9, 0.1], 40: [0.62, 0.96, 0.78, 0.76]}, 40),
    ({20: [0.2] * 4, 30: [0.3] * 4, 40: [0.9, 0.9, 0.9, 0.4999]}, 60),
    ({20: [0.9, None, 0.9, 0.9], 30: [0.3] * 4, 40: [0.3] * 4}, 60),
], ids=["20", "30-at-the-edge", "40", "none-then-60", "a-missing-seed"])
def test_estar_is_the_first_budget_where_every_seed_leaves_chance(cf, want):
    assert fv.estar(cf) == want


@pytest.mark.parametrize("cf,gen,want", [
    ([0.92, 0.85], [0.90, 0.80], "shown"),
    ([0.921, 0.85], [0.80, 0.80], "unresolved"),
    ([0.90, 0.85], [0.901, 0.80], "unresolved"),
    ([0.97, 0.999], [0.99, 0.98], "refuted"),
    ([0.969, 0.999], [0.99, 0.98], "unresolved"),
    ([0.95, 0.95], [0.95, 0.95], "unresolved"),
], ids=["shown-at-the-edges", "cf-just-above", "generated-just-above", "refuted-at-the-edge",
        "one-seed-below-0.97", "between"])
def test_tpu_precision_rule(cf, gen, want):
    assert fv.tpu_precision_verdict(cf, gen) == want


PORT = [0.9614, 0.6182, 0.7837, 0.7559]


@pytest.mark.parametrize("jax_cf,want", [
    ([0.5682, 1.0], "agree"), ([0.70], "agree"), ([0.5681, 0.8], "unresolved"),
    ([0.50, 0.45], "port training fault"), ([0.5181], "port training fault"), ([0.5183], "unresolved"),
    ([0.30, 0.70], "unresolved"),
], ids=["agree-at-the-edges", "one-seed", "just-below", "fault", "fault-at-the-edge", "between",
        "split"])
def test_jax_agreement_rule(jax_cf, want):
    assert fv.jax_agreement_verdict(jax_cf, PORT) == want


RANK_PORT = [0.5801, 0.4844, 0.5977, 0.7920, 0.45, 0.52, 0.55, 0.62, 0.66, 0.70, 0.74, 0.88]


@pytest.mark.parametrize("jax_cf,port_cf,want", [
    ([0.2793, 0.2729, 0.30, 0.25], RANK_PORT, "port training fault"),
    ([0.50, 0.60, 0.70, 0.80], RANK_PORT, "agree"),
    ([0.50, 0.51, 0.52, 0.53], [0.54, 0.55, 0.56, 0.57, 0.58, 0.59, 0.60, 0.61, 0.62, 0.63, 0.64, 0.65],
     "unresolved"),
    ([0.30, 0.30, 0.30, 0.30], RANK_PORT, "port training fault"),
    ([0.50, 0.50, 0.60, 0.60], [0.50] * 6 + [0.60] * 6, "agree"),
    ([0.40, 0.45, 0.62, 0.90], [0.70] * 12, "unresolved"),
    ([0.2793, 0.2729, 0.30], RANK_PORT, "not run"),
    ([0.2793, 0.2729, 0.30, 0.25], RANK_PORT[:11], "not run"),
], ids=["all-jax-below", "interleaved", "p-small-gap-small", "tied-jax-below", "ties-across", "gap-too-wide",
        "three-jax-seeds", "eleven-port-seeds"])
def test_jax_rank_rule(jax_cf, port_cf, want):
    assert fv.jax_rank_verdict(jax_cf, port_cf) == want


def test_rank_test_is_exact():
    t = fv.rank_test([0.1, 0.2, 0.3, 0.4], [0.5 + 0.01 * i for i in range(12)])
    assert t["p_lower"] == pytest.approx(1 / 1820) and t["p_two_sided"] == pytest.approx(2 / 1820)
    assert t["median_gap"] == pytest.approx(0.555 - 0.25)


@pytest.mark.parametrize("cf,want", [
    ([0.9933, 0.9383, 0.99, 0.98, 0.97, 0.96], "spread"),
    ([0.9933, 0.9383, 0.94, 0.95, 0.99, 0.98], "unresolved"),
    ([0.93, 0.94, 0.94, 0.95, 0.94, 0.92], "fault"),
    ([0.9533, 0.9533, 0.9533, 0.9533, 0.99, 1.0], "spread"),
], ids=["spread", "three-inside", "mean-outside", "edges"])
def test_audio_spread_rule(cf, want):
    assert fv.audio_spread_verdict(cf) == want


@pytest.mark.parametrize("readings,want", [
    ([0.4611, 0.5483, 0.5826, 0.62, 0.64, 0.65], "spread"),
    ([0.4611, 0.5483, 0.5826, 0.50, 0.52, 0.55], "fault stands"),
    ([0.40, 0.42, 0.44, 0.61, 0.45, 0.46], "fault stands"),
], ids=["spread", "below-the-range", "mean-too-far"])
def test_identity_rule(readings, want):
    verdict, gap = fv.identity_verdict(readings)
    assert verdict == want
    assert gap == pytest.approx(sum(readings) / len(readings) - 0.6002)


def test_report_reads_the_committed_records(capsys):
    assert fv.main(["--report"]) == 0
    lines = {r["rule"]: r for r in map(json.loads, capsys.readouterr().out.splitlines())}
    assert set(lines) == {"estar", "tpu_precision", "jax_agreement", "jax_rank", "jax_rank_tf32", "tf32_rank",
                          "audio_spread", "identity"}
    assert lines["estar"]["verdict"] == 40
    assert lines["estar"]["bigan_cf"]["40"] == PORT
    tpu = lines["tpu_precision"]
    assert tpu["epochs"] == [440, 440] and tpu["budget"] == [600, 600]
    assert tpu["reads_as"] == "shown" and tpu["verdict"] == "unresolved: below the budget"
    rank = lines["jax_rank"]
    assert len(rank["jax_cf"]) == 4 and len(rank["port_cf"]) == 12 and rank["verdict"] == "agree"
    assert lines["jax_rank_tf32"]["verdict"] == "port training fault"
    assert lines["tf32_rank"]["verdict"] == "reported"
    assert len(lines["identity"]["readings"]) == 6 and lines["identity"]["verdict"] == "fault stands"


def test_trained_epochs_of_a_whole_and_a_cut_stage(tmp_path):
    whole = {"stages": {"bigan": {"printed": {"epochs": [[599, 0.1, 0.9, 30.0], [600, 0.1, 0.9, 30.0]]}}}}
    assert fv.trained_epochs(whole, str(tmp_path / "none.log")) == 600
    log = tmp_path / "cut.log"
    log.write_text("=== bigan: x\nepoch 446/600: D(G(z))=0.07\nepoch 447/600: D(G(z))=0.08\n")
    assert fv.trained_epochs({"stages": {}}, str(log)) == 440  # the checkpoint before the cut
    assert fv.trained_epochs({"stages": {}}, str(tmp_path / "none.log")) is None


def test_report_says_not_run_without_records(tmp_path, capsys):
    assert fv.main(["--report", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["verdict"] for ln in lines] == ["not run"] * 8
