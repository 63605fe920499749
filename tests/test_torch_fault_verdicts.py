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


def test_identity_rank_of_jax_among_the_port_readings():
    assert fv.identity_rank([0.4611, 0.5483, 0.5826, 0.3217, 0.0889, 0.3961]) == {
        "rank": 1, "of": 7, "p_jax_highest": pytest.approx(1 / 7)}
    assert fv.identity_rank([0.61, 0.6002, 0.2], jax=0.6002)["rank"] == 3  # a tie counts as above


@pytest.mark.parametrize("step1,gap,want", [
    ([1e-5, 2e-6], [0.03, -0.03], "agree"),
    ([1.1e-5, 2e-6], [0.0, 0.0], "unresolved"),
    ([1e-5, 2e-6], [0.031, 0.0], "unresolved"),
    ([1e-4, 5e-5], [0.0, 0.0], "unresolved"),
    ([1.01e-4, 2e-6], [0.0, 0.0], "fault"),
    ([1e-6, 1e-6], [0.11, 0.101], "fault"),
    ([1e-6, 1e-6], [-0.11, -0.12], "fault"),
    ([1e-6, 1e-6], [0.11, -0.12], "unresolved"),
    ([1e-6, 1e-6], [0.10, 0.15], "unresolved"),
], ids=["agree-at-the-edges", "step1-just-above", "gap-just-above", "step1-at-the-fault-edge", "step1-fault",
        "both-gaps-up", "both-gaps-down", "gaps-split", "one-gap-at-the-edge"])
def test_clf_trace_rule(step1, gap, want):
    assert fv.clf_trace_verdict(step1, gap) == want


@pytest.mark.parametrize("dist,gap,want", [
    ({"E": 1e-5, "G": 1e-5, "D": 1e-5}, [1e-4, -1e-4], "agree"),
    ({"E": 1.1e-5, "G": 1e-6, "D": 1e-6}, [0.0, 0.0], "unresolved"),
    ({"E": 1e-6, "G": 1e-6, "D": 1e-6}, [2e-4, 0.0], "unresolved"),
    ({"E": 1e-6, "G": 1e-3, "D": 1e-6}, [0.0, 0.0], "unresolved"),
    ({"E": 1e-6, "G": 1e-6, "D": 1.01e-3}, [0.0, 0.0], "fault"),
    ({"E": 1e-6, "G": 1e-6, "D": 1e-6}, [0.0, -1.1e-3], "fault"),
], ids=["agree-at-the-edges", "a-part-just-above", "a-score-just-above", "a-part-at-the-fault-edge",
        "a-part-fault", "a-score-fault"])
def test_audio_step_rule(dist, gap, want):
    assert fv.audio_step_verdict(dist, gap) == want


def scorer_lines(bigan=(100, 100, 0), vae=(50, 50, 0), bigan_int=(70, 70, 0), total=5000):
    return {name: {"jax": [j, total], "port": [p, total], "near_ties": t}
            for name, (j, p, t) in (("bigan", bigan), ("vae", vae), ("bigan_int", bigan_int))}


@pytest.mark.parametrize("lines,want", [
    (scorer_lines(), "agree"),
    (scorer_lines(bigan=(100, 101, 0)), "fault"),
    (scorer_lines(bigan=(100, 101, 1)), "agree"),
    (scorer_lines(vae=(50, 45, 5)), "agree"),
    (scorer_lines(vae=(50, 44, 6)), "fault"),
    (scorer_lines(bigan_int=(70, 72, 1)), "fault"),
    ({**scorer_lines(), "vae": {"jax": [50, 5000], "port": [50, 4999], "near_ties": 0}}, "fault"),
    ({k: v for k, v in scorer_lines().items() if k != "vae"}, "fault"),
], ids=["equal", "one-off-no-tie", "one-off-one-tie", "ties-at-one-in-1000", "ties-above-one-in-1000",
        "two-off-one-tie", "totals-differ", "a-line-missing"])
def test_identity_scorer_rule(lines, want):
    assert fv.identity_scorer_verdict(lines) == want


def bisect_row(port=1e-6, jax=1e-6, apart=1e-6, outside=None, flips=0, unexplained=0):
    return {"update": "D_real", "part": "D", "tensor": "dx.conv_0_kernel", "port": port, "jax": jax,
            "port_vs_jax": apart, "port_vs_jax_outside": apart if outside is None else outside,
            "kink_flips_on_path": flips, "unexplained": unexplained}


def bisect_parts(d=1e-6, outside=None):
    return {"E": {"distance": 1e-7, "outside": 1e-7}, "G": {"distance": 1e-7, "outside": 1e-7},
            "D": {"distance": d, "outside": d if outside is None else outside}}


@pytest.mark.parametrize("rows,parts,want", [
    ([bisect_row()], bisect_parts(), "rounding"),
    ([bisect_row(port=1.1e-5, jax=1e-5, apart=2e-5)], bisect_parts(), "code"),
    ([bisect_row(port=1.1e-5, jax=1e-5, apart=2e-5, flips=1)], bisect_parts(), "rounding"),
    ([bisect_row(port=1.1e-5, jax=1.1e-5, apart=2e-5, outside=1e-5)], bisect_parts(), "rounding"),
    ([bisect_row(port=1e-5, jax=1e-6, apart=1.1e-5, outside=1.1e-5)], bisect_parts(), "unresolved"),
    ([bisect_row(apart=2e-5, outside=1e-6, unexplained=1)], bisect_parts(), "unresolved"),
    ([bisect_row(apart=2e-5, outside=1e-3, unexplained=3, flips=2)], bisect_parts(), "rounding"),
    ([bisect_row()], bisect_parts(1.36e-5, 1e-5), "rounding"),
    ([bisect_row()], bisect_parts(1.36e-5, 1.1e-5), "unresolved"),
    ([bisect_row(), bisect_row(port=3e-5, jax=2e-6, flips=4), bisect_row(port=2e-5, jax=1e-6)], bisect_parts(),
     "code"),
], ids=["all-near", "port-off-jax-at-the-edge", "a-kink-on-the-path", "outside-at-the-edge", "outside-just-above",
        "an-unexplained-sign", "kink-covers-all", "parts-outside-at-the-edge", "parts-outside-just-above",
        "one-tensor-without-a-kink"])
def test_audio_step_bisect_rule(rows, parts, want):
    assert fv.audio_step_bisect_verdict(rows, parts) == want


TF32_IDENTITY = [0.4611, 0.5483, 0.5826, 0.3217, 0.0889, 0.3961]


@pytest.mark.parametrize("witness,want", [
    ([0.59, 0.60, 0.61, 0.62], "arithmetic"),
    ([0.6502] * 4, "arithmetic"),
    ([0.70, 0.71, 0.72, 0.73], "unresolved"),
    ([0.4611, 0.5483, 0.5826, 0.3217], "not arithmetic"),
    ([0.10, 0.20, 0.30, 0.40], "not arithmetic"),
    ([0.35, 0.47, 0.55, 0.60, 0.62], "unresolved"),
    ([0.59, 0.60, 0.61], "not run"),
], ids=["above-every-reading", "median-at-the-edge", "median-too-high", "same-readings", "median-below",
        "between", "three-seeds"])
def test_identity_precision_rule(witness, want):
    verdict, test = fv.identity_precision_verdict(witness, TF32_IDENTITY)
    assert verdict == want
    if want == "not run":
        return
    assert test["tf32_median"] == pytest.approx((0.3961 + 0.4611) / 2)
    if witness[:2] == [0.59, 0.60]:
        assert test["p_higher"] == pytest.approx(1 / 210)  # 4 of 10 all on top: 1 / C(10, 4)
    if want == "unresolved" and witness[0] == 0.35:
        assert fv.PRECISION_P_SHOWN < test["p_higher"] <= fv.PRECISION_P_NOT


def test_report_reads_the_committed_records(capsys):
    assert fv.main(["--report"]) == 0
    lines = {r["rule"] + (":" + r["classifier"] if "classifier" in r else ""): r
             for r in map(json.loads, capsys.readouterr().out.splitlines())}
    assert set(lines) == {"estar", "tpu_precision", "jax_agreement", "jax_rank", "jax_rank_tf32", "tf32_rank",
                          "audio_spread", "identity", "identity_rank", "clf_trace", "audio_step",
                          "audio_step_bisect", "identity_scorer:jax_clf", "identity_scorer:port_clf",
                          "identity_precision"}
    assert lines["estar"]["verdict"] == 40
    assert lines["estar"]["bigan_cf"]["40"] == PORT
    tpu = lines["tpu_precision"]
    assert tpu["records"] == ["hard-560-tpu-precision.json", "hard-440-tpu-precision-seed1.json"]
    assert tpu["epochs"] == [560, 440] and tpu["budget"] == [600, 600]
    assert tpu["bigan_cf"] == [0.998, 0.7222]
    assert tpu["reads_as"] == "unresolved" and tpu["verdict"] == "unresolved: below the budget"
    rank = lines["jax_rank"]
    assert len(rank["jax_cf"]) == 4 and len(rank["port_cf"]) == 12 and rank["verdict"] == "agree"
    assert lines["jax_rank_tf32"]["verdict"] == "port training fault"
    assert lines["tf32_rank"]["verdict"] == "reported"
    assert len(lines["identity"]["readings"]) == 6 and lines["identity"]["verdict"] == "fault stands"
    assert lines["identity_rank"]["rank"] == 1 and lines["identity_rank"]["p_jax_highest"] == pytest.approx(1 / 7)
    clf = lines["clf_trace"]
    assert clf["step1_distance"][0] > fv.CLF_FAULT_STEP1 and clf["verdict"] == "fault"
    step = lines["audio_step"]
    assert step["steps_traced"] == 8 and step["verdict"] == "unresolved"
    assert step["step1_distance"]["D"] == pytest.approx(1.3627e-5, rel=1e-3)
    assert set(step["mnist_growth"]) == set(step["growth"])
    for name in ("jax_clf", "port_clf"):
        scorer = lines["identity_scorer:" + name]
        assert scorer["verdict"] == fv.identity_scorer_verdict(scorer["lines"]) == "agree"
    bisect = lines["audio_step_bisect"]
    assert bisect["step1_parts"]["D"]["distance"] == pytest.approx(step["step1_distance"]["D"], rel=1e-4)
    assert bisect["step1_parts"]["D"]["outside"] == pytest.approx(1.0298e-5, rel=1e-3)
    assert bisect["kink_flips"]["jax"] > 0 and bisect["kink_flips"]["port"] > 0
    assert bisect["verdict"] == "unresolved"
    prec = lines["identity_precision"]
    assert len(prec["witness"]) == 4 and set(prec["seeds"]) == set(prec["witness"])
    assert prec["p_higher"] == pytest.approx(0.6190, abs=1e-4) and prec["witness_median"] < prec["tf32_median"]
    assert prec["verdict"] == "not arithmetic" and prec["jax_rank"]["rank"] == 1
    assert set(lines["identity"]["readings"]) == {f"audio-f32-1200-identity{s}.json" for s in (
        "", "-run2", "-run3", "-seed1", "-seed2", "-seed3")}  # the witness's records are not among them


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
    assert [ln["verdict"] for ln in lines] == ["not run"] * 15
