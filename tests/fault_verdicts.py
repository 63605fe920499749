"""The decision rules of the quality batteries' open faults, each fixed
before the runs that decide it, and the verdicts the committed records give.

    python tests/fault_verdicts.py --report [RECORDS_DIR]

``--report`` prints one JSON line a rule: the numbers it read, from which
records, and its verdict ("not run" where a record is missing). The records
are ``imagecfgen_torch/tools/battery_records/``'s:

- ``estar``: the port's MNIST hard BiGAN at 20, 30 and 40 epochs, seeds 0-3
  (``hard-{20,30,40}-seed{0..3}.json``);
- ``tpu_precision_verdict``: the same under
  ``tests/tpu_default_precision.py``, seeds 0 and 1
  (``hard-<epochs>-tpu-precision[-seed1].json``, the BiGAN stage's output
  beside each in ``...-bigan.log``); the rule is read at the record's budget
  (600 epochs), and a BiGAN cut short is reported as unresolved, with what
  its scores read as;
- ``jax_agreement_verdict``: the JAX package's BiGAN at ``E*`` on the CPU
  (``jax-cpu-hard-<E*>*.json``, from ``tests/jax_cpu_battery.py``) against the
  port's four seeds at ``E*``;
- ``jax_rank_verdict``: the same JAX runs, seeds 0-3 (``jax-cpu-hard-<E*>.json``,
  ``...-seed{1,2,3}.json``), ranked against the port's twelve seeds at
  ``E*`` with TF32 off (``hard-<E*>-f32-seed{0..11}.json``), the decided
  pool; beside it, without deciding anything, the same rule on the TF32
  pool (``hard-<E*>-seed{0..11}.json``) and one rank test of TF32 on
  against TF32 off;
- ``audio_spread_verdict``: the AudioMNIST bf16 arm's CF at every committed
  seed (``audio-bf16-1200*.json``);
- ``identity_verdict``: the float32 identity arm's subject identity after a
  digit CF, every committed BiGAN run scored by the port's seed-0 subject
  classifier (``audio-f32-1200-identity*.json``).
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys
from statistics import median
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = os.path.join(REPO, "imagecfgen_torch", "tools", "battery_records")

CHANCE_LEFT = 0.5  # a BiGAN CF at or above it has left chance
BUDGETS, FALLBACK = (20, 30, 40), 60
SHOWN_CF, SHOWN_GENERATED, REFUTED_CF = 0.92, 0.90, 0.97
AGREE_MARGIN, FAULT_MARGIN = 0.05, 0.10
RANK_FAULT_P, RANK_FAULT_GAP = 0.01, 0.10  # one-sided p at most, median gap above
RANK_AGREE_P, RANK_AGREE_GAP = 0.10, 0.15  # two-sided p at least, |median gap| at most
RANK_JAX_SEEDS, RANK_PORT_SEEDS = 4, 12
AUDIO_BF16_CF, AUDIO_BAND, AUDIO_MIN_INSIDE = 0.9833, 0.03, 4
JAX_IDENTITY, IDENTITY_BAND = 0.6002, 0.05
EDGE = 1e-9  # a reading printed at a bound lies on it, whatever the float sum's last bit


def estar(cf: Mapping[int, Sequence[Optional[float]]]) -> int:
    """The smallest budget at which every seed's BiGAN CF reads at least
    :data:`CHANCE_LEFT`; :data:`FALLBACK` if none."""
    for budget in sorted(cf):
        if cf[budget] and all(v is not None and v >= CHANCE_LEFT for v in cf[budget]):
            return budget
    return FALLBACK


def tpu_precision_verdict(cf: Sequence[float], generated: Sequence[float]) -> str:
    """"shown" when every seed reads CF at most 0.92 and generated accuracy at
    most 0.90 (more than half the gap to JAX's 0.8467 / 0.8027); "refuted"
    when every seed reads CF at least 0.97; else "unresolved"."""
    if cf and all(c <= SHOWN_CF for c in cf) and len(generated) == len(cf) and all(
            g <= SHOWN_GENERATED for g in generated):
        return "shown"
    if cf and all(c >= REFUTED_CF for c in cf):
        return "refuted"
    return "unresolved"


def jax_agreement_verdict(jax_cf: Sequence[float], port_cf: Sequence[float]) -> str:
    """"agree" when every JAX seed's CF lies within [min - 0.05, max + 0.05]
    of the port's seeds; "port training fault" when every JAX seed lies more
    than 0.10 below the port's minimum; else "unresolved"."""
    lo, hi = min(port_cf), max(port_cf)
    if jax_cf and all(lo - AGREE_MARGIN - EDGE <= j <= hi + AGREE_MARGIN + EDGE for j in jax_cf):
        return "agree"
    if jax_cf and all(j < lo - FAULT_MARGIN for j in jax_cf):
        return "port training fault"
    return "unresolved"


def rank_test(low: Sequence[float], high: Sequence[float]) -> Dict[str, float]:
    """The exact Mann-Whitney test of ``low`` against ``high``: the
    one-sided p that ``low`` lies lower, the two-sided p, and the median of
    ``high`` less the median of ``low``."""
    from scipy.stats import mannwhitneyu

    return {"p_lower": float(mannwhitneyu(low, high, alternative="less", method="exact").pvalue),
            "p_two_sided": float(mannwhitneyu(low, high, alternative="two-sided", method="exact").pvalue),
            "median_gap": median(high) - median(low)}


def jax_rank_verdict(jax_cf: Sequence[float], port_cf: Sequence[float]) -> str:
    """"port training fault" when the exact one-sided Mann-Whitney p that
    JAX's CFs lie lower is at most 0.01 and the port's median exceeds JAX's
    by more than 0.10; "agree" when the exact two-sided p is at least 0.10
    and the medians differ by at most 0.15; else "unresolved". Fewer than
    four JAX seeds or twelve port seeds: "not run"."""
    if len(jax_cf) < RANK_JAX_SEEDS or len(port_cf) < RANK_PORT_SEEDS:
        return "not run"
    t = rank_test(jax_cf, port_cf)
    if t["p_lower"] <= RANK_FAULT_P + EDGE and t["median_gap"] > RANK_FAULT_GAP + EDGE:
        return "port training fault"
    if t["p_two_sided"] >= RANK_AGREE_P - EDGE and abs(t["median_gap"]) <= RANK_AGREE_GAP + EDGE:
        return "agree"
    return "unresolved"


def audio_spread_verdict(cf: Sequence[float]) -> str:
    """"spread" when at least four of the seeds lie inside 0.9833 ± 0.03 and
    their mean does; "fault" when the mean lies outside; else "unresolved"."""
    mean = sum(cf) / len(cf)
    inside = sum(abs(c - AUDIO_BF16_CF) <= AUDIO_BAND + EDGE for c in cf)
    if abs(mean - AUDIO_BF16_CF) > AUDIO_BAND + EDGE:
        return "fault"
    return "spread" if inside >= AUDIO_MIN_INSIDE else "unresolved"


def identity_verdict(readings: Sequence[float]) -> Tuple[str, float]:
    """("spread", gap) when JAX's 0.6002 lies within the readings' range and
    their mean within 0.05 of it, else ("fault stands", gap); ``gap`` is the
    readings' mean less JAX's."""
    gap = sum(readings) / len(readings) - JAX_IDENTITY
    inside = min(readings) <= JAX_IDENTITY <= max(readings) and abs(gap) <= IDENTITY_BAND + EDGE
    return ("spread" if inside else "fault stands"), gap


# ---------------------------------------------------------------- records

CHECKPOINT_EVERY = 10  # the BiGAN trainer's checkpoint cadence, in epochs


def trained_epochs(record: Dict, log: str) -> Optional[int]:
    """The epochs the scored BiGAN had trained: its stage's last printed
    epoch; for a stage cut before its end (no entry in the record), the last
    checkpoint before the last epoch its log printed."""
    rows = record.get("stages", {}).get("bigan", {}).get("printed", {}).get("epochs")
    if rows:
        return rows[-1][0]
    if not os.path.exists(log):
        return None
    with open(log) as f:
        last = [int(m.group(1)) for m in re.finditer(r"^epoch (\d+)/\d+:", f.read(), re.M)]
    return last[-1] // CHECKPOINT_EVERY * CHECKPOINT_EVERY if last else None



def _load(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _score(rec: Optional[Dict], key: str) -> Optional[float]:
    return None if rec is None else rec.get("scores", {}).get(key)


def report(records: str = RECORDS) -> List[Dict]:
    """Each rule's inputs and verdict from the records in ``records``."""
    j = lambda name: os.path.join(records, name)  # noqa: E731
    out = []
    cf = {e: [_score(_load(j(f"hard-{e}-seed{s}.json")), "bigan_cf_digit_accuracy") for s in range(4)]
          for e in BUDGETS}
    if all(v is not None for vals in cf.values() for v in vals):
        e_star = estar(cf)
        out.append({"rule": "estar", "bigan_cf": cf, "verdict": e_star})
    else:
        e_star = None
        out.append({"rule": "estar", "bigan_cf": cf, "verdict": "not run"})

    names = [sorted(glob.glob(j(f"hard-*-tpu-precision{arm}.json"))) for arm in ("", "-seed1")]
    if all(names):
        paths = [n[-1] for n in names]
        tpu = [_load(p) for p in paths]
        epochs = [trained_epochs(rec, p[:-len(".json")] + "-bigan.log") for rec, p in zip(tpu, paths)]
        got = [_score(r, "bigan_cf_digit_accuracy") for r in tpu], [_score(r, "bigan_generated_accuracy") for r in tpu]
        reads = tpu_precision_verdict(*got)
        at_budget = all(e == r["epochs"] for e, r in zip(epochs, tpu))
        out.append({"rule": "tpu_precision", "records": [os.path.basename(p) for p in paths], "epochs": epochs,
                    "budget": [r["epochs"] for r in tpu], "bigan_cf": got[0], "generated": got[1],
                    "reads_as": reads, "verdict": reads if at_budget else "unresolved: below the budget"})
    else:
        out.append({"rule": "tpu_precision", "verdict": "not run"})

    jax_recs = {p: _load(p) for p in sorted(glob.glob(j(f"jax-cpu-hard-{e_star}*.json")))} if e_star else {}
    jax_cf = [_score(r, "bigan_cf_digit_accuracy") for r in jax_recs.values()]
    if e_star in cf and jax_cf and all(v is not None for v in jax_cf):
        out.append({"rule": "jax_agreement", "estar": e_star, "jax_cf": jax_cf, "port_cf": cf[e_star],
                    "records": [os.path.basename(p) for p in jax_recs],
                    "verdict": jax_agreement_verdict(jax_cf, cf[e_star])})
    else:
        out.append({"rule": "jax_agreement", "estar": e_star, "verdict": "not run"})
    out.extend(rank_lines(records, e_star))

    bf16 = {os.path.basename(p): _score(_load(p), "bigan_cf_digit_accuracy")
            for p in sorted(glob.glob(j("audio-bf16-1200*.json")))}
    bf16 = {k: v for k, v in bf16.items() if v is not None}
    out.append({"rule": "audio_spread", "bigan_cf": bf16,
                "verdict": audio_spread_verdict(list(bf16.values())) if len(bf16) >= 6 else "not run"})

    ident = {}
    for p in sorted(glob.glob(j("audio-f32-1200-identity*.json"))):
        if re.search(r"rehearsal", p):
            continue
        value = (_score(_load(p), "subject_identity") or {}).get("bigan")
        if value is not None:
            ident[os.path.basename(p)] = value
    if len(ident) >= 6:
        verdict, gap = identity_verdict(list(ident.values()))
        out.append({"rule": "identity", "readings": ident, "mean_gap": gap, "verdict": verdict})
    else:
        out.append({"rule": "identity", "readings": ident, "verdict": "not run"})
    return out


def rank_lines(records: str, e_star: Optional[int]) -> List[Dict]:
    """``jax_rank`` (JAX against the port with TF32 off: the verdict),
    ``jax_rank_tf32`` (against the TF32 pool: reported, not decided) and
    ``tf32_rank`` (TF32 on against off) at ``E*``, from the records present."""
    def pool(names: Sequence[str]) -> Dict[str, float]:
        got = {n: _score(_load(os.path.join(records, n)), "bigan_cf_digit_accuracy") for n in names}
        return {n: v for n, v in got.items() if v is not None}

    if e_star is None:
        return [{"rule": r, "verdict": "not run"} for r in ("jax_rank", "jax_rank_tf32", "tf32_rank")]
    jax = pool([f"jax-cpu-hard-{e_star}{'' if s == 0 else f'-seed{s}'}.json" for s in range(RANK_JAX_SEEDS)])
    f32 = pool([f"hard-{e_star}-f32-seed{s}.json" for s in range(RANK_PORT_SEEDS)])
    tf32 = pool([f"hard-{e_star}-seed{s}.json" for s in range(RANK_PORT_SEEDS)])
    out = []
    for rule, port in (("jax_rank", f32), ("jax_rank_tf32", tf32)):
        verdict = jax_rank_verdict(list(jax.values()), list(port.values()))
        line = {"rule": rule, "estar": e_star, "jax_cf": jax, "port_cf": port, "verdict": verdict}
        if verdict != "not run":
            line.update(rank_test(list(jax.values()), list(port.values())))
        out.append(line)
    line = {"rule": "tf32_rank", "estar": e_star, "f32_cf": f32, "tf32_cf": tf32}
    if len(f32) >= RANK_PORT_SEEDS and len(tf32) >= RANK_PORT_SEEDS:
        out.append({**line, **rank_test(list(f32.values()), list(tf32.values())), "verdict": "reported"})
    else:
        out.append({**line, "verdict": "not run"})
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] != ["--report"]:
        print(__doc__)
        return 2
    for line in report(argv[1] if len(argv) > 1 else RECORDS):
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
