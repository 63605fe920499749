"""The parsers of ``test_torch_cli_explain.py``'s CLIs (each takes every
option string of its JAX script's parser, with the same defaults, plus
``--device``), and the port's ``mnist_oracle_scores`` CLI on the CPU, on the
artifacts that its ``trained`` fixture trains (16-row splits, narrow
models): the scores CSV has the columns the JAX script writes, one row an
image, its rates and JS divergences in range.
"""
import importlib
import re
import runpy

import numpy as np
import pytest
from test_torch_cli_explain import (  # noqa: F401  (trained: a fixture)
    CLIS,
    N,
    REPO,
    STEPS,
    TENSOR_CLIS,
    jax_oracle_columns,
    read_csv,
    run,
    trained,
)


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("name", CLIS)
def test_parser_takes_the_jax_scripts_flags(name):
    jparser = runpy.run_path(str(REPO / f"{name}.py"), run_name="x")["parser"]
    tparser = importlib.import_module(f"imagecfgen_torch.cli.{name}").parser
    extra = {"--device"} if name in TENSOR_CLIS else set()
    assert _options(tparser) == _options(jparser) | extra
    port = {a.dest: a for a in tparser._actions}
    for a in jparser._actions:
        t = port[a.dest]
        assert (t.default, t.nargs, t.type, t.option_strings, t.choices) == (
            a.default, a.nargs, a.type, a.option_strings, a.choices), a.dest
    if extra:
        assert tparser.parse_args([]).device == "cuda"


def test_oracle_scores_csv_has_the_jax_columns(trained, tmp_path):
    data, models, _ = trained
    out = tmp_path / "scores.csv"
    log = run("mnist_oracle_scores", "--data-dir", data, "--model-dir", models, "--limit", N,
              "--steps", STEPS, "--output", out)
    header, rows = read_csv(out)
    assert header == jax_oracle_columns() and len(rows) == N
    for name in ("bigan", "bigan_agnostic", "cf", "pn"):
        rate = float(re.search(rf"^{name}_oracle_agree: ([0-9.]+)$", log, re.M).group(1))
        assert 0.0 <= rate <= 1.0
    for r in rows:
        d = dict(zip(header, r))
        assert int(d["target_class"]) != int(d["digit"])
        for name in ("bigan", "cf"):
            assert -1e-6 <= float(d[f"{name}_js"]) <= np.log(2) + 1e-6  # float32 rounding
            assert all(0.0 <= float(d[f"{name}_os_{j}"]) <= 1.0 for j in range(10))
