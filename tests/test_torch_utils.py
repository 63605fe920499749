"""The port's utilities against the JAX package's (``utils/profiling.py``,
``utils/logging.py``, ``utils/heartbeat.py``): ``sync``'s returned leaf,
``StepTimer``'s warm-up exclusion on the same clock, ``MetricsLogger``'s
JSONL records and echo field for field, the heartbeat's lines and its
stop; and the port's own ``timed`` and ``trace``."""
import json
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecfgen_tpu.utils import heartbeat as jheartbeat
from imagecfgen_tpu.utils import logging as jlogging
from imagecfgen_tpu.utils import profiling as jprofiling
from imagecfgen_torch.utils import heartbeat, logging, profiling


@pytest.mark.parametrize("tree", ["scalar_first", "nested", "none_of_size_one", "floats_only"])
def test_sync_returns_what_the_jax_sync_returns(tree):
    trees = {
        "scalar_first": lambda a: {"a": a([3.5]), "b": a(np.zeros(4))},
        "nested": lambda a: [a(np.ones((2, 2))), {"x": (a(np.zeros(3)), a(np.full((1, 1), -2.0)))}],
        "none_of_size_one": lambda a: {"a": a(np.zeros(2))},
        "floats_only": lambda a: {"loss": 0.25, "step": 3},
    }[tree]
    want = jprofiling.sync(trees(lambda v: jnp.asarray(v, jnp.float32) if not np.isscalar(v) else v))
    got = profiling.sync(trees(lambda v: torch.tensor(np.asarray(v, np.float32)) if not np.isscalar(v) else v))
    assert got == want


class FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.mark.parametrize("warmup", [0, 1, 2])
def test_step_timer_excludes_warmup_as_jax_does(warmup, monkeypatch):
    # four timed blocks of 10, 1, 2 and 3 s, then ticks at 0, 5, 6, 8, 11
    blocks = [0, 10, 10, 11, 11, 13, 13, 16]
    ticks = [0, 5, 6, 8, 11]
    rates = {}
    for name, mod in (("jax", jprofiling), ("port", profiling)):
        monkeypatch.setattr(mod, "time", SimpleNamespace(perf_counter=FakeClock(blocks + ticks)))
        timer = mod.StepTimer(warmup_steps=warmup)
        for _ in range(4):
            with timer:
                pass
        ticked = mod.StepTimer(warmup_steps=warmup)
        for n in (1, 2, 2, 4, 1):
            ticked.tick(n)
        rates[name] = (timer.steps_per_sec, ticked.steps_per_sec)
    assert rates["port"] == rates["jax"]
    assert rates["port"][0] == pytest.approx((4 - warmup) / sum([10, 1, 2, 3][warmup:]))


def test_timed_closes_its_region():
    out, secs = profiling.timed(lambda n: {"loss": torch.ones(n).sum()}, 5)
    assert out["loss"].item() == 5.0 and secs >= 0.0


def test_metrics_logger_writes_the_jax_records(tmp_path, monkeypatch, capsys):
    lines, echoes = {}, {}
    for name, mod in (("jax", jlogging), ("port", logging)):
        monkeypatch.setattr(mod, "time", SimpleNamespace(time=FakeClock([100.0, 101.25, 102.5])))
        path = tmp_path / name / "metrics.jsonl"
        log = mod.MetricsLogger(str(path))
        log.log(1, {"loss_D": np.float32(0.5), "EG_score": 0.25}, epoch=0)
        log.log(2, {"loss_D": 0.125}, tag="x")
        log.close()
        lines[name] = [json.loads(line) for line in path.read_text().splitlines()]
        echoes[name] = capsys.readouterr().out
    assert lines["port"] == lines["jax"]
    assert [list(r) for r in lines["port"]] == [list(r) for r in lines["jax"]]  # the fields' order
    assert echoes["port"] == echoes["jax"]
    assert lines["port"][0] == {"step": 1, "time": 1.25, "loss_D": 0.5, "EG_score": 0.25, "epoch": 0}


def test_heartbeat_prints_and_stops(capsys):
    threads = {}
    for name, mod in (("jax", jheartbeat), ("port", heartbeat)):
        with mod.Heartbeat("saving", interval=0.02, prefix="hb") as hb:
            time.sleep(0.15)
        threads[name] = hb._thread
        out = capsys.readouterr().out.splitlines()
        assert out and all(line.startswith("[hb] saving... ") and line.endswith("s") for line in out), out
    assert not threads["port"].is_alive() and threads["port"].daemon
    time.sleep(0.05)
    assert capsys.readouterr().out == "", "a line after the block ended"


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        profiling.sync(torch.ones(64, 64) @ torch.ones(64, 64))
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
