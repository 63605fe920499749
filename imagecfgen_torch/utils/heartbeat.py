"""Liveness heartbeat for silent long phases (port of
``imagecfgen_tpu/utils/heartbeat.py``).

A multi-GB checkpoint's save or load, or a first kernel build, can run for
minutes without a line of output; a watchdog that kills a stage after some
silent minutes cannot tell it from a hang. Wrap such a phase in ``with
Heartbeat("label"):`` and a daemon thread prints ``[hb] label... <t>s`` every
``interval`` seconds until the phase ends.
"""
from __future__ import annotations

import threading
import time


class Heartbeat:
    """Print ``[<prefix>] <label>... <t>s`` every ``interval`` seconds while
    the ``with`` block runs (one thread an instance)."""

    def __init__(self, label: str, interval: float = 60.0, prefix: str = "hb"):
        self._stop = threading.Event()
        self._label = label
        self._interval = interval
        self._prefix = prefix
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        t0 = time.monotonic()
        while not self._stop.wait(self._interval):
            print(f"[{self._prefix}] {self._label}... {time.monotonic() - t0:.0f}s", flush=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
