"""Structured metrics logging (port of ``imagecfgen_tpu/utils/logging.py``):
one JSONL record a step, ``{"step", "time", <metrics>..., <extra>...}``,
with an echo to stdout."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Appends to ``path`` (none: echo only); ``time`` is the seconds since
    the logger was made, rounded to milliseconds."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, metrics: Dict[str, float], **extra) -> None:
        record = {
            "step": int(step),
            "time": round(time.time() - self._t0, 3),
            **{k: float(v) for k, v in metrics.items()},
            **extra,
        }
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
        if self.echo:
            body = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"[step {step}] {body}")

    def close(self) -> None:
        if self._f:
            self._f.close()
