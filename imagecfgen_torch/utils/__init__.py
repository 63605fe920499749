"""Profiling, metrics logging and a liveness heartbeat (port of
``imagecfgen_tpu/utils``)."""
from .logging import MetricsLogger
from .profiling import StepTimer, sync, timed, trace

__all__ = ["MetricsLogger", "StepTimer", "sync", "timed", "trace"]
