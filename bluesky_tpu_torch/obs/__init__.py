"""Observability of the port: the in-chunk instruments (``scanstats``,
the ScanStats accumulators, and ``fingerprint``, the state fingerprint,
folded once per step by the chunk runners of ``core/step.py``), the
metrics registry (``metrics``) their drains feed, the flight recorder
(``trace``) and the device observability of PROFILE (``devprof``)."""
from .metrics import Registry, get_registry          # noqa: F401
from .trace import Recorder, get_recorder            # noqa: F401
