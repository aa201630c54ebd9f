"""The count of calls that take a shape-decided route with no kernel
(``torchmx_tpu/ops/fallbacks.py``).

JAX's plan serves some shapes by no Pallas kernel, and its attention then
runs the eager route over the dequantized cache (``plan_cached_attention``:
a head_dim that is not a multiple of 128).  The port takes the same route
there and counts each call here under JAX's key, logged once per key, so a
test or a run can assert how often it ran.  It is a route chosen by shape,
not a fallback from a failed kernel: nothing catches a kernel's error.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_logged = set()


def note_fallback(op: str, reason: str) -> None:
    """Count (and log, once per key) a call of ``op`` that JAX's plan serves
    by no kernel; the key is ``"op: reason"``."""
    key = f"{op}: {reason}"
    with _lock:
        _counts[key] = _counts.get(key, 0) + 1
        if key not in _logged:
            _logged.add(key)
            logger.warning("no kernel for %s: running the eager route over the dequantized operands", key)


def fallback_counts() -> Dict[str, int]:
    """The counts since the last reset, by key ``"op: reason"``."""
    with _lock:
        return dict(_counts)


def reset_fallback_counts() -> None:
    with _lock:
        _counts.clear()
        _logged.clear()
