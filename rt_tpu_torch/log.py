"""Logging helpers + once-only warnings (port of ``rt_tpu.log``).

The reference's observability is bare stdout/stderr helpers
(main.cpp:30-47); this module keeps that posture and adds ``warn_once`` so
a performance-relevant condition is reported exactly once per process.
"""

from __future__ import annotations

import sys

__all__ = ["log", "error", "warn", "warn_once", "reset_warnings"]

_warned: set = set()


def log(*args) -> None:
    print(*args, flush=True)


def error(*args) -> None:
    print("error:", *args, file=sys.stderr, flush=True)


def warn(*args) -> None:
    print("warning:", *args, file=sys.stderr, flush=True)


def warn_once(key, msg: str) -> bool:
    """Emit ``msg`` to stderr the first time ``key`` is seen; return whether
    it was emitted."""
    if key in _warned:
        return False
    _warned.add(key)
    warn(msg)
    return True


def reset_warnings() -> None:
    """Forget emitted once-only warnings (tests)."""
    _warned.clear()
