"""Accumulating scope profiler (reference parity: sig21's ``profc.h``).

The reference's SIG21 subsystem instruments hot scopes with the
``PROFC_NODE(name)`` macro — a static per-site accumulator printing a
``name / count / total ms / mean us`` table at process exit
(gravomg/src/sig21/profc.h:9-79, used from mg_VCycle.cpp:121 and
min_quad_with_fixed_mg.cpp:132).  This is the Python equivalent:

    from gravo_mg.utils.profiler import profile_scope, print_profile

    with profile_scope("cycle"):
        ...

    print_profile()          # or register_atexit() for exit-time printing

Alongside it, :func:`jax_trace` wraps ``jax.profiler.trace`` for device-
level traces (the device-side analog SURVEY.md §5 calls for).
"""

from __future__ import annotations

import atexit
import contextlib
import threading
import time
from typing import Dict, Optional


class _Node:
    __slots__ = ("name", "count", "elapsed_us")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.elapsed_us = 0.0


_nodes: Dict[str, _Node] = {}
_lock = threading.Lock()


@contextlib.contextmanager
def profile_scope(name: str):
    """Accumulate wall time of the enclosed block under ``name``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed_us = (time.perf_counter() - start) * 1e6
        with _lock:
            node = _nodes.get(name)
            if node is None:
                node = _nodes[name] = _Node(name)
            node.count += 1
            node.elapsed_us += elapsed_us


def profile_table() -> Dict[str, dict]:
    """Snapshot: name -> {count, total_ms, mean_us}."""
    with _lock:
        return {
            n.name: {
                "count": n.count,
                "total_ms": n.elapsed_us / 1e3,
                "mean_us": n.elapsed_us / max(n.count, 1),
            }
            for n in _nodes.values()
        }


def print_profile(file=None) -> None:
    """Print the profc-format table (name, count, total ms, mean us)."""
    import sys

    file = file or sys.stderr
    for name, row in profile_table().items():
        print(
            f"{name:<25} {row['count']:>10d} {row['total_ms']:>10.0f}ms "
            f"{row['mean_us']:>10.0f}us",
            file=file,
        )


def reset_profile() -> None:
    with _lock:
        _nodes.clear()


_registered = False


def register_atexit() -> None:
    """Print the table at interpreter exit, like profc's static dtor."""
    global _registered
    if not _registered:
        atexit.register(print_profile)
        _registered = True


@contextlib.contextmanager
def jax_trace(log_dir: str, name: Optional[str] = None):
    """Device-level profiling via jax.profiler (TensorBoard format)."""
    import jax

    with jax.profiler.trace(log_dir):
        if name:
            with jax.profiler.TraceAnnotation(name):
                yield
        else:
            yield
