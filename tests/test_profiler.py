"""Scope profiler (profc.h analog) unit tests."""

import io
import time

from gravo_mg.utils.profiler import (
    print_profile,
    profile_scope,
    profile_table,
    reset_profile,
)


def test_profile_accumulates():
    reset_profile()
    for _ in range(3):
        with profile_scope("work"):
            time.sleep(0.001)
    table = profile_table()
    assert table["work"]["count"] == 3
    assert table["work"]["total_ms"] >= 3 * 0.9  # >= ~3ms
    assert table["work"]["mean_us"] >= 900

    buf = io.StringIO()
    print_profile(buf)
    out = buf.getvalue()
    assert "work" in out and "ms" in out
    reset_profile()
    assert profile_table() == {}
