"""Which device a measurement ran on, as every measurement must print it."""

from __future__ import annotations

import subprocess


def nvidia_smi() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one card per line (raises if the tool is missing or fails)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports its devices."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpus(n: int = 1, what: str = "this script") -> dict:
    """The device record, or SystemExit (non-zero, with a message on
    stderr) when JAX finds fewer than ``n`` GPUs.  No CPU fallback."""
    rec = device_record()
    if rec["platform"] != "gpu" or rec["count"] < n:
        raise SystemExit(
            f"{what}: needs {n} GPU(s), but JAX found {rec['count']} "
            f"{rec['platform']!r} device(s) ({rec['kind']})"
        )
    return rec
