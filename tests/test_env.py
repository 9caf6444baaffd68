"""Process environment rules: the compile-cache location, the native
library's build key, and chip_smoke.py's refusal to run without a GPU.
Each rule that depends on process start-up runs in a subprocess."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(code_or_args, env_extra=None, drop=(), cwd=ROOT, timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable, *code_or_args])
    return subprocess.run(args, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


_PRINT_CACHE = ("import json, jax, gravo_mg; "
                "print(json.dumps(jax.config.jax_compilation_cache_dir))")


def test_compile_cache_follows_env(tmp_path):
    out = _run(_PRINT_CACHE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == str(tmp_path)


def test_compile_cache_defaults_to_checkout():
    out = _run(_PRINT_CACHE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert pathlib.Path(got) == ROOT / ".jax_cache"


def test_chip_smoke_fails_without_gpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert "GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_native_library_keyed_by_sources(tmp_path, monkeypatch):
    from gravo_mg import native

    status = native.status()
    assert status == "native" or status.startswith(
        ("build failed", "load failed", "disabled"))
    path = native.library_path()
    assert path.parent.parent == pathlib.Path(native.__file__).parent / "_build"
    # Any change to a source moves the library to a new build directory.
    srcs = []
    for src in native._SRCS:
        shutil.copy(src, tmp_path / src.name)
        srcs.append(tmp_path / src.name)
    monkeypatch.setattr(native, "_SRCS", srcs)
    assert native.library_path() == path
    with open(srcs[0], "a") as f:
        f.write("\n// edited\n")
    assert native.library_path() != path
    # The library is built from sources, never committed.
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "gravo_mg/native/_build/" in ignored
