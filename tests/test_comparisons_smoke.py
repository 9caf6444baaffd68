"""End-to-end smoke of the comparison harness (experiments/comparisons.py).

The suite is the round-5 bug-finder of record (it exposed the
deflation-gate scale bug and the sig21 transfer-layout pathology), but
it had no test of its own and crashed twice mid-campaign.  This drives
one tiny generated shape through every solver section (direct, sig21,
sig06, CG, ours) plus the table generator, on CPU.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_comparisons_harness_smoke(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(REPO / 'experiments')!r})
sys.path.insert(0, {str(REPO)!r})
import jax; jax.config.update("jax_platforms", "cpu")
import comparisons
p = comparisons.build_parser()
args = p.parse_args([
    "--label", "smoke", "--out_dir", {str(tmp_path)!r},
    "--sig06", "--direct", "--cg", "--tolerance", "1e-4",
])
from gravo_mg import Sampling, Weighting
args.sampling = Sampling.FASTDISK
args.weighting = Weighting.BARYCENTRIC
args.sig21 = True
# one tiny shape only
import numpy as np
from gravo_mg.utils.meshgen import icosphere
V, F = icosphere(3, bump=0.1)
comparisons.generated_shapes = lambda sizes: [("sphere_s", V, F)]
comparisons.run(args)
from comparisons_to_table import save_to_table
save_to_table({str(tmp_path)!r}, args.tau, "smoke", sig21=True,
              sig06=True, amg=False, direct=True, names_counts=True)
print("SMOKE-OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, cwd=str(REPO),
    )
    assert "SMOKE-OK" in out.stdout, (out.stdout[-2000:], out.stderr[-3000:])
    table = tmp_path / "smoke_0.001_table.csv"
    assert table.exists()
    import pandas as pd

    t = pd.read_csv(table)
    assert float(t["our_residue"].iloc[0]) <= 1e-4
    assert float(t["sig06_residue"].iloc[0]) <= 1e-4
