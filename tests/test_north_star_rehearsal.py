"""End-to-end rehearsal of the EXACT north-star bench block at small scale.

The block (bench._north_star_bench) is what the driver runs at 1M x 100K
on hardware; this guards its glue (cache synthesis, NorthStarIO, streamed
auto-selection, causal-recovery accounting) against regressions.  Runs in
a subprocess because north_star_data reads its N/P/dir overrides from the
environment at import time.
"""

import os
import subprocess
import sys


def test_north_star_block_small_scale(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import jax; jax.config.update('jax_platforms', 'cpu')
import sys, json
sys.path.insert(0, %r)
from adelie_tpu.configs import set_configs
set_configs('snp_hbm_budget', 1)        # force auto-streaming at tiny scale
import bench
res = bench._north_star_bench()
assert 'error' not in res and 'skipped' not in res, res
assert res['lambdas'] >= 10, res
assert res['causal_hits'][0] >= 5, res
assert res['dev_final'] > 0.3, res
assert res['streamed'] is True, res
print('@@OK@@' + json.dumps(res))
""" % repo
    env = dict(os.environ)
    env.update({
        "ADELIE_TPU_NORTH_STAR_N": "400",
        "ADELIE_TPU_NORTH_STAR_P": "2000",
        "ADELIE_TPU_NORTH_STAR_DIR": str(tmp_path),
        "JAX_PLATFORMS": "cpu",
        "JAX_PLATFORM_NAME": "cpu",
    })
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env,
        capture_output=True, text=True, timeout=560,
    )
    assert proc.returncode == 0, (proc.stdout[-800:], proc.stderr[-800:])
    assert "@@OK@@" in proc.stdout


def test_north_star_block_guard_skips_when_cache_absent(tmp_path):
    """Contract of the budget guard: cache absent + hopeless budget ->
    explicit skip (no synthesis started), NOT an error."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import jax; jax.config.update('jax_platforms', 'cpu')
import sys, json
sys.path.insert(0, %r)
import bench
res = bench._north_star_bench()
assert 'skipped' in res and 'cache absent' in res['skipped'], res
print('@@OK@@' + json.dumps(res))
""" % repo
    env = dict(os.environ)
    env.update({
        "ADELIE_TPU_NORTH_STAR_N": "400",
        "ADELIE_TPU_NORTH_STAR_P": "2000",
        "ADELIE_TPU_NORTH_STAR_DIR": str(tmp_path),
        "ADELIE_TPU_NORTH_STAR_BUDGET_S": "0.001",
        "JAX_PLATFORMS": "cpu",
        "JAX_PLATFORM_NAME": "cpu",
    })
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, (proc.stdout[-800:], proc.stderr[-800:])
    assert "@@OK@@" in proc.stdout
