"""Test configuration: run everything on a virtual 8-device CPU mesh.

The recipe lives in ``lightgbm_tpu.utils.cpu_mesh`` (shared with
``__graft_entry__.dryrun_multichip``); importing it by path here avoids
triggering the package __init__ (and its jax import) before the environment
is set.
"""
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "_cpu_mesh", os.path.join(os.path.dirname(__file__), os.pardir,
                              "lightgbm_tpu", "utils", "cpu_mesh.py"))
_cpu_mesh = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cpu_mesh)
_cpu_mesh.force_cpu_devices(8)
os.environ.setdefault("JAX_ENABLE_X64", "0")

# LGBM_TPU_* knobs that env-sensitive tests override per-train; shared
# by tests/test_physical.py and tests/test_fused.py so the save/restore
# semantics live in one place
ENV_KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_FUSED", "LGBM_TPU_PART_INTERP",
             "LGBM_TPU_PARTITION", "LGBM_TPU_COMB_PACK",
             "LGBM_TPU_STREAM")


def save_env_knobs(keys=ENV_KNOBS):
    return {k: os.environ.get(k) for k in keys}


def restore_env_knobs(saved):
    """Put the ambient knob values back EXACTLY (not just pop): the CI
    fallback leg (tools/ci_tier1.sh) exports LGBM_TPU_FUSED=0 /
    LGBM_TPU_PARTITION=matmul for the whole pytest process — a plain
    pop would silently flip every later env-sensitive test in the same
    process back to the shipping defaults."""
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def pytest_configure(config):
    # tier-1 (ROADMAP) runs with -m 'not slow'; the slow remainder of
    # the parity matrices runs in its owning ci_tier1.sh leg
    config.addinivalue_line(
        "markers", "slow: excluded from tier-1; run by its CI leg")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (lightgbm_tpu_torch kernels); "
                   "skips without one")
