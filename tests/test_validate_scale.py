"""Pinned human-scale validation artifact.

Runs scripts/validate_scale.py — sitegen builds a 12,000-site set from a
synthetic genome, `ntsm count` processes 2 x ~100 Mbase on the GPU with
byte parity against the golden oracle, and eval round-trips device vs
exact — as a slow-marked test so "ALL CHECKS PASSED" is reproducible on
demand on a machine with a GPU:

    python -m pytest tests/test_validate_scale.py -m slow -q

Deselected from the default suite (pyproject addopts).  The suite's
conftest pins this process to a CPU mesh, so the validation runs in a
subprocess on the GPU (NTSM_SCALE_PLATFORM overrides the platform).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_validate(args: list[str], timeout: int) -> None:
    env = dict(os.environ)
    # undo the conftest's CPU pinning for the child
    env.pop("JAX_NUM_CPU_DEVICES", None)
    env["JAX_PLATFORMS"] = env.get("NTSM_SCALE_PLATFORM", "cuda")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "validate_scale.py"),
         *args],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    sys.stderr.write(res.stderr[-4000:])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ALL CHECKS PASSED" in res.stderr or "ALL CHECKS PASSED" in res.stdout


@pytest.mark.slow
def test_validate_scale_all_checks_passed():
    _run_validate([], timeout=3600)


@pytest.mark.slow
def test_validate_scale_human_site_count():
    """The full 96,287-site tier: sitegen at the real site-set size,
    counting on the device against the golden oracle, eval
    device-vs-exact.  Sitegen's host-side uniqueness scan dominates the
    runtime:

        python -m pytest tests/test_validate_scale.py -m slow \
            -k human -q
    """
    _run_validate(["200", "96287"], timeout=7200)
