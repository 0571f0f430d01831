"""The device engines refuse to run on JAX's CPU fallback unless the CPU
was asked for by name, and the compile cache lands in one fixed place."""

import os
import subprocess
import sys

import pytest

from ntsm_tpu.utils.device import NoAcceleratorError, require_accelerator
from ntsm_tpu.utils.machine import compile_cache_dir, enable_compile_cache
from tests.synth import make_reads_fastq, make_site_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platforms", ["cpu", "cuda,cpu", " CPU "])
def test_guard_allows_cpu_when_named(platforms):
    require_accelerator(backend="cpu", platforms=platforms)


def test_guard_allows_gpu_backend():
    require_accelerator(backend="gpu", platforms="")


def test_guard_raises_on_silent_cpu_fallback():
    with pytest.raises(NoAcceleratorError, match="no GPU found"):
        require_accelerator(backend="cpu", platforms="")


def test_count_cli_without_gpu_fails_naming_it(tmp_path, rng):
    """`ntsm count` in a process where JAX finds no GPU and JAX_PLATFORMS
    is unset stops with the missing-GPU message instead of counting on
    XLA:CPU."""
    sites = str(tmp_path / "s.fa")
    _, sl = make_site_fasta(rng, n_sites=4, path=sites)
    fq = str(tmp_path / "r.fq")
    make_reads_fastq(rng, sl, coverage=2, path=fq)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no GPU even where one exists
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "ntsm_tpu", "count", "-s", sites, fq],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 1, res.stderr[-2000:]
    assert "no GPU found" in res.stderr
    assert res.stdout == ""


def test_compile_cache_follows_the_variable():
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory of
    its own (JAX uses the variable's)."""
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) is None
    assert enable_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) is None


def test_compile_cache_default_is_fixed_and_ignored():
    """Unset, the cache is one fixed path inside the checkout, under a
    directory .gitignore lists."""
    a = compile_cache_dir({})
    assert a == compile_cache_dir({})
    assert a.startswith(os.path.join(REPO, ".jax_cache") + os.sep)
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_compile_cache_unwritable_warns(monkeypatch, tmp_path, capsys):
    import ntsm_tpu.utils.machine as m

    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(m, "_CHECKOUT", str(blocker))
    assert enable_compile_cache({}) is None
    assert "no compile cache" in capsys.readouterr().err
