"""Device-engine process settings (hiphase_jax/utils/jax_env.py): where the
persistent compile cache lives, and the --engine device guard against
running on a CPU that nobody asked for."""

import pathlib

import jax
import pytest

from hiphase_jax.cli import build_parser
from hiphase_jax.cli import main as cli_main
from hiphase_jax.utils import jax_env

from tests.sim import build_dataset

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.fixture
def implicit_platform(monkeypatch):
    """JAX's platform as if neither the environment nor the config had
    named one (the backend stays the CPU that is already initialized)."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    old = jax.config.jax_platforms
    jax.config.update("jax_platforms", None)
    yield
    jax.config.update("jax_platforms", old)


def test_compile_cache_env_var_is_the_only_cache(monkeypatch, tmp_path,
                                                 restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert jax_env.configure_compile_cache() == str(tmp_path)
    # left to JAX, which reads the variable itself: nothing set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = jax_env.configure_compile_cache()
    assert first == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    assert jax_env.configure_compile_cache() == first
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in ignored


def test_guard_runs_with_explicit_cpu():
    # conftest asks for the CPU through jax.config
    assert jax_env.cpu_requested()
    assert jax_env.require_accelerator() == "cpu"


def test_guard_refuses_implicit_cpu(implicit_platform):
    assert not jax_env.cpu_requested()
    with pytest.raises(SystemExit, match="no accelerator.*'cpu'"):
        jax_env.require_accelerator()


def test_guard_accepts_env_var(implicit_platform, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert jax_env.require_accelerator() == "cpu"


def test_cli_device_engine_refuses_implicit_cpu(tmp_path, implicit_platform):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=5, n_contigs=1, contig_len=6000)
    with pytest.raises(SystemExit, match="no accelerator"):
        cli_main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                  "--output-vcf", str(tmp_path / "out.vcf.gz"),
                  "--engine", "device", "--beam-width", "64"])


def test_cli_device_engine_is_not_wrapped(tmp_path, monkeypatch):
    """--engine device solves on a bare BatchedDeviceSolver: the auto
    engine's deadline wrapper is never built."""
    from hiphase_jax.parallel import engine_select

    def _no_wrapper(*_a, **_k):
        raise AssertionError("ResilientSolver built under --engine device")

    monkeypatch.setattr(engine_select, "ResilientSolver", _no_wrapper)
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=6, n_contigs=1, contig_len=6000)
    assert cli_main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(tmp_path / "out.vcf.gz"),
                     "--engine", "device", "--beam-width", "64"]) == 0
    from hiphase_jax.cli import LAST_RUN_STATS
    assert LAST_RUN_STATS["engine"] == "device"
    assert LAST_RUN_STATS["device_batches"] >= 1


@pytest.mark.parametrize("engine,ok", [
    ("device", True), ("native", True), ("astar", True), ("auto", True),
    ("tpu", False)])
def test_engine_names(engine, ok):
    argv = ["--bam", "x.bam", "--vcf", "x.vcf.gz", "--output-vcf", "o.vcf.gz",
            "--reference", "x.fa", "--engine", engine]
    if ok:
        assert build_parser().parse_args(argv).engine == engine
    else:
        with pytest.raises(SystemExit) as e:
            build_parser().parse_args(argv)
        assert e.value.code == 2
