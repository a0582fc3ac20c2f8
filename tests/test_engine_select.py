"""Engine auto-selection and device-health resilience
(hiphase_jax/parallel/engine_select.py): a hung device call must degrade the
run to the native host engine with every outstanding block re-solved and no
duplicate or lost results."""

import time

import numpy as np
import pytest

from hiphase_jax.io import native
from hiphase_jax.parallel.engine_select import ResilientSolver, choose_engine
from hiphase_jax.phasing.native_beam import NativeBeamSolver
from hiphase_jax.phasing.phaser import BlockData
from hiphase_jax.phasing.block_gen import PhaseBlock

from tests.test_solver import make_block


def _block_data(seed, index):
    rng = np.random.default_rng(seed)
    variants, reads, _h1, _h2 = make_block(rng, 8, 10, flip_prob=0.1)
    pb = PhaseBlock.new(index, "chr1", 0, 0, "SAMPLE", 1)
    for v in variants:
        pb.add_locus_variant("chr1", v.position, 0)
    return BlockData(phase_block=pb, variants=variants, read_segments=reads,
                     phasable_segments=[], hom_variants=[],
                     read_stats=None)


class HangingSolver:
    """Device-solver stand-in that answers N times then hangs forever."""

    def __init__(self, answers_before_hang: int):
        self.remaining = answers_before_hang
        self.inner = NativeBeamSolver(batch_size=1)

    def submit(self, data):
        if self.remaining <= 0:
            time.sleep(3600)
        self.remaining -= 1
        return self.inner.submit(data)

    def drain(self):
        if self.remaining <= 0:
            time.sleep(3600)
        return self.inner.drain()


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_degrades_on_hang_no_lost_or_duplicate_blocks():
    blocks = [_block_data(100 + i, i) for i in range(6)]
    solver = ResilientSolver(HangingSolver(answers_before_hang=2),
                             NativeBeamSolver(batch_size=2), timeout=0.5)
    results = []
    for b in blocks:
        results.extend(solver.submit(b))
    results.extend(solver.drain())
    assert solver.degraded
    got = sorted(pr.phase_block.block_index for pr, _hr in results)
    assert got == list(range(6))


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_healthy_device_passes_through():
    blocks = [_block_data(200 + i, i) for i in range(4)]
    solver = ResilientSolver(HangingSolver(answers_before_hang=10**9),
                             NativeBeamSolver(batch_size=2), timeout=30)
    results = []
    for b in blocks:
        results.extend(solver.submit(b))
    results.extend(solver.drain())
    assert not solver.degraded
    got = sorted(pr.phase_block.block_index for pr, _hr in results)
    assert got == list(range(4))


def test_choose_engine_explicit_passthrough():
    assert choose_engine("astar") == "astar"
    assert choose_engine("native") == "native"
    assert choose_engine("device") == "device"


def test_choose_engine_auto_on_cpu_prefers_native():
    # tests pin jax to the CPU backend (conftest), so the probe must decline
    resolved = choose_engine("auto")
    expected = "native" if native.available() else "astar"
    assert resolved == expected


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_deferred_upgrade_switches_mid_run():
    """Auto mode starts on native and upgrades to the device solver when
    the probe future resolves to 'device'; no blocks lost or duplicated."""
    from concurrent.futures import Future

    from hiphase_jax.parallel.engine_select import DeferredUpgradeSolver

    fut = Future()
    made = []

    def make_device():
        s = NativeBeamSolver(batch_size=1)  # stand-in "device" solver
        made.append(s)
        return s

    solver = DeferredUpgradeSolver(NativeBeamSolver(batch_size=3), fut,
                                   make_device)
    blocks = [_block_data(300 + i, i) for i in range(6)]
    results = []
    for i, b in enumerate(blocks):
        if i == 3:
            fut.set_result("device")
        results.extend(solver.submit(b))
    results.extend(solver.drain())
    assert made, "device solver was never built"
    got = sorted(pr.phase_block.block_index for pr, _hr in results)
    assert got == list(range(6))


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_deferred_upgrade_ignores_unresolved_probe():
    from concurrent.futures import Future

    from hiphase_jax.parallel.engine_select import DeferredUpgradeSolver

    fut = Future()  # never resolves (hung probe)
    solver = DeferredUpgradeSolver(NativeBeamSolver(batch_size=2), fut,
                                   lambda: pytest.fail("must not build"))
    blocks = [_block_data(400 + i, i) for i in range(4)]
    results = []
    for b in blocks:
        results.extend(solver.submit(b))
    results.extend(solver.drain())
    got = sorted(pr.phase_block.block_index for pr, _hr in results)
    assert got == list(range(4))


def test_choose_engine_measured_rates_device_wins(monkeypatch):
    """'auto' routes on MEASURED economics: a device that beats the native
    rate by the margin is chosen even at a high round-trip latency (the 5 ms
    fallback constant must not veto a fast device)."""
    from hiphase_jax.parallel import engine_select as es

    monkeypatch.setattr(es, "probe_accelerator", lambda **_: (True, 0.030))
    monkeypatch.setattr(es, "measure_engine_rates",
                        lambda **_: {"device": 100_000.0, "native": 9_000.0})
    assert es.choose_engine("auto") == "device"


def test_choose_engine_measured_rates_native_wins(monkeypatch):
    """...and a device that measures slower than the host is rejected even
    at a low round-trip latency."""
    from hiphase_jax.parallel import engine_select as es

    if not native.available():
        pytest.skip("native library not built")
    monkeypatch.setattr(es, "probe_accelerator", lambda **_: (True, 0.0001))
    monkeypatch.setattr(es, "measure_engine_rates",
                        lambda **_: {"device": 5_000.0, "native": 9_000.0})
    assert es.choose_engine("auto") == "native"


def test_choose_engine_latency_fallback(monkeypatch):
    """With no rate measurement available the latency heuristic decides."""
    from hiphase_jax.parallel import engine_select as es

    monkeypatch.setattr(es, "probe_accelerator", lambda **_: (True, 0.0001))
    monkeypatch.setattr(es, "measure_engine_rates", lambda **_: None)
    assert es.choose_engine("auto") == "device"


def test_measure_native_rate_runs():
    """The native half of the measurement produces a real positive rate on
    the shared synthetic workload."""
    from hiphase_jax.parallel import engine_select as es

    if not native.available():
        pytest.skip("native library not built")
    wl = es._synthetic_workload(blocks=2, variants=128)
    rate = es._measure_native_rate(wl, width=256)
    assert rate is not None and rate > 0
