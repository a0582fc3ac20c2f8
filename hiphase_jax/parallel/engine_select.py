"""Engine selection for ``--engine auto`` and its device-health guard.

The reference has no analog (it is CPU-only and fail-fast, ref:
src/main.rs:20-73). ``--engine device`` does not use this module: a device
error or hang there ends the run. ``--engine auto`` does:

  * `probe_accelerator` — answers "is there a non-CPU backend that
    completes a tiny computation within a deadline?" without risking the
    main thread (the probe runs on a daemon thread; a hung backend strands
    only that thread).
  * `choose_engine` — resolves ``--engine auto``: device engine when the
    probe passes and the device's measured rate wins, native C++ beam
    otherwise, host A* as the last resort.
  * `ResilientSolver` — wraps the device solver so every JAX interaction
    runs on one dedicated worker thread under a deadline; on timeout the
    run degrades to the native engine and every outstanding block is
    re-solved on the host. This guards ``auto`` against a device that stops
    answering. Device results that arrive after degradation are discarded
    (block identity is tracked, nothing is emitted twice). The native and
    device engines produce bit-identical results by construction (see
    phasing/native_beam.py), so a mid-run engine change cannot change
    output bytes.
"""

from __future__ import annotations

import logging
import os
import queue
import threading

logger = logging.getLogger(__name__)

# Deadline for one device interaction (submit/drain of a batch) under
# --engine auto. Generous: a cold batch includes its XLA compile; a healthy
# warm interaction is milliseconds.
DEVICE_CALL_TIMEOUT = float(os.environ.get("HIPHASE_DEVICE_TIMEOUT", 90))
PROBE_TIMEOUT = float(os.environ.get("HIPHASE_PROBE_TIMEOUT", 10))


# Fallback heuristic ONLY (used when the rate measurement is unavailable):
# a dispatch→result round-trip above this suggests per-batch transfers that
# cost more than the native host engine's solve.
LATENCY_THRESHOLD_S = float(
    os.environ.get("HIPHASE_DEVICE_LATENCY_THRESHOLD", 0.005))

# 'auto' routes to the device when its measured batch rate beats the native
# engine's measured rate by this margin (covers backtrace/escalation
# overheads the microbench can't see).
RATE_MARGIN = float(os.environ.get("HIPHASE_RATE_MARGIN", 1.2))
MEASURE_TIMEOUT = float(os.environ.get("HIPHASE_MEASURE_TIMEOUT", 90))

PROBE_CACHE_TTL = float(os.environ.get("HIPHASE_PROBE_TTL", 300))
# a failed probe is retried sooner than a healthy one is re-trusted, so a
# recovered device becomes visible again quickly
PROBE_CACHE_TTL_UNHEALTHY = float(
    os.environ.get("HIPHASE_PROBE_TTL_UNHEALTHY", 60))
# engine rates are a property of the hardware pair, not of the moment
RATE_CACHE_TTL = float(os.environ.get("HIPHASE_RATE_TTL", 3600))


def _probe_cache_path() -> str:
    from hiphase_jax.utils.jax_env import REPO_ROOT
    return os.path.join(REPO_ROOT, ".engine_probe.json")


def _cache_load() -> dict:
    try:
        import json
        with open(_probe_cache_path()) as fh:
            d = json.load(fh)
        if d.get("platforms") != os.environ.get("JAX_PLATFORMS", ""):
            return {}
        return d
    except Exception:
        return {}


def _cache_store(update: dict) -> None:
    if os.environ.get("HIPHASE_PROBE_CACHE") == "0":
        return
    try:
        import json
        path = _probe_cache_path()
        d = _cache_load()
        d.update(update)
        d["platforms"] = os.environ.get("JAX_PLATFORMS", "")
        with open(path, "w") as fh:
            json.dump(d, fh)
    except Exception:
        pass


def _probe_cache_read() -> tuple[bool, float | None] | None:
    if os.environ.get("HIPHASE_PROBE_CACHE") == "0":
        return None
    import time
    d = _cache_load()
    if "healthy" not in d or "time" not in d:
        return None
    ttl = PROBE_CACHE_TTL if d["healthy"] else PROBE_CACHE_TTL_UNHEALTHY
    if time.time() - d["time"] > ttl:
        return None
    return bool(d["healthy"]), d.get("latency")


def _probe_cache_write(healthy: bool, latency: float | None) -> None:
    import time
    _cache_store({"healthy": healthy, "latency": latency,
                  "time": time.time()})


def probe_accelerator(timeout: float = PROBE_TIMEOUT
                      ) -> tuple[bool, float | None]:
    """(healthy, median round-trip seconds) for a non-CPU JAX backend.
    The probe runs on a daemon thread; a hung backend strands only it.
    The result is disk-cached for PROBE_CACHE_TTL seconds so an
    unresponsive device costs the probe timeout once, not once per
    process."""
    cached = _probe_cache_read()
    if cached is not None:
        return cached
    result: list[tuple[bool, float | None]] = []

    def _probe():
        try:
            import time

            import jax
            import jax.numpy as jnp
            import numpy as np
            devs = jax.devices()
            if not devs or devs[0].platform == "cpu":
                result.append((False, None))
                return
            x = jax.device_put(np.zeros(8, dtype=np.float32))
            np.asarray(x + 1)  # compile + first transfer
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                np.asarray(x + 1)
                times.append(time.perf_counter() - t0)
            times.sort()
            result.append((True, times[len(times) // 2]))
        except Exception:  # pragma: no cover - backend import failures
            result.append((False, None))

    import threading
    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout)
    if not result:
        logger.warning("Accelerator probe did not answer within %.1fs; "
                       "treating device as unavailable", timeout)
        _probe_cache_write(False, None)
        return False, None
    _probe_cache_write(*result[0])
    return result[0]


def _synthetic_workload(blocks: int = 16, variants: int = 128,
                        coverage: int = 30, span: int = 24, seed: int = 0):
    """A production-representative batch: `blocks` blocks of `variants`
    het columns covered by reads spanning `span` columns at `coverage`x.
    Both engines are timed on THIS workload so the comparison is apples
    to apples."""
    import numpy as np
    rng = np.random.default_rng(seed)
    per_block = []
    for _ in range(blocks):
        reads = []
        for start in range(0, variants, max(span // 2, 1)):
            end = min(start + span, variants)
            for _c in range(max(coverage * span // (2 * span), 1)):
                n = end - start
                alleles = rng.integers(0, 2, size=n).astype(np.uint8)
                quals = np.full(n, 80, dtype=np.uint8)
                reads.append((start, alleles, quals))
        per_block.append(reads)
    return per_block


def _measure_native_rate(workload, width: int) -> float | None:
    """hets/s of the native C++ beam on the synthetic workload."""
    import time

    import numpy as np

    from hiphase_jax.io import native as native_lib
    if not native_lib.available():
        return None
    blocks = len(workload)
    nvar = 128
    nv = np.full(blocks, nvar, dtype=np.int32)
    skip_off = np.arange(blocks + 1, dtype=np.int64) * nvar
    skip = np.zeros(blocks * nvar, dtype=np.uint8)
    read_off = np.zeros(blocks + 1, dtype=np.int64)
    read_off[1:] = np.cumsum([len(r) for r in workload])
    seg_start = np.concatenate(
        [[s for s, _a, _q in reads] for reads in workload]).astype(np.int32)
    seg_lens = np.concatenate(
        [[len(a) for _s, a, _q in reads] for reads in workload])
    seg_off = np.zeros(len(seg_start) + 1, dtype=np.int64)
    np.cumsum(seg_lens, out=seg_off[1:])
    alleles = np.concatenate(
        [a for reads in workload for _s, a, _q in reads])
    quals = np.concatenate(
        [q for reads in workload for _s, _a, q in reads])
    t0 = time.perf_counter()
    out = native_lib.beam_solve_batch_native(
        nv, skip_off, skip, read_off, seg_start, seg_off, alleles, quals,
        width, width, 2)
    dt = time.perf_counter() - t0
    if out is None:
        return None
    return blocks * nvar / dt


def _measure_device_rate(workload, width: int) -> float | None:
    """hets/s of the device beam on the same workload, INCLUDING the
    per-batch host->device transfers and the result fetch — the transfer
    economics are exactly what this measurement exists to capture."""
    import time

    import numpy as np

    import jax

    from hiphase_jax.utils.jax_env import configure_compile_cache
    configure_compile_cache()
    from hiphase_jax.phasing.beam import (
        PACK_PAD, assign_slots, beam_init_device, beam_tile_packed,
        pack_inputs,
    )

    class _Seg:
        def __init__(self, start, alleles, quals):
            self.start, self.end = start, start + len(alleles)
            self.alleles, self.quals = alleles, quals

    blocks = len(workload)
    nvar = 128
    R = 128  # production slot bucket
    A = np.full((blocks, R, nvar), 3, dtype=np.uint8)
    Q = np.zeros((blocks, R, nvar), dtype=np.int32)
    RS = np.zeros((blocks, R, nvar), dtype=bool)
    for b, reads in enumerate(workload):
        segs = [_Seg(s, a, q) for s, a, q in reads]
        slots, n_slots = assign_slots(segs)
        if n_slots > R:
            return None
        last_end: dict = {}
        for i, seg in enumerate(segs):
            s = slots[i]
            A[b, s, seg.start:seg.end] = seg.alleles
            Q[b, s, seg.start:seg.end] = seg.quals
            if s in last_end:
                RS[b, s, seg.start] = True
            last_end[s] = seg.end
    packed = np.pad(pack_inputs(A, Q, RS), ((0, 0), (0, 0), (0, 1)),
                    constant_values=PACK_PAD)
    skip = np.zeros((blocks, nvar), dtype=bool)

    def one_batch():
        pk = jax.device_put(packed)
        sk = jax.device_put(skip)
        st = beam_init_device(blocks, R, width)
        st, _tr = beam_tile_packed(st, pk, sk, beam_width=width)
        np.asarray(st[2][:, 0])  # materialized value proves completion

    one_batch()  # compile + warm
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        one_batch()
    dt = (time.perf_counter() - t0) / reps
    return blocks * nvar / dt


def measure_engine_rates(timeout: float = MEASURE_TIMEOUT) -> dict | None:
    """Measured hets/s of the device vs native engines on one shared
    synthetic workload; disk-cached for RATE_CACHE_TTL. The device side
    runs on a daemon thread under `timeout` (a hung backend strands only
    the thread). Returns {"device": r, "native": r} or None."""
    import time
    d = _cache_load()
    r = d.get("rates")
    if r is not None:
        ttl = RATE_CACHE_TTL if not r.get("failed") \
            else PROBE_CACHE_TTL_UNHEALTHY
        if time.time() - r.get("time", 0) < ttl:
            if r.get("failed"):
                return None
            return {"device": r["device"], "native": r["native"]}

    width = 1024  # the default full queue width (cli --phase-min-queue-size)
    workload = _synthetic_workload()
    native_rate = _measure_native_rate(workload, width)
    if native_rate is None:
        return None

    box: list = []

    def _dev():
        try:
            box.append(_measure_device_rate(workload, width))
        except Exception:  # pragma: no cover - backend failure
            box.append(None)

    t = threading.Thread(target=_dev, daemon=True)
    t.start()
    t.join(timeout)
    if not box or box[0] is None:
        logger.warning("Device rate measurement failed or exceeded %.0fs",
                       timeout)
        # cache the failure briefly: a probe-healthy-but-stalling device
        # must not cost MEASURE_TIMEOUT in every process
        _cache_store({"rates": {"failed": True, "time": time.time()}})
        return None
    rates = {"device": box[0], "native": native_rate}
    _cache_store({"rates": {"device": rates["device"],
                            "native": rates["native"],
                            "time": time.time()}})
    return rates


def choose_engine(requested: str) -> str:
    """Resolve the --engine flag. 'auto' picks the fastest available
    engine from MEASURED economics: when the device is healthy, both
    engines are timed on one shared synthetic workload (the device side
    including its per-batch transfers), and the device wins only if its
    rate beats the native engine's by RATE_MARGIN. If no measurement is
    available the old latency heuristic decides. All engines produce
    identical output, so this is purely a performance decision."""
    if requested != "auto":
        return requested
    from hiphase_jax.io import native as native_lib
    healthy, latency = probe_accelerator()
    if healthy:
        rates = measure_engine_rates()
        if rates is not None:
            if rates["device"] > RATE_MARGIN * rates["native"]:
                logger.info(
                    "Engine 'auto': device measured %.0f hets/s vs native "
                    "%.0f (margin %.1fx) — using 'device'",
                    rates["device"], rates["native"], RATE_MARGIN)
                return "device"
            logger.info(
                "Engine 'auto': device measured %.0f hets/s vs native %.0f "
                "— native wins (force with --engine device)",
                rates["device"], rates["native"])
        elif latency is not None and latency < LATENCY_THRESHOLD_S:
            return "device"
        else:
            logger.info(
                "Accelerator answers but no rate measurement and round-trip "
                "is %.1f ms (threshold %.1f ms); using the host engine",
                1e3 * (latency or 0), 1e3 * LATENCY_THRESHOLD_S)
    if native_lib.available():
        return "native"
    return "astar"


class _DaemonCaller:
    """Runs calls sequentially on one daemon thread with a per-call
    deadline. Daemon matters: a call stuck inside a hung backend must not
    block interpreter shutdown (concurrent.futures joins its workers at
    exit, which would hang the whole process)."""

    def __init__(self, name: str):
        self._q: queue.Queue = queue.Queue()
        self._t = threading.Thread(target=self._run, daemon=True, name=name)
        self._t.start()

    def _run(self):
        while True:
            fn, args, box, done = self._q.get()
            try:
                box.append(("ok", fn(*args)))
            except BaseException as e:  # propagate to caller (fail-fast)
                box.append(("err", e))
            done.set()

    def call(self, fn, args, timeout: float):
        """Returns fn(*args), raises its exception, or raises TimeoutError
        after `timeout` seconds (the call keeps running; its result is
        abandoned)."""
        box: list = []
        done = threading.Event()
        self._q.put((fn, args, box, done))
        if not done.wait(timeout):
            raise TimeoutError
        kind, val = box[0]
        if kind == "err":
            raise val
        return val


class DeferredUpgradeSolver:
    """Starts on the native host solver and switches to a lazily-built
    device solver if the (still running) engine probe resolves to
    'device'.
    Engines are bit-identical, so the mid-run switch cannot change output;
    a probe that never answers costs nothing."""

    def __init__(self, native_solver, probe_future, make_device_solver):
        self._sol = native_solver
        self._native = native_solver
        self._future = probe_future
        self._make = make_device_solver

    @property
    def degraded(self) -> bool:
        return getattr(self._sol, "degraded", False)

    def _maybe_upgrade(self) -> list:
        if self._future is None or not self._future.done():
            return []
        choice = self._future.result()
        self._future = None
        if choice != "device":
            return []
        out = self._native.drain()
        logger.info("Device probe resolved in favor of the accelerator; "
                    "upgrading engine to 'device' mid-run")
        self._sol = self._make()
        return out

    def submit(self, data):
        out = self._maybe_upgrade()
        out.extend(self._sol.submit(data))
        return out

    def drain(self):
        self._future = None  # too late to benefit from an upgrade
        return self._sol.drain()


class ResilientSolver:
    """Device solver with deadline-supervised calls and host fallback.

    All device work runs on one daemon worker thread. If a call exceeds
    ``timeout`` the solver flips to the native engine permanently for this
    run: outstanding blocks re-solve on the host, late device results are
    dropped, and subsequent submissions go straight to the native solver.
    """

    def __init__(self, device_solver, native_solver,
                 timeout: float = DEVICE_CALL_TIMEOUT):
        self._device = device_solver
        self._native = native_solver
        self._timeout = timeout
        self._caller = _DaemonCaller("device-solver")
        self._outstanding: dict[int, object] = {}  # block_index -> BlockData
        self.degraded = False

    # -- internal ----------------------------------------------------------
    def _call(self, fn, *args):
        """Run a device-solver method under the deadline; returns results or
        flips to degraded mode (never raises on timeout)."""
        try:
            return self._caller.call(fn, args, self._timeout)
        except TimeoutError:
            logger.warning(
                "Device call exceeded %.0fs; degrading to the native host "
                "engine for the remainder of the run (%d blocks re-solve "
                "on host)", self._timeout, len(self._outstanding))
            self.degraded = True
            return None

    def _emit_device_results(self, results):
        out = []
        for pr, hr in results:
            idx = pr.phase_block.block_index
            if self._outstanding.pop(idx, None) is not None:
                out.append((pr, hr))
        return out

    def _resolve_outstanding_native(self):
        out = []
        pending = [self._outstanding.pop(k)
                   for k in sorted(self._outstanding.keys())]
        for data in pending:
            out.extend(self._native.submit(data))
        out.extend(self._native.drain())
        return out

    # -- public (mirrors BatchedDeviceSolver) ------------------------------
    def submit(self, data):
        if self.degraded:
            return self._native.submit(data)
        self._outstanding[data.phase_block.block_index] = data
        results = self._call(self._device.submit, data)
        if results is None:
            return self._resolve_outstanding_native()
        return self._emit_device_results(results)

    def drain(self):
        if self.degraded:
            return self._native.drain()
        results = self._call(self._device.drain)
        if results is None:
            return self._resolve_outstanding_native()
        out = self._emit_device_results(results)
        out.extend(self._native.drain())
        return out
