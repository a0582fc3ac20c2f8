"""Benchmark: end-to-end phasing throughput through the full pipeline.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
Baseline: HiPhase v1.x steady state on HG001 WGS with 16 CPU threads
≈ 2,068 hets/sec (reference docs/user_guide.md:78).

Every timed rep is a FRESH PROCESS (`bench_e2e.py` via subprocess), so the
numbers include process start, engine selection, reference load, and any
persistent-cache reads — what a real user pays. Run 1 is reported
separately (`run1_s`, `cold_over_warm`) alongside the warm best. The parent
process never initializes a JAX backend, so only one process at a time
holds the accelerator.

Budget: every configuration draws from ONE shared deadline (start + 540 s),
each additionally capped per config, so the whole bench provably fits the
driver's `timeout 600` — a hung config yields an `error` field in its
section, never a lost JSON line.

Configurations reported:
  * local-only mode (the reference's published steady-state config) — the
    primary metric
  * dual/global-realignment mode (the SV/TR path; reference costs 2.2x
    wall in this mode, docs/performance.md:32)
  * device mode (`--engine device` forced): the device pipeline's end-to-end
    economics, measured even when `auto` would route to the host
  * full-output mode (dual + haplotagged BAM — the heaviest real-user
    config, the one the reference's v0.10.0 I/O thread pool targeted)
  * device-resident beam-kernel microbenchmark + node expansions/s
"""

import json
import os
import subprocess
import sys
import time

BASELINE_HETS_PER_SEC = 2068.0   # HiPhase 16-thread steady state, local mode
BASELINE_DUAL = 2068.0 / 2.2     # dual mode costs 2.2x wall (performance.md:32)

TOTAL_BUDGET_S = 540.0           # hard ceiling for the WHOLE bench
MIN_USEFUL_S = 15.0              # don't start a config with less than this

KERNEL_NOTE = (
    "kernel_hets_per_sec is a device-resident microbenchmark at the full "
    "sound beam width (W=1024): beam state stays on device across reps and "
    "a final scalar fetch marks completion. node_expansions_per_sec counts "
    "generated beam candidates (the A* node-expansion analog); "
    "e2e_node_expansions_per_sec is the same counter from the end-to-end "
    "run's solver."
)


class Budget:
    """Shared wall-clock budget; per-call caps never exceed what's left."""

    def __init__(self, total_s: float):
        self.deadline = time.monotonic() + total_s

    def grant(self, cap_s: float) -> float:
        """Seconds this config may use: min(cap, time left)."""
        return min(cap_s, self.deadline - time.monotonic())


def card_info() -> list[str]:
    """The cards' name and power limit as nvidia-smi reports them, one entry
    per card (a card below its maximum power limit runs slower under load,
    so every number is kept beside it); empty when nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def _run_json(cmd, timeout, env=None):
    """Run a subprocess, return its last JSON stdout line (or None)."""
    if timeout < MIN_USEFUL_S:
        return None
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return None
    for line in reversed(p.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def kernel_metric():
    """Device-resident beam-kernel throughput (run me via --kernel-only)."""
    import numpy as np

    import jax

    from hiphase_jax.phasing.beam import (
        PACK_PAD, beam_init_device, beam_tile_packed, pack_inputs,
    )

    B = int(os.environ.get("HIPHASE_KERNEL_B", "64"))
    R, W, T = 128, 1024, 128
    rng = np.random.default_rng(0)
    alleles = rng.integers(0, 2, size=(B, R, T)).astype(np.uint8)
    quals = rng.integers(20, 80, size=(B, R, T)).astype(np.int32)
    skip = np.zeros((B, T), dtype=bool)
    resets = np.zeros((B, R, T), dtype=bool)
    packed = np.pad(pack_inputs(alleles, quals, resets),
                    ((0, 0), (0, 0), (0, 1)), constant_values=PACK_PAD)
    packed_d = jax.device_put(packed)
    skip_d = jax.device_put(skip)
    state = beam_init_device(B, R, W)
    state, _ = beam_tile_packed(state, packed_d, skip_d, beam_width=W)
    np.asarray(state[1][:, 0])  # warm; also proves completion
    reps = 8
    best = float("inf")
    for _trial in range(3):
        st = state
        t0 = time.perf_counter()
        for _ in range(reps):
            st, _ys = beam_tile_packed(st, packed_d, skip_d, beam_width=W)
        # a fetched value marks that the whole chain has executed
        np.asarray(st[1][:, 0])
        best = min(best, (time.perf_counter() - t0) / reps)
    dev = jax.devices()[0]
    return {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "kernel_hets_per_sec": round(B * T / best, 1),
        # candidates generated per column ~= 4*W per batch row
        "node_expansions_per_sec": round(B * T * 4 * W / best, 1),
        "kernel_batch": [B, R, T],
        "kernel_beam_width": W,
    }


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=30,
                    help="dataset size; 30Mb balances steady-state "
                         "representativeness against cold dataset-gen time")
    ap.add_argument("--reps", type=int, default=3,
                    help="fresh-process warm reps after run 1")
    ap.add_argument("--skip-kernel", action="store_true")
    ap.add_argument("--skip-global", action="store_true")
    ap.add_argument("--skip-device", action="store_true")
    ap.add_argument("--skip-full-output", action="store_true")
    ap.add_argument("--kernel-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.kernel_only:
        print(json.dumps(kernel_metric()))
        return 0

    os.environ.setdefault("HIPHASE_BENCH_QUIET", "1")
    here = os.path.dirname(os.path.abspath(__file__))
    e2e = os.path.join(here, "bench_e2e.py")

    budget = Budget(TOTAL_BUDGET_S)

    # build the dataset once so run 1 times the pipeline, not the simulator
    import bench_e2e
    bench_e2e.ensure_dataset(bench_e2e.build_args(["--mb", str(args.mb)]))

    base_cmd = [sys.executable, e2e, "--mb", str(args.mb)]
    # per-rep cap scales with dataset size (local mode runs ~1 s per 3 Mb
    # warm; 2x headroom + a floor for process/start costs)
    rep_cap = max(60, min(2 * args.mb, 180))
    attempts = []
    for _ in range(1 + args.reps):
        attempts.append(_run_json(base_cmd, timeout=budget.grant(rep_cap)))
    runs = [r for r in attempts if r is not None]
    if not runs:
        print(json.dumps({"metric": "e2e_phased_hets_per_sec", "value": 0,
                          "unit": "hets/s", "vs_baseline": 0,
                          "error": "all e2e runs failed"}))
        return 1

    times = [r["elapsed_s"] for r in runs]
    warm_best = min(times[1:]) if len(times) > 1 else times[0]
    n_het = runs[0]["n_het"]
    hets_per_sec = n_het / warm_best
    best_run = min(runs[1:] or runs, key=lambda r: r["elapsed_s"])

    out = {
        "metric": "e2e_phased_hets_per_sec",
        "value": round(hets_per_sec, 1),
        "unit": "hets/s",
        "vs_baseline": round(hets_per_sec / BASELINE_HETS_PER_SEC, 3),
        "elapsed_s": [round(t, 2) for t in times],
        "n_het": n_het,
        "total_bp": runs[0]["total_bp"],
        "engine_resolved": best_run.get("engine"),
        "fresh_process_per_rep": True,
    }
    # run 1 is the cold run; if it failed/timed out, say so — never label a
    # warm rep as the cold number
    if attempts[0] is not None:
        run1 = attempts[0]["elapsed_s"]
        out["run1_s"] = round(run1, 2)
        out["warm_best_s"] = round(warm_best, 2)
        out["cold_over_warm"] = round(run1 / warm_best, 2)
    else:
        out["run1_error"] = "cold run failed or timed out"
    if len(runs) < len(attempts):
        out["failed_reps"] = len(attempts) - len(runs)
    if best_run.get("node_expansions"):
        sol = best_run.get("solve_seconds") or 0
        out["e2e_node_expansions"] = best_run["node_expansions"]
        if sol > 0:
            out["e2e_node_expansions_per_sec"] = round(
                best_run["node_expansions"] / sol, 1)

    def _best_of(cmd, reps, cap, env=None):
        """Best (fastest) of up to `reps` runs, each budget-capped — this
        box swings +-25% with noisy neighbors, so a single rep is noise."""
        best = None
        for _ in range(reps):
            r = _run_json(cmd, timeout=budget.grant(cap), env=env)
            if r is not None and (best is None
                                  or r["elapsed_s"] < best["elapsed_s"]):
                best = r
        return best

    if not args.skip_global:
        g = _best_of(base_cmd + ["--global"], 2, 60)
        if g is not None:
            out["global_mode"] = {
                "e2e_phased_hets_per_sec": g["value"],
                "elapsed_s": g["elapsed_s"],
                "vs_local": round(g["elapsed_s"] / warm_best, 2),
                "vs_dual_baseline": round(g["value"] / BASELINE_DUAL, 3),
            }
        else:
            out["global_mode"] = {"error": "timed out or failed"}

    if not args.skip_full_output:
        # dual + haplotagged BAM: the heaviest real-user configuration
        f = _best_of(base_cmd + ["--global", "--output-bam"], 2, 70)
        if f is not None:
            out["full_output_mode"] = {
                "e2e_phased_hets_per_sec": f["value"],
                "elapsed_s": f["elapsed_s"],
                "vs_local": round(f["elapsed_s"] / warm_best, 2),
                "vs_baseline": round(f["value"] / BASELINE_HETS_PER_SEC, 3),
            }
        else:
            out["full_output_mode"] = {"error": "timed out or failed"}

    if not args.skip_device:
        # forced-device e2e: measures the device pipeline's transfer
        # economics every round, even when `auto` routes to the host
        d = _run_json(base_cmd + ["--engine", "device"],
                      timeout=budget.grant(185))
        if d is not None:
            dm = {
                "e2e_phased_hets_per_sec": d["value"],
                "elapsed_s": d["elapsed_s"],
                "vs_local": round(d["elapsed_s"] / warm_best, 2),
            }
            for k in ("device_batches", "device_transfers",
                      "transfers_per_batch"):
                if d.get(k) is not None:
                    dm[k] = d[k]
            out["device_mode"] = dm
        else:
            out["device_mode"] = {"error": "timed out or failed"}

    if not args.skip_kernel:
        k = _run_json([sys.executable, os.path.abspath(__file__),
                       "--kernel-only"], timeout=budget.grant(120))
        if k is None:
            out["kernel_hets_per_sec"] = None
            out["kernel_error"] = "device kernel bench timed out or failed"
        else:
            out.update(k)
        out["kernel_metric_note"] = KERNEL_NOTE

    out["cards"] = card_info()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
