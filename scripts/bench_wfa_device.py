"""Device graph-WFA microbench: batched banded-DP aligner vs the host C++
wavefront aligner on a realistic window (reads/s per engine).

Run on the accelerator (or JAX_PLATFORMS=cpu for a smoke test):
    timeout 300 python scripts/bench_wfa_device.py [--reads 64] [--window 2000]
Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--reads", type=int, default=64)
ap.add_argument("--window", type=int, default=2000)
ap.add_argument("--variants", type=int, default=10)
ap.add_argument("--error", type=float, default=0.01)
ap.add_argument("--reps", type=int, default=3)
args = ap.parse_args()


def main():
    from hiphase_jax.align.wfa_device import align_reads_device
    from hiphase_jax.align.wfa_graph import WFAGraph
    from hiphase_jax.core.variants import Variant

    rng = np.random.default_rng(0)
    L = args.window
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), L).astype(
        np.uint8).tobytes()
    variants = []
    step = L // (args.variants + 1)
    for k in range(args.variants):
        pos = step * (k + 1)
        alt = bytes([rng.choice([b for b in b"ACGT" if b != ref[pos]])])
        variants.append(Variant.new_snv(0, pos, ref[pos:pos + 1], alt, 0, 1))
    g, n2a = WFAGraph.from_reference_variants(ref, variants, 0, L, 500)

    # simulated haplotype reads with sequencing errors
    hap = bytearray(ref)
    for v in variants[::2]:
        hap[v.position] = v.allele1[0]
    reads = []
    for _ in range(args.reads):
        r = bytearray(hap if rng.random() < 0.5 else ref)
        for j in rng.choice(L, size=int(L * args.error), replace=False):
            r[j] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        reads.append(bytes(r))

    # device
    t0 = time.perf_counter()
    res = align_reads_device(g, reads)
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        res = align_reads_device(g, reads)
        best = min(best, time.perf_counter() - t0)
    n_ok = sum(1 for r in res if r is not None)

    # host C++ (per-read, like production's batched chunk path)
    import jax
    host_best = None
    try:
        from hiphase_jax.io import native
        if native.available():
            host_best = float("inf")
            for _ in range(args.reps):
                t0 = time.perf_counter()
                for r in reads:
                    g.edit_distance_with_pruning(r, 500)
                host_best = min(host_best, time.perf_counter() - t0)
    except Exception:
        pass

    out = {
        "metric": "wfa_device_reads_per_sec",
        "value": round(args.reads / best, 1),
        "platform": jax.devices()[0].platform,
        "reads": args.reads, "window": L, "variants": args.variants,
        "certified": n_ok, "compile_s": round(compile_s, 2),
        "device_ms_per_read": round(1e3 * best / args.reads, 3),
    }
    if host_best is not None:
        out["host_reads_per_sec"] = round(args.reads / host_best, 1)
        out["host_ms_per_read"] = round(1e3 * host_best / args.reads, 3)
        out["device_vs_host"] = round(host_best / best, 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
