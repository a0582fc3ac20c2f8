"""End-to-end benchmark: run the full CLI on a WGS-scale simulated dataset.

This is the number BASELINE.md tracks: wall-clock phasing throughput through
the entire pipeline (block gen -> allele assignment -> solve -> ordered
writers), reported as hets/s and blocks/s against the reference's published
steady state (~2,068 hets/s, 16 CPU threads, HG001 WGS local-only mode;
ref: docs/user_guide.md:78).

Usage: python bench_e2e.py [--mb 100] [--coverage 30] [--engine device]

The dataset is built once (vectorized simulator) and cached under
``.bench_data/`` in the checkout (or $HIPHASE_BENCH_CACHE), keyed by its
parameters; repeat runs only time the pipeline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def dataset_dir(args) -> str:
    key = (f"mb{args.mb}_cov{args.coverage}_rl{args.read_length}"
           f"_het{args.het_spacing}_err{args.error_rate}"
           f"_blk{args.block_kb}_seed{args.seed}_v3")
    base = os.environ.get("HIPHASE_BENCH_CACHE") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".bench_data")
    return os.path.join(base, key)


def ensure_dataset(args) -> dict:
    d = dataset_dir(args)
    meta_path = os.path.join(d, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            return json.load(fh)
    from hiphase_jax.utils.simulate import build_benchmark_dataset
    t0 = time.time()
    meta = build_benchmark_dataset(
        d, total_mb=args.mb, coverage=args.coverage,
        read_length=args.read_length, seed=args.seed,
        het_spacing=args.het_spacing, error_rate=args.error_rate,
        block_kb=args.block_kb, io_threads=2)
    meta["gen_seconds"] = round(time.time() - t0, 2)
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    return meta


def build_args(argv=None):
    return _parser().parse_args(argv)


def run_once(args, meta) -> float:
    """One timed CLI run over the cached dataset; returns elapsed seconds."""
    out_dir = os.path.join(dataset_dir(args), "out")
    os.makedirs(out_dir, exist_ok=True)
    out_vcf = os.path.join(out_dir, "phased.vcf.gz")
    cli_args = [
        "--bam", meta["bam"], "--vcf", meta["vcf"],
        "--reference", meta["fasta"], "--output-vcf", out_vcf,
        "--engine", args.engine, "--threads", str(args.threads),
    ]
    if not args.global_mode:
        cli_args.append("--disable-global-realignment")
    if args.output_bam:
        cli_args += ["--output-bam", os.path.join(out_dir, "tagged.bam")]
    from hiphase_jax.cli import main as cli_main
    t0 = time.time()
    rc = cli_main(cli_args)
    elapsed = time.time() - t0
    assert rc == 0
    return elapsed


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-length", type=int, default=15000)
    ap.add_argument("--het-spacing", type=int, default=800)
    ap.add_argument("--error-rate", type=float, default=0.01)
    ap.add_argument("--block-kb", type=int, default=250)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "astar", "device", "native"])
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--global", dest="global_mode", action="store_true",
                    help="enable global realignment (dual mode); default is "
                         "local-only, matching the reference's baseline run")
    ap.add_argument("--output-bam", action="store_true",
                    help="also write the haplotagged BAM")
    ap.add_argument("--profile", action="store_true",
                    help="run under cProfile and print the top entries")
    return ap


def main(argv=None):
    args = build_args(argv)
    meta = ensure_dataset(args)

    if args.profile:
        import cProfile
        import pstats
        prof = cProfile.Profile()
        prof.enable()
        elapsed = run_once(args, meta)
        prof.disable()
        stats = pstats.Stats(prof, stream=sys.stderr)
        stats.sort_stats("cumulative").print_stats(40)
        stats.sort_stats("tottime").print_stats(40)
    else:
        elapsed = run_once(args, meta)

    hets_per_sec = meta["n_het"] / elapsed
    baseline = 2068.0
    from hiphase_jax.cli import LAST_RUN_STATS
    out = {
        "metric": "e2e_phased_hets_per_sec",
        "value": round(hets_per_sec, 1),
        "unit": "hets/s",
        "vs_baseline": round(hets_per_sec / baseline, 3),
        "elapsed_s": round(elapsed, 2),
        "n_het": meta["n_het"],
        "n_reads": meta["n_reads"],
        "total_bp": meta["total_bp"],
        "engine": args.engine,
        "global_mode": args.global_mode,
        "output_bam": bool(args.output_bam),
    }
    out.update({k: v for k, v in LAST_RUN_STATS.items()
                if k in ("engine", "node_expansions", "solve_seconds",
                         "degraded", "phasing_seconds", "stage_seconds",
                         "device_batches", "device_transfers",
                         "transfers_per_batch")})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
