"""Smoke run of the phasing pipeline's device engine on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the device engine on a
                                       # 4-device mesh vs the native engine

Phases (one process; each must pass, nothing is caught):
  1. setup: build native/ from source, require JAX's GPU backend, print the
     card's name and power limit;
  2. main path: the 30 Mb, 30x simulated dataset through ``cli.main`` with
     ``--engine device`` (cold, then again after clearing the in-memory
     compile caches so the persistent cache serves it) and with
     ``--engine native``; phased VCF and haplotagged BAM must be
     record-identical and the three TSVs byte-identical;
  3. oracle: a 2 Mb dataset, ``--engine device`` vs the host A* oracle;
  4. kernel: the device-resident beam tile at B=64, R=128, T=128, W=1024;
  5. device graph-WFA: 15 kb reads against graphs with SV and TR branches,
     exact against the host aligner for every certified read.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import struct
import subprocess
import sys
import time

import numpy as np

import bench
import bench_e2e
from hiphase_jax import cli
from hiphase_jax.io import native
from hiphase_jax.utils.jax_env import configure_compile_cache

MAIN_MB = 30
ORACLE_MB = 2
THREADS = 8
# header lines that carry the command line, the only lines that may differ
VCF_COMMAND_PREFIX = b"##hiphase_jax_command="
BAM_PG_PREFIX = "@PG\tID:hiphase-jax"
TSV_OUTPUTS = ("summary", "blocks", "haplotag")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- setup

def require_gpu(count: int):
    """JAX's devices, which must be ``count`` GPUs."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{devs[0].platform!r}, devices {devs})")
    if len(devs) != count:
        raise SystemExit(f"chip_smoke: expected {count} GPU(s), JAX sees "
                         f"{len(devs)}: {devs}")
    return devs


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def device_info_line(cards: list[str], jax_version: str,
                     platform_version: str) -> str:
    """One line with every card's name and power limit (as nvidia-smi
    prints them) beside the JAX and CUDA versions."""
    return (f"card: {' | '.join(cards)} ; jax {jax_version} ; "
            f"{' '.join(platform_version.split())}")


def setup(count: int):
    import jax
    devs = require_gpu(count)
    native.build(force=True)
    if not native.available():
        raise SystemExit("chip_smoke: native library did not load")
    log(device_info_line(card_lines(), jax.__version__,
                         devs[0].client.platform_version))
    log(f"devices: {[d.device_kind for d in devs]}; compile cache: "
        f"{configure_compile_cache()}; native BGZF codec: "
        f"{'libdeflate' if native.has_libdeflate() else 'zlib'}")
    return devs


# ------------------------------------------------------- output compare

def _vcf_lines(path: str) -> list[bytes]:
    with gzip.open(path, "rb") as fh:
        return [line for line in fh.read().splitlines()
                if not line.startswith(VCF_COMMAND_PREFIX)]


def _bam_open(path: str):
    """(header text lines without our @PG line, stream positioned after the
    header text)."""
    fh = gzip.open(path, "rb")
    if fh.read(4) != b"BAM\x01":
        raise AssertionError(f"{path}: not a BAM file")
    l_text = struct.unpack("<i", fh.read(4))[0]
    text = fh.read(l_text).split(b"\x00")[0].decode()
    lines = [line for line in text.splitlines()
             if not line.startswith(BAM_PG_PREFIX)]
    return lines, fh


def compare_vcf(a: str, b: str) -> int:
    """Assert record identity (header included, command line excluded);
    returns the number of data records."""
    la, lb = _vcf_lines(a), _vcf_lines(b)
    if la != lb:
        diff = next(i for i, (x, y) in enumerate(zip(la + [b""], lb + [b""]))
                    if x != y)
        raise AssertionError(f"VCF differs at line {diff}: {a} vs {b}")
    return sum(1 for line in la if not line.startswith(b"#"))


def compare_bam(a: str, b: str, chunk: int = 1 << 24) -> int:
    """Assert that two BAMs hold the same header (our @PG line excluded)
    and byte-identical reference lists and records; returns the bytes of
    records compared."""
    ha, fa = _bam_open(a)
    hb, fb = _bam_open(b)
    with fa, fb:
        if ha != hb:
            raise AssertionError(f"BAM headers differ: {a} vs {b}")
        n = 0
        while True:
            ca, cb = fa.read(chunk), fb.read(chunk)
            if ca != cb:
                raise AssertionError(
                    f"BAM records differ within bytes {n}..{n + chunk}")
            if not ca:
                return n
            n += len(ca)


def compare_outputs(a: dict, b: dict) -> dict:
    """Compare two runs' outputs (see `run_cli`); raises on any
    difference."""
    out = {"vcf_records": compare_vcf(a["vcf"], b["vcf"])}
    if "bam" in a:
        out["bam_record_bytes"] = compare_bam(a["bam"], b["bam"])
    for k in TSV_OUTPUTS:
        if k in a:
            with open(a[k], "rb") as fa, open(b[k], "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"{k} TSV differs: {a[k]} "
                                         f"vs {b[k]}")
            out[f"{k}_tsv"] = "identical"
    return out


# ----------------------------------------------------------- CLI runs

def run_cli(meta: dict, out_dir: str, engine: str, threads: int = THREADS,
            full_outputs: bool = True) -> dict:
    """One in-process ``cli.main`` run in local mode; returns output paths,
    wall seconds and the run's telemetry."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {"vcf": os.path.join(out_dir, "phased.vcf.gz")}
    argv = ["--bam", meta["bam"], "--vcf", meta["vcf"],
            "--reference", meta["fasta"], "--output-vcf", paths["vcf"],
            "--disable-global-realignment", "--engine", engine,
            "--threads", str(threads)]
    if full_outputs:
        paths["bam"] = os.path.join(out_dir, "haplotagged.bam")
        argv += ["--output-bam", paths["bam"]]
        for k in TSV_OUTPUTS:
            paths[k] = os.path.join(out_dir, f"{k}.tsv")
            argv += [f"--{k}-file", paths[k]]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main --engine {engine} returned {rc}")
    return {"paths": paths, "wall_s": wall, "stats": dict(cli.LAST_RUN_STATS)}


def report_run(label: str, run: dict, n_het: int) -> None:
    s = run["stats"]
    log(f"[{label}] wall {run['wall_s']:.3f} s, {n_het / run['wall_s']:.1f} "
        f"hets/s; engine {s.get('engine')}, device_batches "
        f"{s.get('device_batches')}, transfers_per_batch "
        f"{s.get('transfers_per_batch')}, mesh_devices "
        f"{s.get('mesh_devices')}")
    log(f"[{label}] stage_seconds {json.dumps(s.get('stage_seconds'))}")


def dataset(mb: int) -> dict:
    t0 = time.perf_counter()
    meta = bench_e2e.ensure_dataset(bench_e2e.build_args(["--mb", str(mb)]))
    log(f"[data] {mb} Mb: {meta['n_het']} hets, {meta['n_reads']} reads "
        f"({time.perf_counter() - t0:.1f} s)")
    return meta


def main_path(devs, work: str, warm_rerun: bool = True) -> None:
    import jax
    meta = dataset(MAIN_MB)
    n_het = meta["n_het"]
    dev = run_cli(meta, os.path.join(work, "device"), "device")
    report_run("device cold", dev, n_het)
    if dev["stats"].get("mesh_devices") != len(devs):
        raise AssertionError(f"device engine meshed "
                             f"{dev['stats'].get('mesh_devices')} devices, "
                             f"JAX sees {len(devs)}")
    if warm_rerun:
        # drop the in-memory executables: the rerun's programs come from
        # the persistent compile cache
        jax.clear_caches()
        warm = run_cli(meta, os.path.join(work, "device_warm"), "device")
        report_run("device persistent-cache", warm, n_het)
        log(f"[compile] cold {dev['wall_s']:.3f} s vs persistent-cache "
            f"{warm['wall_s']:.3f} s; cache entries: "
            f"{_cache_entries()}")
        compare_outputs(dev["paths"], warm["paths"])
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    log(f"[memory] peak_bytes_in_use per device: {peaks}")
    nat = run_cli(meta, os.path.join(work, "native"), "native")
    report_run("native", nat, n_het)
    same = compare_outputs(dev["paths"], nat["paths"])
    log(f"[main] device == native on {MAIN_MB} Mb: {json.dumps(same)}")


def _cache_entries():
    d = configure_compile_cache()
    return len(os.listdir(d)) if os.path.isdir(d) else 0


def oracle(work: str) -> None:
    meta = dataset(ORACLE_MB)
    dev = run_cli(meta, os.path.join(work, "oracle_device"), "device",
                  full_outputs=False)
    ast = run_cli(meta, os.path.join(work, "oracle_astar"), "astar",
                  threads=1, full_outputs=False)
    n = compare_vcf(dev["paths"]["vcf"], ast["paths"]["vcf"])
    log(f"[oracle] device == astar on {ORACLE_MB} Mb: {n} VCF records "
        f"(device {dev['wall_s']:.3f} s, astar {ast['wall_s']:.3f} s)")


def kernel() -> None:
    k = bench.kernel_metric()
    log(f"[kernel] {json.dumps(k)}")


# ------------------------------------------------------- device graph-WFA

def wfa_workload(n_graphs: int = 4, reads_per_graph: int = 64,
                 length: int = 15_000, error_rate: float = 0.002,
                 seed: int = 7):
    """Graphs over ``length`` bp of random reference with one SV deletion,
    one SV insertion, one tandem-repeat expansion and SNVs, and reads that
    are haplotypes of the full window with substitution errors. Every graph
    has the same layout, so the device kernel compiles once per band."""
    from hiphase_jax.align.wfa_graph import WFAGraph
    from hiphase_jax.core.variants import Variant

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    scale = length / 15_000
    sv_del, sv_ins, tr = (int(3000 * scale), int(6500 * scale),
                          int(10_000 * scale))
    del_len, ins_len = max(int(150 * scale), 2), max(int(120 * scale), 1)
    tr_unit, tr_ref, tr_alt = b"CAG", 30, 40
    work = []
    for _g in range(n_graphs):
        ref = bytearray(rng.choice(acgt, length).tobytes())
        ref[tr:tr + 3 * tr_ref] = tr_unit * tr_ref
        ref = bytes(ref)
        variants = []
        for pos in range(350, length - 200, max(int(700 * scale), 40)):
            if any(abs(pos - p) < 400 * scale + 3 * tr_alt
                   for p in (sv_del, sv_ins, tr)):
                continue
            alt = bytes([rng.choice([b for b in b"ACGT" if b != ref[pos]])])
            variants.append(Variant.new_snv(0, pos, ref[pos:pos + 1], alt,
                                            0, 1))
        variants.append(Variant.new_sv_deletion(
            0, sv_del, del_len + 1, ref[sv_del:sv_del + del_len + 1],
            ref[sv_del:sv_del + 1], 0, 1))
        variants.append(Variant.new_sv_insertion(
            0, sv_ins, 1, ref[sv_ins:sv_ins + 1],
            ref[sv_ins:sv_ins + 1] + rng.choice(acgt, ins_len).tobytes(),
            0, 1))
        variants.append(Variant.new_tandem_repeat(
            0, tr, 3 * tr_ref, tr_unit * tr_ref, tr_unit * tr_alt, 0, 1))
        variants.sort(key=lambda v: v.position)
        graph, _ = WFAGraph.from_reference_variants(ref, variants, 0, length,
                                                    1000)
        reads = []
        for _r in range(reads_per_graph):
            # each read carries a random mix of the two alleles
            alt_mask = rng.random(len(variants)) < 0.5
            seq, prev = bytearray(), 0
            for v, use_alt in zip(variants, alt_mask):
                seq += ref[prev:v.position]
                seq += v.allele1 if use_alt else v.allele0
                prev = v.position + v.ref_len
            seq += ref[prev:]
            n_err = rng.binomial(len(seq), error_rate)
            for j in rng.choice(len(seq), size=n_err, replace=False):
                seq[j] = rng.choice([b for b in b"ACGT" if b != seq[j]])
            reads.append(bytes(seq))
        work.append((graph, reads))
    return work


def wfa_check(work, min_certified: float = 0.9) -> dict:
    """Device vs host graph-WFA on `wfa_workload` output; asserts equal
    score and traversed nodes for every read the band ladder certifies."""
    from hiphase_jax.align.wfa_device import align_reads_device

    n_reads = sum(len(r) for _g, r in work)
    align_reads_device(*work[0])  # compile every band of the ladder
    t0 = time.perf_counter()
    dev = [align_reads_device(g, reads) for g, reads in work]
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [[g.edit_distance(r) for r in reads] for g, reads in work]
    host_s = time.perf_counter() - t0
    certified = 0
    for gi, (d_res, h_res) in enumerate(zip(dev, host)):
        for ri, (d, h) in enumerate(zip(d_res, h_res)):
            if d is None:
                continue
            certified += 1
            if d != (h.score, h.traversed_nodes):
                raise AssertionError(
                    f"graph {gi} read {ri}: device {d[0]} {d[1]} vs host "
                    f"{h.score} {h.traversed_nodes}")
    if certified < min_certified * n_reads:
        raise AssertionError(f"only {certified}/{n_reads} reads certified")
    return {"reads": n_reads, "certified": certified,
            "read_len": len(work[0][1][0]),
            "device_reads_per_s": n_reads / dev_s,
            "host_reads_per_s": n_reads / host_s}


def wfa() -> None:
    log(f"[wfa] device == host: {json.dumps(wfa_check(wfa_workload()))}")


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the main path's device run on four GPUs "
                         "and the native run it is compared with")
    ap.add_argument("--work-dir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".bench_data", "smoke"))
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    t_start = time.perf_counter()
    devs = setup(count)
    if args.four_cards:
        main_path(devs, args.work_dir, warm_rerun=False)
    else:
        main_path(devs, args.work_dir)
        oracle(args.work_dir)
        kernel()
        wfa()
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
