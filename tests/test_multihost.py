"""Multi-host execution: REAL `jax.distributed.initialize` runs (2 and 4
processes) whose host-0 outputs must equal the single-process run —
phased VCF, haplotagged BAM, and all four stats files (SURVEY.md
§2.9/§5.8 — the distributed-backend obligation)."""

import pathlib
import socket
import subprocess
import sys
import textwrap

import pytest

from hiphase_jax.io.vcf import VcfReader

from tests.sim import build_dataset
from tests.test_e2e import run_cli

REPO = str(pathlib.Path(__file__).resolve().parents[1])

DRIVER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import os
    os.environ["HIPHASE_PROBE_CACHE"] = "0"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize({coord!r}, {n!r}, int(sys.argv[1]))
    from hiphase_jax.cli import main
    rc = main(["--bam", {bam!r}, "--vcf", {vcf!r}, "--reference", {fasta!r},
               "--output-vcf", {out!r}, "--output-bam", {out_bam!r},
               "--stats-file", {stats!r}, "--haplotag-file", {tags!r},
               "--blocks-file", {blocks!r}, "--summary-file", {summary!r},
               "--engine", {engine!r}, "--threads", "2",
               "--beam-width", "64", "--batch-size", "4",
               "--disable-global-realignment"])
    sys.exit(rc)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _bam_records(path):
    from hiphase_jax.io.bam import BamReader
    with BamReader(path) as rd:
        return [(r.read_name, r.refid, r.pos, r.flag, r.get_tag("HP"),
                 r.get_tag("PS")) for r in rd]


@pytest.mark.parametrize("n_procs,engine", [
    pytest.param(2, "device", id="2-tpu"),  # id kept from the engine's old name
    (4, "native")])
def test_multiprocess_run_matches_single(tmp_path, n_procs, engine):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=31, n_contigs=4, contig_len=6000, coverage=15)

    # run_cli already writes out-bam + all four stats files as single.*
    vcf_single, bam_single = run_cli(
        tmp_path, fasta, vcf, bam, name="single",
        extra=["--engine", engine, "--beam-width", "64", "--batch-size", "4"])
    single = {"bam": bam_single,
              "stats.csv": str(tmp_path / "single.stats.csv"),
              "tags.tsv": str(tmp_path / "single.haplotag.tsv"),
              "blocks.tsv": str(tmp_path / "single.blocks.tsv"),
              "summary.tsv": str(tmp_path / "single.summary.tsv")}

    multi = {k: str(tmp_path / f"multi{n_procs}.{k}") for k in
             ("vcf.gz", "bam", "stats.csv", "tags.tsv", "blocks.tsv",
              "summary.tsv")}
    coord = f"127.0.0.1:{_free_port()}"
    driver = tmp_path / f"driver{n_procs}.py"
    driver.write_text(DRIVER.format(
        repo=REPO, coord=coord, n=n_procs, bam=bam, vcf=vcf, fasta=fasta,
        out=multi["vcf.gz"], out_bam=multi["bam"], stats=multi["stats.csv"],
        tags=multi["tags.tsv"], blocks=multi["blocks.tsv"],
        summary=multi["summary.tsv"], engine=engine))
    procs = [subprocess.Popen([sys.executable, str(driver), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(n_procs)]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, so, se))
    for rc, so, se in outs:
        assert rc == 0, se.decode()[-2000:]

    a = [r.serialize() for r in VcfReader(vcf_single)]
    b = [r.serialize() for r in VcfReader(multi["vcf.gz"])]
    assert a == b and len(a) > 50

    assert _bam_records(single["bam"]) == _bam_records(multi["bam"])

    for k in ("stats.csv", "tags.tsv", "blocks.tsv", "summary.tsv"):
        sa = open(single[k]).read().splitlines()
        sb = open(multi[k]).read().splitlines()
        if k in ("stats.csv", "tags.tsv"):
            # per-result rows are written in arrival order (the reference's
            # mpsc semantics); multihost replay changes arrival order but
            # not content
            sa, sb = [sa[0]] + sorted(sa[1:]), [sb[0]] + sorted(sb[1:])
        assert sa == sb, f"{k} differs at {n_procs} processes"
        assert len(sa) > 1
