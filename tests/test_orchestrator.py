"""Batched device orchestration: many blocks, threaded prepare, bucket batching
— output must be byte-identical to the serial A* path."""

from hiphase_jax.io.vcf import VcfReader

from tests.sim import build_dataset
from tests.test_e2e import run_cli


def test_batched_threaded_matches_serial(tmp_path):
    fasta, vcf, bam, contigs, _ = build_dataset(
        tmp_path, seed=21, n_contigs=6, contig_len=6000, coverage=15)
    vcf_a, bam_a = run_cli(tmp_path, fasta, vcf, bam, name="serial")
    vcf_b, bam_b = run_cli(
        tmp_path, fasta, vcf, bam, name="batched",
        extra=["--engine", "device", "--beam-width", "64", "--batch-size", "4",
               "--threads", "3"])
    a = [r.serialize() for r in VcfReader(vcf_a)]
    b = [r.serialize() for r in VcfReader(vcf_b)]
    assert a == b

    from hiphase_jax.io.bam import BamReader
    with BamReader(bam_a) as ra, BamReader(bam_b) as rb:
        recs_a = [(r.read_name, r.pos, r.get_tag("HP"), r.get_tag("PS"))
                  for r in ra]
        recs_b = [(r.read_name, r.pos, r.get_tag("HP"), r.get_tag("PS"))
                  for r in rb]
    assert recs_a == recs_b


def test_drain_partial_buckets(tmp_path):
    """Fewer blocks than batch size: drain must still solve everything."""
    fasta, vcf, bam, contigs, _ = build_dataset(
        tmp_path, seed=22, n_contigs=1, contig_len=6000)
    vcf_a, _ = run_cli(tmp_path, fasta, vcf, bam, name="serial")
    vcf_b, _ = run_cli(tmp_path, fasta, vcf, bam, name="big-batch",
                       extra=["--engine", "device", "--beam-width", "64",
                              "--batch-size", "64"])
    a = [r.serialize() for r in VcfReader(vcf_a)]
    b = [r.serialize() for r in VcfReader(vcf_b)]
    assert a == b


def test_tpu_engine_with_global_realignment(tmp_path):
    """The batched device engine composes with graph-WFA allele assignment."""
    from hiphase_jax.cli import main as cli_main

    fasta, vcf, bam, contigs, _ = build_dataset(
        tmp_path, seed=23, n_contigs=1, contig_len=6000)
    out_a = str(tmp_path / "astar.vcf.gz")
    out_t = str(tmp_path / "device.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out_a,
                     "--reference", fasta]) == 0
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out_t,
                     "--reference", fasta, "--engine", "device",
                     "--beam-width", "64", "--batch-size", "4"]) == 0
    a = [r.serialize() for r in VcfReader(out_a)]
    b = [r.serialize() for r in VcfReader(out_t)]
    assert a == b
