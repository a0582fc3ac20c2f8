"""End-to-end CLI tests on simulated data: phased VCF correctness vs
simulation truth, haplotagged BAM, stats outputs, and engine agreement."""

import numpy as np
import pytest

from hiphase_jax.cli import main as cli_main
from hiphase_jax.io.bam import BamReader
from hiphase_jax.io.vcf import VcfReader

from tests.sim import build_dataset


def run_cli(tmp_path, fasta, vcf, bam, extra=None, name="out"):
    out_vcf = str(tmp_path / f"{name}.vcf.gz")
    out_bam = str(tmp_path / f"{name}.bam")
    argv = ["--bam", bam, "--output-bam", out_bam,
            "--vcf", vcf, "--output-vcf", out_vcf,
            "--reference", fasta,
            "--summary-file", str(tmp_path / f"{name}.summary.tsv"),
            "--stats-file", str(tmp_path / f"{name}.stats.csv"),
            "--blocks-file", str(tmp_path / f"{name}.blocks.tsv"),
            "--haplotag-file", str(tmp_path / f"{name}.haplotag.tsv"),
            "--disable-global-realignment"] + (extra or [])
    assert cli_main(argv) == 0
    return out_vcf, out_bam


def check_phasing_against_truth(out_vcf, contigs):
    """Every het variant must be phased a|b with a PS tag; within one phase
    set, orientation must be consistent with the truth diplotype (zero switch
    errors expected for clean simulated reads)."""
    rd = VcfReader(out_vcf)
    records = list(rd)
    truth = {(c.name, v.pos): v for c in contigs for v in c.variants}
    n_phased = 0
    orientation_by_ps: dict[tuple, int] = {}
    for rec in records:
        v = truth[(rec.chrom, rec.pos0)]
        gt, phased = rec.genotype(0)
        if v.gt == (1, 1):
            assert gt == [1, 1] and not phased, "hom variant must be untouched"
            continue
        assert phased, f"het at {rec.chrom}:{rec.pos0} not phased"
        ps = rec.sample_field(0, "PS")
        assert ps not in (None, b"."), "phased het must carry PS"
        key = (rec.chrom, ps)
        # orientation: 0 if (h1,h2)==truth, 1 if flipped
        if tuple(gt) == v.gt:
            orient = 0
        elif tuple(gt) == v.gt[::-1]:
            orient = 1
        else:
            raise AssertionError(f"GT {gt} does not match truth {v.gt}")
        if key in orientation_by_ps:
            assert orientation_by_ps[key] == orient, \
                f"switch error within phase set {key}"
        else:
            orientation_by_ps[key] = orient
        n_phased += 1
    assert n_phased > 0
    return n_phased, orientation_by_ps


def test_e2e_single_sample(tmp_path):
    fasta, vcf, bam, contigs, truth_haps = build_dataset(tmp_path, seed=1)
    out_vcf, out_bam = run_cli(tmp_path, fasta, vcf, bam)

    n_phased, orientations = check_phasing_against_truth(out_vcf, contigs)
    n_het = sum(1 for c in contigs for v in c.variants if v.gt != (1, 1))
    assert n_phased == n_het, "all het SNVs should phase in clean sim"

    # output VCF indexed and record count preserved
    rd = VcfReader(out_vcf)
    assert rd._index is not None
    assert len(list(rd)) == sum(len(c.variants) for c in contigs)

    # haplotagged BAM: HP consistent with truth within each phase set
    with BamReader(out_bam) as bamr:
        recs = list(bamr)
        in_count = sum(1 for _ in BamReader(bam))
        assert len(recs) == in_count, "all reads must be copied"
        tagged = [r for r in recs if r.get_tag("HP") is not None]
        assert len(tagged) > 0.9 * len(recs)
        mismatches = 0
        for r in tagged:
            hp = r.get_tag("HP")
            ps = r.get_tag("PS")
            assert hp in (1, 2) and ps is not None
            chrom = bamr.header.ref_names[r.refid]
            orient = orientations.get((chrom, str(ps).encode()))
            if orient is None:
                continue
            expected_hp = (truth_haps[r.read_name] ^ orient) + 1
            if hp != expected_hp:
                mismatches += 1
        assert mismatches == 0, f"{mismatches} haplotag mismatches"

    # stats outputs parse
    blocks = (tmp_path / "out.blocks.tsv").read_text().splitlines()
    assert blocks[0].startswith("source_block_index")
    assert len(blocks) > 1
    summary = (tmp_path / "out.summary.tsv").read_text().splitlines()
    assert len(summary) >= 4  # 2 contigs + all, per sample + header
    stats = (tmp_path / "out.stats.csv").read_text().splitlines()
    assert "," in stats[0]
    haplotags = (tmp_path / "out.haplotag.tsv").read_text().splitlines()
    assert len(haplotags) - 1 == len(
        [l for l in haplotags[1:] if l.strip()])


def test_e2e_tpu_engine_matches_astar(tmp_path):
    fasta, vcf, bam, contigs, _ = build_dataset(tmp_path, seed=2,
                                                n_contigs=1, contig_len=12000)
    vcf_a, _ = run_cli(tmp_path, fasta, vcf, bam, name="astar")
    vcf_b, _ = run_cli(tmp_path, fasta, vcf, bam,
                       extra=["--engine", "device", "--beam-width", "64"],
                       name="device")
    recs_a = [r.serialize() for r in VcfReader(vcf_a)]
    recs_b = [r.serialize() for r in VcfReader(vcf_b)]
    assert recs_a == recs_b, "device engine output differs from A* oracle"


def test_e2e_prephased_input_stripped(tmp_path):
    """Pre-existing phasing in the input must be stripped and re-derived."""
    fasta, vcf, bam, contigs, _ = build_dataset(tmp_path, seed=3,
                                                n_contigs=1, contig_len=10000)
    # rewrite the VCF with pre-phased GTs + bogus PS everywhere
    from hiphase_jax.io.vcf import VcfHeader, VcfRecord, VcfWriter
    rd = VcfReader(vcf)
    header = VcfHeader(list(rd.header.lines), list(rd.samples))
    header.add_line('##FORMAT=<ID=PS,Number=1,Type=Integer,Description="x">')
    pre = str(tmp_path / "prephased.vcf.gz")
    wr = VcfWriter(pre, header)
    for rec in rd:
        gt, _ = rec.genotype(0)
        rec.set_genotype(0, gt[::-1], phased=True)
        rec.set_sample_field(0, "PS", b"999999")
        wr.write(rec)
    wr.close()
    wr.write_index()

    out_vcf, _ = run_cli(tmp_path, fasta, vcf, bam, name="clean")
    out_vcf2, _ = run_cli(tmp_path, fasta, pre, bam, name="strip")
    a = [r.serialize() for r in VcfReader(out_vcf)]
    b = [r.serialize() for r in VcfReader(out_vcf2)]
    assert a == b, "prephased input must produce identical output"


def test_e2e_unphased_regions(tmp_path):
    """Variants with no read support become unphased blocks, left as-is."""
    import numpy as np
    from tests.sim import (simulate_contig, simulate_reads, write_bam,
                           write_fasta, write_vcf, RG_TAG)
    rng = np.random.default_rng(7)
    contigs = [simulate_contig(rng, "chr1", 20000)]
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    bam = str(tmp_path / "reads.bam")
    write_fasta(fasta, contigs)
    write_vcf(vcf, contigs)
    # reads only cover the first half of the contig
    reads = simulate_reads(rng, contigs[0], 0, coverage=20, rg_tag=RG_TAG)
    reads = [t for t in reads if t[0] + 2000 < 10000]
    write_bam(bam, contigs, [reads])

    out_vcf, _ = run_cli(tmp_path, fasta, vcf, bam, name="half")
    rd = VcfReader(out_vcf)
    phased_pos = []
    unphased_pos = []
    for rec in rd:
        gt, phased = rec.genotype(0)
        if gt == [1, 1]:
            continue
        (phased_pos if phased else unphased_pos).append(rec.pos0)
    assert phased_pos and unphased_pos
    assert max(phased_pos) < 10000, "nothing beyond read coverage can phase"
    assert all(p > 9000 for p in unphased_pos), \
        "covered variants should be phased"


def test_bam_writer_native_window_matches_record_path(tmp_path):
    """The bulk native strip+retag window path must produce records
    byte-identical (including aux tag order and widths) to the per-record
    Python path."""
    from hiphase_jax.io import native as native_mod
    from hiphase_jax.writers.bam_writer import OrderedBamWriter

    if not native_mod.available():
        pytest.skip("native library not built")
    fasta, vcf, bam, contigs, _ = build_dataset(
        tmp_path, seed=77, n_contigs=2, contig_len=9000, coverage=12)
    out_n = run_cli(tmp_path, fasta, vcf, bam, name="nat",
                    extra=["--engine", "native"])[1]
    orig = OrderedBamWriter._write_window_native
    OrderedBamWriter._write_window_native = lambda *a, **k: False
    try:
        out_r = run_cli(tmp_path, fasta, vcf, bam, name="rec",
                        extra=["--engine", "native"])[1]
    finally:
        OrderedBamWriter._write_window_native = orig
    with BamReader(out_n) as a, BamReader(out_r) as b:
        ra = [r.raw for r in a]
        rb = [r.raw for r in b]
    assert len(ra) == len(rb) > 50
    assert ra == rb
