"""Genotype edge cases end-to-end: multi-allelic 1/2 sites, haploid GTs
(TRGT-style), and missing genotypes."""

import numpy as np

from hiphase_jax.cli import main as cli_main
from hiphase_jax.io.vcf import VcfHeader, VcfReader, VcfRecord, VcfWriter

from tests import sim


def test_multiallelic_het_phasing(tmp_path):
    """GT 1/2 sites phase to 1|2 or 2|1 with correct truth orientation."""
    rng = np.random.default_rng(71)
    contig = sim.simulate_contig(rng, "chr1", 12000)
    # convert every 5th het SNV into a multi-allelic 1/2 site
    n_multi = 0
    for i, v in enumerate(contig.variants):
        if v.gt != (1, 1) and i % 5 == 0:
            others = [bytes([b]) for b in sim.BASES
                      if bytes([b]) not in (v.ref, v.alt)]
            v.alt2 = others[0]
            v.gt = (1, 2) if v.gt == (0, 1) else (2, 1)
            n_multi += 1
    assert n_multi >= 10
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    bam = str(tmp_path / "reads.bam")
    sim.write_fasta(fasta, [contig])
    sim.write_vcf(vcf, [contig])
    reads = sim.simulate_reads_mixed(rng, contig, 0, coverage=25,
                                     rg_tag=sim.RG_TAG)
    sim.write_bam(bam, [contig], [reads])

    out = str(tmp_path / "o.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out,
                     "--reference", fasta]) == 0
    truth = {v.pos: v for v in contig.variants}
    orientation = {}
    n_checked = 0
    for rec in VcfReader(out):
        v = truth[rec.pos0]
        gt, phased = rec.genotype(0)
        if v.gt == (1, 1):
            continue
        assert phased, f"het at {rec.pos0} not phased"
        assert sorted(gt) == sorted(v.gt), (gt, v.gt)
        ps = rec.sample_field(0, "PS")
        orient = 0 if tuple(gt) == v.gt else 1
        assert orientation.setdefault(ps, orient) == orient, "switch error"
        if v.alt2 is not None:
            assert sorted(gt) == [1, 2]
            n_checked += 1
    assert n_checked == n_multi


def test_haploid_and_missing_gts_stream_through(tmp_path):
    rng = np.random.default_rng(72)
    contig = sim.simulate_contig(rng, "chr1", 6000)
    fasta = str(tmp_path / "ref.fa")
    bam = str(tmp_path / "reads.bam")
    sim.write_fasta(fasta, [contig])
    reads = sim.simulate_reads(rng, contig, 0, rg_tag=sim.RG_TAG)
    sim.write_bam(bam, [contig], [reads])

    # hand-build a VCF with haploid / missing / normal records interleaved
    lines = [b"##fileformat=VCFv4.2",
             b'##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
             b'##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Q">',
             b"##contig=<ID=chr1,length=6000>",
             b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE"]
    header = VcfHeader.parse(lines)
    vcf = str(tmp_path / "calls.vcf.gz")
    wr = VcfWriter(vcf, header)
    kinds = {}
    for i, v in enumerate(contig.variants):
        if v.gt == (1, 1):
            gt = "1/1"
        elif i % 7 == 3:
            gt = "1"      # haploid (TRGT-style) → treated as homozygous
        elif i % 7 == 5:
            gt = "./."    # missing → unknown zygosity, not phasable
        else:
            gt = "0/1"
        kinds[v.pos] = gt
        wr.write(VcfRecord.parse(
            f"chr1\t{v.pos + 1}\t.\t{v.ref.decode()}\t{v.alt.decode()}"
            f"\t60\tPASS\t.\tGT:GQ\t{gt}:60".encode()))
    wr.close()
    wr.write_index()

    out = str(tmp_path / "o.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out,
                     "--reference", fasta,
                     "--disable-global-realignment"]) == 0
    n_phased = 0
    for rec in VcfReader(out):
        gt_field = rec.sample_field(0, "GT")
        phased = b"|" in gt_field
        kind = kinds[rec.pos0]
        if kind == "1":
            assert gt_field == b"1", gt_field  # haploid copied through
        elif kind == "./.":
            assert gt_field == b"./." and not phased
        elif kind == "1/1":
            assert gt_field == b"1/1" and not phased
        else:
            n_phased += phased
    assert n_phased > 20
