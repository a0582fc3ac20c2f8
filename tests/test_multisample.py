"""Multi-sample joint phasing: 2-sample VCF + per-sample BAMs, per-sample
phase blocks merged by the multi iterator, dummy-block BAM protocol."""

import numpy as np

from hiphase_jax.cli import main as cli_main
from hiphase_jax.io.bam import BamReader
from hiphase_jax.io.vcf import VcfHeader, VcfReader, VcfRecord, VcfWriter

from tests import sim


def build_two_sample(tmp_path, seed=41, length=15000):
    """Both samples share the contig; each has its own diplotype over a
    (mostly shared) variant set."""
    rng = np.random.default_rng(seed)
    base = sim.simulate_contig(rng, "chr1", length)
    # sample B: same sites, independent phase orientations + some hom-ref
    contig_a = sim.SimContig(base.name, base.seq, list(base.variants))
    b_variants = []
    for v in base.variants:
        if v.gt == (1, 1):
            b_variants.append(sim.SimVariant(v.pos, v.ref, v.alt, (1, 1)))
        elif rng.random() < 0.15:
            b_variants.append(sim.SimVariant(v.pos, v.ref, v.alt, (0, 0)))
        else:
            gt = (0, 1) if rng.random() < 0.5 else (1, 0)
            b_variants.append(sim.SimVariant(v.pos, v.ref, v.alt, gt))
    contig_b = sim.SimContig(base.name, base.seq, b_variants)

    fasta = str(tmp_path / "ref.fa")
    sim.write_fasta(fasta, [contig_a])

    # joint 2-sample VCF
    vcf = str(tmp_path / "joint.vcf.gz")
    lines = [b"##fileformat=VCFv4.2",
             b'##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
             b'##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Q">',
             f"##contig=<ID={base.name},length={length}>".encode(),
             b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSA\tSB"]
    header = VcfHeader.parse(lines)
    wr = VcfWriter(vcf, header)
    bmap = {v.pos: v for v in b_variants}
    for v in contig_a.variants:
        gta = f"{min(v.gt)}/{max(v.gt)}"
        vb = bmap[v.pos]
        gtb = f"{min(vb.gt)}/{max(vb.gt)}"
        wr.write(VcfRecord.parse(
            f"{base.name}\t{v.pos + 1}\t.\t{v.ref.decode()}\t"
            f"{v.alt.decode()}\t60\tPASS\t.\tGT:GQ\t{gta}:60\t{gtb}:60".encode()))
    wr.close()
    wr.write_index()

    # per-sample BAMs with RG SM tags
    bam_a = str(tmp_path / "a.bam")
    bam_b = str(tmp_path / "b.bam")
    reads_a = sim.simulate_reads(rng, contig_a, 0, coverage=20, rg_tag=sim.RG_TAG)
    truth_a = sim.write_bam(bam_a, [contig_a], [reads_a], sample="SA")
    reads_b = sim.simulate_reads(rng, contig_b, 0, coverage=20, rg_tag=sim.RG_TAG)
    truth_b = sim.write_bam(bam_b, [contig_b], [reads_b], sample="SB")
    return fasta, vcf, bam_a, bam_b, contig_a, contig_b, truth_a, truth_b


def test_two_sample_joint_phasing(tmp_path):
    (fasta, vcf, bam_a, bam_b, contig_a, contig_b,
     truth_a, truth_b) = build_two_sample(tmp_path)
    out_vcf = str(tmp_path / "phased.vcf.gz")
    out_a = str(tmp_path / "a.out.bam")
    out_b = str(tmp_path / "b.out.bam")
    assert cli_main([
        "--bam", bam_a, "--bam", bam_b,
        "--output-bam", out_a, "--output-bam", out_b,
        "--vcf", vcf, "--output-vcf", out_vcf, "--reference", fasta,
        "-s", "SA", "-s", "SB",
        "--disable-global-realignment"]) == 0

    rd = VcfReader(out_vcf)
    assert rd.samples == ["SA", "SB"]
    amap = {v.pos: v for v in contig_a.variants}
    bmap = {v.pos: v for v in contig_b.variants}
    phased_a = phased_b = 0
    for rec in rd:
        for si, vmap in ((0, amap), (1, bmap)):
            v = vmap[rec.pos0]
            gt, phased = rec.genotype(si)
            if v.gt in ((0, 1), (1, 0)):
                assert phased, f"sample {si} het at {rec.pos0} unphased"
                assert sorted(gt) == [0, 1]
                if si == 0:
                    phased_a += 1
                else:
                    phased_b += 1
            else:
                assert not phased
                assert tuple(sorted(gt)) == tuple(sorted(v.gt))
    assert phased_a > 50 and phased_b > 40

    # per-sample haplotagged BAMs: every read copied, tags per own sample
    for out_bam, src_bam in ((out_a, bam_a), (out_b, bam_b)):
        with BamReader(out_bam) as bo, BamReader(src_bam) as bi:
            orecs = list(bo)
            assert len(orecs) == sum(1 for _ in bi)
            tagged = [r for r in orecs if r.get_tag("HP") is not None]
            assert len(tagged) > 0.8 * len(orecs)
