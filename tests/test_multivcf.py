"""Joint phasing across multiple input VCFs (the DeepVariant + pbsv
configuration): SNVs in one VCF, SV deletions in another, phased together
into one set of phase blocks; each output VCF carries its own records."""

import numpy as np

from hiphase_jax.cli import main as cli_main
from hiphase_jax.io.vcf import VcfReader

from tests import sim


def test_two_vcf_joint_phasing(tmp_path):
    rng = np.random.default_rng(61)
    contig = sim.simulate_contig_mixed(rng, "chr1", 20000, sv_del=True)
    fasta = str(tmp_path / "ref.fa")
    sim.write_fasta(fasta, [contig])

    sv_variants = [v for v in contig.variants if v.info.startswith("SVTYPE")]
    small_variants = [v for v in contig.variants if not v.info.startswith("SVTYPE")]
    assert sv_variants and small_variants

    small_contig = sim.SimContig(contig.name, contig.seq, small_variants)
    sv_contig = sim.SimContig(contig.name, contig.seq, sv_variants)
    vcf_small = str(tmp_path / "dv.vcf.gz")
    vcf_sv = str(tmp_path / "pbsv.vcf.gz")
    sim.write_vcf(vcf_small, [small_contig])
    sim.write_vcf(vcf_sv, [sv_contig])

    reads = sim.simulate_reads_mixed(rng, contig, 0, coverage=25,
                                     rg_tag=sim.RG_TAG)
    bam = str(tmp_path / "reads.bam")
    sim.write_bam(bam, [contig], [reads])

    out_small = str(tmp_path / "dv.phased.vcf.gz")
    out_sv = str(tmp_path / "pbsv.phased.vcf.gz")
    assert cli_main(["--bam", bam,
                     "--vcf", vcf_small, "--vcf", vcf_sv,
                     "--output-vcf", out_small, "--output-vcf", out_sv,
                     "--reference", fasta,
                     "--blocks-file", str(tmp_path / "blocks.tsv")]) == 0

    # each output carries exactly its own input's records
    small_out = list(VcfReader(out_small))
    sv_out = list(VcfReader(out_sv))
    assert len(small_out) == len(small_variants)
    assert len(sv_out) == len(sv_variants)

    # the SV is phased and shares a PS with neighboring small variants
    sv_rec = next(r for r in sv_out if r.pos0 == sv_variants[0].pos)
    gt, phased = sv_rec.genotype(0)
    assert phased and sorted(gt) == [0, 1]
    sv_ps = sv_rec.sample_field(0, "PS")
    small_ps = {r.sample_field(0, "PS") for r in small_out
                if r.genotype(0)[1]}
    assert sv_ps in small_ps, "SV must join the surrounding phase set"

    # truth check across both files
    truth = {v.pos: v for v in contig.variants}
    orientation = {}
    for rec in small_out + sv_out:
        v = truth[rec.pos0]
        gt, phased = rec.genotype(0)
        if v.gt in ((0, 1), (1, 0)):
            assert phased
            key = rec.sample_field(0, "PS")
            orient = 0 if tuple(gt) == v.gt else 1
            assert orientation.setdefault(key, orient) == orient, \
                "switch error inside phase set"


def test_empty_contig_passthrough(tmp_path):
    """A contig in the VCF with only hom/no variants must stream through
    unmodified (empty phase block path)."""
    rng = np.random.default_rng(62)
    c1 = sim.simulate_contig(rng, "chr1", 8000)
    c2 = sim.SimContig("chr2", sim.simulate_contig(rng, "chr2", 6000).seq, [])
    # chr2 gets only hom variants (nothing phasable)
    for pos in (1000, 3000):
        ref1 = c2.seq[pos:pos + 1]
        alt = b"A" if ref1 != b"A" else b"G"
        c2.variants.append(sim.SimVariant(pos, ref1, alt, (1, 1)))
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    bam = str(tmp_path / "reads.bam")
    sim.write_fasta(fasta, [c1, c2])
    sim.write_vcf(vcf, [c1, c2])
    reads1 = sim.simulate_reads(rng, c1, 0, rg_tag=sim.RG_TAG)
    reads2 = sim.simulate_reads(rng, c2, 1, rg_tag=sim.RG_TAG)
    sim.write_bam(bam, [c1, c2], [reads1, reads2])

    out = str(tmp_path / "o.vcf.gz")
    out_bam = str(tmp_path / "o.bam")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out,
                     "--output-bam", out_bam, "--reference", fasta,
                     "--disable-global-realignment"]) == 0
    recs = [r for r in VcfReader(out) if r.chrom == "chr2"]
    assert len(recs) == 2
    for r in recs:
        gt, phased = r.genotype(0)
        assert gt == [1, 1] and not phased
    # chr2 reads all copied untagged
    from hiphase_jax.io.bam import BamReader
    with BamReader(out_bam) as b:
        chr2_reads = [r for r in b if r.refid == 1]
        assert len(chr2_reads) == len(reads2)
        assert all(r.get_tag("HP") is None for r in chr2_reads)
