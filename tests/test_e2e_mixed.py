"""End-to-end tests with mixed variant types: SNVs + indels + SV deletion +
tandem repeat, through both realignment modes."""

import numpy as np
import pytest

from hiphase_jax.cli import main as cli_main
from hiphase_jax.io.vcf import VcfReader

from tests import sim
from tests.test_e2e import check_phasing_against_truth


def build_mixed(tmp_path, seed, length=20000, sv_del=False, tr=False,
                coverage=25):
    rng = np.random.default_rng(seed)
    contig = sim.simulate_contig_mixed(rng, "chr1", length, sv_del=sv_del,
                                       tandem_repeat=tr)
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    bam = str(tmp_path / "reads.bam")
    sim.write_fasta(fasta, [contig])
    sim.write_vcf(vcf, [contig])
    reads = sim.simulate_reads_mixed(rng, contig, 0, coverage=coverage,
                                     rg_tag=sim.RG_TAG)
    truth = sim.write_bam(bam, [contig], [reads])
    return fasta, vcf, bam, [contig], truth


@pytest.mark.parametrize("mode", ["local", "global"])
def test_e2e_mixed_indels(tmp_path, mode):
    fasta, vcf, bam, contigs, _ = build_mixed(tmp_path, seed=31)
    out_vcf = str(tmp_path / f"{mode}.vcf.gz")
    argv = ["--bam", bam, "--vcf", vcf, "--output-vcf", out_vcf,
            "--reference", fasta]
    if mode == "local":
        argv.append("--disable-global-realignment")
    assert cli_main(argv) == 0
    n_phased, _ = check_phasing_against_truth(out_vcf, contigs)
    n_het = sum(1 for v in contigs[0].variants if v.gt != (1, 1))
    # clean reads: every het (SNV and indel) phases
    assert n_phased == n_het


def test_e2e_sv_deletion(tmp_path):
    fasta, vcf, bam, contigs, _ = build_mixed(tmp_path, seed=32, sv_del=True)
    out_vcf = str(tmp_path / "sv.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out_vcf,
                     "--reference", fasta]) == 0
    sv = [v for v in contigs[0].variants if v.info.startswith("SVTYPE")]
    assert len(sv) == 1
    recs = {r.pos0: r for r in VcfReader(out_vcf)}
    gt, phased = recs[sv[0].pos].genotype(0)
    assert phased, "SV deletion should be phased jointly with SNVs"
    assert sorted(gt) == [0, 1]


def test_e2e_tandem_repeat_with_overlap_suppression(tmp_path):
    fasta, vcf, bam, contigs, _ = build_mixed(tmp_path, seed=33, tr=True)
    # add a small variant fully inside the TR span to test suppression
    tr = next(v for v in contigs[0].variants if v.info.startswith("TRID"))
    inner_pos = tr.pos + 3
    ref1 = contigs[0].seq[inner_pos:inner_pos + 1]
    alt = b"G" if ref1 != b"G" else b"T"
    contigs[0].variants.append(
        sim.SimVariant(inner_pos, ref1, alt, (0, 1)))
    contigs[0].variants.sort(key=lambda v: v.pos)
    vcf2 = str(tmp_path / "calls2.vcf.gz")
    sim.write_vcf(vcf2, contigs)

    out_vcf = str(tmp_path / "tr.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf2, "--output-vcf", out_vcf,
                     "--reference", fasta]) == 0
    recs = {r.pos0: r for r in VcfReader(out_vcf)}
    # the TR itself should be phased
    gt, phased = recs[tr.pos].genotype(0)
    assert phased and sorted(gt) == [0, 1]
    # the contained small variant is flagged TR_OVERLAP and left unphased
    inner = recs[inner_pos]
    g2, p2 = inner.genotype(0)
    assert not p2
    assert inner.sample_field(0, "PF") == b"TR_OVERLAP"
