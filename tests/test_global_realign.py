"""Dual-mode (global graph-WFA) allele assignment tests."""

import numpy as np

from hiphase_jax.cli import main as cli_main
from hiphase_jax.io.vcf import VcfReader

from tests.sim import build_dataset
from tests.test_e2e import check_phasing_against_truth, run_cli


def test_e2e_global_realignment_matches_truth(tmp_path):
    fasta, vcf, bam, contigs, _ = build_dataset(tmp_path, seed=5,
                                                n_contigs=1, contig_len=8000)
    # run WITHOUT --disable-global-realignment → graph-WFA path
    out_vcf = str(tmp_path / "g.vcf.gz")
    argv = ["--bam", bam, "--vcf", vcf, "--output-vcf", out_vcf,
            "--reference", fasta]
    assert cli_main(argv) == 0
    n_phased, _ = check_phasing_against_truth(out_vcf, contigs)
    n_het = sum(1 for c in contigs for v in c.variants if v.gt != (1, 1))
    assert n_phased == n_het


def test_global_vs_local_same_phasing(tmp_path):
    fasta, vcf, bam, contigs, _ = build_dataset(tmp_path, seed=6,
                                                n_contigs=1, contig_len=8000)
    vcf_local, _ = run_cli(tmp_path, fasta, vcf, bam, name="local")
    out_vcf = str(tmp_path / "global.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out_vcf,
                     "--reference", fasta]) == 0
    # same GT/PS phasing decisions on clean reads (quals differ internally)
    a = [(r.chrom, r.pos0, r.sample_values(0)[0]) for r in VcfReader(vcf_local)]
    b = [(r.chrom, r.pos0, r.sample_values(0)[0]) for r in VcfReader(out_vcf)]
    assert a == b


def test_global_quals_are_doubled_baseline(tmp_path):
    """Global realignment assigns exactly 2× baseline quals (SNV: 160)."""
    from hiphase_jax.core.reference_genome import ReferenceGenome
    from hiphase_jax.phasing.block_gen import MultiPhaseBlockIterator, PhaseBlockIterator
    from hiphase_jax.phasing.phaser import prepare_block
    from hiphase_jax.phasing.read_parsing import GlobalRealignmentConfig

    fasta, vcf, bam, contigs, _ = build_dataset(tmp_path, seed=7,
                                                n_contigs=1, contig_len=6000)
    rg = ReferenceGenome.from_fasta(fasta)
    blocks = [b for b in MultiPhaseBlockIterator(
        [PhaseBlockIterator([vcf], [bam], "SAMPLE")]) if b.num_variants > 1]
    assert blocks
    data = prepare_block(blocks[0], [vcf], [bam], rg, 15, 2, 5,
                         GlobalRealignmentConfig())
    assert data.read_segments
    assert data.read_stats.global_aligned > 0
    assert data.read_stats.local_aligned == 0
    quals = np.concatenate([rs.quals for rs in data.read_segments])
    set_quals = quals[quals > 0]
    assert set_quals.size > 0
    assert (set_quals == 160).all()  # 2 x SNV_QUAL
