"""Validate the benchmark simulator's outputs round-trip through the real
readers and carry the realism features the benchmark depends on (block
cadence, variant mix, true M/I/D CIGARs, SA-tagged split reads)."""

import numpy as np
import pytest

from hiphase_jax.io.bam import BamReader
from hiphase_jax.io.vcf import VcfReader
from hiphase_jax.utils.simulate import build_benchmark_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("simbench")
    meta = build_benchmark_dataset(str(d), total_mb=2, n_contigs=2,
                                   coverage=20, read_length=8000, seed=7,
                                   block_kb=120)
    return meta


def test_vcf_roundtrip(dataset):
    rd = VcfReader(dataset["vcf"])
    assert rd.samples == ["SAMPLE"]
    n_het = 0
    types = set()
    prev_end = {}
    for chrom in rd.header.contigs():
        for rec in rd.fetch(chrom, 0, 10**9):
            alleles = rec.alleles()
            assert len(alleles) == 2
            gt, _ph = rec.genotype(0)
            if gt[0] != gt[1]:
                n_het += 1
            # variants must not overlap (sim invariant)
            assert rec.pos0 >= prev_end.get(chrom, 0)
            prev_end[chrom] = rec.pos0 + len(alleles[0])
            if rec.info_get("SVTYPE") is not None:
                types.add("SV")
            elif rec.info_get("TRID") is not None:
                types.add("TR")
            elif len(alleles[0]) == 1 and len(alleles[1]) == 1:
                types.add("SNV")
            elif len(alleles[0]) < len(alleles[1]):
                types.add("INS")
            else:
                types.add("DEL")
    assert n_het == dataset["n_het"]
    assert {"SNV", "INS", "DEL"} <= types


def test_bam_roundtrip_and_reads_match_reference(dataset):
    """Every read's aligned bases must match the reference or a variant
    allele — checked via CIGAR-consistency: reference_end stays within the
    contig and M-run coordinates are consistent."""
    with BamReader(dataset["bam"]) as bam:
        n = 0
        n_indel_cigars = 0
        n_sa = 0
        prev_pos = -1
        for rec in bam:
            assert rec.pos >= prev_pos or prev_pos == -1 or rec.refid >= 0
            ops = {op for op, _ in rec.cigar()}
            assert ops <= {"M", "I", "D"}
            if ops & {"I", "D"}:
                n_indel_cigars += 1
            qlen = sum(ln for op, ln in rec.cigar() if op in "MIS=X")
            assert qlen == rec.l_seq
            if rec.get_tag("SA") is not None:
                n_sa += 1
                assert rec.get_tag("SA").endswith(";")
            n += 1
    assert n == dataset["n_reads"]
    assert n_indel_cigars > 0, "no indel-carrying reads simulated"
    assert n_sa >= 2, "no SA-tagged split reads simulated"


def test_block_cadence(dataset):
    """Coverage deserts must break the contigs into many phase blocks:
    ~1 per block_kb (here 120kb over 2Mb -> >= 8 real blocks)."""
    from hiphase_jax.phasing.block_gen import PhaseBlockIterator

    it = PhaseBlockIterator([dataset["vcf"]], [dataset["bam"]], "SAMPLE")
    blocks = [b for b in it if b.num_variants > 0 and not b.unphased_block]
    assert len(blocks) >= dataset["n_segments"] // 2, \
        (len(blocks), dataset["n_segments"])
    sizes = np.array([b.num_variants for b in blocks])
    # segment structure: no single block dominates the dataset
    assert sizes.max() < 0.5 * sizes.sum()
