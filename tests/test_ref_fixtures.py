"""Sample-matching behavior against the REFERENCE repo's own fixture files,
including exact error strings (ref: block_gen.rs:1116-1159 — the reference
asserts these strings verbatim in its tests)."""

import pytest

from hiphase_jax.io.vcf import get_vcf_samples
from hiphase_jax.phasing.block_gen import BlockGenError, get_sample_bams


def test_get_vcf_samples_reference_fixture(ref_test_data):
    samples = get_vcf_samples(str(ref_test_data / "header_only.vcf.gz"))
    assert samples == ["HG001", "HG002_30x", "HG005_30x"]


def test_sample_bam_matching_reference_fixtures(ref_test_data):
    bams = [str(ref_test_data / "header_only.bam"),
            str(ref_test_data / "multi_smrtcell.bam")]
    # both fixtures belong to HG002-rep1 (ref: block_gen.rs:1126-1141)
    assert get_sample_bams(bams, "HG002-rep1") == bams
    assert get_sample_bams(bams, "HG002-other") == []


def test_multisample_bam_exact_error(ref_test_data):
    bam = str(ref_test_data / "multisample.bam")
    with pytest.raises(BlockGenError) as exc:
        get_sample_bams([bam], "HG002-rep1")
    assert str(exc.value) == (
        "BAM file with multiple sample reads groups detected, this is not "
        f"supported: {bam}")


def test_no_read_groups_exact_error(tmp_path):
    from hiphase_jax.io.bam import BamWriter, SamHeader
    path = str(tmp_path / "norg.bam")
    w = BamWriter(path, SamHeader("@HD\tVN:1.6\n", ["c1"], [100]))
    w.close()
    with pytest.raises(BlockGenError) as exc:
        get_sample_bams([path], "S")
    assert str(exc.value) == f"BAM file has no read groups (RG) tag: {path}"


def test_rg_without_sm_exact_error(tmp_path):
    from hiphase_jax.io.bam import BamWriter, SamHeader
    path = str(tmp_path / "nosm.bam")
    w = BamWriter(path, SamHeader("@HD\tVN:1.6\n@RG\tID:rg1\n",
                                  ["c1"], [100]))
    w.close()
    with pytest.raises(BlockGenError) as exc:
        get_sample_bams([path], "S")
    assert str(exc.value) == (
        f"BAM file has read group with no sample name (SM) tag: {path}")
