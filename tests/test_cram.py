"""CRAM 3.0 (restricted profile): BAM→CRAM→BAM round-trip equality, region
fetch parity, and end-to-end phasing from CRAM input to haplotagged CRAM
output (ref: src/writers/ordered_bam_writer.rs:76-80 — CRAM by extension)."""

import pytest

from hiphase_jax.core.reference_genome import ReferenceGenome
from hiphase_jax.io.bam import BamReader
from hiphase_jax.io.cram import CramReader, CramWriter

from tests.sim import build_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("cram")
    fasta, vcf, bam, contigs, truth = build_dataset(
        d, seed=51, n_contigs=3, contig_len=6000, coverage=12)
    return dict(dir=d, fasta=fasta, vcf=vcf, bam=bam, contigs=contigs)


def _fields(rec):
    return (rec.read_name, rec.refid, rec.pos, rec.mapq, rec.flag,
            tuple(rec.cigar()), rec.query_sequence(),
            rec.query_qualities(),
            tuple((t, tc, v if not isinstance(v, list) else tuple(v))
                  for t, tc, _s, _e, v in rec._iter_aux()))


def test_roundtrip(dataset):
    ref = ReferenceGenome.from_fasta(dataset["fasta"])
    cram_path = str(dataset["dir"] / "rt.cram")
    with BamReader(dataset["bam"]) as bam:
        w = CramWriter(cram_path, bam.header, ref)
        original = []
        for rec in bam:
            original.append(_fields(rec))
            w.write(rec)
        w.close()
        w.write_index()
    with CramReader(cram_path, ref) as cr:
        got = [_fields(rec) for rec in cr]
    assert len(got) == len(original)
    for a, b in zip(got, original):
        assert a == b, a[0]


def test_fetch_parity(dataset):
    ref = ReferenceGenome.from_fasta(dataset["fasta"])
    cram_path = str(dataset["dir"] / "fetch.cram")
    with BamReader(dataset["bam"]) as bam:
        w = CramWriter(cram_path, bam.header, ref)
        for rec in bam:
            w.write(rec)
        w.close()
        w.write_index()
        regions = [(c, s, s + 1500) for c in bam.header.ref_names
                   for s in (0, 1800, 4200)]
        with CramReader(cram_path, ref) as cr:
            for chrom, start, end in regions:
                a = [_fields(r) for r in bam.fetch(chrom, start, end)]
                b = [_fields(r) for r in cr.fetch(chrom, start, end)]
                assert a == b, (chrom, start, end)


def test_e2e_cram_in_cram_out(dataset, tmp_path):
    """Phase from .cram input to a haplotagged .cram output; VCF and tags
    must equal the BAM-path run."""
    from hiphase_jax.cli import main as cli_main
    from hiphase_jax.io.vcf import VcfReader

    ref = ReferenceGenome.from_fasta(dataset["fasta"])
    cram_in = str(tmp_path / "in.cram")
    with BamReader(dataset["bam"]) as bam:
        w = CramWriter(cram_in, bam.header, ref)
        for rec in bam:
            w.write(rec)
        w.close()
        w.write_index()

    vcf_bam = str(tmp_path / "frombam.vcf.gz")
    bam_out = str(tmp_path / "frombam.bam")
    assert cli_main(["--bam", dataset["bam"], "--vcf", dataset["vcf"],
                     "--reference", dataset["fasta"],
                     "--output-vcf", vcf_bam, "--output-bam", bam_out]) == 0

    vcf_cram = str(tmp_path / "fromcram.vcf.gz")
    cram_out = str(tmp_path / "fromcram.cram")
    assert cli_main(["--bam", cram_in, "--vcf", dataset["vcf"],
                     "--reference", dataset["fasta"],
                     "--output-vcf", vcf_cram, "--output-bam", cram_out]) == 0

    a = [r.serialize() for r in VcfReader(vcf_bam)]
    b = [r.serialize() for r in VcfReader(vcf_cram)]
    assert a == b, "phased VCF must not depend on the alignment container"

    with BamReader(bam_out) as rb:
        tags_bam = [(r.read_name, r.pos, r.get_tag("HP"), r.get_tag("PS"))
                    for r in rb]
    with CramReader(cram_out, ref) as rc:
        tags_cram = [(r.read_name, r.pos, r.get_tag("HP"), r.get_tag("PS"))
                     for r in rc]
    assert tags_bam == tags_cram
