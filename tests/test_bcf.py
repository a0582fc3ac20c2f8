"""BCF 2.2 binary container support (ref: src/phaser.rs:43-45 — htslib's
readers handle BCF transparently): typed-value round-trips, indexed fetch,
and end-to-end phasing from .bcf input to .bcf output matching the text-VCF
run record for record."""

import gzip

import pytest

from hiphase_jax.io.bcf import BcfReader, BcfWriter, is_bcf
from hiphase_jax.io.vcf import VcfReader

from tests.sim import build_dataset


HDR_EXTRA = [
    b'##FILTER=<ID=LowQual,Description="x">',
    b'##INFO=<ID=SVTYPE,Number=1,Type=String,Description="x">',
    b'##INFO=<ID=DP,Number=1,Type=Integer,Description="x">',
    b'##INFO=<ID=AF,Number=A,Type=Float,Description="x">',
    b'##INFO=<ID=TRID,Number=0,Type=Flag,Description="x">',
    b'##FORMAT=<ID=AD,Number=R,Type=Integer,Description="x">',
    b'##FORMAT=<ID=VAF,Number=1,Type=Float,Description="x">',
]


def test_typed_value_roundtrip(tmp_path):
    hdr = [b"##fileformat=VCFv4.2",
           b'##contig=<ID=chr1,length=50000>',
           b'##contig=<ID=chr2,length=40000>',
           b'##FILTER=<ID=PASS,Description="x">',
           b'##FORMAT=<ID=GT,Number=1,Type=String,Description="x">',
           b'##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="x">',
           ] + HDR_EXTRA + [
           b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2"]
    lines = [
        b"chr1\t100\trs1\tA\tC\t50\tPASS\tDP=30;AF=0.5\tGT:GQ\t0/1:44\t1|1:12",
        b"chr1\t200\t.\tAC\tA,ACC\t.\t.\tDP=900\tGT:AD\t1/2:3,4,5\t0/0:.",
        b"chr1\t300\t.\tA\tC\t12.5\tLowQual\tTRID;SVTYPE=DEL\t"
        b"GT:VAF\t./.:0.25\t.:.",
        b"chr2\t150\t.\tG\tGTTT\t.\tPASS;LowQual\t.\tGT:GQ\t1:99\t0|1:70000",
    ]
    p = str(tmp_path / "t.bcf")
    w = BcfWriter(p, hdr)
    for line in lines:
        w.write_line(line)
    w.close()
    w.write_index()
    assert is_bcf(p)
    rd = BcfReader(p)
    assert list(rd) == lines
    assert list(rd.fetch_lines("chr1", 150, 400)) == lines[1:3]
    assert list(rd.fetch_lines("chr2", 0, 10**9)) == lines[3:]
    # through the generic VcfReader facade
    vr = VcfReader(p)
    assert vr.samples == ["S1", "S2"]
    recs = list(vr.fetch("chr1", 0, 10**9))
    assert len(recs) == 3 and recs[0].pos0 == 99
    assert recs[0].genotype(0) == ([0, 1], False)


def _vcf_to_bcf(vcf_gz: str, bcf_path: str) -> None:
    raw = gzip.open(vcf_gz).read()
    lines = [l for l in raw.split(b"\n") if l]
    hdr = [l for l in lines if l.startswith(b"#")]
    w = BcfWriter(bcf_path, hdr)
    for l in lines:
        if not l.startswith(b"#"):
            w.write_line(l)
    w.close()
    w.write_index()


def test_e2e_bcf_in_bcf_out(tmp_path):
    from hiphase_jax.cli import main as cli_main

    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=71, n_contigs=2, contig_len=9000, coverage=13)
    bcf_in = str(tmp_path / "calls.bcf")
    _vcf_to_bcf(vcf, bcf_in)

    out_vcf = str(tmp_path / "out.vcf.gz")
    out_bcf = str(tmp_path / "out.bcf")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", out_vcf, "--engine", "native"]) == 0
    assert cli_main(["--bam", bam, "--vcf", bcf_in, "--reference", fasta,
                     "--output-vcf", out_bcf, "--engine", "native"]) == 0

    text_recs = [l for l in gzip.open(out_vcf).read().split(b"\n")
                 if l and not l.startswith(b"#")]
    bcf_recs = list(BcfReader(out_bcf))
    assert len(text_recs) == len(bcf_recs) > 50
    for a, b in zip(text_recs, bcf_recs):
        assert a == b, (a, b)
    # output .csi answers region queries
    out_rd = VcfReader(out_bcf)
    some = list(out_rd.fetch(text_recs[0].split(b"\t")[0].decode(), 0, 10**9))
    assert some


def test_gt_phased_missing_and_wide_alleles(tmp_path):
    """Phased half-missing GTs ('0|.', '.|.') must round-trip (missing is
    (v>>1)==0 regardless of the phase bit), and GT allele indexes > 62 must
    widen past int8 instead of crashing."""
    hdr = [b"##fileformat=VCFv4.2",
           b'##contig=<ID=c,length=1000>',
           b'##FILTER=<ID=PASS,Description="x">',
           b'##FORMAT=<ID=GT,Number=1,Type=String,Description="x">',
           b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1"]
    alts = b",".join(b"A" * (k + 2) for k in range(70))
    lines = [
        b"c\t10\t.\tA\tC\t.\t.\t.\tGT\t0|.",
        b"c\t20\t.\tA\tC\t.\t.\t.\tGT\t.|.",
        b"c\t30\t.\tA\tC\t.\t.\t.\tGT\t.|1",
        b"c\t40\t.\tA\t" + alts + b"\t.\t.\t.\tGT\t63/70",
    ]
    p = str(tmp_path / "gt.bcf")
    w = BcfWriter(p, hdr)
    for line in lines:
        w.write_line(line)
    w.close()
    assert list(BcfReader(p)) == lines


def test_undeclared_key_clean_error(tmp_path):
    from hiphase_jax.io.bcf import BcfError
    hdr = [b"##fileformat=VCFv4.2",
           b'##contig=<ID=c,length=1000>',
           b'##FORMAT=<ID=GT,Number=1,Type=String,Description="x">',
           b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1"]
    w = BcfWriter(str(tmp_path / "e.bcf"), hdr)
    with pytest.raises(BcfError, match="'FOO' is not declared"):
        w.write_line(b"c\t10\t.\tA\tC\t.\t.\tFOO=1\tGT\t0/1")
    w.close()
