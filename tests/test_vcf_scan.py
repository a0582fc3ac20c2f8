"""Native VCF scan parity (hn_vcf_scan): per-record type/zygosity/GQ and
the vectorized phasability mask must match the Python record path
(ref semantics: src/block_gen.rs:115-312)."""

import numpy as np
import pytest

from hiphase_jax.io import native
from hiphase_jax.io.vcf import VcfReader
from hiphase_jax.io.vcf_scan import scan_chrom
from hiphase_jax.phasing.block_gen import (
    get_variant_type, get_variant_zygosity, is_phasable_variant)

from tests.sim import build_dataset

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcfscan")
    return build_dataset(d, seed=9, n_contigs=2, contig_len=20000,
                         coverage=12)


def test_scan_matches_record_path(dataset):
    fasta, vcf, bam, contigs, _ = dataset
    rd = VcfReader(vcf)
    S = len(rd.samples)
    for chrom in [c.name for c in contigs]:
        scan = scan_chrom(vcf, chrom, S)
        assert scan is not None
        records = list(rd.fetch(chrom, 0, 2**62))
        assert len(records) == len(scan.pos)
        mask = scan.phasable_mask(0, 0, False)
        mask_hom = scan.phasable_mask(0, 0, True)
        for i, rec in enumerate(records):
            assert int(scan.pos[i]) == rec.pos0
            assert int(scan.ref_len[i]) == len(rec.ref)
            assert scan.line_bytes(i).split(b"\t")[1] == rec.fields[1]
            assert int(scan.vtype[i]) == int(get_variant_type(rec)), i
            for s in range(S):
                assert int(scan.zyg[i, s]) == int(
                    get_variant_zygosity(rec, s)), (i, s)
                gq = rec.gq(s)
                if gq is None:
                    assert scan.has_gq[i, s] == 0
                else:
                    assert scan.has_gq[i, s] == 1
                    assert float(scan.gq[i, s]) == gq
                a, ph = rec.genotype(s)
                g0 = -1 if a[0] is None else a[0]
                g1 = g0 if len(a) == 1 else (-1 if a[1] is None else a[1])
                assert int(scan.gt0[i, s]) == g0
                assert int(scan.gt1[i, s]) == g1
                assert bool(scan.gt_phased[i, s]) == ph
            assert bool(mask[i]) == is_phasable_variant(rec, 0, 0, False), i
            assert bool(mask_hom[i]) == is_phasable_variant(rec, 0, 0, True)


def test_scan_handcrafted_edge_cases(tmp_path):
    """Symbolic ALTs, SVTYPE records, TRID flags, haploid and missing GTs,
    GQ thresholds, multiallelics — native classification must match."""
    from hiphase_jax.io.bgzf import BgzfBatchWriter
    from hiphase_jax.io.tabix import TabixBuilder

    lines = [
        "##fileformat=VCFv4.2",
        '##contig=<ID=chrT,length=100000>',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="x">',
        '##INFO=<ID=TRID,Number=1,Type=String,Description="x">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="x">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="x">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1",
        "chrT\t100\t.\tA\tC\t.\t.\t.\tGT:GQ\t0/1:50",       # SNV het
        "chrT\t200\t.\tA\tC,G\t.\t.\t.\tGT:GQ\t1/2:50",     # multiallelic SNV
        "chrT\t300\t.\tA\tACGT\t.\t.\t.\tGT\t0|1",          # insertion, phased
        "chrT\t400\t.\tACGT\tA\t.\t.\t.\tGT:GQ\t1/1:10",    # deletion hom-alt
        "chrT\t500\t.\tAC\tGT\t.\t.\t.\tGT:GQ\t0/1:.",      # indel, GQ missing
        "chrT\t600\t.\tA\t<DEL>\t.\t.\tSVTYPE=DEL\tGT\t0/1",  # symbolic
        "chrT\t700\t.\tACCCCCCCC\tA\t.\t.\tSVTYPE=DEL\tGT\t0/1",
        "chrT\t800\t.\tA\tACCCCCCCC\t.\t.\tSVTYPE=INS\tGT\t0/1",
        "chrT\t900\t.\tA\tC\t.\t.\tTRID=tr1\tGT\t1/1",      # TR hom-alt
        "chrT\t1000\t.\tA\tC\t.\t.\t.\tGT\t.",              # missing GT
        "chrT\t1100\t.\tA\tC\t.\t.\t.\tGT\t1",              # haploid
        "chrT\t1200\t.\tA\tC\t.\t.\t.\tGT\t./1",            # half-missing
        "chrT\t1300\t.\tA\t.\t.\t.\t.\tGT\t0/0",            # no ALT
        "chrT\t1400\t.\tA\tC\t.\t.\t.\tGT:GQ\t0/1:5",       # low GQ
        "chrT\t1500\t.\tA\tC\t.\t.\tSVTYPE=CNV\tGT\t0/1",   # unhandled SVTYPE
    ]
    body = ("\n".join(lines) + "\n").encode()
    path = str(tmp_path / "edge.vcf.gz")
    w = BgzfBatchWriter(path, threads=1)
    w.write(body)
    w.close()
    # tabix index it through the repo's own builder
    tb = TabixBuilder()
    import hiphase_jax.io.bgzf as bgzf_mod
    with bgzf_mod.BgzfReader(path) as bz:
        while True:
            vo = bz.virtual_offset
            line = bz.readline()
            if not line:
                break
            if line.startswith(b"#"):
                continue
            f = line.split(b"\t")
            p = int(f[1]) - 1
            tb.add(f[0].decode(), p, p + len(f[3]), vo, bz.virtual_offset)
    tb.build().save_tbi(path + ".tbi")

    rd = VcfReader(path)
    scan = scan_chrom(path, "chrT", 1)
    assert scan is not None
    records = list(rd.fetch("chrT", 0, 2**62))
    assert len(records) == len(scan.pos) == 15
    mask = scan.phasable_mask(0, 20, False)
    for i, rec in enumerate(records):
        if scan.vtype[i] == -1:
            with pytest.raises(Exception):
                get_variant_type(rec)
            continue
        assert int(scan.vtype[i]) == int(get_variant_type(rec)), i
        assert int(scan.zyg[i, 0]) == int(get_variant_zygosity(rec, 0)), i
        assert bool(mask[i]) == is_phasable_variant(rec, 0, 20, False), i
    # the unhandled-SVTYPE row must be the re-parse marker
    assert scan.vtype[14] == -1


def test_block_stream_matches_record_path(tmp_path):
    """The array-driven block generator must produce the identical block
    stream (boundaries, counts, unphased flags, variant stats) as the
    streaming-record path."""
    from hiphase_jax.phasing.block_gen import PhaseBlockIterator
    from hiphase_jax.utils.simulate import build_benchmark_dataset

    meta = build_benchmark_dataset(str(tmp_path / "wgs"), total_mb=2,
                                   n_contigs=2, coverage=15,
                                   read_length=8000, seed=13, block_kb=120)
    vcf, bam = meta["vcf"], meta["bam"]
    fast = PhaseBlockIterator([vcf], [bam], "SAMPLE")
    slow = PhaseBlockIterator([vcf], [bam], "SAMPLE")
    slow._chrom_scans = lambda _chrom: None  # force the record path
    blocks_fast = [(b.chrom, b.start, b.end, b.num_variants,
                    b.unphased_block, tuple(b.vcf_index_counts))
                   for b in fast]
    blocks_slow = [(b.chrom, b.start, b.end, b.num_variants,
                    b.unphased_block, tuple(b.vcf_index_counts))
                   for b in slow]
    assert blocks_fast == blocks_slow
    assert len(blocks_fast) > 3
    assert fast.variant_stats == slow.variant_stats


def test_writer_array_path_matches_record_path(tmp_path, monkeypatch):
    """The native bulk transform writer must produce byte-identical output
    to the per-record Python writer."""
    import gzip

    from hiphase_jax.cli import main as cli_main
    from hiphase_jax.writers.vcf_writer import OrderedVcfWriter

    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=33, n_contigs=2, contig_len=12000, coverage=14)
    out_a = str(tmp_path / "arrays.vcf.gz")
    out_r = str(tmp_path / "records.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", out_a, "--engine", "native"]) == 0
    monkeypatch.setattr(OrderedVcfWriter, "_write_window_arrays",
                        lambda self, *a, **k: False)
    assert cli_main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", out_r, "--engine", "native"]) == 0
    a = [l for l in gzip.open(out_a).read().split(b"\n")
         if not l.startswith(b"##")]
    r = [l for l in gzip.open(out_r).read().split(b"\n")
         if not l.startswith(b"##")]
    assert a == r and len(a) > 50
