"""I/O stack tests: BGZF roundtrip, BAM read of reference fixtures, BAM+BAI
write/read roundtrip, VCF parse + tabix fetch roundtrip."""

import struct

import numpy as np
import pytest

from hiphase_jax.io.bam import (
    BamReader, BamRecord, BamWriter, SamHeader, reg2bin, reg2bins,
)
from hiphase_jax.io.bgzf import (
    BGZF_EOF, BgzfReader, BgzfWriter, compress_block, is_bgzf,
)
from hiphase_jax.io.vcf import VcfHeader, VcfReader, VcfRecord, VcfWriter, get_vcf_samples


# ---------------- BGZF ----------------

def test_bgzf_roundtrip(tmp_path):
    path = str(tmp_path / "x.gz")
    payload = b"".join(f"line {i} abcdefghijklmnop\n".encode() for i in range(20000))
    with BgzfWriter(path) as w:
        w.write(payload)
    assert is_bgzf(path)
    with BgzfReader(path) as r:
        assert r.read_all() == payload
    # line iteration
    with BgzfReader(path) as r:
        lines = list(r)
    assert b"".join(lines) == payload
    assert lines[0] == b"line 0 abcdefghijklmnop\n"
    # file ends with the standard EOF marker
    raw = open(path, "rb").read()
    assert raw.endswith(BGZF_EOF)


def test_bgzf_virtual_offsets(tmp_path):
    path = str(tmp_path / "x.gz")
    with BgzfWriter(path) as w:
        offsets = []
        for i in range(5000):
            offsets.append(w.virtual_offset)
            w.write(f"record-{i}\n".encode())
    with BgzfReader(path) as r:
        for i in (0, 1, 4999, 2500):
            r.seek_virtual(offsets[i])
            assert r.readline() == f"record-{i}\n".encode()


def test_bgzf_reads_reference_fixture(ref_test_data):
    # the reference repo's bgzipped VCF decompresses to a text header
    with BgzfReader(str(ref_test_data / "header_only.vcf.gz")) as r:
        text = r.read_all()
    assert text.startswith(b"##fileformat=VCF")
    assert b"#CHROM" in text


# ---------------- BAM ----------------

def test_bam_reads_reference_fixtures(ref_test_data):
    with BamReader(str(ref_test_data / "header_only.bam")) as bam:
        assert bam.header.ref_names  # has references
        rgs = bam.header.read_groups()
        assert all("SM" in rg for rg in rgs)

    with BamReader(str(ref_test_data / "multisample.bam")) as bam:
        assert len(bam.header.samples()) > 1

    with BamReader(str(ref_test_data / "multi_smrtcell.bam")) as bam:
        smrt_samples = bam.header.samples()
        assert len(smrt_samples) == 1
        recs = list(bam)
        # header-only fixture: no records is fine; parsing must not crash
        for rec in recs:
            rec.cigar()
            rec.query_sequence()


def _make_record(name: str, refid: int, pos: int, seq: bytes, cigar: list,
                 mapq: int = 60, flag: int = 0, quals: bytes | None = None) -> BamRecord:
    from hiphase_jax.io.bam import CIGAR_OPS, SEQ_NT16
    nameb = name.encode() + b"\x00"
    cig = b"".join(struct.pack("<I", (length << 4) | CIGAR_OPS.index(op))
                   for op, length in cigar)
    packed = bytearray((len(seq) + 1) // 2)
    for i, base in enumerate(seq):
        nib = SEQ_NT16.index(chr(base))
        if i % 2 == 0:
            packed[i // 2] |= nib << 4
        else:
            packed[i // 2] |= nib
    q = quals if quals is not None else bytes([30] * len(seq))
    raw = struct.pack("<iiBBHHHIiii", refid, pos, len(nameb), mapq,
                      reg2bin(pos, pos + len(seq)), len(cigar), flag,
                      len(seq), -1, -1, 0)
    raw += nameb + cig + bytes(packed) + q
    return BamRecord.parse(raw)


def test_bam_write_read_roundtrip(tmp_path):
    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n@RG\tID:rg1\tSM:sampleA\n",
                       ["chr1", "chr2"], [100000, 50000])
    path = str(tmp_path / "t.bam")
    w = BamWriter(path, header)
    recs = [
        _make_record("read1", 0, 100, b"ACGTACGT", [("M", 8)]),
        _make_record("read2", 0, 20000, b"ACGT", [("S", 1), ("M", 3)]),
        _make_record("read3", 1, 500, b"GGGG", [("M", 2), ("D", 5), ("M", 2)]),
    ]
    for r in recs:
        w.write(r)
    w.close()
    w.write_index()

    with BamReader(path) as bam:
        assert bam.header.samples() == {"sampleA"}
        got = list(bam)
        assert [r.read_name for r in got] == ["read1", "read2", "read3"]
        assert got[0].query_sequence() == b"ACGTACGT"
        assert got[1].cigar() == [("S", 1), ("M", 3)]
        assert got[2].reference_end() == 500 + 2 + 5 + 2
        # indexed fetch hits only overlapping records
        assert [r.read_name for r in bam.fetch("chr1", 0, 150)] == ["read1"]
        assert [r.read_name for r in bam.fetch("chr1", 19999, 20004)] == ["read2"]
        assert [r.read_name for r in bam.fetch("chr2", 503, 504)] == ["read3"]
        assert bam._index is not None  # really used the BAI


def test_bam_aux_tags():
    rec = _make_record("r", 0, 10, b"ACGT", [("M", 4)])
    rec2 = rec.with_int_tags([("HP", 1), ("PS", 123456)])
    assert rec2.get_tag("HP") == 1
    assert rec2.get_tag("PS") == 123456
    rec3 = rec2.strip_tags({"HP", "PS"})
    assert rec3.get_tag("HP") is None
    assert rec3.get_tag("PS") is None
    assert rec3.raw == rec.raw


def test_aligned_pairs():
    rec = _make_record("r", 0, 100, b"ACGTACGTAC", [("S", 2), ("M", 3), ("I", 2), ("M", 1), ("D", 4), ("M", 2)])
    pairs = list(rec.aligned_pairs())
    assert pairs == [(2, 100), (3, 101), (4, 102), (7, 103), (8, 108), (9, 109)]


def test_reg2bins_contains_reg2bin():
    for beg, end in [(0, 1), (100, 200), (16383, 16385), (1 << 20, (1 << 20) + 5000)]:
        assert reg2bin(beg, end) in reg2bins(beg, end)


# ---------------- VCF ----------------

VCF_TEXT = b"""##fileformat=VCFv4.2
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="GQ">
##FORMAT=<ID=PS,Number=1,Type=Integer,Description="old PS">
##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">
##contig=<ID=chr1,length=100000>
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2
chr1\t101\t.\tA\tC\t50\tPASS\t.\tGT:GQ\t0/1:40\t0|1:10
chr1\t201\t.\tAT\tA\t30\tPASS\t.\tGT:GQ\t1/1:99\t./.:.
chr1\t301\tsv1\tT\t<DEL>\t.\tPASS\tSVTYPE=DEL;END=800\tGT\t0/1\t0/0
"""


def test_vcf_parse_and_mutate(tmp_path):
    p = tmp_path / "t.vcf"
    p.write_bytes(VCF_TEXT)
    rd = VcfReader(str(p))
    assert rd.samples == ["S1", "S2"]
    recs = list(rd)
    assert len(recs) == 3
    r0 = recs[0]
    assert (r0.chrom, r0.pos0, r0.ref, r0.alts) == ("chr1", 100, b"A", [b"C"])
    assert r0.genotype(0) == ([0, 1], False)
    assert r0.genotype(1) == ([0, 1], True)
    assert r0.gq(0) == 40
    assert recs[1].genotype(1) == ([None, None], False)
    assert recs[2].info_get("SVTYPE") == b"DEL"
    assert recs[2].info_get("END") == b"800"
    assert recs[2].info_get("NOPE") is None

    # mutation: strip + set
    r0.strip_format_tag("GQ")
    assert r0.sample_field(0, "GQ") is None
    r0.set_genotype(0, [1, 0], phased=True)
    r0.set_sample_field(0, "PS", b"101")
    assert r0.serialize() == b"chr1\t101\t.\tA\tC\t50\tPASS\t.\tGT:PS\t1|0:101\t0|1:.\n"


def test_vcf_write_fetch_roundtrip(tmp_path):
    header = VcfHeader.parse(VCF_TEXT.split(b"\n")[:7])
    header.remove_format("PS")
    assert not any(b"ID=PS" in l for l in header.lines)
    path = str(tmp_path / "out.vcf.gz")
    wr = VcfWriter(path, header)
    rng = np.random.default_rng(7)
    positions = sorted(int(x) for x in rng.choice(90000, size=500, replace=False))
    for pos in positions:
        wr.write(VcfRecord.parse(
            f"chr1\t{pos + 1}\t.\tA\tC\t50\tPASS\t.\tGT\t0/1\t0/0".encode()))
    wr.close()
    wr.write_index()

    rd = VcfReader(path)
    assert rd._index is not None
    allr = list(rd)
    assert len(allr) == 500
    lo, hi = 30000, 60000
    expected = [p for p in positions if lo <= p < hi]
    got = [r.pos0 for r in rd.fetch("chr1", lo, hi)]
    assert got == expected
    assert list(rd.fetch("chrX", 0, 1000)) == []


def test_vcf_reads_reference_fixture(ref_test_data):
    assert get_vcf_samples(str(ref_test_data / "header_only.vcf.gz")) == \
        ["HG001", "HG002_30x", "HG005_30x"]

    iupac = VcfReader(str(ref_test_data / "iupac_test" / "small_variants.vcf.gz"))
    recs = list(iupac)
    assert len(recs) > 0
    # indexed fetch agrees with linear scan
    chrom = recs[0].chrom
    sub = [r.pos0 for r in iupac.fetch(chrom, 0, 10**9)]
    assert sub == [r.pos0 for r in recs if r.chrom == chrom]


def test_prephased_fixture_strip(ref_test_data):
    rd = VcfReader(str(ref_test_data / "prephased_test" / "prephased.vcf"))
    recs = list(rd)
    assert recs
    # records carry pre-existing phasing that the writer must strip
    found_phased = any(rec.genotype(si)[1]
                       for rec in recs for si in range(len(rd.samples)))
    assert found_phased


def test_bam_opens_with_csi_only_index(tmp_path):
    """htslib auto-loads .csi for BAMs (long contigs); a BAM with only a
    .csi index must open and fetch identically (ref: phaser.rs:43-45)."""
    import os

    from hiphase_jax.io.bam import BaiIndex, BamReader
    from hiphase_jax.io.tabix import TabixIndex

    from tests.sim import simulate_contig, simulate_reads, write_bam

    rng = np.random.default_rng(5)
    contig = simulate_contig(rng, "c1", 30000)
    bam = str(tmp_path / "c.bam")
    reads = simulate_reads(rng, contig, 0, coverage=8,
                           rg_tag=b"RGZrg1\x00")
    write_bam(bam, [contig], [reads])
    with BamReader(bam) as rd:
        expected = [(r.read_name, r.pos) for r in rd.fetch("c1", 5000, 9000)]
    assert expected
    # BAI and CSI share bin numbering at min_shift=14/depth=5: convert
    bai = BaiIndex.load(bam + ".bai")
    csi = TabixIndex([], bai.bins, [[] for _ in bai.bins],
                     min_shift=14, depth=5)
    csi.save_csi(bam + ".csi")
    os.remove(bam + ".bai")
    with BamReader(bam) as rd:
        assert rd._index is not None
        got = [(r.read_name, r.pos) for r in rd.fetch("c1", 5000, 9000)]
    assert got == expected


def test_bam_writer_emits_csi_for_long_contigs(tmp_path):
    """Contigs >= 2^29-1 cannot be BAI-indexed; the writer must emit .csi
    (htslib's switch) and region fetch must work beyond 2^29."""
    import os

    from hiphase_jax.io.bam import BamReader, BamWriter, SamHeader

    from tests.sim import make_bam_record

    L = (1 << 29) + 200_000
    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n"
                       "@RG\tID:rg1\tSM:S\n", ["big"], [L])
    path = str(tmp_path / "long.bam")
    w = BamWriter(path, header)
    positions = [100, (1 << 29) - 50, (1 << 29) + 100_000]
    for k, pos in enumerate(positions):
        w.write(make_bam_record(f"r{k}", 0, pos, b"ACGT" * 10,
                                [("M", 40)], tags=b"RGZrg1\x00"))
    w.close()
    w.write_index()
    assert not os.path.exists(path + ".bai")
    assert os.path.exists(path + ".csi")
    with BamReader(path) as rd:
        got = [r.read_name for r in rd.fetch("big", (1 << 29), L)]
        assert got == ["r2"]
        got_all = [r.read_name for r in rd.fetch("big", 0, L)]
        assert got_all == ["r0", "r1", "r2"]


def test_fetch_includes_placed_unmapped(tmp_path):
    """htslib region fetches return placed-unmapped mates (FLAG 0x4 with a
    valid position); ours must too, and the haplotag writer must copy them
    identically through the native and record paths."""
    from hiphase_jax.io.bam import BamReader, BamWriter, SamHeader

    from tests.sim import make_bam_record

    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n@RG\tID:rg1\tSM:S\n",
                       ["c1"], [50000])
    path = str(tmp_path / "pu.bam")
    w = BamWriter(path, header)
    w.write(make_bam_record("m1", 0, 100, b"ACGT" * 5, [("M", 20)],
                            tags=b"RGZrg1\x00"))
    # placed-unmapped mate at its mate's coordinate, no CIGAR
    w.write(make_bam_record("pu", 0, 150, b"ACGT" * 5, [], flag=0x4,
                            mapq=0, tags=b"RGZrg1\x00"))
    w.write(make_bam_record("m2", 0, 300, b"ACGT" * 5, [("M", 20)],
                            tags=b"RGZrg1\x00"))
    w.close()
    w.write_index()
    with BamReader(path) as rd:
        got = [r.read_name for r in rd.fetch("c1", 0, 1000)]
        assert got == ["m1", "pu", "m2"]
        got2 = [r.read_name for r in rd.fetch("c1", 140, 160)]
        assert got2 == ["pu"]
        # the streaming writer path sees it too
        chunks = rd.stream_raw_window("c1", 0, 49999)
        n = sum(len(c[1]) for c in chunks)
        assert n == 3


def test_stream_cursor_error_propagates(tmp_path):
    """A decode failure mid-stream must surface as None (use the record
    fallback), never as silent end-of-data."""
    from hiphase_jax.io.bam import BamReader, BamWriter, SamHeader

    from tests.sim import make_bam_record

    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n@RG\tID:rg1\tSM:S\n",
                       ["c1"], [50000])
    path = str(tmp_path / "tr.bam")
    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n@RG\tID:rg1\tSM:S\n",
                       ["c1"], [500000])
    w = BamWriter(path, header)
    rng = np.random.default_rng(3)
    for k in range(400):
        seq = bytes(rng.choice([65, 67, 71, 84], 400).astype(np.uint8))
        w.write(make_bam_record(f"r{k}", 0, 100 + 700 * k, seq,
                                [("M", 400)], tags=b"RGZrg1\x00"))
    w.close()
    w.write_index()
    # corrupt a later BGZF block's payload (the header block stays intact)
    data = bytearray(open(path, "rb").read())
    at = (3 * len(data)) // 4
    for d in range(16):
        data[at + d] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with BamReader(path) as rd:
        out = rd.stream_raw_window("c1", 0, 499999)
        # either the corruption hit the scanned range (None => fallback)
        # or decode legitimately succeeded past it; it must NOT claim a
        # clean full read with records missing
        if out is not None:
            n = sum(len(c[1]) for c in out)
            assert n == 400
