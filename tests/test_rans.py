"""rANS 4x8 codec (CRAM 3.0 §13): Python-oracle round-trips for both
orders, native-decoder agreement, malformed-stream rejection, and CRAM
files whose external blocks use rans4x8 (the codec real pbmm2/samtools
CRAMs use; ref gap from VERDICT r03 #6)."""

import numpy as np
import pytest

from hiphase_jax.io import native, rans


def _cases(rng):
    return [
        b"",
        b"A",
        b"AB",
        b"ABC",
        b"ABCDE",
        b"\x00" * 500,                                     # single symbol 0
        bytes(range(256)) * 4,                             # all symbols
        bytes(rng.integers(0, 256, 10001, dtype=np.uint8)),
        bytes(rng.integers(65, 69, 40000, dtype=np.uint8)),        # ACGT
        bytes(np.clip(rng.normal(33, 4, 30000), 0, 90)
              .astype(np.uint8)),                          # quality-shaped
    ]


@pytest.mark.parametrize("order", [0, 1])
def test_python_roundtrip(order):
    rng = np.random.default_rng(3)
    for data in _cases(rng):
        enc = rans.compress(data, order=order)
        assert rans.uncompress(enc) == data


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_native_decoder_matches_oracle(order):
    rng = np.random.default_rng(4)
    for data in _cases(rng):
        enc = rans.compress(data, order=order)
        got = native.rans_uncompress(enc, len(data))
        if len(data) == 0:
            assert got in (b"", None) or got == b""
            continue
        assert got == data


def test_malformed_streams_rejected():
    with pytest.raises(rans.RansError):
        rans.uncompress(b"\x02\x00\x00\x00\x00\x08\x00\x00\x00")  # order 2
    with pytest.raises(rans.RansError):
        rans.uncompress(b"\x00\x00\x00")  # truncated header
    enc = bytearray(rans.compress(b"HELLOHELLO"))
    truncated = bytes(enc[:len(enc) // 2])
    with pytest.raises(Exception):
        rans.uncompress(truncated)
    if native.available():
        assert native.rans_uncompress(truncated, 10) is None


def test_cram_rans_blocks_roundtrip(tmp_path):
    """A CRAM written with rans4x8 external blocks must read back
    identically (through the native decoder) — _read_block no longer
    errors on method 4."""
    from hiphase_jax.core.reference_genome import ReferenceGenome
    from hiphase_jax.io.bam import BamReader
    from hiphase_jax.io.cram import CramReader, CramWriter

    from tests.sim import build_dataset

    fasta, vcf, bam, contigs, _ = build_dataset(
        tmp_path, seed=61, n_contigs=2, contig_len=5000, coverage=10)
    ref = ReferenceGenome.from_fasta(fasta)
    cram_path = str(tmp_path / "rans.cram")
    with BamReader(bam) as rd:
        w = CramWriter(cram_path, rd.header, ref, codec="rans")
        original = [(r.read_name, r.refid, r.pos, r.flag,
                     r.query_sequence()) for r in rd]
        for_w = BamReader(bam)
        for rec in for_w:
            w.write(rec)
        for_w.close()
        w.close()
        w.write_index()
    # the file must actually contain rans4x8 blocks
    from hiphase_jax.io.cram import BLOCK_RANS4X8
    raw = open(cram_path, "rb").read()
    assert bytes([BLOCK_RANS4X8]) in raw  # weak but method bytes exist
    got = []
    rdr = CramReader(cram_path, ref)
    for rec in rdr:
        got.append((rec.read_name, rec.refid, rec.pos, rec.flag,
                    rec.query_sequence()))
    rdr.close()
    assert got == original and len(got) > 20


def test_cram_B_feature_and_canonical_eof(tmp_path):
    """A read base outside the substitution alphabet ('R') must encode as a
    (base, quality) 'B' feature pair without desyncing the QS stream, and
    the file must end with the spec's canonical 38-byte EOF container."""
    from hiphase_jax.core.reference_genome import ReferenceGenome
    from hiphase_jax.io.bam import SamHeader
    from hiphase_jax.io.cram import CramReader, CramWriter

    from tests.sim import make_bam_record

    fasta = tmp_path / "r.fa"
    fasta.write_text(">c1\n" + "ACGT" * 25 + "\n")
    ref = ReferenceGenome.from_fasta(str(fasta))
    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n"
                       "@RG\tID:rg0\tSM:SAMPLE\n", ["c1"], [100])
    seq = bytearray(b"ACGT" * 5)
    seq[3] = ord("R")   # IUPAC code: no substitution code exists
    seq[7] = ord("N")   # N: substitution code exists (not a B feature)
    quals = bytes([30 + i for i in range(20)])
    rec = make_bam_record("read1", 0, 2, bytes(seq), [("M", 20)],
                          quals=quals)
    cram_path = str(tmp_path / "b.cram")
    w = CramWriter(cram_path, header, ref)
    w.write(rec)
    w.close()

    raw = open(cram_path, "rb").read()
    assert raw.endswith(CramWriter.EOF_BYTES)

    rd = CramReader(cram_path, ref)
    got = list(rd)
    rd.close()
    assert len(got) == 1
    assert got[0].query_sequence() == bytes(seq)
    assert got[0].query_qualities() == quals


# ---------------------------------------------------------------------------
# rANS Nx16 (CRAM 3.1)


def test_rans_nx16_roundtrip_matrix():
    """Encoder<->decoder round-trips across orders, state counts and the
    PACK/RLE pre-transforms."""
    import numpy as np

    from hiphase_jax.io import rans_nx16 as rn

    rng = np.random.default_rng(0)
    cases = [b"", b"A", b"hello world" * 10,
             bytes(rng.integers(0, 4, 5000).astype(np.uint8)),
             bytes(rng.integers(0, 256, 3000).astype(np.uint8)),
             b"AAAAABBBBBCCCCC" * 200,
             bytes(rng.choice([65, 67, 71, 84], 8000).astype(np.uint8))]
    for order in (0, 1):
        for n32 in (False, True):
            for pk in (False, True):
                for rle in (False, True):
                    for d in cases:
                        enc = rn.compress(d, order=order, nway32=n32,
                                          use_pack=pk, use_rle=rle)
                        assert rn.uncompress(enc) == d, \
                            (order, n32, pk, rle, len(d))


def test_rans_nx16_stripe_decode():
    """STRIPE streams (byte-interleaved sub-streams) decode; the stream is
    assembled from independently-encoded slices as the spec lays out."""
    import numpy as np

    from hiphase_jax.io import rans_nx16 as rn

    rng = np.random.default_rng(5)
    data = bytes(rng.choice([65, 67, 71, 84], 4001).astype(np.uint8))
    n = 4
    subs = [rn.compress(data[j::n]) for j in range(n)]
    out = bytearray([rn.F_STRIPE])
    rn._put_uint7(out, len(data))
    out.append(n)
    for s in subs:
        rn._put_uint7(out, len(s))
    for s in subs:
        out += s
    assert rn.uncompress(bytes(out)) == data


def test_rans_nx16_compresses():
    """DNA-like data must compress near its order-0 entropy."""
    import numpy as np

    from hiphase_jax.io import rans_nx16 as rn

    rng = np.random.default_rng(1)
    d = bytes(rng.choice([65, 67, 71, 84], 50000,
                         p=[.4, .1, .1, .4]).astype(np.uint8))
    enc = rn.compress(d, order=0)
    assert len(enc) < 0.25 * len(d)  # H0 ~ 1.72 bits/byte = 21.5%


def test_cram_rans_nx16_blocks_roundtrip(tmp_path):
    """A CRAM written with ransNx16 external blocks (method 5, the CRAM 3.1
    codec) must read back record-identical."""
    from hiphase_jax.core.reference_genome import ReferenceGenome
    from hiphase_jax.io.bam import BamReader
    from hiphase_jax.io.cram import BLOCK_RANSNX16, CramReader, CramWriter

    from tests.sim import build_dataset

    fasta, vcf, bam, contigs, _ = build_dataset(
        tmp_path, seed=62, n_contigs=1, contig_len=5000, coverage=10)
    ref = ReferenceGenome.from_fasta(fasta)
    cram_path = str(tmp_path / "nx16.cram")
    with BamReader(bam) as rd:
        w = CramWriter(cram_path, rd.header, ref, codec="ransNx16")
        original = [(r.read_name, r.refid, r.pos, r.flag,
                     r.query_sequence()) for r in rd]
        for_w = BamReader(bam)
        for rec in for_w:
            w.write(rec)
        for_w.close()
        w.close()
        w.write_index()
    raw = open(cram_path, "rb").read()
    assert bytes([BLOCK_RANSNX16]) in raw
    got = []
    rdr = CramReader(cram_path, ref)
    for rec in rdr:
        got.append((rec.read_name, rec.refid, rec.pos, rec.flag,
                    rec.query_sequence()))
    rdr.close()
    assert got == original and len(got) > 10


def test_rans_nx16_constant_and_odd_tables():
    """Regression: PACK of a constant buffer (empty rANS payload) must
    round-trip, and a frequency table with a non-power-of-two total must
    raise rather than silently mis-decode."""
    import pytest as _pytest

    from hiphase_jax.io import rans_nx16 as rn

    for d in (b"AAAAAAAA", b"A" * 4097):
        for order in (0, 1):
            enc = rn.compress(d, order=order, use_pack=True)
            assert rn.uncompress(enc) == d
    # corrupt table: total 4095
    f = [0] * 256
    f[65], f[66] = 4000, 95
    body = bytearray()
    rn._write_freqs_o0(body, f)
    with _pytest.raises(rn.RansNx16Error):
        rn._read_freqs_o0(bytes(body), 0)
