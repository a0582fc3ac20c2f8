"""ReadSegment tests (parity values from ref: src/data_types/read_segments.rs tests)."""

import numpy as np

from hiphase_jax.core import ReadSegment, collapse_read_segments


def test_constructor_trims_to_set_window():
    rs = ReadSegment.new("read_name",
                         [3, 0, 1, 0, 0, 1, 2, 2, 3, 3],
                         [0, 1, 2, 3, 4, 5, 6, 7, 0, 0])
    assert rs.start == 1 and rs.end == 6
    assert list(rs.alleles) == [0, 1, 0, 0, 1]
    assert list(rs.quals) == [1, 2, 3, 4, 5]


def test_score_haplotype():
    rs = ReadSegment.new("read_name",
                         [3, 0, 1, 0, 0, 1, 2, 1, 3, 3],
                         [0, 1, 2, 3, 4, 5, 6, 7, 0, 0])
    assert (rs.start, rs.end) == (1, 8)
    assert rs.get_num_set() == 6

    assert rs.score_haplotype([0, 0, 1, 0, 0, 1, 1, 1, 0, 0]) == 6
    assert rs.score_haplotype([2] * 10) == 0
    assert rs.score_haplotype([1, 1, 0, 1, 1, 0, 0, 0, 1, 1]) == sum(range(1, 8))


def test_score_partial_haplotype():
    rs = ReadSegment.new("read_name",
                         [2, 0, 1, 0, 0, 1, 2, 1, 2, 2],
                         [0, 1, 2, 3, 4, 5, 6, 7, 0, 0])
    assert rs.score_partial_haplotype([0, 1, 0, 0, 1, 1, 1], 1) == 6
    assert rs.score_partial_haplotype([2] * 7, 2) == 0
    hap = [1, 0, 1, 1, 0, 0, 0]
    assert rs.score_partial_haplotype(hap, 1) == sum(range(1, 8))
    for x in range(len(hap)):
        assert rs.score_partial_haplotype(hap[x:], 1 + x) == sum(range(x + 1, 8))


def test_collapse():
    rs1 = ReadSegment.new("read_name",
                          [3, 1, 0, 2, 1, 3, 3], [0, 2, 1, 0, 2, 0, 0])
    rs2 = ReadSegment.new("read_name",
                          [3, 3, 0, 1, 0, 1, 1], [0, 0, 1, 2, 2, 1, 1])
    expected = ReadSegment.new("read_name",
                               [3, 1, 0, 2, 2, 1, 1], [0, 2, 1, 0, 0, 1, 1])

    collapsed = collapse_read_segments([rs1, rs2])
    assert collapsed.start == expected.start and collapsed.end == expected.end
    assert np.array_equal(collapsed.alleles, expected.alleles)
    assert np.array_equal(collapsed.quals, expected.quals)
    assert (collapsed.start, collapsed.end) == (1, 7)

    assert collapsed.score_haplotype([0, 1, 0, 0, 0, 1, 0]) == 1

    single = collapse_read_segments([rs1])
    assert np.array_equal(single.alleles, rs1.alleles)


def test_to_padded_roundtrip():
    rs = ReadSegment.new("r", [3, 0, 1, 2, 1, 3], [0, 5, 6, 0, 7, 0])
    alleles, quals = rs.to_padded(6)
    assert list(alleles) == [3, 0, 1, 2, 1, 3]
    assert list(quals) == [0, 5, 6, 0, 7, 0]
