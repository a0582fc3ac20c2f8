"""Span-index parity: the one-pass native BAM span index must answer the
block-generation queries (multispan, next-mapped, supplemental overlap)
identically to the per-locus fetch path it replaces
(ref: src/block_gen.rs:630-799)."""

import numpy as np
import pytest

from hiphase_jax.io import native
from hiphase_jax.phasing.block_gen import PhaseBlock, PhaseBlockIterator
from hiphase_jax.utils.simulate import build_benchmark_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("spanidx")
    return build_benchmark_dataset(str(d), total_mb=2, n_contigs=2,
                                   coverage=15, read_length=8000, seed=11,
                                   block_kb=120)


def _iterators(dataset, **kwargs):
    a = PhaseBlockIterator([dataset["vcf"]], [dataset["bam"]], "SAMPLE",
                           **kwargs)
    b = PhaseBlockIterator([dataset["vcf"]], [dataset["bam"]], "SAMPLE",
                           **kwargs)
    b._span_indexes = []  # force the fetch fallback

    def chrom_spans_none(_chrom):
        return None

    b._chrom_spans = chrom_spans_none
    return a, b


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_queries_match_fetch_path(dataset):
    fast, slow = _iterators(dataset)
    rng = np.random.default_rng(0)
    contigs = fast.contigs
    for chrom in contigs:
        length = fast._contig_length(chrom)
        positions = sorted(int(p) for p in
                           rng.integers(0, length, size=60))
        for pos in positions:
            assert fast.get_longest_multispan(chrom, pos) == \
                slow.get_longest_multispan(chrom, pos), (chrom, pos)
            assert fast.get_next_mapped(chrom, pos) == \
                slow.get_next_mapped(chrom, pos), (chrom, pos)
            block = PhaseBlock.new(0, chrom, 0, 0, "SAMPLE", 1)
            block.add_locus_variant(chrom, max(pos - 50_000, 0), 0)
            block.add_locus_variant(chrom, pos, 0)
            assert fast.is_supplemental_overlap(chrom, pos, block) == \
                slow.is_supplemental_overlap(chrom, pos, block), (chrom, pos)


def test_next_starts_no_double_count_at_read_start():
    """A single read starting exactly at the queried position must appear
    once: with k=2 the fetch path sees one overlapping read (=> caller
    returns U64_MAX); the index must not manufacture [pos, pos]."""
    from hiphase_jax.io.span_index import ChromSpans
    e = np.empty(0, dtype=np.int64)
    spans = ChromSpans(np.array([100], dtype=np.int64),
                       np.array([200], dtype=np.int64), e, e, e, e)
    got = spans.next_starts(100, 2)
    assert list(got) == [100]
    # read covering pos but starting earlier still contributes once
    spans2 = ChromSpans(np.array([50, 100], dtype=np.int64),
                        np.array([150, 200], dtype=np.int64), e, e, e, e)
    assert sorted(spans2.next_starts(100, 2)) == [50, 100]


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_queries_match_at_exact_read_starts(dataset):
    """Querying at a position where a read starts must not double-count that
    read (it appears both as 'covering' and in the next-starts tail).
    min_spanning_reads=2 makes the k-th smallest sensitive to duplicates."""
    fast, slow = _iterators(dataset, min_spanning_reads=2)
    for chrom in fast.contigs:
        spans = fast._chrom_spans(chrom)
        assert spans is not None
        starts = np.unique(np.concatenate([s.starts for s in spans]))
        sample = starts[:: max(1, len(starts) // 40)]
        for pos in (int(p) for p in sample):
            assert fast.get_next_mapped(chrom, pos) == \
                slow.get_next_mapped(chrom, pos), (chrom, pos)
            assert fast.get_longest_multispan(chrom, pos) == \
                slow.get_longest_multispan(chrom, pos), (chrom, pos)


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_block_stream_identical(dataset):
    """The full block stream must be identical through either query path."""
    fast, slow = _iterators(dataset)
    blocks_fast = [(b.chrom, b.start, b.end, b.num_variants, b.unphased_block)
                   for b in fast]
    blocks_slow = [(b.chrom, b.start, b.end, b.num_variants, b.unphased_block)
                   for b in slow]
    assert blocks_fast == blocks_slow
    assert len(blocks_fast) > 5
