"""Native whole-block realigner parity: `hn_realign_block` (record parse +
CIGAR walk + SV-deletion windows + anchor matching + stats in C) must
reproduce the per-read Python path exactly on WGS-realistic data including
indels, SV deletions, tandem repeats, and split reads
(ref: src/read_parsing.rs:48-503)."""

import numpy as np
import pytest

from hiphase_jax.io import native
from hiphase_jax.core.reference_genome import ReferenceGenome
from hiphase_jax.phasing import read_parsing
from hiphase_jax.phasing.block_gen import (
    MultiPhaseBlockIterator, PhaseBlockIterator,
)
from hiphase_jax.phasing.phaser import load_variant_calls, _mark_tr_overlaps
from hiphase_jax.utils.simulate import build_benchmark_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("realign")
    return build_benchmark_dataset(str(d), total_mb=2, n_contigs=2,
                                   coverage=15, read_length=8000, seed=5,
                                   block_kb=120)


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_block_realign_matches_python(dataset, monkeypatch):
    ref = ReferenceGenome.from_fasta(dataset["fasta"])
    it = MultiPhaseBlockIterator(
        [PhaseBlockIterator([dataset["vcf"]], [dataset["bam"]], "SAMPLE")])
    blocks = [b for b in it if not b.unphased_block and b.num_variants > 1]
    assert len(blocks) >= 4

    checked_reads = 0
    for block in blocks:
        variants, _homs = load_variant_calls(
            block, [dataset["vcf"]], ref, 15, False)
        _mark_tr_overlaps(variants, [])

        segs_n, thin_n, stats_n = read_parsing.load_read_segments(
            block, [dataset["bam"]], variants, 2, 5)

        # force the per-read Python path by disabling the block fast path
        monkeypatch.setattr(read_parsing, "_realign_block_native",
                            lambda *a, **k: False)
        segs_p, thin_p, stats_p = read_parsing.load_read_segments(
            block, [dataset["bam"]], variants, 2, 5)
        monkeypatch.undo()

        assert len(segs_n) == len(segs_p)
        for a, b in zip(segs_n, segs_p):
            assert a.read_name == b.read_name
            assert a.start == b.start and a.end == b.end
            assert np.array_equal(a.alleles, b.alleles), a.read_name
            assert np.array_equal(a.quals, b.quals), a.read_name
        for a, b in zip(thin_n, thin_p):
            assert a.read_name == b.read_name
            assert np.array_equal(a.alleles, b.alleles)

        assert stats_n.num_reads == stats_p.num_reads
        assert stats_n.num_alleles == stats_p.num_alleles
        assert stats_n.skipped_reads == stats_p.skipped_reads
        assert stats_n.local_aligned == stats_p.local_aligned
        assert np.array_equal(stats_n.exact_matches, stats_p.exact_matches)
        assert np.array_equal(stats_n.inexact_matches, stats_p.inexact_matches)
        assert np.array_equal(stats_n.failed_matches, stats_p.failed_matches)
        assert np.array_equal(stats_n.allele0_matches, stats_p.allele0_matches)
        assert np.array_equal(stats_n.allele1_matches, stats_p.allele1_matches)
        checked_reads += len(segs_n)
    assert checked_reads > 200
