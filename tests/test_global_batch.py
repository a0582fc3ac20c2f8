"""Batched graph-WFA parity: the one-native-call-per-chunk global path
(hn_wfa_batch + host ladder) must reproduce the per-read dual-mode path
exactly — segments, quals, stats, and fallback decisions
(ref: src/read_parsing.rs:520-867)."""

import numpy as np
import pytest

from hiphase_jax.io import native
from hiphase_jax.core.reference_genome import ReferenceGenome
from hiphase_jax.phasing import global_realign
from hiphase_jax.phasing.block_gen import (
    MultiPhaseBlockIterator, PhaseBlockIterator,
)
from hiphase_jax.phasing.phaser import _mark_tr_overlaps, load_variant_calls
from hiphase_jax.phasing.read_parsing import GlobalRealignmentConfig
from hiphase_jax.utils.simulate import build_benchmark_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("gbatch")
    return build_benchmark_dataset(str(d), total_mb=2, n_contigs=2,
                                   coverage=15, read_length=8000, seed=13,
                                   block_kb=120)


@pytest.mark.skipif(not native.available(), reason="native library not built")
@pytest.mark.parametrize("max_ed", [500, 8])
def test_batched_matches_per_read(dataset, monkeypatch, max_ed):
    """max_ed=8 forces frequent max-ED fallbacks so the ladder and the
    local-fallback merging are exercised, not just the happy path."""
    ref = ReferenceGenome.from_fasta(dataset["fasta"])
    it = MultiPhaseBlockIterator(
        [PhaseBlockIterator([dataset["vcf"]], [dataset["bam"]], "SAMPLE")])
    blocks = [b for b in it if not b.unphased_block and b.num_variants > 1]
    config = GlobalRealignmentConfig(max_edit_distance=max_ed,
                                     global_failure_minimum=5)

    total = 0
    fellback = 0
    for block in blocks:
        variants, homs = load_variant_calls(
            block, [dataset["vcf"]], ref, 15, True)
        _mark_tr_overlaps(variants, homs)

        segs_b, thin_b, stats_b = global_realign.load_full_read_segments(
            block, [dataset["bam"]], variants, homs, ref, 2, 5, config)

        # disable the batched chunk path -> per-read dual-mode path
        monkeypatch.setattr(global_realign, "_global_batch_chunk",
                            lambda *a, **k: False)
        segs_p, thin_p, stats_p = global_realign.load_full_read_segments(
            block, [dataset["bam"]], variants, homs, ref, 2, 5, config)
        monkeypatch.undo()

        assert len(segs_b) == len(segs_p)
        for a, b in zip(segs_b, segs_p):
            assert a.read_name == b.read_name
            assert a.start == b.start and a.end == b.end
            assert np.array_equal(a.alleles, b.alleles), (a.read_name, max_ed)
            assert np.array_equal(a.quals, b.quals), (a.read_name, max_ed)
        for a, b in zip(thin_b, thin_p):
            assert a.read_name == b.read_name
            assert np.array_equal(a.alleles, b.alleles)

        assert stats_b.num_reads == stats_p.num_reads
        assert stats_b.num_alleles == stats_p.num_alleles
        assert stats_b.skipped_reads == stats_p.skipped_reads
        assert stats_b.global_aligned == stats_p.global_aligned
        assert stats_b.local_aligned == stats_p.local_aligned
        assert np.array_equal(stats_b.exact_matches, stats_p.exact_matches)
        assert np.array_equal(stats_b.inexact_matches, stats_p.inexact_matches)
        assert np.array_equal(stats_b.failed_matches, stats_p.failed_matches)
        assert np.array_equal(stats_b.allele0_matches, stats_p.allele0_matches)
        assert np.array_equal(stats_b.allele1_matches, stats_p.allele1_matches)
        total += len(segs_b)
        fellback += stats_b.local_aligned
    assert total > 200
    if max_ed == 8:
        assert fellback > 0, "low max-ED must exercise the fallback ladder"
