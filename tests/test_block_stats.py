"""Block statistics math (parity vectors from ref: block_stats.rs tests)."""

from hiphase_jax.writers.block_stats import BlockStatsCollector, calculate_block_ng50


def test_calculate_block_ng50():
    blocks = [1, 2, 3, 4, 10]
    bad_blocks = [2]
    good_blocks = [9, 10]
    # odd contig length
    assert calculate_block_ng50(blocks, 21) == 4
    assert calculate_block_ng50(bad_blocks, 21) == 0
    assert calculate_block_ng50(good_blocks, 21) == 9
    # even contig length
    assert calculate_block_ng50(blocks, 20) == 10
    assert calculate_block_ng50(bad_blocks, 20) == 0
    assert calculate_block_ng50(good_blocks, 20) == 10


def test_summary_row_math():
    from hiphase_jax.phasing.block_gen import PhaseBlock

    blocks = []
    for i, (start, end, nv) in enumerate([(100, 1099, 10), (2000, 2000, 1),
                                          (3000, 5999, 25)]):
        b = PhaseBlock.new(i, "chr1", 0, 0, "S", 1)
        b.start, b.end, b.num_variants = start, end, nv
        blocks.append(b)
    row = BlockStatsCollector._summary_row(
        "S", "chr1", blocks, num_variants=60, num_heterozygous=40,
        num_het_snv=30, num_phased_snv=28, contig_length=10000)
    cols = dict(zip(
        ["sample_name", "chromosome", "num_variants", "num_heterozygous",
         "num_phased", "num_unphased", "num_het_snv", "num_phased_snv",
         "num_blocks", "num_singletons", "vpb_median", "vpb_mean", "vpb_min",
         "vpb_max", "vpb_sum", "bpb_median", "bpb_mean", "bpb_min", "bpb_max",
         "bpb_sum", "ng50"], row))
    assert cols["num_phased"] == 36 and cols["num_unphased"] == 4
    assert cols["num_blocks"] == 3 and cols["num_singletons"] == 1
    assert cols["vpb_median"] == 10 and cols["vpb_sum"] == 36
    assert cols["bpb_min"] == 1 and cols["bpb_max"] == 3000
    # lengths sorted [1, 1000, 3000]; target (10000+1)//2 = 5000 →
    # 3000 + 1000 = 4000 < 5000 → +1 = 4001 < 5000 → ng50 = 0
    assert cols["ng50"] == 0
    row2 = BlockStatsCollector._summary_row(
        "S", "chr1", blocks, 60, 40, 30, 28, contig_length=8000)
    assert row2[-1] == 1000  # target 4000: 3000+1000 >= 4000 → 1000
