"""--stats-file estimated_cost parity: the device engine must report the same
heuristic estimate (and therefore the same cost_ratio semantics) as the
host A* engine (ref: astar_phaser.rs:246-292, phase_stats.rs:130-199)."""

import pytest

from hiphase_jax.cli import main as cli_main

from tests.sim import build_dataset


def _stats_rows(path):
    rows = []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split(",")
        for line in fh:
            rows.append(dict(zip(header, line.rstrip("\n").split(","))))
    return rows


@pytest.mark.parametrize("queue_args", [
    [],                                                     # defaults (1000, 3)
    ["--phase-min-queue-size", "200", "--phase-queue-increment", "7"],
])
def test_estimated_cost_matches_astar(tmp_path, queue_args):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=41, n_contigs=3, contig_len=6000, coverage=15)
    stats_a = tmp_path / "a.stats.csv"
    stats_t = tmp_path / "t.stats.csv"
    assert cli_main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(tmp_path / "a.vcf.gz"),
                     "--engine", "astar",
                     "--stats-file", str(stats_a)] + queue_args) == 0
    assert cli_main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(tmp_path / "t.vcf.gz"),
                     "--engine", "device", "--batch-size", "4",
                     "--stats-file", str(stats_t)] + queue_args) == 0
    rows_a = _stats_rows(stats_a)
    rows_t = _stats_rows(stats_t)
    assert len(rows_a) == len(rows_t) and rows_a
    checked = 0
    for ra, rt in zip(rows_a, rows_t):
        assert ra["block_index"] == rt["block_index"]
        if not ra["estimated_cost"]:
            continue
        assert ra["estimated_cost"] == rt["estimated_cost"], ra["block_index"]
        assert ra["actual_cost"] == rt["actual_cost"], ra["block_index"]
        assert ra["cost_ratio"] == rt["cost_ratio"], ra["block_index"]
        checked += 1
    assert checked > 0
