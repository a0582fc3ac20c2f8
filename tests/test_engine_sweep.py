"""Broad cross-engine regression sweep: randomized datasets × CLI
configurations, astar vs native byte-compared on every output surface.
The point A/B tests elsewhere pin specific features; this adds breadth so
a config-dependent divergence (width schedules, hom handling, spanning
thresholds, multi-VCF merging) cannot slip through."""

import gzip

import pytest

from hiphase_jax.cli import main as cli_main

from tests.sim import build_dataset

CONFIGS = [
    ("defaults", []),
    ("global-mode", None),  # global realignment ON (flag removed below)
    ("spanning2-minallele1", ["--min-spanning-reads", "2",
                              "--min-matched-alleles", "1"]),
    ("queue-small", ["--phase-min-queue-size", "64",
                     "--phase-queue-increment", "1"]),
    ("beamwidth-escalate", ["--beam-width", "64"]),
    ("singletons-mapq0", ["--phase-singletons", "--min-mapq", "0"]),
]


def _records(path):
    return [l for l in gzip.open(path).read().split(b"\n")
            if l and not l.startswith(b"##")]


@pytest.mark.parametrize("name,extra", CONFIGS)
@pytest.mark.parametrize("seed", [101, 202])
def test_engines_agree(tmp_path, name, extra, seed):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=seed, n_contigs=2, contig_len=9000,
        coverage=11 + (seed % 7))
    base = ["--bam", bam, "--vcf", vcf, "--reference", fasta]
    if extra is None:
        extra = []          # global realignment enabled
    else:
        extra = ["--disable-global-realignment"] + extra
    outs = {}
    for eng in ("astar", "native"):
        out = str(tmp_path / f"{name}.{eng}.vcf.gz")
        tags = str(tmp_path / f"{name}.{eng}.tags.tsv")
        stats = str(tmp_path / f"{name}.{eng}.stats.csv")
        rc = cli_main(base + ["--output-vcf", out, "--engine", eng,
                              "--haplotag-file", tags,
                              "--stats-file", stats] + extra)
        assert rc == 0, (name, eng)
        outs[eng] = (_records(out), open(tags).read(), open(stats).read())
    assert outs["astar"][0] == outs["native"][0], f"{name}: VCF differs"
    assert outs["astar"][1] == outs["native"][1], f"{name}: haplotags differ"
    assert outs["astar"][2] == outs["native"][2], f"{name}: stats differ"
    assert len(outs["astar"][0]) > 40
