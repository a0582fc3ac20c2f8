"""Device graph-WFA parity: the banded-DP device kernel must reproduce the
Python WFA spec (scores AND traversal/ambiguity sets) on the full scenario
matrix and on randomized graphs. Runs on the CPU backend (conftest)."""

import numpy as np
import pytest

import tests.test_wfa_graph as twg
from hiphase_jax.align.wfa_device import align_reads_device
from hiphase_jax.align.wfa_graph import WFAGraph, WFAGraphError, WFAResult
from hiphase_jax.core.variants import Variant


def _device_result(graph, seq):
    res = align_reads_device(graph, [bytes(seq)])
    assert res[0] is not None, "band ladder failed to certify a tiny case"
    score, trav = res[0]
    if score > graph.max_edit_distance:
        raise WFAGraphError(graph.max_edit_distance)
    return WFAResult(score, trav)


@pytest.fixture
def device_wfa(monkeypatch):
    monkeypatch.setattr(WFAGraph, "edit_distance", _device_result)
    monkeypatch.setattr(
        WFAGraph, "edit_distance_with_pruning",
        lambda self, seq, prune: _device_result(self, seq))


# every pinned scenario from the host suite, replayed on the device kernel
SCENARIOS = [
    n for n in dir(twg)
    if n.startswith("test_") and "native" not in n
]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_on_device(name, device_wfa):
    getattr(twg, name)()


def test_device_matches_python_randomized():
    """Randomized A/B: device kernel vs the Python spec, scores and
    traversal sets, on variant graphs with SNVs/ins/dels + mutated reads."""
    rng = np.random.default_rng(7)
    for trial in range(25):
        n = int(rng.integers(2, 8))
        length = 40 + n * 12
        ref = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                         size=length).astype(np.uint8).tobytes()
        variants = []
        pos = 5
        while pos < length - 12 and len(variants) < n:
            kind = rng.choice(["snv", "ins", "del"])
            if kind == "snv":
                alt = bytes([rng.choice([b for b in b"ACGT"
                                         if b != ref[pos]])])
                variants.append(
                    Variant.new_snv(0, pos, ref[pos:pos + 1], alt, 0, 1))
            elif kind == "ins":
                ins = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                 size=int(rng.integers(1, 4))
                                 ).astype(np.uint8).tobytes()
                variants.append(Variant.new_insertion(
                    0, pos, ref[pos:pos + 1], ref[pos:pos + 1] + ins, 0, 1))
            else:
                d = int(rng.integers(1, 4))
                variants.append(Variant.new_deletion(
                    0, pos, 1 + d, ref[pos:pos + 1 + d], ref[pos:pos + 1],
                    0, 1))
            pos += int(rng.integers(6, 14))
        g, _ = WFAGraph.from_reference_variants(ref, variants, 0, length,
                                                1000)
        obs = bytearray(ref)
        for j in rng.choice(length, size=int(rng.integers(0, 4)),
                            replace=False):
            obs[j] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        obs = bytes(obs)
        r_py = g._edit_distance_python(obs, 10**9)
        r_dev = _device_result(g, obs)
        assert r_dev.score == r_py.score, trial
        assert r_dev.traversed_nodes == r_py.traversed_nodes, trial


def test_device_batch_mixed_reads():
    """One batched call over several reads returns per-read results
    identical to one-at-a-time calls."""
    ref = b"ACGTACGTACGTACGTACGTACGTACGTACGT"
    variants = [Variant.new_snv(0, 7, b"G", b"C", 0, 1),
                Variant.new_snv(0, 19, b"T", b"A", 0, 1)]
    g, _ = WFAGraph.from_reference_variants(ref, variants, 0, len(ref), 1000)
    reads = [ref,
             ref[:7] + b"C" + ref[8:],
             ref[2:30],
             b"",
             ref[:19] + b"A" + ref[20:]]
    batch = align_reads_device(g, list(reads))
    for r, got in zip(reads, batch):
        solo = align_reads_device(g, [r])[0]
        assert got == solo
        py = g._edit_distance_python(r, 10**9)
        assert got[0] == py.score
        assert got[1] == py.traversed_nodes


def test_e2e_dual_mode_device_wfa(tmp_path):
    """Full dual-mode CLI run with --wfa-engine device produces records
    identical to the host WFA engine (score parity flows through to
    alleles, phase sets and haplotypes)."""
    from tests.sim import build_dataset
    from hiphase_jax.cli import main as cli_main
    from hiphase_jax.io.vcf import VcfReader

    fasta, vcf, bam, contigs, _truth = build_dataset(
        tmp_path, seed=11, n_contigs=1, contig_len=12000, coverage=12)
    outs = {}
    for eng in ("host", "device"):
        out_vcf = str(tmp_path / f"{eng}.vcf.gz")
        rc = cli_main([
            "--bam", bam, "--vcf", vcf, "--reference", fasta,
            "--output-vcf", out_vcf,
            "--engine", "native", "--wfa-engine", eng, "--threads", "1"])
        assert rc == 0
        outs[eng] = [tuple(r.fields) for r in VcfReader(out_vcf)]
    assert outs["host"], "empty phased VCF"
    assert outs["host"] == outs["device"]
