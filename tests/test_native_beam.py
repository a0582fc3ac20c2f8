"""Native C++ beam solver parity: hn_beam_solve_batch must match the exact
host A* and the device beam kernel bit-for-bit — same haplotypes, cost,
hets, and pruned accounting (ref semantics: src/astar_phaser.rs)."""

import numpy as np
import pytest

from hiphase_jax.io import native
from hiphase_jax.phasing.astar import astar_solver
from hiphase_jax.phasing.beam import solve_blocks, tensorize_block

from tests.test_solver import make_block

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def native_solve(blocks, fast_width=64, full_width=1024, threads=2):
    """blocks: list of (variants, reads). Returns per-block
    (h1, h2, cost, hets, pruned)."""
    nv = np.array([len(v) for v, _ in blocks], dtype=np.int32)
    skip_off = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum(nv, out=skip_off[1:])
    skip = np.zeros(int(skip_off[-1]), dtype=np.uint8)
    for i, (variants, _) in enumerate(blocks):
        for j, v in enumerate(variants):
            skip[skip_off[i] + j] = 1 if v.is_ignored else 0
    read_off = np.zeros(len(blocks) + 1, dtype=np.int64)
    read_off[1:] = np.cumsum([len(r) for _, r in blocks])
    seg_start, blob_a, blob_q, lens = [], [], [], []
    for _, reads in blocks:
        for rs in reads:
            seg_start.append(rs.start)
            lens.append(len(rs.alleles))
            blob_a.append(rs.alleles)
            blob_q.append(rs.quals)
    seg_off = np.zeros(len(seg_start) + 1, dtype=np.int64)
    np.cumsum(np.asarray(lens, dtype=np.int64), out=seg_off[1:])
    alleles = np.concatenate(blob_a) if blob_a else np.empty(0, np.uint8)
    quals = np.concatenate(blob_q) if blob_q else np.empty(0, np.uint8)
    out = native.beam_solve_batch_native(
        np.asarray(nv), skip_off, skip, read_off,
        np.asarray(seg_start, dtype=np.int32), seg_off, alleles, quals,
        fast_width, full_width, threads)
    assert out is not None
    h1, h2, cost, hets, pruned, _exp = out
    res = []
    for i in range(len(blocks)):
        sl = slice(int(skip_off[i]), int(skip_off[i + 1]))
        res.append((list(h1[sl]), list(h2[sl]), int(cost[i]), int(hets[i]),
                    int(pruned[i])))
    return res


@pytest.mark.parametrize("seed", range(8))
def test_native_matches_astar_random(seed):
    rng = np.random.default_rng(seed)
    variants, reads, _h1, _h2 = make_block(
        rng, int(rng.integers(3, 25)), int(rng.integers(4, 30)),
        flip_prob=0.15, amb_prob=0.1)
    ref = astar_solver(0, variants, reads, 1000, 3)
    (h1, h2, cost, hets, _pruned), = native_solve([(variants, reads)])
    assert cost == ref.statistics.actual_cost
    assert h1 == ref.haplotype_1 and h2 == ref.haplotype_2, seed


@pytest.mark.parametrize("seed", range(4))
def test_native_matches_device_beam_windowed(seed):
    """Windowed reads (slot reuse + folds) and narrow fast width with
    escalation: native must equal the device kernel exactly, including
    pruned accounting."""
    rng = np.random.default_rng(100 + seed)
    variants, reads, _h1, _h2 = make_block(
        rng, 40, 60, flip_prob=0.2, amb_prob=0.1, window=12)
    for j in (5, 17, 30):
        variants[j].set_ignored()
    W = 128
    alleles, quals, skip = tensorize_block(reads, variants, 64, 40)
    dev = solve_blocks(alleles[None], quals[None], skip[None], beam_width=W)
    (h1, h2, cost, hets, pruned), = native_solve(
        [(variants, reads)], fast_width=W, full_width=W)
    assert cost == int(dev.cost[0])
    assert hets == int(dev.num_hets[0])
    assert pruned == int(dev.pruned[0])
    assert h1 == [int(x) for x in dev.h1[0]]
    assert h2 == [int(x) for x in dev.h2[0]]


@pytest.mark.parametrize("seed", range(4))
def test_escalation_equals_direct_full_width(seed):
    """fast-width solve with pruned>0 re-solves at full width; the final
    result must equal a direct full-width solve (the width-invariance of the
    viable beam prefix)."""
    rng = np.random.default_rng(200 + seed)
    variants, reads, _h1, _h2 = make_block(rng, 30, 40, flip_prob=0.35,
                                           amb_prob=0.05, window=8)
    esc, = native_solve([(variants, reads)], fast_width=8, full_width=256)
    direct, = native_solve([(variants, reads)], fast_width=256,
                           full_width=256)
    assert esc == direct


def test_batch_of_blocks_threaded():
    rng = np.random.default_rng(7)
    blocks = []
    for _ in range(9):
        v, r, _, _ = make_block(rng, int(rng.integers(2, 20)),
                                int(rng.integers(3, 25)), flip_prob=0.1)
        blocks.append((v, r))
    batch = native_solve(blocks, threads=3)
    singles = [native_solve([b])[0] for b in blocks]
    assert batch == singles
    for (variants, reads), got in zip(blocks, singles):
        ref = astar_solver(0, variants, reads, 1000, 3)
        assert got[2] == ref.statistics.actual_cost


def test_empty_and_tiny_blocks():
    from hiphase_jax.core.variants import Variant
    v = [Variant.new_snv(0, 10, b"A", b"C", 0, 1)]
    (h1, h2, cost, hets, pruned), = native_solve([(v, [])])
    assert cost == 0 and pruned == 0
    assert [list(map(int, h1)), list(map(int, h2))] == [[0], [1]]
    assert hets == 1
