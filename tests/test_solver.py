"""Solver parity: device beam engine vs exact A* vs brute force on synthetic
phase blocks (the reference validates A* mechanics in astar_phaser.rs tests;
here we additionally pin optimality and cross-engine agreement)."""

import itertools

import numpy as np
import pytest

from hiphase_jax.core.read_segments import ReadSegment
from hiphase_jax.core.variants import Variant
from hiphase_jax.phasing.astar import astar_solver
from hiphase_jax.phasing.beam import solve_blocks, tensorize_block


def make_block(rng, num_variants, num_reads, flip_prob=0.1, amb_prob=0.05,
               window=None):
    """Simulate reads from a random diplotype; returns (variants, reads,
    true_h1, true_h2)."""
    h1 = rng.integers(0, 2, size=num_variants)
    h2 = 1 - h1  # fully het truth
    variants = [Variant.new_snv(0, 10 * (j + 1), b"A", b"C", 0, 1)
                for j in range(num_variants)]
    reads = []
    for i in range(num_reads):
        hap = h1 if rng.random() < 0.5 else h2
        if window is None:
            start, end = 0, num_variants
        else:
            start = int(rng.integers(0, max(1, num_variants - window + 1)))
            end = min(num_variants, start + window)
        alleles = np.full(num_variants, 3, dtype=np.uint8)
        quals = np.zeros(num_variants, dtype=np.uint8)
        for j in range(start, end):
            r = rng.random()
            if r < amb_prob:
                alleles[j] = 2
            else:
                a = int(hap[j])
                if rng.random() < flip_prob:
                    a = 1 - a
                alleles[j] = a
                quals[j] = int(rng.integers(10, 60))
        reads.append(ReadSegment.new(f"read{i}", alleles, quals))
    return variants, reads, h1, h2


def brute_force_cost(reads, num_variants):
    """Exhaustive minimum weighted-MEC cost over all diplotypes."""
    best = None
    A = np.stack([r.to_padded(num_variants)[0] for r in reads])
    Q = np.stack([r.to_padded(num_variants)[1] for r in reads]).astype(np.int64)
    for h1 in itertools.product([0, 1], repeat=num_variants):
        for h2 in itertools.product([0, 1], repeat=num_variants):
            c1 = (Q * (A != np.array(h1))).sum(axis=1)
            c2 = (Q * (A != np.array(h2))).sum(axis=1)
            cost = int(np.minimum(c1, c2).sum())
            if best is None or cost < best:
                best = cost
    return best


def _bucket(n, q):
    return ((n + q - 1) // q) * q


def run_beam_single(variants, reads, beam_width=64, r_pad=None, v_pad=None):
    # bucketed padding keeps the jit cache small across random test shapes
    r_pad = r_pad or _bucket(len(reads), 16)
    v_pad = v_pad or _bucket(len(variants), 8)
    alleles, quals, skip = tensorize_block(reads, variants, r_pad, v_pad)
    res = solve_blocks(alleles[None], quals[None], skip[None],
                       beam_width=beam_width)
    nv = len(variants)
    return (list(res.h1[0][:nv]), list(res.h2[0][:nv]), int(res.cost[0]),
            int(res.pruned[0]))


def test_perfect_reads_phase_exactly():
    rng = np.random.default_rng(0)
    variants, reads, h1, h2 = make_block(rng, 8, 12, flip_prob=0.0, amb_prob=0.0)
    result = astar_solver(0, variants, reads)
    got = np.array(result.haplotype_1)
    # perfect reads: zero cost, full het phasing, matches truth up to swap
    assert result.statistics.actual_cost == 0
    assert result.statistics.phased_variants == 8
    assert (np.array_equal(got, h1) or np.array_equal(got, h2))

    bh1, bh2, bcost, bpruned = run_beam_single(variants, reads)
    assert bcost == 0
    assert bh1 == result.haplotype_1
    assert bh2 == result.haplotype_2


@pytest.mark.parametrize("seed", range(8))
def test_astar_beam_bruteforce_agree(seed):
    rng = np.random.default_rng(seed)
    nv = int(rng.integers(3, 6))
    nr = int(rng.integers(4, 12))
    variants, reads, _, _ = make_block(rng, nv, nr, flip_prob=0.15, amb_prob=0.1)
    expected = brute_force_cost(reads, nv)
    result = astar_solver(0, variants, reads)
    assert result.statistics.actual_cost == expected, "A* not optimal"

    bh1, bh2, bcost, _ = run_beam_single(variants, reads, beam_width=128)
    assert bcost == expected, "beam not optimal"
    # same tie-breaking → identical haplotypes between engines
    assert bh1 == result.haplotype_1
    assert bh2 == result.haplotype_2


@pytest.mark.parametrize("seed", range(4))
def test_beam_matches_astar_bigger_blocks(seed):
    rng = np.random.default_rng(100 + seed)
    variants, reads, _, _ = make_block(rng, 20, 24, flip_prob=0.1,
                                       amb_prob=0.05, window=12)
    result = astar_solver(0, variants, reads)
    bh1, bh2, bcost, bpruned = run_beam_single(variants, reads, beam_width=256)
    assert bcost == result.statistics.actual_cost
    assert bh1 == result.haplotype_1
    assert bh2 == result.haplotype_2


def test_ignored_variants_skipped():
    rng = np.random.default_rng(3)
    variants, reads, _, _ = make_block(rng, 6, 8, flip_prob=0.0, amb_prob=0.0)
    # mark variant 2 ignored; its read alleles must be cleared to NoOverlap
    variants[2].set_ignored()
    cleared = []
    for rs in reads:
        a, q = rs.to_padded(6)
        a[2] = 3
        q[2] = 0
        cleared.append(ReadSegment.new(rs.read_name, a, q))
    result = astar_solver(0, variants, cleared)
    assert result.haplotype_1[2] == 2 and result.haplotype_2[2] == 2
    assert result.statistics.skipped_variants == 1
    assert result.statistics.phased_variants == 5

    bh1, bh2, bcost, _ = run_beam_single(variants, cleared)
    assert bh1 == result.haplotype_1
    assert bh2 == result.haplotype_2
    assert bcost == result.statistics.actual_cost


def test_beam_padding_invariance():
    """Padding reads/variants must not change the solution."""
    rng = np.random.default_rng(5)
    variants, reads, _, _ = make_block(rng, 7, 9, flip_prob=0.1)
    base = run_beam_single(variants, reads, beam_width=64)
    padded = run_beam_single(variants, reads, beam_width=64, r_pad=16, v_pad=12)
    assert base == padded


def test_beam_batched_blocks_independent():
    """Solving two blocks in one batch matches solving them separately."""
    rng = np.random.default_rng(9)
    blocks = [make_block(rng, 6, 8, flip_prob=0.1)[:2] for _ in range(3)]
    singles = [run_beam_single(v, r, beam_width=64, r_pad=8, v_pad=6)
               for v, r in blocks]
    arrs = [tensorize_block(r, v, 8, 6) for v, r in blocks]
    A = np.stack([a for a, _, _ in arrs])
    Q = np.stack([q for _, q, _ in arrs])
    S = np.stack([s for _, _, s in arrs])
    res = solve_blocks(A, Q, S, beam_width=64)
    for i, (h1, h2, cost, _pruned) in enumerate(singles):
        assert list(res.h1[i]) == h1
        assert list(res.h2[i]) == h2
        assert int(res.cost[i]) == cost


def test_hom_conversion():
    """Reads overwhelmingly support 0 at a 'het' site → converted homozygous."""
    variants = [Variant.new_snv(0, 10 * (j + 1), b"A", b"C", 0, 1)
                for j in range(3)]
    reads = [ReadSegment.new(f"r{i}", [0, i % 2, (i + 1) % 2], [40, 40, 40])
             for i in range(6)]
    result = astar_solver(0, variants, reads)
    assert result.haplotype_1[0] == 0 and result.haplotype_2[0] == 0
    assert result.statistics.homozygous_variants >= 1
    bh1, bh2, bcost, _ = run_beam_single(variants, reads)
    assert bh1 == result.haplotype_1 and bh2 == result.haplotype_2


def test_slotted_matches_dense():
    """Slot-packed tensorization (frozen/fluid fold) must give identical
    results to one-row-per-read dense mode."""
    from hiphase_jax.phasing.beam import assign_slots
    rng = np.random.default_rng(77)
    for seed in range(4):
        rng = np.random.default_rng(200 + seed)
        variants, reads, _, _ = make_block(rng, 24, 30, flip_prob=0.12,
                                           amb_prob=0.05, window=8)
        dense = tensorize_block(reads, variants, 32, 24)
        r_dense = solve_blocks(dense[0][None], dense[1][None], dense[2][None],
                               beam_width=64)
        _slots, n_slots = assign_slots(reads)
        assert n_slots < len(reads), "windowed reads must share slots"
        rb = 16 if n_slots <= 16 else 32
        al, qu, sk, rs = tensorize_block(reads, variants, rb, 24, slotted=True)
        r_slot = solve_blocks(al[None], qu[None], sk[None], beam_width=64,
                              resets=rs[None])
        assert int(r_slot.cost[0]) == int(r_dense.cost[0])
        assert list(r_slot.h1[0]) == list(r_dense.h1[0])
        assert list(r_slot.h2[0]) == list(r_dense.h2[0])


def test_slotted_with_ignored_and_reset_collision():
    """Resets landing on ignored columns must stay consistent."""
    from hiphase_jax.phasing.beam import assign_slots
    rng = np.random.default_rng(300)
    variants, reads, _, _ = make_block(rng, 16, 20, flip_prob=0.1, window=5)
    variants[8].set_ignored()
    cleared = []
    for r in reads:
        a, q = r.to_padded(16)
        a[8] = 3
        q[8] = 0
        cleared.append(ReadSegment.new(r.read_name, a, q))
    cleared = [r for r in cleared if r.get_num_set() > 0]
    dense = tensorize_block(cleared, variants, 32, 16)
    r_dense = solve_blocks(dense[0][None], dense[1][None], dense[2][None],
                           beam_width=64)
    _s, n_slots = assign_slots(cleared)
    al, qu, sk, rs = tensorize_block(cleared, variants, 16, 16, slotted=True)
    r_slot = solve_blocks(al[None], qu[None], sk[None], beam_width=64,
                          resets=rs[None])
    assert int(r_slot.cost[0]) == int(r_dense.cost[0])
    assert list(r_slot.h1[0]) == list(r_dense.h1[0])


def test_wide_beam_over_2048_correct():
    """Beam widths above 2048 (a supported --phase-min-queue-size) must not
    overflow the packed sort key: the order field is sized from the width."""
    from hiphase_jax.phasing.beam import max_hets_for, order_bits_for
    assert order_bits_for(4096) == 14
    assert max_hets_for(4096) == (1 << 17) - 1
    rng = np.random.default_rng(7)
    variants, reads, _h1, _h2 = make_block(rng, 10, 12, flip_prob=0.15)
    ref = astar_solver(0, variants, reads, 1000, 3)
    h1, h2, cost, _pruned = run_beam_single(variants, reads, beam_width=2560)
    assert cost == ref.statistics.actual_cost
    assert (h1 == ref.haplotype_1 and h2 == ref.haplotype_2) or \
        (h1 == ref.haplotype_2 and h2 == ref.haplotype_1)
