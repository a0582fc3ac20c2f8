"""Graph-WFA parity tests; scenarios and expected traversal sets mirror the
reference's wfa_graph.rs test suite (the traversed-node sets are the
ambiguity spec)."""

import pytest

from hiphase_jax.align.wfa_graph import WFAGraph, WFAGraphError
from hiphase_jax.core.variants import Variant


def ed(graph, seq):
    r = graph.edit_distance(seq)
    return r.score, r.traversed_nodes


def test_single_node():
    g = WFAGraph()
    v1 = bytes([0, 1, 2, 4, 5])
    g.add_node(v1, [])
    assert ed(g, v1) == (0, [0])
    assert g.edit_distance(bytes([0, 1, 3, 4, 5])).score == 1
    assert g.edit_distance(bytes([1, 2, 3, 5])).score == 2
    assert g.edit_distance(b"").score == 5


def test_two_node_single_path():
    v1 = bytes([0, 1, 2, 4, 5])
    for split in range(len(v1)):
        g = WFAGraph()
        g.add_node(v1[:split], [])
        g.add_node(v1[split:], [0])
        assert ed(g, v1) == (0, [0, 1])
        assert ed(g, bytes([0, 1, 3, 4, 5])) == (1, [0, 1])
        assert ed(g, bytes([1, 2, 3, 5])) == (2, [0, 1])
        assert ed(g, b"") == (5, [0, 1])


def test_basic_variant():
    g = WFAGraph()
    v1 = bytes([0, 1, 2, 4, 5])
    g.add_node(v1[:2], [])
    g.add_node(bytes([2]), [0])
    g.add_node(bytes([3]), [0])
    g.add_node(v1[3:], [1, 2])
    assert ed(g, v1) == (0, [0, 1, 3])
    assert ed(g, bytes([0, 1, 3, 4, 5])) == (0, [0, 2, 3])
    assert ed(g, bytes([1, 2, 3, 5])) == (2, [0, 1, 3])
    assert ed(g, b"") == (5, [0, 1, 2, 3])
    assert ed(g, bytes([0, 1, 4, 5])) == (1, [0, 1, 2, 3])


def test_overlapping_split():
    v1 = bytes([0, 1, 2, 3, 4, 5])
    g = WFAGraph()
    root = g.add_node(v1[0:1], [])
    s1 = g.add_node(v1[1:2], [root])
    s2 = g.add_node(v1[2:3], [s1])
    s3 = g.add_node(v1[3:4], [root, s2])
    tail = g.add_node(v1[4:], [s1, s3])
    assert ed(g, v1) == (0, [root, s1, s2, s3, tail])
    assert ed(g, bytes([0, 3, 4, 5])) == (0, [root, s3, tail])
    assert ed(g, bytes([0, 1, 4, 5])) == (0, [root, s1, tail])


def test_simple_snv():
    reference = b"AAA"
    variants = [Variant.new_snv(0, 1, b"A", b"C", 0, 1)]
    g, n2a = WFAGraph.from_reference_variants(reference, variants, 0, 3, 1000)
    assert g.num_nodes == 4
    assert ed(g, reference) == (0, [0, 2, 3])
    assert ed(g, b"ACA") == (0, [0, 1, 3])
    assert ed(g, b"AA") == (1, [0, 1, 2, 3])
    assert n2a.get(1) == [(0, 1)]
    assert n2a.get(2) == [(0, 0)]
    assert n2a.get(0) is None and n2a.get(3) is None


def test_multiple_variants():
    reference = b"AAAAA"
    variants = [Variant.new_snv(0, 1, b"A", b"C", 0, 1),
                Variant.new_snv(0, 3, b"A", b"C", 0, 1)]
    g, n2a = WFAGraph.from_reference_variants(reference, variants, 0, 5, 1000)
    assert g.num_nodes == 7
    assert ed(g, reference) == (0, [0, 2, 3, 5, 6])
    assert ed(g, b"ACAAA") == (0, [0, 1, 3, 5, 6])
    assert ed(g, b"AAACA") == (0, [0, 2, 3, 4, 6])
    assert ed(g, b"ACACA") == (0, [0, 1, 3, 4, 6])
    assert ed(g, b"AAA") == (2, [0, 1, 2, 3, 4, 5, 6])
    assert ed(g, b"AGAGA") == (2, [0, 1, 2, 3, 4, 5, 6])
    assert ed(g, b"GAAAA") == (1, [0, 2, 3, 5, 6])
    assert ed(g, b"ACAGAA") == (1, [0, 1, 3, 5, 6])
    assert n2a.get(1) == [(0, 1)]
    assert n2a.get(2) == [(0, 0)]
    assert n2a.get(4) == [(1, 1)]
    assert n2a.get(5) == [(1, 0)]


def test_overlapping_variants():
    reference = b"ACGTA"
    variants = [Variant.new_deletion(0, 1, 2, b"CG", b"C", 0, 1),
                Variant.new_deletion(0, 2, 2, b"GT", b"G", 0, 1)]
    g, n2a = WFAGraph.from_reference_variants(reference, variants, 0, 5, 1000)
    assert g.num_nodes == 7
    assert ed(g, reference) == (0, [0, 2, 4, 5, 6])
    assert ed(g, b"ACTA") == (0, [0, 1, 5, 6])
    assert ed(g, b"ACGA") == (0, [0, 2, 3, 6])
    assert ed(g, b"AGTA") == (1, [0, 1, 2, 4, 5, 6])
    assert ed(g, b"AA") == (2, [0, 1, 2, 3, 5, 6])
    assert n2a.get(1) == [(0, 1)]
    assert n2a.get(2) == [(0, 0)]
    assert n2a.get(3) == [(1, 1)]
    assert n2a.get(4) == [(1, 0)]


def test_identical_insertions():
    reference = b"ACGTA"
    variants = [Variant.new_insertion(0, 2, b"G", b"GT", 0, 1),
                Variant.new_insertion(1, 2, b"G", b"GT", 0, 1)]
    g, n2a = WFAGraph.from_reference_variants(reference, variants, 0, 5, 1000)
    assert g.num_nodes == 5
    assert ed(g, reference) == (0, [0, 3, 4])
    assert ed(g, b"ACGTTA") == (0, [0, 1, 2, 4])
    assert ed(g, b"ACGATA") == (1, [0, 1, 2, 3, 4])
    assert n2a.get(1) == [(0, 1)]
    assert n2a.get(2) == [(1, 1)]
    assert n2a.get(3) == [(0, 0), (1, 0)]  # both reference alleles


def test_multiallelic_indel():
    reference = b"ACGTA"
    variants = [Variant.new_indel(0, 2, 2, b"G", b"GTT", 1, 2)]
    g, n2a = WFAGraph.from_reference_variants(reference, variants, 0, 5, 1000)
    assert g.num_nodes == 5
    assert ed(g, reference) == (0, [0, 3, 4])
    assert ed(g, b"ACGA") == (0, [0, 1, 4])
    assert ed(g, b"ACGTTA") == (0, [0, 2, 4])
    assert ed(g, b"ACGGA") == (1, [0, 1, 3, 4])
    assert ed(g, b"ACGGTA") == (1, [0, 2, 3, 4])
    assert n2a.get(1) == [(0, 0)]
    assert n2a.get(2) == [(0, 1)]
    assert n2a.get(3) is None


def test_partial_reference():
    reference = b"AAAAAAA"
    variants = [Variant.new_snv(0, 3, b"A", b"C", 0, 1)]
    g, n2a = WFAGraph.from_reference_variants(reference, variants, 2, 5, 1000)
    assert g.num_nodes == 4
    assert ed(g, reference[2:5]) == (0, [0, 2, 3])
    assert ed(g, b"ACA") == (0, [0, 1, 3])
    assert ed(g, b"AA") == (1, [0, 1, 2, 3])


def test_complex_problem():
    reference = b"AACGTTGACGTCC"
    variants = [
        Variant.new_deletion(0, 3, 4, b"GTTG", b"G", 0, 1),
        Variant.new_deletion(0, 4, 2, b"TT", b"T", 0, 1),
        Variant.new_snv(0, 6, b"A", b"C", 1, 2),
    ]
    g, n2a = WFAGraph.from_reference_variants(reference, variants, 2, 12, 1000)
    assert g.num_nodes == 9
    assert ed(g, b"CGTTGACGTC") == (0, [0, 2, 4, 7, 8])
    assert ed(g, b"CGACGTC") == (0, [0, 1, 8])
    assert ed(g, b"CGTGACGTC") == (0, [0, 2, 3, 7, 8])
    assert ed(g, b"CGTTAACGTC") == (0, [0, 2, 4, 5, 8])
    assert ed(g, b"CGTTCACGTC") == (0, [0, 2, 4, 6, 8])
    assert ed(g, b"CGTAACGTC") == (0, [0, 2, 3, 5, 8])
    assert ed(g, b"CGTCACGTC") == (0, [0, 2, 3, 6, 8])
    assert ed(g, b"CGGACGTC") == (1, [0, 1, 2, 3, 7, 8])
    assert ed(g, b"CGTACGTC") == (1, [0, 1, 2, 3, 5, 6, 7, 8])
    assert n2a.get(1) == [(0, 1)]
    assert n2a.get(2) == [(0, 0)]
    assert n2a.get(3) == [(1, 1)]
    assert n2a.get(4) == [(1, 0)]
    assert n2a.get(5) == [(2, 0)]
    assert n2a.get(6) == [(2, 1)]


def test_variant_before_start():
    reference = b"NNNNNNNNNAACGTA"
    ref_start = 10
    variants = [Variant.new_snv(0, ref_start - 1, b"A", b"T", 0, 1),
                Variant.new_snv(0, ref_start, b"A", b"T", 0, 1)]
    g, n2a = WFAGraph.from_reference_variants(
        reference, variants, ref_start, len(reference), 1000)
    assert g.num_nodes == 4
    assert n2a.get(1) == [(1, 1)]
    assert n2a.get(2) == [(1, 0)]


def test_span_ref_end():
    reference = b"ACGTA"
    variants = [Variant.new_deletion(0, 3, 3, b"TAG", b"T", 0, 1)]
    g, n2a = WFAGraph.from_reference_variants(reference, variants, 0, 5, 1000)
    assert g.num_nodes == 1
    assert n2a == {}


def test_hom_variants():
    reference = b"AAAAA"
    variants = [Variant.new_snv(0, 3, b"A", b"C", 0, 1)]
    hom_variants = [Variant.new_snv(0, 1, b"A", b"C", 0, 1)]
    g, n2a = WFAGraph.from_reference_variants_with_hom(
        reference, variants, hom_variants, 0, 5, 1000)
    assert g.num_nodes == 7
    assert ed(g, b"AAAAA") == (0, [0, 2, 3, 5, 6])
    assert ed(g, b"ACAAA") == (0, [0, 1, 3, 5, 6])
    assert ed(g, b"ACACA") == (0, [0, 1, 3, 4, 6])
    assert ed(g, b"ACAA") == (1, [0, 1, 3, 4, 5, 6])
    assert n2a.get(1) is None  # hom branch: no allele mapping
    assert n2a.get(4) == [(0, 1)]
    assert n2a.get(5) == [(0, 0)]


def test_variant_at_start_and_end():
    reference = b"AAA"
    for pos, obs in [(0, b"CAA"), (2, b"AAC")]:
        variants = [Variant.new_snv(0, pos, b"A", b"C", 0, 1)]
        g, n2a = WFAGraph.from_reference_variants(reference, variants, 0, 3, 1000)
        assert g.num_nodes == 4
        assert ed(g, reference) == (0, [0, 2, 3])
        assert ed(g, obs) == (0, [0, 1, 3])
        assert ed(g, b"AA") == (1, [0, 1, 2, 3])


def test_max_edit_distance_error():
    g = WFAGraph(max_edit_distance=2)
    g.add_node(b"AAAAAAAAAA", [])
    with pytest.raises(WFAGraphError):
        g.edit_distance(b"TTTTTTTTTT")


def test_pruning_still_finds_exact():
    reference = b"ACGT" * 20
    variants = [Variant.new_snv(0, 17, b"A", b"G", 0, 1)]
    g, _ = WFAGraph.from_reference_variants(reference, variants, 0, 80, 1000)
    obs = bytearray(reference)
    obs[17] = ord("G")
    r = g.edit_distance_with_pruning(bytes(obs), 5)
    assert r.score == 0


def test_native_matches_python_wfa():
    """The C++ WFA must reproduce the Python implementation (score AND
    traversal sets) on randomized variant graphs and reads."""
    import numpy as np
    from hiphase_jax.io import native
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(0)
    for trial in range(30):
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
                variants.append(Variant.new_snv(0, pos, ref[pos:pos+1], alt, 0, 1))
            elif kind == "ins":
                ins = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                 size=int(rng.integers(1, 4))).astype(np.uint8).tobytes()
                variants.append(Variant.new_insertion(
                    0, pos, ref[pos:pos+1], ref[pos:pos+1] + ins, 0, 1))
            else:
                d = int(rng.integers(1, 4))
                variants.append(Variant.new_deletion(
                    0, pos, 1 + d, ref[pos:pos+1+d], ref[pos:pos+1], 0, 1))
            pos += int(rng.integers(6, 14))
        g, _ = WFAGraph.from_reference_variants(ref, variants, 0, length, 1000)
        # random read: mutate the reference a bit
        obs = bytearray(ref)
        for j in rng.choice(length, size=int(rng.integers(0, 4)), replace=False):
            obs[j] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        obs = bytes(obs)
        r_py = g._edit_distance_python(obs, 10**9)
        r_nat = g.edit_distance(obs)
        assert r_nat.score == r_py.score, trial
        assert r_nat.traversed_nodes == r_py.traversed_nodes, trial


def test_native_build_matches_python():
    """C++ graph construction must reproduce the Python builder exactly
    (sequences, edges, allele maps) on randomized windows with homs and
    multi-allelics."""
    import numpy as np
    from hiphase_jax.io import native
    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(5)
    for trial in range(30):
        length = 80
        ref = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                         size=length).astype(np.uint8).tobytes()
        hets, homs = [], []
        pos = 4
        while pos < length - 10:
            kind = rng.choice(["snv", "del", "multi", "hom"])
            if kind == "snv":
                alt = bytes([rng.choice([b for b in b"ACGT" if b != ref[pos]])])
                hets.append(Variant.new_snv(0, pos, ref[pos:pos+1], alt, 0, 1))
            elif kind == "del":
                d = int(rng.integers(1, 4))
                hets.append(Variant.new_deletion(
                    0, pos, 1 + d, ref[pos:pos+1+d], ref[pos:pos+1], 0, 1))
            elif kind == "multi":
                hets.append(Variant.new_indel(
                    0, pos, 2, b"G", b"GTT", 1, 2))
            else:
                alt = bytes([rng.choice([b for b in b"ACGT" if b != ref[pos]])])
                homs.append(Variant.new_snv(0, pos, ref[pos:pos+1], alt, 0, 1))
            pos += int(rng.integers(5, 12))
        rs = int(rng.integers(0, 3))
        re_ = length - int(rng.integers(0, 3))
        g_n, n2a_n = WFAGraph.from_reference_variants_with_hom(
            ref, hets, homs, rs, re_, 1000)
        g_p, n2a_p = WFAGraph._from_reference_variants_python(
            ref, hets, homs, rs, re_, 1000)
        assert g_n.sequences == g_p.sequences, trial
        assert g_n.edges == g_p.edges, trial
        assert n2a_n == n2a_p, trial
