"""Edit-distance tests (ref: src/sequence_alignment.rs tests) + batch parity."""

import numpy as np

from hiphase_jax.align.edit_distance import edit_distance, edit_distance_batch


def test_edit_distance_basic():
    assert edit_distance(b"ACGT", b"ACGT") == 0
    assert edit_distance(b"ACGT", b"ACCT") == 1
    assert edit_distance(b"ACGT", b"ACT") == 1
    assert edit_distance(b"ACGT", b"AACGT") == 1
    assert edit_distance(b"", b"ACGT") == 4
    assert edit_distance(b"ACGT", b"") == 4
    assert edit_distance(b"kitten", b"sitting") == 3
    assert edit_distance(b"flaw", b"lawn") == 2


def test_edit_distance_random_vs_naive():
    rng = np.random.default_rng(0)

    def naive(a, b):
        n, m = len(a), len(b)
        dp = [[0] * (m + 1) for _ in range(n + 1)]
        for i in range(n + 1):
            dp[i][0] = i
        for j in range(m + 1):
            dp[0][j] = j
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                dp[i][j] = min(dp[i - 1][j] + 1, dp[i][j - 1] + 1,
                               dp[i - 1][j - 1] + (a[i - 1] != b[j - 1]))
        return dp[n][m]

    for _ in range(50):
        la, lb = rng.integers(0, 20, size=2)
        a = bytes(rng.choice(list(b"ACGT"), size=la))
        b = bytes(rng.choice(list(b"ACGT"), size=lb))
        assert edit_distance(a, b) == naive(a, b)


def test_edit_distance_batch_parity():
    rng = np.random.default_rng(1)
    B, Lq, Lt = 32, 24, 30
    qlens = rng.integers(0, Lq + 1, size=B).astype(np.int32)
    tlens = rng.integers(0, Lt + 1, size=B).astype(np.int32)
    queries = rng.choice(list(b"ACGT"), size=(B, Lq)).astype(np.uint8)
    targets = rng.choice(list(b"ACGT"), size=(B, Lt)).astype(np.uint8)
    out = edit_distance_batch(queries, qlens, targets, tlens)
    for i in range(B):
        expected = edit_distance(bytes(queries[i, :qlens[i]]),
                                 bytes(targets[i, :tlens[i]]))
        assert out[i] == expected, i
