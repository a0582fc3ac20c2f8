"""Sharded data-parallel solve over an 8-device virtual CPU mesh."""

import numpy as np

from hiphase_jax.parallel.sharding import make_mesh, pad_batch, solve_blocks_sharded
from hiphase_jax.phasing.beam import solve_blocks


def _rand_block(rng, R=16, V=8):
    h1 = rng.integers(0, 2, V)
    alleles = np.where(rng.random((R, V)) < 0.5, h1, 1 - h1).astype(np.uint8)
    quals = rng.integers(10, 50, size=(R, V)).astype(np.int32)
    skip = np.zeros(V, dtype=bool)
    return alleles, quals, skip


def test_sharded_solve_matches_single_device():
    rng = np.random.default_rng(0)
    mesh = make_mesh()
    assert mesh.devices.size == 8  # conftest forces 8 virtual CPU devices
    blocks = [_rand_block(rng) for _ in range(13)]
    A, Q, S, n_real = pad_batch(blocks, mesh.devices.size)
    assert A.shape[0] == 16 and n_real == 13

    h1, h2, cost, hets, pruned, summary = solve_blocks_sharded(
        mesh, A, Q, S, beam_width=16)
    single = solve_blocks(A, Q, S, beam_width=16)
    assert np.array_equal(h1, single.h1)
    assert np.array_equal(h2, single.h2)
    assert np.array_equal(cost, single.cost)
    assert summary["blocks"] == 16
    assert summary["total_cost"] == int(single.cost.sum())
    # padding blocks are inert
    assert (cost[n_real:] == 0).all()


def test_graft_entry():
    import jax

    from __graft_entry__ import dryrun_multichip, entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    dryrun_multichip(8)


def test_multihost_block_sharding():
    """Deterministic round-robin host sharding covers every block once."""
    from hiphase_jax.parallel.multihost import blocks_for_host, shard_block_stream

    class B:
        def __init__(self, i):
            self.block_index = i

    blocks = [B(i) for i in range(17)]
    n_hosts = 4
    seen = []
    for h in range(n_hosts):
        mine = list(shard_block_stream(iter(blocks), n_hosts, h))
        seen.extend(b.block_index for b in mine)
        assert all(blocks_for_host(b.block_index, n_hosts, h) for b in mine)
    assert sorted(seen) == list(range(17))
