"""Device-mesh data parallelism for the phasing engine.

The reference's entire parallel story is a shared-memory thread pool over
independent phase blocks (ref: src/main.rs:325-462). The device equivalent is
data-parallel sharding of padded block batches over a 1-D `jax.sharding.Mesh`
("data" axis): every chip solves its shard of blocks with the variant-tiled
beam kernel. Blocks are independent, so there are no collectives inside the
solve; inputs are placed with `NamedSharding(mesh, P("data"))` and XLA's
SPMD partitioner splits the tile program over the batch axis automatically.

Multi-host: the same kernel runs under `jax.distributed.initialize`; see
`hiphase_jax.parallel.multihost` for the host-sharded block stream and the
host-0 result replay.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hiphase_jax.phasing.beam import (
    beam_init_device, pack_inputs, pack_job_stats, tiles_backtrace_device,
    tiles_forward_packed, unpack_job_stats,
)


def make_mesh(num_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), ("data",))


def solve_blocks_sharded(mesh: Mesh, alleles: np.ndarray, quals: np.ndarray,
                         skip: np.ndarray, beam_width: int = 256,
                         resets: np.ndarray | None = None,
                         tile: int | None = None):
    """Solve a padded batch of blocks data-parallel over the mesh.

    The batch dimension must be divisible by the mesh size (pad with empty
    blocks: all-NoOverlap reads, skip all-true). Returns
    (h1, h2, cost, hets, pruned, summary-dict) as host arrays.
    """
    n = mesh.devices.size
    B, R, V = alleles.shape
    assert B % n == 0, f"batch {B} not divisible by mesh size {n}"
    sharding = NamedSharding(mesh, P("data"))
    if resets is None:
        resets = np.zeros((B, R, V), dtype=bool)

    T = V if tile is None else int(tile)
    Vp = ((V + T - 1) // T) * T
    if Vp > V:
        pad = ((0, 0), (0, 0), (0, Vp - V))
        alleles = np.pad(alleles, pad, constant_values=3)
        quals = np.pad(quals, pad)
        resets = np.pad(resets, pad)
        skip = np.pad(skip, ((0, 0), (0, Vp - V)), constant_values=True)

    from hiphase_jax.phasing.beam import PACK_PAD
    packed = np.pad(pack_inputs(alleles, quals, resets),
                    ((0, 0), (0, 0), (0, 1)), constant_values=PACK_PAD)
    packed_d = jax.device_put(packed, sharding)
    skip_d = jax.device_put(skip, sharding)
    state = beam_init_device(B, R, beam_width, sharding)
    state, traces = tiles_forward_packed(state, packed_d, skip_d,
                                         beam_width, T)
    cost, hets, pruned = unpack_job_stats(
        np.asarray(pack_job_stats(state, traces)))
    h1, h2 = tiles_backtrace_device(traces, skip_d, T)
    h1, h2 = h1[:, :V], h2[:, :V]
    summary = {
        "total_cost": int(cost.sum()),
        "total_hets": int(hets.sum()),
        "total_pruned": int(pruned.sum()),
        "blocks": B,
    }
    return h1, h2, cost, hets, pruned, summary


def pad_batch(blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
              multiple: int):
    """Stack per-block (alleles, quals, skip) tuples and pad the batch
    dimension up to a multiple of the mesh size with inert blocks."""
    assert blocks
    R, V = blocks[0][0].shape
    B = len(blocks)
    pad = (-B) % multiple
    A = np.full((B + pad, R, V), 3, dtype=np.uint8)
    Q = np.zeros((B + pad, R, V), dtype=np.int32)
    S = np.ones((B + pad, V), dtype=bool)
    for i, (a, q, s) in enumerate(blocks):
        A[i], Q[i], S[i] = a, q, s
    return A, Q, S, B
