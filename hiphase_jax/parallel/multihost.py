"""Multi-host execution support.

The reference's distribution story is a single-process thread pool
(SURVEY.md §2.9); this build's counterpart is the JAX multi-host runtime:

  * every host runs the same program under `jax.distributed.initialize`
    (DCN bootstrap);
  * the block stream is deterministically sharded by host — host h takes
    blocks with ``block_index % num_hosts == h`` — so no coordination is
    needed while producing (each host reads the shared BAM/VCF inputs and
    the replicated reference FASTA);
  * each host solves its shard with its addressable devices (the solve is
    embarrassingly parallel over blocks, so no cross-host collective runs
    inside it);
  * per-block results live on the host that solved them; the ordered
    writers run on host 0 only. `ResultReplay` moves results there: hosts
    serialize finished (PhaseResult, HaplotagResult) pairs and exchange
    them through fixed-cadence `process_allgather` rounds (every
    ``gather_every`` global blocks plus one final round — a deterministic
    collective schedule every process hits identically), and host 0 replays
    the union into its in-order drain (the ordered writers already reorder
    by block_index).

Single-host multi-chip needs none of this — `parallel.sharding` covers it.
The gather plumbing is validated by a real 2-process CPU
`jax.distributed.initialize` run in tests/test_multihost.py, whose host-0
output must byte-equal the single-process run.
"""

from __future__ import annotations

import pickle

import jax
import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bootstrap the multi-host runtime (no-op when single-process).
    On a cluster that JAX detects (SLURM, Open MPI, cloud metadata), bare
    `jax.distributed.initialize()` fills in all three arguments."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)


def host_count() -> int:
    return jax.process_count()


def host_index() -> int:
    return jax.process_index()


def blocks_for_host(block_index: int, n_hosts: int | None = None,
                    host: int | None = None) -> bool:
    """Deterministic round-robin block→host assignment."""
    n = n_hosts if n_hosts is not None else jax.process_count()
    h = host if host is not None else jax.process_index()
    return block_index % n == h


def shard_block_stream(block_iterator, n_hosts: int | None = None,
                       host: int | None = None):
    """Yield only this host's blocks from the global (renumbered) stream."""
    for block in block_iterator:
        if blocks_for_host(block.block_index, n_hosts, host):
            yield block


def allgather_bytes(payload: bytes) -> list[bytes]:
    """Gather one bytes blob from every process (collective: every process
    must call with its own payload; returns all, ordered by process index).

    Two `process_allgather` rounds: lengths, then the zero-padded blobs —
    the DCN analog of the reference's mpsc result channel
    (ref: src/main.rs:333)."""
    from jax.experimental import multihost_utils

    lens = np.asarray(multihost_utils.process_allgather(
        np.asarray(len(payload), dtype=np.int64))).reshape(-1)
    mx = max(int(lens.max()), 1)
    buf = np.zeros(mx, dtype=np.uint8)
    if payload:
        buf[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(buf))
    gathered = gathered.reshape(len(lens), mx)
    return [gathered[i, :int(lens[i])].tobytes() for i in range(len(lens))]


class ResultReplay:
    """Fixed-cadence exchange of per-block results with replay on host 0.

    Usage on every host, with an identical global block stream:

        replay = ResultReplay(gather_every=64)
        for block in stream:                       # the GLOBAL stream
            if blocks_for_host(block.block_index):
                results = solve(block)             # this host's work
                replay.stash(results)
            for r in replay.tick():                # host 0: replayed results
                emit(r)
        for r in replay.finish():
            emit(r)

    `tick` fires a collective every `gather_every` global blocks, so all
    processes reach the same allgather schedule regardless of which blocks
    they solved. On hosts ≠ 0 the returned list is always empty.
    """

    def __init__(self, gather_every: int = 64):
        self.gather_every = max(gather_every, 1)
        self._seen = 0
        self._local: list = []

    def stash(self, result) -> None:
        self._local.append(result)

    def _exchange(self) -> list:
        payload = pickle.dumps(self._local, protocol=pickle.HIGHEST_PROTOCOL)
        self._local = []
        blobs = allgather_bytes(payload)
        if jax.process_index() != 0:
            return []
        out = []
        for blob in blobs:
            out.extend(pickle.loads(blob))
        return out

    def tick(self) -> list:
        """Count one global block; exchange when the window fills."""
        self._seen += 1
        if self._seen % self.gather_every == 0:
            return self._exchange()
        return []

    def finish(self) -> list:
        """Final exchange (always runs, even with an empty tail)."""
        return self._exchange()
