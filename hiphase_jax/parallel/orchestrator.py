"""Block-stream orchestration (ref: src/main.rs:325-462).

The reference fans blocks out to a shared-memory thread pool and restores
order in the writers. Here the equivalent is a pipelined producer/consumer:

  producer (host)  — streaming block gen + per-block prepare (VCF/BAM I/O,
                     tensorization), optionally on a thread pool
  device           — fixed-shape batches through the variant-tiled beam
                     kernel; the ONLY shape axes are (batch, slot-bucket,
                     tile, width), so the whole run compiles a handful of
                     programs and a block of any length is a chain of tile
                     calls. Dispatch is asynchronous: a bounded pipeline of
                     in-flight batches overlaps host prepare with device
                     compute.
  consumer (host)  — finalize (backtrace, block split, haplotag) and feed
                     the ordered writers, which already reorder by index

Width schedule (ref: astar_phaser.rs:451-502, cli.rs:214-226): every batch
first runs at the fast width (``--beam-width``); any block whose result is
not provably optimal (pruned > 0) is re-solved at the full width
(``--phase-min-queue-size`` rounded up), so the default configuration honors
the reference's queue-size floor while paying full-width compute only where
it can matter.

Multi-chip: when more than one JAX device is visible, batches are sharded
over a 1-D data mesh (batch axis) with `jax.NamedSharding`; XLA partitions
the tile kernel automatically (blocks are independent, so there is no
cross-device communication inside the solve).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from hiphase_jax.phasing.astar import astar_solver
from hiphase_jax.phasing.beam import (
    PACK_PAD, assign_slots, beam_init_device, max_hets_for, pack_inputs,
    pack_job_stats, tensorize_block, tiles_backtrace_device,
    tiles_forward_packed, unpack_job_stats,
)
from hiphase_jax.phasing.phaser import BlockData, finalize_block
from hiphase_jax.core.variants import AlleleType, VariantType
from hiphase_jax.writers.phase_stats import PhaseStats

logger = logging.getLogger(__name__)

AMB = int(AlleleType.AMBIGUOUS)

# slot-bucket ladder: padded concurrent-read capacities. The slot axis counts
# *concurrent* reads (interval-packed), so even megabase blocks stay within a
# few hundred slots at WGS coverage; beyond the ladder → host A* fallback.
READ_BUCKETS = (128, 512, 1024)
# blocks per device batch for each slot bucket (every batch is padded to
# exactly this size so each (bucket, width) pair is ONE compiled program).
# BUCKET_BATCH, TILE and PIPELINE_DEPTH are not tuned for the current
# accelerator; re-sweep them with scripts/ablate_beam.py. A full batch's
# [B, W, R] int32 delta state is 32 MB at B=64, W=1024, R=128.
BUCKET_BATCH = {128: 64, 512: 16, 1024: 8}
# variant-tile size: the kernel's static column count
TILE = 128
# in-flight device batches before the oldest is forced to materialize
PIPELINE_DEPTH = 2


def _bucket_of(n: int, ladder: tuple[int, ...]) -> int | None:
    for b in ladder:
        if n <= b:
            return b
    return None


def _pad_width(w: int) -> int:
    """Round a width up to a multiple of 64 (sort/beam shapes stay regular)."""
    return max(64, ((w + 63) // 64) * 64)


def _stats_from_beam(data: BlockData, h1, h2, cost: int, pruned: int,
                     estimate: bool = False, min_queue_size: int = 1000,
                     queue_increment: int = 3) -> PhaseStats:
    phased = sum(1 for a, b in zip(h1, h2) if a != b)
    phased_snvs = sum(
        1 for i, (a, b) in enumerate(zip(h1, h2))
        if a != b and data.variants[i].variant_type == VariantType.SNV)
    skipped = sum(1 for a, b in zip(h1, h2) if a == b == AMB)
    hom = len(h1) - phased - skipped
    if estimate:
        # --stats-file semantics: estimated_cost is the root value of the
        # reference's right-to-left heuristic sweep, so cost_ratio compares
        # like-for-like (ref: astar_phaser.rs:246-292, phase_stats.rs:130-199)
        from hiphase_jax.phasing.astar import (
            MAX_SEGMENT_SIZE, _BlockReads, calculate_astar_heuristic,
        )
        reads = _BlockReads(data.read_segments, len(data.variants))
        heuristics, _bad = calculate_astar_heuristic(
            len(data.variants), MAX_SEGMENT_SIZE, reads, min_queue_size,
            queue_increment, [v.is_ignored for v in data.variants])
        estimated = heuristics[0]
    else:
        # no estimate requested: report the exact cost (cost_ratio 1.0);
        # pruned==0 still means provably optimal (the kernel discounts
        # discards that provably couldn't beat the result)
        estimated = cost
    return PhaseStats(pruned, estimated, cost, phased, phased_snvs, hom,
                      skipped)


@dataclass
class _Pending:
    data: BlockData
    packed: np.ndarray          # [rb, vp] int32 (see beam.pack_inputs)
    skip: np.ndarray            # [vp] bool


@dataclass
class _Job:
    """One dispatched device batch (async; arrays still on device)."""

    pending: list[_Pending]
    width: int
    skip_d: object              # [B, Vp] bool, DEVICE-resident
    stats: object               # device-packed (cost, hets, cnt, dmin)
    traces: list                # per tile: (parents, choices, cnt, dmin)
    escalated: bool = False


class BatchedDeviceSolver:
    """Buckets prepared blocks into fixed-shape padded batches and solves
    them on the accelerator; results flow back through an async pipeline."""

    def __init__(self, beam_width: int | None = None, batch_size: int = 32,
                 min_queue_size: int = 1000, queue_increment: int = 3,
                 tile: int = TILE, compute_estimates: bool = False):
        self.compute_estimates = compute_estimates
        # default: solve once at the full queue-size width (the reference's
        # effective search budget, ref: cli.rs:214-226); an explicit smaller
        # beam_width enables the fast-then-escalate schedule instead
        self.full_width = _pad_width(min_queue_size)
        self.fast_width = self.full_width if beam_width is None \
            else _pad_width(beam_width)
        self.full_width = max(self.fast_width, self.full_width)
        self.batch_cap = max(batch_size, 1)
        self.min_queue_size = min_queue_size
        self.queue_increment = queue_increment
        self.tile = tile
        self._buckets: dict[int, list[_Pending]] = {}
        self._esc_buckets: dict[int, list[_Pending]] = {}
        self._jobs: deque[_Job] = deque()
        # transfer economics telemetry (surfaced in bench device_mode)
        self.device_batches = 0
        self.device_transfers = 0
        # host wall time inside submit/drain: tensorize, dispatch, and
        # waiting on the device for materialized batches
        self.solve_seconds = 0.0
        self._sharding = None
        self.n_devices = 1
        try:
            import jax
            # local devices only: each host solves its own block shard, so
            # the batch axis never spans processes (multi-host result
            # movement is parallel.multihost's job, not the mesh's)
            devs = jax.local_devices()
            if len(devs) > 1:
                from jax.sharding import Mesh, NamedSharding, PartitionSpec
                self._mesh = Mesh(np.array(devs), ("data",))
                self._sharding = NamedSharding(self._mesh, PartitionSpec("data"))
                self.n_devices = len(devs)
        except Exception:  # pragma: no cover - no backend at all
            pass

    def _batch_size_for(self, rb: int) -> int:
        b = min(BUCKET_BATCH[rb], self.batch_cap)
        if self.n_devices > 1:
            b = max(((b + self.n_devices - 1) // self.n_devices) * self.n_devices,
                    self.n_devices)
        return b

    def submit(self, data: BlockData):
        """Queue one prepared block; returns finalized results whose device
        work has completed."""
        t0 = time.perf_counter()
        try:
            return self._submit(data)
        finally:
            self.solve_seconds += time.perf_counter() - t0

    def _submit(self, data: BlockData):
        nv = len(data.variants)
        _slots, n_slots = assign_slots(data.read_segments) \
            if data.read_segments else ([], 1)
        rb = _bucket_of(n_slots, READ_BUCKETS)
        if rb is None or nv > max_hets_for(self.full_width):
            # beyond the slot ladder (pathological coverage): host oracle
            result = astar_solver(data.phase_block.block_index, data.variants,
                                  data.read_segments, self.min_queue_size,
                                  self.queue_increment)
            return [finalize_block(data, result.haplotype_1,
                                   result.haplotype_2, result.statistics)]
        vp = ((max(nv, 1) + self.tile - 1) // self.tile) * self.tile
        alleles, quals, skip, resets = tensorize_block(
            data.read_segments, data.variants, rb, vp, slotted=True)
        bucket = self._buckets.setdefault(rb, [])
        bucket.append(_Pending(data, pack_inputs(alleles, quals, resets),
                               skip))
        out = []
        if len(bucket) >= self._batch_size_for(rb):
            self._dispatch(self._buckets.pop(rb), rb, self.fast_width)
        while len(self._jobs) > PIPELINE_DEPTH:
            out.extend(self._materialize(self._jobs.popleft()))
        return out

    def _device_put(self, arr):
        """One explicit host->device transfer (sharded when on a mesh).
        Always an actual device_put: downstream device-side slicing must
        see a committed device array, never re-upload a host array."""
        import jax
        if self._sharding is not None:
            return jax.device_put(arr, self._sharding)
        return jax.device_put(arr)

    def _dispatch(self, pending: list[_Pending], rb: int, width: int,
                  escalated: bool = False) -> None:
        """Pad a bucket to its fixed batch size and enqueue the tile chain
        on the device (non-blocking). The whole batch goes to the device in
        TWO transfers (packed inputs + skip) no matter how many tiles it
        spans; the zero-filled beam state is created on the device."""
        B = self._batch_size_for(rb)
        assert len(pending) <= B
        vp = max(p.packed.shape[1] for p in pending)
        # vp+1 columns: the trailing PACK_PAD column feeds the last tile's
        # lookahead reset plane (see beam.tiles_forward_packed)
        PK = np.full((B, rb, vp + 1), PACK_PAD, dtype=np.int32)
        S = np.ones((B, vp), dtype=bool)
        for i, p in enumerate(pending):
            v = p.packed.shape[1]
            PK[i, :, :v] = p.packed
            S[i, :v] = p.skip
        packed_d = self._device_put(PK)
        skip_d = self._device_put(S)
        self.device_batches += 1
        self.device_transfers += 2
        state = beam_init_device(B, rb, width, self._sharding)
        state, traces = tiles_forward_packed(state, packed_d, skip_d, width,
                                             self.tile)
        self._jobs.append(_Job(pending, width, skip_d,
                               pack_job_stats(state, traces), traces,
                               escalated))

    def _materialize(self, job: _Job):
        """Block on a dispatched batch (one stats transfer + one haplotype
        transfer), backtrace on device, and finalize; blocks that aren't
        provably optimal at the fast width re-enter at full width."""
        cost, _hets, pruned = unpack_job_stats(np.asarray(job.stats))
        h1a, h2a = tiles_backtrace_device(job.traces, job.skip_d, self.tile)

        out = []
        for i, p in enumerate(job.pending):
            blk_pruned = int(pruned[i])
            if (blk_pruned > 0 and not job.escalated
                    and self.full_width > job.width):
                rb = p.packed.shape[0]
                esc = self._esc_buckets.setdefault(rb, [])
                esc.append(p)
                if len(esc) >= self._batch_size_for(rb):
                    self._dispatch(self._esc_buckets.pop(rb), rb,
                                   self.full_width, escalated=True)
                continue
            nv = len(p.data.variants)
            bh1 = [int(x) for x in h1a[i, :nv]]
            bh2 = [int(x) for x in h2a[i, :nv]]
            stats = _stats_from_beam(p.data, bh1, bh2, int(cost[i]),
                                     blk_pruned,
                                     estimate=self.compute_estimates,
                                     min_queue_size=self.min_queue_size,
                                     queue_increment=self.queue_increment)
            out.append(finalize_block(p.data, bh1, bh2, stats))
        return out

    def drain(self):
        t0 = time.perf_counter()
        try:
            return self._drain()
        finally:
            self.solve_seconds += time.perf_counter() - t0

    def _drain(self):
        out = []
        for rb in sorted(self._buckets.keys()):
            self._dispatch(self._buckets.pop(rb), rb, self.fast_width)
        while self._jobs:
            out.extend(self._materialize(self._jobs.popleft()))
        # escalation rounds: anything re-queued solves at full width
        while self._esc_buckets or self._jobs:
            for rb in sorted(self._esc_buckets.keys()):
                self._dispatch(self._esc_buckets.pop(rb), rb, self.full_width,
                               escalated=True)
            while self._jobs:
                out.extend(self._materialize(self._jobs.popleft()))
        return out


def iter_prepared(block_iterator, prepare_fn, classify,
                  threads: int = 1, window: int = 40):
    """Yield (kind, item) per block preserving stream order, preparing up
    to ``window × threads`` blocks ahead on a pool (the reference's
    40×threads in-flight backpressure, ref: main.rs:328).

    ``classify(block)`` returns 'solve' (item = prepare_fn(block)),
    'unphased', or 'skip' (item = the block itself — multi-host streams
    use 'skip' for blocks assigned to other hosts, which still must flow
    through so the collective cadence lines up)."""
    if threads <= 1:
        for block in block_iterator:
            kind = classify(block)
            yield (kind, prepare_fn(block) if kind == "solve" else block)
        return

    max_inflight = window * threads
    with ThreadPoolExecutor(max_workers=threads) as pool:
        inflight = []  # list of (kind, future-or-block)
        for block in block_iterator:
            kind = classify(block)
            if kind == "solve":
                inflight.append(("solve", pool.submit(prepare_fn, block)))
            else:
                inflight.append((kind, block))
            while len(inflight) >= max_inflight:
                kind, item = inflight.pop(0)
                yield (kind, item.result() if kind == "solve" else item)
        for kind, item in inflight:
            yield (kind, item.result() if kind == "solve" else item)
