"""Native host beam engine — the CPU production path.

Same lockstep-beam formulation as the device kernel (`phasing/beam.py`), run
by the C++ solver in ``native/hiphase_native.cc`` (`hn_beam_solve_batch`)
with per-column active lists and a thread pool across blocks. Used when no
healthy accelerator is available (see `parallel.engine_select`) and as the
low-latency engine for small runs: the result is bit-identical to the
device engine by construction — both rank candidates with the identical
packed key and both escalate any block whose fast-width result is not
provably optimal to the full ``--phase-min-queue-size`` width, and a
provably-optimal (pruned == 0) narrow-width solve is positionally identical
to the wide solve (the viable cost-prefix of the beam is width-invariant).

Ref: src/astar_phaser.rs (search semantics), src/main.rs:325-462 (the
reference's thread-pool orchestration this replaces).
"""

from __future__ import annotations

import numpy as np

from hiphase_jax.io import native
from hiphase_jax.phasing.astar import astar_solver
from hiphase_jax.phasing.phaser import BlockData, finalize_block

# Escalation schedule: every block first solves at this width; blocks whose
# result is not provably optimal re-solve at the full queue-size width.
FAST_WIDTH = 64


def _pad_width(w: int) -> int:
    return max(64, ((w + 63) // 64) * 64)


class NativeBeamSolver:
    """Buckets prepared blocks into batches for the native C++ beam.

    Mirrors `parallel.orchestrator.BatchedDeviceSolver`'s submit/drain
    interface so the CLI can swap engines freely.
    """

    def __init__(self, beam_width: int | None = None, batch_size: int = 32,
                 min_queue_size: int = 1000, queue_increment: int = 3,
                 threads: int = 2, compute_estimates: bool = False):
        # widths must match BatchedDeviceSolver exactly (mid-run engine
        # switching relies on bit-identical results): an explicit
        # --beam-width above the queue floor raises the full width too
        self.full_width = _pad_width(min_queue_size)
        if beam_width is None:
            self.fast_width = min(FAST_WIDTH, self.full_width)
        else:
            self.fast_width = _pad_width(beam_width)
            self.full_width = max(self.full_width, self.fast_width)
        self.min_queue_size = min_queue_size
        self.queue_increment = queue_increment
        self.threads = max(threads, 1)
        self.compute_estimates = compute_estimates
        self.batch_cap = max(batch_size, 1)
        self._pending: list[BlockData] = []
        self.total_expansions = 0
        self.solve_seconds = 0.0

    def available(self) -> bool:
        return native.available()

    def _max_nv(self) -> int:
        # ranking-key capacity at the full width (see hn_beam_solve_batch)
        from hiphase_jax.phasing.beam import max_hets_for
        return max_hets_for(self.full_width)

    def submit(self, data: BlockData):
        if len(data.variants) > self._max_nv():
            result = astar_solver(data.phase_block.block_index, data.variants,
                                  data.read_segments, self.min_queue_size,
                                  self.queue_increment)
            return [finalize_block(data, result.haplotype_1,
                                   result.haplotype_2, result.statistics)]
        self._pending.append(data)
        if len(self._pending) >= self.batch_cap:
            return self._solve_batch()
        return []

    def drain(self):
        return self._solve_batch()

    def _solve_batch(self):
        pending, self._pending = self._pending, []
        if not pending:
            return []
        import time
        t0 = time.perf_counter()

        nv = np.array([len(d.variants) for d in pending], dtype=np.int32)
        skip_off = np.zeros(len(pending) + 1, dtype=np.int64)
        np.cumsum(nv, out=skip_off[1:])
        skip = np.zeros(int(skip_off[-1]), dtype=np.uint8)
        for i, d in enumerate(pending):
            base = skip_off[i]
            for j, v in enumerate(d.variants):
                if v.is_ignored:
                    skip[base + j] = 1

        read_off = np.zeros(len(pending) + 1, dtype=np.int64)
        read_off[1:] = np.cumsum([len(d.read_segments) for d in pending])
        total_reads = int(read_off[-1])
        seg_start = np.empty(total_reads, dtype=np.int32)
        seg_lens = np.empty(total_reads, dtype=np.int64)
        blobs_a: list[np.ndarray] = []
        blobs_q: list[np.ndarray] = []
        r = 0
        for d in pending:
            for rs in d.read_segments:
                seg_start[r] = rs.start
                seg_lens[r] = len(rs.alleles)
                blobs_a.append(rs.alleles)
                blobs_q.append(rs.quals)
                r += 1
        seg_off = np.zeros(total_reads + 1, dtype=np.int64)
        np.cumsum(seg_lens, out=seg_off[1:])
        alleles = (np.concatenate(blobs_a) if blobs_a
                   else np.empty(0, dtype=np.uint8))
        quals = (np.concatenate(blobs_q) if blobs_q
                 else np.empty(0, dtype=np.uint8))

        out = native.beam_solve_batch_native(
            nv, skip_off, skip, read_off, seg_start, seg_off, alleles, quals,
            self.fast_width, self.full_width, self.threads)
        if out is None:  # native unavailable: host-oracle fallback
            results = []
            for d in pending:
                res = astar_solver(d.phase_block.block_index, d.variants,
                                   d.read_segments, self.min_queue_size,
                                   self.queue_increment)
                results.append(finalize_block(d, res.haplotype_1,
                                              res.haplotype_2,
                                              res.statistics))
            return results

        h1, h2, cost, hets, pruned, expansions = out
        self.total_expansions += int(expansions.sum())
        results = []
        from hiphase_jax.parallel.orchestrator import _stats_from_beam
        for i, d in enumerate(pending):
            sl = slice(int(skip_off[i]), int(skip_off[i + 1]))
            bh1 = [int(x) for x in h1[sl]]
            bh2 = [int(x) for x in h2[sl]]
            stats = _stats_from_beam(d, bh1, bh2, int(cost[i]),
                                     int(pruned[i]),
                                     estimate=self.compute_estimates,
                                     min_queue_size=self.min_queue_size,
                                     queue_increment=self.queue_increment)
            results.append(finalize_block(d, bh1, bh2, stats))
        self.solve_seconds += time.perf_counter() - t0
        return results
