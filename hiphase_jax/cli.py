"""CLI and orchestration (ref: src/cli.rs, src/main.rs).

Flag surface and defaults mirror the reference. The orchestrator pulls phase
blocks from the streaming iterator, solves them (host A* oracle, native
host beam, or the device beam engine; ``--engine device`` batches blocks onto
the accelerator), and feeds
results in block-index order into the ordered writers.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from hiphase_jax.version import full_version

logger = logging.getLogger("hiphase_jax")

U64_MAX = 2**63 - 1

# run telemetry for benches/tests: resolved engine, solver counters
LAST_RUN_STATS: dict = {}


def build_parser() -> argparse.ArgumentParser:
    """Flag surface (ref: cli.rs:28-239)."""
    p = argparse.ArgumentParser(
        prog="hiphase-jax",
        description="Joint phaser for small, structural, and tandem-repeat "
                    "variants from HiFi BAMs, with a JAX device engine")
    p.add_argument("--version", action="version", version=full_version())
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="Enable verbose output (-vv for trace)")

    io = p.add_argument_group("Input/Output")
    io.add_argument("--bam", dest="bams", action="append", default=[],
                    required=True, help="Input alignment file (indexed BAM)")
    io.add_argument("--output-bam", dest="output_bams", action="append",
                    default=[], help="Output haplotagged alignment file")
    io.add_argument("--vcf", dest="vcfs", action="append", default=[],
                    required=True, help="Input variant file (indexed vcf.gz)")
    io.add_argument("--output-vcf", dest="output_vcfs", action="append",
                    default=[], required=True, help="Output phased variant file")
    io.add_argument("-r", "--reference", required=True,
                    help="Reference FASTA file")
    io.add_argument("-s", "--sample-name", dest="sample_names",
                    action="append", default=[],
                    help="Sample name to phase (default: first in VCF)")
    io.add_argument("--ignore-read-groups", action="store_true",
                    help="Ignore BAM read groups (single sample only)")
    io.add_argument("--summary-file", help="Summary statistics output (tsv/csv)")
    io.add_argument("--stats-file", help="Algorithm statistics output (tsv/csv)")
    io.add_argument("--blocks-file", help="Phase block output (tsv/csv)")
    io.add_argument("--haplotag-file", help="Haplotag output (tsv/csv)")
    io.add_argument("--io-threads", type=int, default=None,
                    help="I/O threads (default: min(threads, 4))")
    io.add_argument("--csi-index", action="store_true",
                    help="Use CSI indexes for outputs")

    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Number of host threads")
    p.add_argument("--engine", choices=["auto", "device", "native", "astar"],
                   default="auto",
                   help="Phasing engine: 'device' = batched beam engine on "
                        "the accelerator JAX finds (refuses an implicit CPU "
                        "backend); "
                        "'native' = C++ host beam engine; 'astar' = host A* "
                        "oracle; 'auto' (default) = device when a healthy "
                        "accelerator answers a probe, else native, else "
                        "astar. All engines produce identical output.")
    p.add_argument("--beam-width", type=int, default=None,
                   help="Device engine fast beam width; blocks not provably "
                        "optimal at this width re-solve at the full "
                        "--phase-min-queue-size width (default: solve "
                        "directly at the full width)")
    p.add_argument("--batch-size", type=int, default=64,
                   help="Device engine blocks per device batch (cap on "
                        "the per-bucket defaults)")

    filt = p.add_argument_group("Variant Filtering")
    filt.add_argument("--min-vcf-qual", dest="min_variant_quality", type=int,
                      default=0, help="Minimum GQ to include a variant")
    filt.add_argument("--min-mapq", dest="min_mapping_quality", type=int,
                      default=5, help="Minimum MAPQ to include a read")
    filt.add_argument("--min-matched-alleles", type=int, default=2,
                      help="Minimum matched alleles for a phasing read")

    bg = p.add_argument_group("Phase Block Generation")
    bg.add_argument("--min-spanning-reads", type=int, default=1,
                    help="Minimum reads to span two loci to join them")
    bg.add_argument("--no-supplemental-joins", dest="disable_supplemental_joins",
                    action="store_true",
                    help="Disable supplemental-mapping block joins")
    bg.add_argument("--phase-singletons", action="store_true",
                    help="Phase blocks with a single variant")

    aa = p.add_argument_group("Allele Assignment")
    aa.add_argument("--max-reference-buffer", dest="reference_buffer",
                    type=int, default=15,
                    help="Reference context around alleles (bp)")
    aa.add_argument("--disable-global-realignment", action="store_true",
                    help="Local realignment only")
    aa.add_argument("--global-realignment-max-ed", dest="max_edit_distance",
                    type=int, default=500,
                    help="Max edit distance before local fallback")
    aa.add_argument("--global-pruning-distance", dest="wfa_prune_distance",
                    type=int, default=500,
                    help="WFA wavefront prune distance (0 = off)")
    aa.add_argument("--max-global-failure-ratio", dest="global_failure_ratio",
                    type=float, default=0.5,
                    help="Failure ratio before block-level local fallback")
    aa.add_argument("--global-failure-count", dest="global_failure_minimum",
                    type=int, default=50,
                    help="Minimum failures before the ratio applies")
    aa.add_argument("--wfa-engine", choices=["host", "device"],
                    default="host",
                    help="Graph-WFA aligner for global realignment: 'host' "
                         "(C++ wavefront) or 'device' (accelerator banded-DP"
                         " kernel; uncertifiable reads fall back per-read)")

    ph = p.add_argument_group("Phasing")
    ph.add_argument("--phase-min-queue-size", dest="phase_min_queue_size",
                    type=int, default=1000, help="Minimum queue/beam size")
    ph.add_argument("--phase-queue-increment", dest="phase_queue_increment",
                    type=int, default=3,
                    help="Queue growth per variant")

    dbg = p.add_argument_group("Debug")
    dbg.add_argument("--skip", type=int, default=0, help=argparse.SUPPRESS)
    dbg.add_argument("--take", type=int, default=0, help=argparse.SUPPRESS)
    return p


def check_settings(args) -> None:
    """Validation + sentinel rewrites (ref: cli.rs:324-420)."""
    from hiphase_jax.io.bgzf import is_bgzf

    for path in args.bams + args.vcfs + [args.reference]:
        if not os.path.exists(path):
            raise SystemExit(f"File does not exist: {path}")
    for vcf in args.vcfs:
        if not is_bgzf(vcf):
            raise SystemExit(f"VCF file is not bgzip-compressed: {vcf}")
        if not (os.path.exists(vcf + ".tbi") or os.path.exists(vcf + ".csi")):
            raise SystemExit(f"VCF index not found for: {vcf}")
    for bam in args.bams:
        if bam.endswith(".cram"):
            if not os.path.exists(bam + ".crai"):
                raise SystemExit(f"CRAM index not found for: {bam}")
        elif not (os.path.exists(bam + ".bai")
                  or os.path.exists(bam + ".csi")):
            raise SystemExit(f"BAM index not found for: {bam}")

    if len(args.vcfs) != len(args.output_vcfs):
        raise SystemExit("--vcf and --output-vcf must be specified the same "
                         "number of times")
    if args.output_bams and len(args.bams) != len(args.output_bams):
        raise SystemExit("--bam and --output-bam must be specified the same "
                         "number of times")

    # sentinel rewrites (ref: cli.rs:349-354)
    if args.take == 0:
        args.take = U64_MAX
    if args.wfa_prune_distance == 0:
        args.wfa_prune_distance = U64_MAX
    args.min_spanning_reads = max(args.min_spanning_reads, 1)
    args.min_matched_alleles = max(args.min_matched_alleles, 1)
    if args.io_threads is None:
        args.io_threads = min(args.threads, 4)


def global_realignment_config(args):
    """(ref: cli.rs:302-313)"""
    if args.disable_global_realignment:
        return None
    from hiphase_jax.phasing.read_parsing import GlobalRealignmentConfig
    return GlobalRealignmentConfig(
        max_edit_distance=args.max_edit_distance,
        wfa_prune_distance=args.wfa_prune_distance,
        global_failure_ratio=args.global_failure_ratio,
        global_failure_minimum=args.global_failure_minimum,
        wfa_engine=args.wfa_engine)


def main(argv=None) -> int:
    try:
        return _main(argv)
    except SystemExit:
        raise
    except Exception as e:
        # fail fast with a clean message, like the reference's error!+exit
        logger.error("%s", e)
        if os.environ.get("HIPHASE_TRACEBACK"):
            raise
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    level = (logging.DEBUG if args.verbose >= 1 else logging.INFO)
    logging.basicConfig(
        level=level,
        format="[%(asctime)s.%(msecs)03d %(levelname)s %(name)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    logger.info("hiphase-jax version %s", full_version())
    check_settings(args)

    from hiphase_jax.core.reference_genome import ReferenceGenome
    from hiphase_jax.io.vcf import get_vcf_samples
    from hiphase_jax.phasing.block_gen import (
        MultiPhaseBlockIterator, PhaseBlockIterator, get_sample_bams)
    from hiphase_jax.phasing.phaser import create_unphased_result, solve_block
    from hiphase_jax.writers.bam_writer import OrderedBamWriter
    from hiphase_jax.writers.block_stats import BlockStatsCollector
    from hiphase_jax.writers.haplotag_writer import HaplotagWriter
    from hiphase_jax.writers.phase_stats import StatsWriter
    from hiphase_jax.writers.vcf_writer import OrderedVcfWriter

    command_line = " ".join(sys.argv if argv is None else ["hiphase-jax"] + list(argv))

    sample_names = list(args.sample_names)
    if not sample_names:
        all_names = get_vcf_samples(args.vcfs[0])
        if len(all_names) > 1:
            logger.warning("Multi-sample VCF detected, but sample name was "
                           "not provided. Assuming name is %r.", all_names[0])
        sample_names.append(all_names[0])
    if args.ignore_read_groups and len(sample_names) > 1:
        raise SystemExit("--ignore-read-groups cannot be used with multiple "
                         "sample names")

    # resolve --engine auto in the background (the device probe may need to
    # initialize the JAX backend, ~1-2 s) while the reference loads
    from concurrent.futures import ThreadPoolExecutor
    from hiphase_jax.parallel.engine_select import choose_engine
    _probe_pool = ThreadPoolExecutor(max_workers=1)
    engine_future = _probe_pool.submit(choose_engine, args.engine)
    # the worker exits once the probe resolves; without this, library
    # callers invoking main() repeatedly would park a thread per run
    _probe_pool.shutdown(wait=False)

    # the reference load, the BAM span scan, and the first VCF chrom scan
    # are independent native/IO tasks; loading the reference on a thread
    # overlaps it with block-iterator priming below (~the entire FASTA load
    # disappears from the critical path; ref loads serially in main.rs:240)
    logger.info("Loading reference genome...")
    # daemon loader thread: a fast failure elsewhere (bad index, malformed
    # VCF) must not block interpreter shutdown behind a multi-GB FASTA read
    import threading as _threading

    class _RefFuture:
        def __init__(self, path):
            self._box = {}
            self._t = _threading.Thread(target=self._run, args=(path,),
                                        daemon=True)
            self._t.start()

        def _run(self, path):
            try:
                self._box["ok"] = ReferenceGenome.from_fasta(path)
            except BaseException as e:
                self._box["err"] = e

        def result(self):
            self._t.join()
            if "err" in self._box:
                raise self._box["err"]
            return self._box["ok"]

    ref_future = _RefFuture(args.reference)
    reference_genome = None
    if any(b.endswith(".cram") for b in args.bams) or \
            any(b.endswith(".cram") for b in args.output_bams):
        # CRAM containers encode/decode against the reference; it must be
        # registered before any alignment file is opened
        reference_genome = ref_future.result()
        from hiphase_jax.io.bam import set_cram_reference
        set_cram_reference(reference_genome)

    # per-sample BAM assignment + block iterators (ref: main.rs:77-141)
    sample_to_bams: dict[str, list[str]] = {}
    sample_to_output_bams: dict[str, list[str]] = {}
    block_iterators = []
    for sample_name in sample_names:
        if args.ignore_read_groups:
            sample_bams = list(args.bams)
            bam_indices = list(range(len(args.bams)))
        else:
            sample_bams = get_sample_bams(args.bams, sample_name)
            bam_indices = [args.bams.index(b) for b in sample_bams]
        sample_to_bams[sample_name] = sample_bams
        if args.output_bams:
            sample_to_output_bams[sample_name] = [
                args.output_bams[i] for i in bam_indices]
        block_iterators.append(PhaseBlockIterator(
            args.vcfs, sample_bams, sample_name,
            min_quality=args.min_variant_quality,
            min_mapq=args.min_mapping_quality,
            min_spanning_reads=args.min_spanning_reads,
            allow_supplemental_joins=not args.disable_supplemental_joins))
    block_iterator = MultiPhaseBlockIterator(block_iterators)

    if reference_genome is None:
        reference_genome = ref_future.result()
        from hiphase_jax.io.bam import set_cram_reference
        set_cram_reference(reference_genome)

    # --engine auto never blocks on the device probe: when the native
    # engine is available, the run starts on it immediately and *upgrades*
    # to the device engine mid-run if the probe resolves in its favor — all
    # engines produce identical bytes, so switching is output-invariant.
    upgrade_future = None
    from hiphase_jax.io import native as _native_lib
    if args.engine == "auto" and _native_lib.available():
        engine = "native"
        upgrade_future = engine_future
    else:
        engine = engine_future.result()
    if engine != args.engine:
        logger.info("Engine 'auto' resolved to %r%s", engine,
                    " (device probe pending; will upgrade if it wins)"
                    if upgrade_future is not None else "")

    # multi-host: every process runs the same program; blocks are sharded
    # round-robin by host and results replay to host 0, which alone runs
    # the writers (SURVEY.md §2.9/§5.8). Activation is engine-independent:
    # any engine can solve this host's shard.
    multihost = False
    is_writer_host = True
    if engine == "device" or "jax" in sys.modules:
        import jax
        if jax.distributed.is_initialized() and jax.process_count() > 1:
            multihost = True
            is_writer_host = jax.process_index() == 0
    if multihost:
        # all hosts must agree on the engine before solving: block on the
        # probe (identical outputs, but keep the configuration symmetric)
        upgrade_future = None
        engine = engine_future.result()

    # writers (ref: main.rs:153-234)
    vcf_writer = None if not is_writer_host else OrderedVcfWriter(
        args.vcfs, args.output_vcfs, args.min_variant_quality, sample_names,
        program_version=full_version(), command_line=command_line,
        csi=args.csi_index, io_threads=args.io_threads)
    bam_writers: dict[str, OrderedBamWriter] = {}
    if args.output_bams and is_writer_host:
        for sample_name in sample_names:
            bam_writers[sample_name] = OrderedBamWriter(
                sample_name, sample_to_bams[sample_name],
                sample_to_output_bams[sample_name],
                program_version=full_version(), command_line=command_line,
                io_threads=args.io_threads)
    stats_writer = StatsWriter(args.stats_file) \
        if args.stats_file and is_writer_host else None
    haplotag_writer = HaplotagWriter(args.haplotag_file) \
        if args.haplotag_file and is_writer_host else None
    block_collector = BlockStatsCollector()


    max_chrom_len = max((reference_genome.contig_length(c)
                         for c in reference_genome.contig_keys()), default=0)
    if max_chrom_len >= 2**29 - 1 and not args.csi_index:
        raise SystemExit("Output files will require .csi indexing; use "
                         "--csi-index to enable")

    global_config = global_realignment_config(args)
    debug_run = args.skip > 0 or args.take != U64_MAX

    def process_results(phase_result, haplotag_result):
        if stats_writer is not None:
            stats_writer.write_stats(phase_result)
        block_collector.add_result(phase_result)
        for sub_block in phase_result.sub_phase_blocks:
            block_collector.add_block(sub_block)
        if haplotag_writer is not None:
            haplotag_writer.write_block(haplotag_result)
        vcf_writer.write_phase_block(phase_result)
        this_sample = phase_result.phase_block.sample_name
        for sample_name, writer in bam_writers.items():
            if sample_name == this_sample:
                writer.write_phase_block(haplotag_result)
            else:
                writer.write_dummy_block(phase_result.phase_block.block_index)

    start_time = time.time()
    results_received = 0
    total_variants = 0
    # cumulative per-stage busy time (thread-summed; stages overlap, so
    # these explain CPU distribution, not wall composition)
    stage_s = {"block_gen": 0.0, "prepare": 0.0, "solve": 0.0,
               "writer": 0.0}
    import threading as _th
    _stage_lock = _th.Lock()
    logger.info("Phase block generation starting...")

    def should_solve(block):
        return (not block.unphased_block
                and (args.phase_singletons or block.num_variants > 1)
                and block.num_variants > 0)

    def emit_sync(phase_result, haplotag_result):
        nonlocal results_received, total_variants
        t0 = time.perf_counter()
        total_variants += phase_result.phase_block.num_variants
        results_received += 1
        process_results(phase_result, haplotag_result)
        stage_s["writer"] += time.perf_counter() - t0
        if results_received % 100 == 0:
            elapsed = time.time() - start_time
            logger.info("Received results for %d phase blocks: %.4f "
                        "blocks/sec, %.4f hets/sec, writer waiting on "
                        "block %d", results_received,
                        results_received / elapsed, total_variants / elapsed,
                        vcf_writer.get_wait_block())

    # the ordered writers drain on their own consumer thread so the VCF/BAM
    # rewrite overlaps block gen + prepare + solve (the reference's
    # producer/consumer split, ref: main.rs:325-462); bounded queue for
    # backpressure, fail-fast error propagation back to the producer
    import queue as _queue
    import threading as _threading
    write_queue: _queue.Queue = _queue.Queue(maxsize=256)
    writer_errors: list[BaseException] = []

    def _writer_loop():
        while True:
            item = write_queue.get()
            if item is None:
                return
            try:
                emit_sync(*item)
            except BaseException as e:
                writer_errors.append(e)
                # keep draining so the producer never blocks on a full queue
                while write_queue.get() is not None:
                    pass
                return

    writer_thread = _threading.Thread(target=_writer_loop, daemon=True,
                                      name="ordered-writers")
    writer_thread.start()

    def emit(phase_result, haplotag_result):
        if writer_errors:
            raise writer_errors[0]
        write_queue.put((phase_result, haplotag_result))

    def finish_writes():
        write_queue.put(None)
        writer_thread.join()
        if writer_errors:
            raise writer_errors[0]

    def windowed(iterator):
        it = iter(iterator)
        i = 0
        while True:
            t0 = time.perf_counter()
            block = next(it, None)
            stage_s["block_gen"] += time.perf_counter() - t0
            if block is None:
                return
            if i >= args.skip + args.take:
                return
            if i >= args.skip:
                yield block
            i += 1

    if engine in ("device", "native"):
        from hiphase_jax.parallel.orchestrator import iter_prepared
        from hiphase_jax.phasing.native_beam import NativeBeamSolver
        from hiphase_jax.phasing.phaser import prepare_block

        def prepare_fn(block):
            t0 = time.perf_counter()
            try:
                return prepare_block(
                    block, args.vcfs, sample_to_bams[block.sample_name],
                    reference_genome, args.reference_buffer,
                    args.min_matched_alleles, args.min_mapping_quality,
                    global_config)
            finally:
                dt = time.perf_counter() - t0
                with _stage_lock:  # float += is not atomic across threads
                    stage_s["prepare"] += dt

        native_solver = NativeBeamSolver(
            beam_width=args.beam_width, batch_size=args.batch_size,
            min_queue_size=args.phase_min_queue_size,
            queue_increment=args.phase_queue_increment,
            threads=args.threads,
            compute_estimates=args.stats_file is not None)
        def make_device_solver():
            from hiphase_jax.parallel.orchestrator import BatchedDeviceSolver
            from hiphase_jax.utils.jax_env import (
                configure_compile_cache, require_accelerator)
            configure_compile_cache()
            require_accelerator()
            return BatchedDeviceSolver(
                beam_width=args.beam_width, batch_size=args.batch_size,
                min_queue_size=args.phase_min_queue_size,
                queue_increment=args.phase_queue_increment,
                compute_estimates=args.stats_file is not None)

        if engine == "device":
            # no deadline wrapper: a device error or hang ends the run
            device_solver = make_device_solver()
        elif upgrade_future is not None:
            from hiphase_jax.parallel.engine_select import (
                DeferredUpgradeSolver, ResilientSolver)
            device_solver = DeferredUpgradeSolver(
                native_solver, upgrade_future,
                lambda: ResilientSolver(make_device_solver(), native_solver))
        else:
            device_solver = native_solver
        if multihost:
            # every host walks the SAME global stream (the collective
            # cadence must line up), solves its round-robin shard on the
            # threaded prepare pipeline, and replays results to host 0's
            # writers; other hosts' blocks flow through as 'skip' so the
            # tick cadence stays identical on every process
            from hiphase_jax.parallel.multihost import (
                ResultReplay, blocks_for_host)

            def classify_mh(block):
                if not should_solve(block):
                    return "unphased"
                return ("solve" if blocks_for_host(block.block_index)
                        else "skip")

            replay = ResultReplay()
            for kind, item in iter_prepared(windowed(block_iterator),
                                            prepare_fn, classify_mh,
                                            threads=args.threads):
                if kind == "solve":
                    for pr, hr in device_solver.submit(item):
                        replay.stash((pr, hr))
                elif kind == "unphased" and is_writer_host:
                    emit(*create_unphased_result(item))
                for pr, hr in replay.tick():
                    emit(pr, hr)
            for pr, hr in device_solver.drain():
                replay.stash((pr, hr))
            for pr, hr in replay.finish():
                emit(pr, hr)
        else:
            for kind, item in iter_prepared(
                    windowed(block_iterator), prepare_fn,
                    lambda b: "solve" if should_solve(b) else "unphased",
                    threads=args.threads):
                if kind == "unphased":
                    emit(*create_unphased_result(item))
                else:
                    for pr, hr in device_solver.submit(item):
                        emit(pr, hr)
            for pr, hr in device_solver.drain():
                emit(pr, hr)
    elif args.threads > 1:
        # worker pool of solve_block processes with bounded in-flight window
        # and fail-fast error propagation (ref: main.rs:325-462); fork shares
        # the loaded reference genome copy-on-write
        import multiprocessing
        from collections import deque

        from hiphase_jax.parallel import workers

        workers.init_parent(
            reference_genome, args.vcfs, sample_to_bams,
            reference_buffer=args.reference_buffer,
            min_matched_alleles=args.min_matched_alleles,
            min_mapq=args.min_mapping_quality,
            min_queue_size=args.phase_min_queue_size,
            queue_increment=args.phase_queue_increment,
            global_config=global_config)
        ctx = multiprocessing.get_context("fork")
        job_slots = 40 * args.threads  # backpressure (ref: main.rs:328)
        with ctx.Pool(args.threads) as pool:
            inflight: deque = deque()

            def emit_one(kind, item):
                if kind == "solve":
                    emit(*item.get())
                else:
                    emit(*create_unphased_result(item))

            for block in windowed(block_iterator):
                if should_solve(block):
                    inflight.append(
                        ("solve",
                         pool.apply_async(workers.solve_block_worker,
                                          (block,))))
                else:
                    # unphased/singleton blocks short-circuit on the main
                    # process (ref: main.rs:409-430)
                    inflight.append(("unphased", block))
                while len(inflight) >= job_slots:
                    emit_one(*inflight.popleft())
            while inflight:
                emit_one(*inflight.popleft())
    else:
        for block in windowed(block_iterator):
            if should_solve(block):
                phase_result, haplotag_result = solve_block(
                    block, args.vcfs, sample_to_bams[block.sample_name],
                    reference_genome,
                    reference_buffer=args.reference_buffer,
                    min_matched_alleles=args.min_matched_alleles,
                    min_mapq=args.min_mapping_quality,
                    min_queue_size=args.phase_min_queue_size,
                    queue_increment=args.phase_queue_increment,
                    global_config=global_config,
                    solver="astar")
            else:
                phase_result, haplotag_result = create_unphased_result(block)
            emit(phase_result, haplotag_result)

    finish_writes()

    # finalization (ref: main.rs:464-570)
    if not is_writer_host:
        pass  # only host 0 owns output files (SURVEY.md §2.9)
    elif not debug_run:
        vcf_writer.write_to_end_position()
        vcf_writer.close()
        vcf_writer.write_indexes()
        for writer in bam_writers.values():
            writer.finalize_chromosome()
            writer.copy_remaining_chromosomes()
            writer.close()
            writer.write_indexes()
        if args.blocks_file:
            block_collector.write_blocks(args.blocks_file)
        if args.summary_file:
            block_collector.write_block_stats(
                sample_names, args.summary_file, reference_genome,
                block_iterator.variant_stats())
    else:
        logger.warning("Debug run (--skip/--take): output files are not "
                       "finalized")
        vcf_writer.close()
        for writer in bam_writers.values():
            writer.close()

    if stats_writer is not None:
        stats_writer.close()
    if haplotag_writer is not None:
        haplotag_writer.close()

    elapsed = time.time() - start_time
    logger.info("Phasing complete: %d blocks, %d variants in %.2fs",
                results_received, total_variants, elapsed)
    LAST_RUN_STATS.clear()
    LAST_RUN_STATS.update(engine=engine, blocks=results_received,
                          variants=total_variants, phasing_seconds=elapsed)
    if engine in ("device", "native"):
        # unwrap the auto engine's Deferred/Resilient wrappers
        bds = device_solver
        for attr in ("_sol", "_device"):
            bds = getattr(bds, attr, bds)
        stage_s["solve"] = native_solver.solve_seconds
        if bds is not native_solver:
            stage_s["solve"] += getattr(bds, "solve_seconds", 0.0)
        LAST_RUN_STATS.update(
            node_expansions=native_solver.total_expansions,
            solve_seconds=stage_s["solve"],
            degraded=getattr(device_solver, "degraded", False))
        nb = getattr(bds, "device_batches", 0)
        if nb:
            LAST_RUN_STATS.update(
                device_batches=nb,
                device_transfers=bds.device_transfers,
                transfers_per_batch=round(bds.device_transfers / nb, 2),
                mesh_devices=bds.n_devices)
    LAST_RUN_STATS["stage_seconds"] = {
        k: round(v, 3) for k, v in stage_s.items()}
    return 0


if __name__ == "__main__":
    rc = main()
    # hard exit: under --engine auto the probe thread may still sit in a
    # device call that never returns, which can abort interpreter teardown
    # after all outputs are closed; the exit code must reflect the run
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
