"""hiphase_jax — joint variant phasing for HiFi long reads, with a JAX
device engine.

A from-scratch re-design of the capabilities of PacificBiosciences/HiPhase
for an accelerator driven through JAX:

- Host layer: pure-Python + C++ BGZF/BAM/VCF/tabix/FASTA I/O (no htslib in the
  environment, so the formats are implemented natively), streaming phase-block
  generation, and ordered result writers.
- Device layer (JAX/XLA/Pallas): batched beam-search diplotype solver over
  dense read-allele matrices, batched edit-distance kernels for allele
  assignment, and data-parallel sharding of phase-block batches over a
  `jax.sharding.Mesh`.

Layer map mirrors the reference (see SURVEY.md §1):
  L0 io/         — file-format I/O            (ref: rust-htslib)
  L1 core/       — data types                 (ref: src/data_types/)
  L2 align/+ops/ — alignment kernels          (ref: src/sequence_alignment.rs, src/wfa_graph.rs)
  L3 phasing/    — per-block phasing engine   (ref: src/read_parsing.rs, src/astar_phaser.rs, src/phaser.rs)
  L4 phasing/block_gen.py — work decomposition(ref: src/block_gen.rs)
  L5 cli.py      — orchestration              (ref: src/main.rs)
  L6 writers/    — ordered sinks              (ref: src/writers/)
  L7 cli.py      — CLI/config                 (ref: src/cli.rs)
"""

from hiphase_jax.version import __version__

__all__ = ["__version__"]
