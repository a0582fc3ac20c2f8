"""Adversarial end-to-end run with COMMITTED golden outputs.

The engine A/B tests elsewhere can't catch a systematic deviation shared by
both engines (e.g. a PS off-by-one); this pins the full phasing output of a
WGS-realistic dataset — 1% read errors, indels, SV deletions, tandem
repeats, SA-tagged split reads, coverage deserts — against a golden file
checked into the repo (tests/goldens/). Regenerate ONLY for an intentional
behavior change: python tests/test_e2e_golden.py --regen
"""

import hashlib
import json
import pathlib

import pytest

from hiphase_jax.cli import main as cli_main
from hiphase_jax.io.bam import BamReader
from hiphase_jax.io.vcf import VcfReader
from hiphase_jax.utils.simulate import build_benchmark_dataset

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
GOLDEN = GOLDEN_DIR / "e2e_wgs_sim.json"

DATASET_KW = dict(total_mb=2, n_contigs=2, coverage=15, read_length=8000,
                  seed=99, block_kb=120)


def _run(tmp_path, engine: str):
    d = tmp_path / f"ds_{engine}"
    meta = build_benchmark_dataset(str(d), **DATASET_KW)
    out_vcf = str(tmp_path / f"{engine}.vcf.gz")
    out_bam = str(tmp_path / f"{engine}.bam")
    argv = ["--bam", meta["bam"], "--vcf", meta["vcf"],
            "--reference", meta["fasta"], "--output-vcf", out_vcf,
            "--output-bam", out_bam,
            "--blocks-file", str(tmp_path / f"{engine}.blocks.tsv")]
    if engine == "device":
        argv += ["--engine", "device", "--batch-size", "8"]
    else:
        argv += ["--engine", engine]
    assert cli_main(argv) == 0
    return out_vcf, out_bam, str(tmp_path / f"{engine}.blocks.tsv")


def _normalize(out_vcf, out_bam, blocks_file) -> dict:
    """Normalized, compression-independent view of the outputs."""
    vcf_lines = []
    for rec in VcfReader(out_vcf):
        gt = rec.sample_field(0, "GT")
        ps = rec.sample_field(0, "PS")
        pf = rec.sample_field(0, "PF")
        vcf_lines.append("\t".join([
            rec.chrom, str(rec.pos0 + 1),
            (gt or b".").decode(),
            (ps or b".").decode() if isinstance(ps, bytes) else str(ps or "."),
            (pf or b".").decode() if isinstance(pf, bytes) else str(pf or "."),
        ]))
    bam_lines = []
    with BamReader(out_bam) as bam:
        for rec in bam:
            bam_lines.append(
                f"{rec.read_name}\t{rec.refid}\t{rec.pos}\t"
                f"{rec.get_tag('HP')}\t{rec.get_tag('PS')}")
    # full-record fidelity: every byte of every output record (QUAL, INFO,
    # FILTER, untouched FORMAT fields must pass through unchanged)
    vcf_full = [b"\t".join(rec.fields).decode()
                for rec in VcfReader(out_vcf)]
    blocks = pathlib.Path(blocks_file).read_text().splitlines()
    return {"vcf": vcf_lines, "vcf_full": vcf_full, "bam": bam_lines,
            "blocks": blocks}


def _digest(norm: dict) -> str:
    blob = json.dumps(norm, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def test_golden_outputs(tmp_path):
    out = _normalize(*_run(tmp_path, "astar"))
    golden = json.loads(GOLDEN.read_text())
    assert len(out["vcf"]) == len(golden["norm"]["vcf"])
    for got, want in zip(out["vcf"], golden["norm"]["vcf"]):
        assert got == want, f"VCF drift: {got!r} != {want!r}"
    for got, want in zip(out["vcf_full"], golden["norm"]["vcf_full"]):
        assert got == want, f"record passthrough drift: {got!r} != {want!r}"
    assert out["bam"] == golden["norm"]["bam"], "haplotag drift"
    assert out["blocks"] == golden["norm"]["blocks"], "phase-block drift"
    assert _digest(out) == golden["sha256"]


def test_golden_outputs_tpu_engine(tmp_path):
    """The device engine must produce the same golden output."""
    out = _normalize(*_run(tmp_path, "device"))
    golden = json.loads(GOLDEN.read_text())
    assert _digest(out) == golden["sha256"]


def _regen(tmp_path):
    out = _normalize(*_run(tmp_path, "astar"))
    GOLDEN_DIR.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps(
        {"dataset": DATASET_KW, "sha256": _digest(out), "norm": out},
        indent=1))
    print(f"wrote {GOLDEN} sha256={_digest(out)}  "
          f"({len(out['vcf'])} vcf rows, {len(out['bam'])} reads)")


if __name__ == "__main__":
    import sys
    import tempfile

    if "--regen" in sys.argv:
        with tempfile.TemporaryDirectory() as td:
            _regen(pathlib.Path(td))
