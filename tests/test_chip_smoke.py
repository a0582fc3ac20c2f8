"""chip_smoke.py's own parts at toy size on the CPU: output comparison
(command-line header lines excluded), the card line, the device graph-WFA
check, and the refusal to run without a GPU. The full smoke runs only on a
GPU (``python chip_smoke.py``)."""

import gzip
import shutil

import pytest

import chip_smoke
from tests.sim import build_dataset


@pytest.fixture(scope="module")
def two_native_runs(tmp_path_factory):
    """Two native runs of one toy dataset; their command lines differ (each
    names its own output paths), their records must not."""
    tmp = tmp_path_factory.mktemp("smoke")
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp, seed=12, n_contigs=2, contig_len=8000, coverage=12)
    meta = {"fasta": fasta, "vcf": vcf, "bam": bam}
    return [chip_smoke.run_cli(meta, str(tmp / name), "native", threads=2)
            for name in ("a", "b")]


def test_compare_outputs_ignores_command_line(two_native_runs):
    a, b = (r["paths"] for r in two_native_runs)
    with gzip.open(a["vcf"], "rb") as fa, gzip.open(b["vcf"], "rb") as fb:
        assert fa.read() != fb.read()  # the command-line header differs
    same = chip_smoke.compare_outputs(a, b)
    assert same["vcf_records"] > 20
    assert same["bam_record_bytes"] > 0
    for k in chip_smoke.TSV_OUTPUTS:
        assert same[f"{k}_tsv"] == "identical"


def test_compare_vcf_detects_a_changed_record(two_native_runs, tmp_path):
    a = two_native_runs[0]["paths"]["vcf"]
    with gzip.open(a, "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    i = next(i for i, line in enumerate(lines) if b"0|1" in line)
    lines[i] = lines[i].replace(b"0|1", b"1|0")
    bad = tmp_path / "bad.vcf.gz"
    with gzip.open(bad, "wb") as fh:
        fh.writelines(lines)
    with pytest.raises(AssertionError, match="VCF differs"):
        chip_smoke.compare_vcf(a, str(bad))


def test_compare_bam_detects_a_changed_record(two_native_runs, tmp_path):
    a = two_native_runs[0]["paths"]["bam"]
    with gzip.open(a, "rb") as fh:
        raw = bytearray(fh.read())
    raw[-1] ^= 1  # last record's last byte
    bad = tmp_path / "bad.bam"
    with gzip.open(bad, "wb") as fh:
        fh.write(bytes(raw))
    with pytest.raises(AssertionError, match="BAM records differ"):
        chip_smoke.compare_bam(a, str(bad))
    same = tmp_path / "same.bam"
    shutil.copy(a, same)
    assert chip_smoke.compare_bam(a, str(same)) > 0


def test_device_info_line_keeps_nvidia_smi_text():
    cards = ["NVIDIA H100 80GB HBM3, 700.00 W"]
    line = chip_smoke.device_info_line(cards, "0.9.0",
                                       "PJRT C API\ncuda 12090")
    assert cards[0] in line and "jax 0.9.0" in line
    assert "PJRT C API cuda 12090" in line
    assert "\n" not in line


def test_wfa_check_toy_graphs():
    work = chip_smoke.wfa_workload(n_graphs=2, reads_per_graph=3,
                                   length=1500)
    res = chip_smoke.wfa_check(work, min_certified=1.0)
    assert res["reads"] == res["certified"] == 6


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_without_gpu(capsys, argv):
    with pytest.raises(SystemExit, match="no GPU") as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    assert not out.strip()
