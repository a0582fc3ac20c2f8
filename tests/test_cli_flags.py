"""Flag-surface behaviors: CSI indexing, --ignore-read-groups,
--phase-singletons, supplemental joins, --min-vcf-qual."""

import numpy as np

from hiphase_jax.cli import main as cli_main
from hiphase_jax.io.vcf import VcfReader

from tests import sim
from tests.test_e2e import run_cli


def test_csi_index_output(tmp_path):
    fasta, vcf, bam, contigs, _ = sim.build_dataset(tmp_path, seed=51,
                                                    n_contigs=1,
                                                    contig_len=8000)
    out_vcf = str(tmp_path / "out.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out_vcf,
                     "--reference", fasta, "--csi-index",
                     "--disable-global-realignment"]) == 0
    assert (tmp_path / "out.vcf.gz.csi").exists()
    assert not (tmp_path / "out.vcf.gz.tbi").exists()
    rd = VcfReader(out_vcf)
    assert rd._index is not None  # csi loaded
    got = [r.pos0 for r in rd.fetch("chr1", 2000, 5000)]
    lin = [r.pos0 for r in rd if 2000 <= r.pos0 < 5000]
    assert got == lin and got


def test_ignore_read_groups(tmp_path):
    """BAM without RG/SM headers works with --ignore-read-groups."""
    rng = np.random.default_rng(52)
    contig = sim.simulate_contig(rng, "chr1", 8000)
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    bam = str(tmp_path / "reads.bam")
    sim.write_fasta(fasta, [contig])
    sim.write_vcf(vcf, [contig])
    reads = sim.simulate_reads(rng, contig, 0)  # no RG tag
    from hiphase_jax.io.bam import BamWriter, SamHeader
    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n", ["chr1"], [8000])
    w = BamWriter(bam, header)
    for _pos, rec, _hap in reads:
        w.write(rec)
    w.close()
    w.write_index()

    out_vcf = str(tmp_path / "o.vcf.gz")
    # without the flag: RG-less BAM is an error
    rc = cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out_vcf,
                   "--reference", fasta, "--disable-global-realignment"])
    assert rc != 0
    # with the flag: runs and phases
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out_vcf,
                     "--reference", fasta, "--ignore-read-groups",
                     "--disable-global-realignment"]) == 0
    phased = [r for r in VcfReader(out_vcf) if r.genotype(0)[1]]
    assert phased


def test_phase_singletons(tmp_path):
    """A contig with one lone het: unphased by default, phased with the flag
    (singleton phasing emits 0|1 with its own PS)."""
    rng = np.random.default_rng(53)
    contig = sim.SimContig("chr1", sim.simulate_contig(rng, "chr1", 4000).seq, [])
    ref1 = contig.seq[2000:2001]
    alt = b"A" if ref1 != b"A" else b"C"
    contig.variants = [sim.SimVariant(2000, ref1, alt, (0, 1))]
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    bam = str(tmp_path / "reads.bam")
    sim.write_fasta(fasta, [contig])
    sim.write_vcf(vcf, [contig])
    reads = sim.simulate_reads(rng, contig, 0, coverage=15, rg_tag=sim.RG_TAG)
    sim.write_bam(bam, [contig], [reads])

    out1 = str(tmp_path / "def.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out1,
                     "--reference", fasta, "--disable-global-realignment"]) == 0
    rec = next(iter(VcfReader(out1)))
    assert not rec.genotype(0)[1], "singleton unphased by default"

    out2 = str(tmp_path / "single.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out2,
                     "--reference", fasta, "--phase-singletons",
                     "--disable-global-realignment"]) == 0
    rec = next(iter(VcfReader(out2)))
    assert rec.genotype(0)[1], "singleton phased with --phase-singletons"
    assert rec.sample_field(0, "PS") == b"2001"


def test_supplemental_joins(tmp_path):
    """A coverage gap splits blocks unless split reads' SA tags bridge it."""
    rng = np.random.default_rng(54)
    contig = sim.simulate_contig(rng, "chr1", 20000)
    # the gap region carries no variants (e.g. an unassemblable repeat):
    # supplemental joins exist to bridge exactly this case
    contig.variants = [v for v in contig.variants
                       if v.pos < 7500 or v.pos >= 12200]
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    sim.write_fasta(fasta, [contig])
    sim.write_vcf(vcf, [contig])

    # normal reads only outside the [8k, 12k) gap
    reads = sim.simulate_reads(rng, contig, 0, coverage=20, rg_tag=sim.RG_TAG)
    reads = [t for t in reads
             if t[0] + 2000 <= 8000 or t[0] >= 12000]
    # split reads: left half [6k,8k) with SA at 12k, right half [12k,14k)
    # with SA back at 6k (SA pos is 1-based in the tag)
    haps = [sim.hap_sequence(contig, 0), sim.hap_sequence(contig, 1)]
    split = []
    for i in range(4):
        hap = i % 2
        sa_left = f"chr1,{6001},+,2000M,60,0;".encode()
        sa_right = f"chr1,{12001},+,2000M,60,0;".encode()
        left = sim.make_bam_record(
            f"split{i}", 0, 6000, haps[hap][6000:8000], [("M", 2000)],
            tags=sim.RG_TAG + b"SAZ" + sa_right + b"\x00")
        right = sim.make_bam_record(
            f"split{i}", 0, 12000, haps[hap][12000:14000], [("M", 2000)],
            flag=0x800, tags=sim.RG_TAG + b"SAZ" + sa_left + b"\x00")
        split.append((6000, left, hap))
        split.append((12000, right, hap))
    allreads = sorted(reads + split, key=lambda t: t[0])
    bam = str(tmp_path / "reads.bam")
    sim.write_bam(bam, [contig], [allreads])

    def count_input_blocks(extra):
        out = str(tmp_path / "x.vcf.gz")
        stats = tmp_path / "s.tsv"
        assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out,
                         "--reference", fasta, "--stats-file", str(stats),
                         "--disable-global-realignment"] + extra) == 0
        return len(stats.read_text().splitlines()) - 1

    joined = count_input_blocks([])
    disjoint = count_input_blocks(["--no-supplemental-joins"])
    assert disjoint == joined + 1, (joined, disjoint)


def test_min_vcf_qual_filters(tmp_path):
    rng = np.random.default_rng(55)
    contig = sim.simulate_contig(rng, "chr1", 8000)
    # degrade GQ on a third of the hets
    low = 0
    for i, v in enumerate(contig.variants):
        if v.gt != (1, 1) and i % 3 == 0:
            v.gq = 5
            low += 1
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    bam = str(tmp_path / "reads.bam")
    sim.write_fasta(fasta, [contig])
    sim.write_vcf(vcf, [contig])
    reads = sim.simulate_reads(rng, contig, 0, rg_tag=sim.RG_TAG)
    sim.write_bam(bam, [contig], [reads])
    out = str(tmp_path / "q.vcf.gz")
    assert cli_main(["--bam", bam, "--vcf", vcf, "--output-vcf", out,
                     "--reference", fasta, "--min-vcf-qual", "20",
                     "--disable-global-realignment"]) == 0
    for rec in VcfReader(out):
        gt, phased = rec.genotype(0)
        if rec.gq(0) == 5:
            assert not phased, "low-GQ variant must stay unphased"
