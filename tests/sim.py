"""Synthetic dataset generator for end-to-end tests: builds a reference
FASTA, a truth diplotype, a bgzipped+indexed VCF, and a coordinate-sorted
indexed BAM of simulated HiFi-like reads."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from hiphase_jax.io.bam import CIGAR_OPS, SEQ_NT16, BamRecord, BamWriter, SamHeader, reg2bin
from hiphase_jax.io.vcf import VcfHeader, VcfRecord, VcfWriter

BASES = b"ACGT"


@dataclass
class SimVariant:
    pos: int            # 0-based
    ref: bytes
    alt: bytes
    gt: tuple[int, int]  # truth genotype per haplotype (h1 allele, h2 allele)
    gq: int = 60
    info: str = "."      # INFO column (e.g. SVTYPE=DEL, TRID=...)
    alt2: bytes | None = None  # second ALT for multi-allelic sites (index 2)

    def allele_seq(self, index: int) -> bytes:
        return (self.ref, self.alt, self.alt2)[index]


@dataclass
class SimContig:
    name: str
    seq: bytes
    variants: list[SimVariant] = field(default_factory=list)


def make_bam_record(name: str, refid: int, pos: int, seq: bytes,
                    cigar: list[tuple[str, int]], mapq: int = 60,
                    flag: int = 0, quals: bytes | None = None,
                    tags: bytes = b"") -> BamRecord:
    nameb = name.encode() + b"\x00"
    cig = b"".join(struct.pack("<I", (length << 4) | CIGAR_OPS.index(op))
                   for op, length in cigar)
    packed = bytearray((len(seq) + 1) // 2)
    for i, base in enumerate(seq):
        nib = SEQ_NT16.index(chr(base))
        if i % 2 == 0:
            packed[i // 2] |= nib << 4
        else:
            packed[i // 2] |= nib
    q = quals if quals is not None else bytes([30] * len(seq))
    raw = struct.pack("<iiBBHHHIiii", refid, pos, len(nameb), mapq,
                      reg2bin(pos, pos + len(seq)), len(cigar), flag,
                      len(seq), -1, -1, 0)
    raw += nameb + cig + bytes(packed) + q + tags
    return BamRecord.parse(raw)


def simulate_contig(rng, name: str, length: int, het_snv_every: int = 120,
                    hom_snv_every: int = 331) -> SimContig:
    seq = rng.choice(np.frombuffer(BASES, dtype=np.uint8),
                     size=length).astype(np.uint8).tobytes()
    contig = SimContig(name, seq)
    used = set()
    for pos in range(60, length - 60, het_snv_every):
        pos = int(pos + rng.integers(0, 30))
        if pos in used:
            continue
        used.add(pos)
        ref = seq[pos:pos + 1]
        alt = bytes([rng.choice([b for b in BASES if b != ref[0]])])
        # random truth phase orientation
        gt = (0, 1) if rng.random() < 0.5 else (1, 0)
        contig.variants.append(SimVariant(pos, ref, alt, gt))
    for pos in range(97, length - 60, hom_snv_every):
        if pos in used or (pos + 1) in used or (pos - 1) in used:
            continue
        used.add(pos)
        ref = seq[pos:pos + 1]
        alt = bytes([rng.choice([b for b in BASES if b != ref[0]])])
        contig.variants.append(SimVariant(pos, ref, alt, (1, 1)))
    contig.variants.sort(key=lambda v: v.pos)
    return contig


def hap_sequence(contig: SimContig, hap: int) -> bytes:
    """Apply the truth alleles for one haplotype (SNV-only fast path)."""
    seq = bytearray(contig.seq)
    for v in contig.variants:
        allele = v.gt[hap]
        if allele == 1:
            assert len(v.ref) == 1 and len(v.alt) == 1
            seq[v.pos] = v.alt[0]
    return bytes(seq)


def hap_arrays(contig: SimContig, hap: int) -> tuple[bytes, np.ndarray]:
    """Apply the truth alleles (any ref/alt lengths) for one haplotype.
    Returns (hap sequence, hap2ref) where hap2ref[i] is the reference
    coordinate of haplotype base i, or -1 for inserted bases."""
    seq = bytearray()
    h2r: list[int] = []
    ref = contig.seq
    pos = 0
    for v in sorted(contig.variants, key=lambda v: v.pos):
        if v.gt[hap] == 0:
            continue
        assert v.pos >= pos, "overlapping variants in sim"
        # identity up to the variant
        seq += ref[pos:v.pos]
        h2r.extend(range(pos, v.pos))
        # alt allele: aligned bases map 1:1 to the ref allele prefix,
        # surplus alt bases are insertions (-1), missing ref bases deletions
        alt = v.allele_seq(v.gt[hap])
        n_aligned = min(len(v.ref), len(alt))
        seq += alt
        h2r.extend(range(v.pos, v.pos + n_aligned))
        h2r.extend([-1] * (len(alt) - n_aligned))
        pos = v.pos + len(v.ref)
    seq += ref[pos:]
    h2r.extend(range(pos, len(ref)))
    return bytes(seq), np.array(h2r, dtype=np.int64)


def cigar_from_h2r(h2r_slice: np.ndarray) -> list[tuple[str, int]]:
    """Derive a CIGAR from a hap2ref window (first/last entries mapped)."""
    ops: list[tuple[str, int]] = []

    def push(op, n):
        if n <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + n)
        else:
            ops.append((op, n))

    prev_ref = None
    for r in h2r_slice:
        if r < 0:
            push("I", 1)
            continue
        if prev_ref is not None and r > prev_ref + 1:
            push("D", int(r - prev_ref - 1))
        push("M", 1)
        prev_ref = int(r)
    return ops


def write_fasta(path: str, contigs: list[SimContig]) -> None:
    with open(path, "w") as fh:
        for c in contigs:
            fh.write(f">{c.name}\n")
            s = c.seq.decode()
            for i in range(0, len(s), 60):
                fh.write(s[i:i + 60] + "\n")


def write_vcf(path: str, contigs: list[SimContig], sample: str = "SAMPLE",
              extra_samples: list[str] | None = None) -> None:
    samples = [sample] + (extra_samples or [])
    lines = [b"##fileformat=VCFv4.2",
             b'##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             b'##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Quality">']
    for c in contigs:
        lines.append(f"##contig=<ID={c.name},length={len(c.seq)}>".encode())
    cols = b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + \
        "\t".join(samples).encode()
    header = VcfHeader.parse(lines + [cols])
    wr = VcfWriter(path, header)
    for c in contigs:
        for v in c.variants:
            gt = f"{min(v.gt)}/{max(v.gt)}"
            alt = v.alt.decode()
            if v.alt2 is not None:
                alt += "," + v.alt2.decode()
            extra = "\t0/0:60" * len(extra_samples or [])
            wr.write(VcfRecord.parse(
                f"{c.name}\t{v.pos + 1}\t.\t{v.ref.decode()}\t"
                f"{alt}\t60\tPASS\t{v.info}\tGT:GQ\t{gt}:{v.gq}"
                f"{extra}".encode()))
    wr.close()
    wr.write_index()


def simulate_reads(rng, contig: SimContig, refid: int, read_length: int = 2000,
                   coverage: int = 20, rg_tag: bytes = b"") -> list[tuple]:
    """Returns [(pos, BamRecord, truth_hap)] coordinate-sorted (SNV-only sim:
    both haplotype sequences are reference-length, so CIGAR is all-M)."""
    haps = [hap_sequence(contig, 0), hap_sequence(contig, 1)]
    n_reads = max(1, coverage * len(contig.seq) // read_length)
    out = []
    for i in range(n_reads):
        hap = int(rng.integers(0, 2))
        # sample virtual starts beyond the edges and clamp, so coverage is
        # uniform across the whole contig (edge reads are just shorter)
        vpos = int(rng.integers(-read_length + 200,
                                len(contig.seq) - 200))
        pos = max(0, vpos)
        end = min(len(contig.seq), vpos + read_length)
        seq = haps[hap][pos:end]
        rec = make_bam_record(f"{contig.name}_read{i}", refid, pos, seq,
                              [("M", len(seq))], tags=rg_tag)
        out.append((pos, rec, hap))
    out.sort(key=lambda t: t[0])
    return out


def write_bam(path: str, contigs: list[SimContig], reads_per_contig,
              sample: str = "SAMPLE") -> dict[str, int]:
    """Write sorted BAM + BAI; returns read_name → truth hap map."""
    header = SamHeader(
        "@HD\tVN:1.6\tSO:coordinate\n"
        f"@RG\tID:rg1\tSM:{sample}\n",
        [c.name for c in contigs], [len(c.seq) for c in contigs])
    w = BamWriter(path, header)
    truth = {}
    for reads in reads_per_contig:
        for _pos, rec, hap in reads:
            w.write(rec)
            truth[rec.read_name] = hap
    w.close()
    w.write_index()
    return truth


def simulate_contig_mixed(rng, name: str, length: int, spacing: int = 150,
                          sv_del: bool = False, tandem_repeat: bool = False
                          ) -> SimContig:
    """SNVs + small insertions + small deletions (optionally an SV deletion
    and a tandem-repeat variant), non-overlapping, mixed het/hom."""
    seq = rng.choice(np.frombuffer(BASES, dtype=np.uint8),
                     size=length).astype(np.uint8).tobytes()
    contig = SimContig(name, seq)
    pos = 100
    while pos < length - 200:
        kind = rng.choice(["snv", "snv", "snv", "ins", "del", "hom"])
        ref1 = seq[pos:pos + 1]
        if kind == "snv" or kind == "hom":
            alt = bytes([rng.choice([b for b in BASES if b != ref1[0]])])
            gt = (1, 1) if kind == "hom" else \
                ((0, 1) if rng.random() < 0.5 else (1, 0))
            contig.variants.append(SimVariant(pos, ref1, alt, gt))
        elif kind == "ins":
            ins = rng.choice(np.frombuffer(BASES, dtype=np.uint8),
                             size=int(rng.integers(1, 6))).astype(np.uint8).tobytes()
            gt = (0, 1) if rng.random() < 0.5 else (1, 0)
            contig.variants.append(SimVariant(pos, ref1, ref1 + ins, gt))
        else:  # del
            dlen = int(rng.integers(1, 6))
            ref = seq[pos:pos + 1 + dlen]
            gt = (0, 1) if rng.random() < 0.5 else (1, 0)
            contig.variants.append(SimVariant(pos, ref, ref1, gt))
        pos += spacing + int(rng.integers(0, 40))
    if sv_del:
        # one ~120bp deletion tagged as an SV in the middle, clear of others
        mid = length // 2
        contig.variants = [v for v in contig.variants
                           if v.pos + len(v.ref) < mid - 20
                           or v.pos > mid + 160]
        ref = seq[mid:mid + 121]
        gt = (0, 1) if rng.random() < 0.5 else (1, 0)
        contig.variants.append(SimVariant(mid, ref, ref[:1], gt,
                                          info="SVTYPE=DEL"))
    if tandem_repeat:
        # a repeat-expansion site near 1/4 of the contig, TRGT-style TRID tag
        q = length // 4
        contig.variants = [v for v in contig.variants
                           if v.pos + len(v.ref) < q - 20 or v.pos > q + 60]
        unit = b"ACA"
        ref = seq[q:q + 1] + unit * 4
        # mutate the underlying reference so REF matches the genome
        contig.seq = seq[:q + 1] + unit * 4 + seq[q + 1 + 12:]
        alt = seq[q:q + 1] + unit * 7
        gt = (0, 1) if rng.random() < 0.5 else (1, 0)
        contig.variants.append(SimVariant(q, ref, alt, gt,
                                          info=f"TRID=TR_{name}_{q}"))
    contig.variants.sort(key=lambda v: v.pos)
    return contig


def simulate_reads_mixed(rng, contig: SimContig, refid: int,
                         read_length: int = 2000, coverage: int = 20,
                         rg_tag: bytes = b"") -> list[tuple]:
    """Reads from haplotypes carrying indels: CIGARs derived from the
    hap→ref coordinate map (M/I/D)."""
    haps = [hap_arrays(contig, 0), hap_arrays(contig, 1)]
    n_reads = max(1, coverage * len(contig.seq) // read_length)
    out = []
    for i in range(n_reads):
        hap = int(rng.integers(0, 2))
        hseq, h2r = haps[hap]
        vpos = int(rng.integers(-read_length + 200, len(hseq) - 200))
        s = max(0, vpos)
        e = min(len(hseq), vpos + read_length)
        # don't start/end on an inserted base
        while s < e and h2r[s] < 0:
            s += 1
        while e > s and h2r[e - 1] < 0:
            e -= 1
        if e - s < 50:
            continue
        cigar = cigar_from_h2r(h2r[s:e])
        rec = make_bam_record(f"{contig.name}_read{i}", refid, int(h2r[s]),
                              hseq[s:e], cigar, tags=rg_tag)
        out.append((int(h2r[s]), rec, hap))
    out.sort(key=lambda t: t[0])
    return out


RG_TAG = b"RGZrg1\x00"


def build_dataset(tmp_path, seed=0, n_contigs=2, contig_len=30000,
                  coverage=20, sample="SAMPLE"):
    """Standard SNV dataset; returns (fasta, vcf, bam, contigs, truth_haps)."""
    rng = np.random.default_rng(seed)
    contigs = [simulate_contig(rng, f"chr{i + 1}", contig_len)
               for i in range(n_contigs)]
    fasta = str(tmp_path / "ref.fa")
    vcf = str(tmp_path / "calls.vcf.gz")
    bam = str(tmp_path / "reads.bam")
    write_fasta(fasta, contigs)
    write_vcf(vcf, contigs, sample=sample)
    reads = [simulate_reads(rng, c, i, coverage=coverage, rg_tag=RG_TAG)
             for i, c in enumerate(contigs)]
    truth = write_bam(bam, contigs, reads, sample=sample)
    return fasta, vcf, bam, contigs, truth
