"""Synthetic diploid read simulation for tests, demos, and benchmarks.

Generates a random reference, plants phased variants (SNVs, insertions,
deletions) on two haplotypes, samples error-free reads with exact CIGARs, and
writes FASTA / BAM / truth-VCF artifacts.  The reference repository has no
simulator; end-to-end validation here runs entirely on simulated data, where
the truth set is known by construction.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

from .io.bam import write_bam
from .io.fasta import write_fasta
from .io.vcf import VcfRecord, write_vcf
from .reads import AlignedRead, FLAG_REVERSE
from .constants import BAM_CDEL, BAM_CINS, BAM_CMATCH


@dataclasses.dataclass
class Variant:
    position: int       # 0-based
    ref: str
    alt: str
    genotype: Tuple[int, int]  # per-haplotype: 0 = ref, 1 = alt


def random_reference(length: int, rng: random.Random) -> str:
    return "".join(rng.choice("ACGT") for _ in range(length))


def plant_variants(ref: str, num: int, rng: random.Random,
                   min_gap: int = 120, start: int = 300) -> List[Variant]:
    """Plant well-separated variants of mixed types and genotypes."""
    variants = []
    pos = start
    while len(variants) < num and pos < len(ref) - 300:
        pos += rng.randint(min_gap, min_gap * 2)
        if pos >= len(ref) - 300:
            break
        kind = rng.choice(["snv", "snv", "ins", "del"])
        gt = rng.choice([(0, 1), (1, 0), (1, 1)])
        base = ref[pos]
        if kind == "snv":
            alt = rng.choice([b for b in "ACGT" if b != base])
            variants.append(Variant(pos, base, alt, gt))
        elif kind == "ins":
            ins = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 4)))
            variants.append(Variant(pos, base, base + ins, gt))
        else:
            dlen = rng.randint(1, 4)
            variants.append(Variant(pos, ref[pos:pos + dlen + 1], base, gt))
    return variants


def _haplotype_columns(ref: str, variants: Sequence[Variant], hap: int):
    """Expand a haplotype into (ref_pos|None, base) columns.

    Insertion bases carry ref_pos None; deleted reference positions are
    skipped, which reads detect as jumps between adjacent M columns.
    """
    columns: List[Tuple[Optional[int], str]] = []
    rpos = 0
    for v in sorted(variants, key=lambda x: x.position):
        if not v.genotype[hap]:
            continue
        while rpos < v.position:
            columns.append((rpos, ref[rpos]))
            rpos += 1
        if len(v.ref) == 1 and len(v.alt) == 1:          # SNV
            columns.append((rpos, v.alt))
            rpos += 1
        elif len(v.alt) > len(v.ref):                     # insertion
            columns.append((rpos, v.alt[0]))
            for b in v.alt[1:]:
                columns.append((None, b))
            rpos += 1
        else:                                             # deletion
            columns.append((rpos, v.alt))
            rpos += len(v.ref)
    while rpos < len(ref):
        columns.append((rpos, ref[rpos]))
        rpos += 1
    return columns


def _inject_errors(cols, rng: random.Random, sub_rate: float,
                   ins_rate: float, del_rate: float):
    """Apply a sequencing-error model to a read's columns.

    Substitutions replace the base of an aligned (M) column; insertion errors
    add a ref-less column; deletion errors drop an M column (the CIGAR
    builder turns the reference jump into a D op).  Error bases keep the
    read's quality string — matching real data, where miscalled bases are
    not always low-quality."""
    out = []
    for col in cols:
        p, b = col
        if p is not None and rng.random() < del_rate:
            continue                                    # deletion error
        if p is not None and rng.random() < sub_rate:
            b = rng.choice([x for x in "ACGT" if x != b])
        out.append((p, b))
        if rng.random() < ins_rate:
            out.append((None, rng.choice("ACGT")))      # insertion error
    return out


def _read_from_columns(columns, start_col: int, length: int, name: str,
                       chromosome: str, qual: int, mapq: int, reverse: bool,
                       pacbio: bool, hp: int,
                       rng: Optional[random.Random] = None,
                       sub_rate: float = 0.0,
                       indel_rate: float = 0.0) -> Optional[AlignedRead]:
    cols = columns[start_col:start_col + length]
    if len(cols) < length:
        return None
    if rng is not None and (sub_rate or indel_rate):
        cols = _inject_errors(cols, rng, sub_rate, indel_rate / 2,
                              indel_rate / 2)
    # trim leading/trailing insertion columns so alignments start/end on M
    while cols and cols[0][0] is None:
        cols = cols[1:]
    while cols and cols[-1][0] is None:
        cols = cols[:-1]
    if not cols:
        return None
    seq = "".join(b for _p, b in cols)
    cigars: List[Tuple[int, int]] = []
    prev_ref = None
    for p, _b in cols:
        if p is None:
            op = BAM_CINS
            advance = 0
        else:
            if prev_ref is not None and p > prev_ref + 1:
                gap = p - prev_ref - 1
                cigars.append((BAM_CDEL, gap))
            op = BAM_CMATCH
            advance = 1
        if cigars and cigars[-1][0] == op:
            cigars[-1] = (op, cigars[-1][1] + 1)
        else:
            cigars.append((op, 1))
        if p is not None:
            prev_ref = p
    # qual as a (lo, hi) range draws realistic per-base qualities — real BAM
    # quality strings are high-entropy (2/3 of a real file's compressed
    # bytes), so capacity soaks need varied quals for honest file sizes
    if isinstance(qual, tuple):
        import numpy as _np
        lo, hi = qual
        seed = rng.getrandbits(32) if rng is not None else 0
        quals = _np.random.default_rng(seed).integers(
            lo, hi + 1, size=len(seq)).tolist()
    else:
        quals = [qual] * len(seq)
    flag = FLAG_REVERSE if reverse else 0
    return AlignedRead(
        name=name, flag=flag, chromosome=chromosome,
        reference_start=cols[0][0], mapq=mapq, cigartuples=cigars,
        sequence=seq, qualities=quals, hp=hp, pacbio=pacbio)


def simulate_reads(ref: str, variants: Sequence[Variant], chromosome: str,
                   coverage: float, read_length: int, rng: random.Random,
                   qual: int = 30, mapq: int = 60, pacbio: bool = False,
                   hp_tags: bool = False, name_prefix: str = "read",
                   sub_error_rate: float = 0.0,
                   indel_error_rate: float = 0.0) -> List[AlignedRead]:
    columns = [_haplotype_columns(ref, variants, h) for h in (0, 1)]
    num_reads = int(coverage * len(ref) / read_length)
    reads = []
    for i in range(num_reads):
        hap = rng.randint(0, 1)
        start = rng.randint(0, max(0, len(columns[hap]) - read_length))
        read = _read_from_columns(
            columns[hap], start, read_length, f"{name_prefix}{i}", chromosome,
            qual, mapq, reverse=bool(i % 2), pacbio=pacbio,
            hp=(hap + 1) if hp_tags else 0,
            rng=rng, sub_rate=sub_error_rate, indel_rate=indel_error_rate)
        if read is not None:
            reads.append(read)
    reads.sort(key=lambda r: r.reference_start)
    return reads


@dataclasses.dataclass
class SimulatedDataset:
    fasta: str
    bams: Dict[str, str]          # platform name -> path
    truth_vcf: str
    chromosome: str               # first chromosome (convenience)
    reference: str                # first chromosome's sequence
    variants: List[Variant]       # first chromosome's variants
    chromosomes: Dict[str, str] = None          # name -> sequence
    variants_by_chrom: Dict[str, List[Variant]] = None


def make_dataset(outdir: str, ref_length: int = 8000, num_variants: int = 20,
                 coverage: float = 30.0, read_length: int = 120,
                 seed: int = 13, chromosome: str = "chrS",
                 platforms: Sequence[str] = ("illumina",),
                 pacbio_read_length: int = 1500,
                 hp_tags: bool = False,
                 num_chromosomes: int = 1,
                 sub_error_rate: float = 0.0,
                 indel_error_rate: float = 0.0) -> SimulatedDataset:
    """Write a complete simulated dataset into ``outdir``.

    With ``num_chromosomes`` > 1 the dataset spans several chromosomes
    (``<chromosome>``, ``<chromosome>2``, ...), each with its own variants.
    ``sub_error_rate`` / ``indel_error_rate`` add per-base sequencing errors
    (indel errors split evenly between 1 bp insertions and deletions)."""
    import os
    os.makedirs(outdir, exist_ok=True)
    rng = random.Random(seed)

    chrom_names = [chromosome if i == 0 else f"{chromosome}{i + 1}"
                   for i in range(num_chromosomes)]
    chromosomes = {}
    variants_by_chrom = {}
    for name in chrom_names:
        ref = random_reference(ref_length, rng)
        chromosomes[name] = ref
        variants_by_chrom[name] = plant_variants(ref, num_variants, rng)

    fasta_path = os.path.join(outdir, "ref.fa")
    write_fasta(fasta_path, chromosomes)

    contigs = {name: len(seq) for name, seq in chromosomes.items()}
    bams = {}
    for platform in platforms:
        pacbio = platform == "pacbio"
        rlen = pacbio_read_length if pacbio else read_length
        all_reads = []
        for name in chrom_names:
            all_reads.extend(simulate_reads(
                chromosomes[name], variants_by_chrom[name], name, coverage,
                min(rlen, ref_length // 2), rng, pacbio=pacbio,
                hp_tags=hp_tags and pacbio, name_prefix=f"{platform}_{name}_",
                sub_error_rate=sub_error_rate,
                indel_error_rate=indel_error_rate))
        path = os.path.join(outdir, f"{platform}.bam")
        write_bam(path, list(contigs.items()), all_reads)
        bams[platform] = path

    truth_path = os.path.join(outdir, "truth.vcf")
    records = []
    for name in chrom_names:
        for v in variants_by_chrom[name]:
            records.append(VcfRecord(name, v.position, v.ref, [v.alt],
                                     (v.genotype[0], v.genotype[1]), qual=50.0))
    write_vcf(truth_path, records, contigs=contigs)

    first = chrom_names[0]
    return SimulatedDataset(fasta_path, bams, truth_path, first,
                            chromosomes[first], list(variants_by_chrom[first]),
                            chromosomes=chromosomes,
                            variants_by_chrom=variants_by_chrom)
