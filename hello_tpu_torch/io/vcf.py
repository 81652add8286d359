"""VCF reading, writing, and record normalisation.

Record normalisation follows the reference's createVcfRecord
(reference python/vcfFromContigs.py:139-227): empty alleles are fixed by
left-extension with a reference base, then right parsimony trimming, then left
parsimony trimming; positions are emitted 1-based.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class VcfRecord:
    chromosome: str
    position: int          # 0-based internal position
    ref: str
    alt: List[str]
    gt: Tuple[int, int]
    qual: float = 30.0
    filter: str = "PASS"
    info: str = "."

    def key(self):
        return (self.chromosome, self.position)


def _fix_empty_alleles(chromosome, location, ref, alts, ref_lookup):
    """If any allele is empty, left-extend all alleles with the reference base
    (reference vcfFromContigs.fixEmptyAlleles:139-160)."""
    alts = [a.replace("-", "") for a in alts]
    if all(len(a) > 0 for a in [ref] + alts):
        return False, location, ref, alts
    location -= 1
    prepend = ref_lookup(chromosome, location)
    if not prepend:
        # chromosome start: nothing to extend with — emit as-is rather than
        # looping forever (only reachable for a variant at position 0)
        return False, location + 1, ref or "N", [a or "N" for a in alts]
    return True, location, prepend + ref, [prepend + a for a in alts]


def normalize_site(chromosome: str, location: int, ref: str, alts: Sequence[str],
                   ref_lookup) -> Tuple[int, str, List[str]]:
    """Normalise (position, ref, alts): empty-allele fixing + right/left parsimony.

    ref_lookup(chromosome, position) -> single reference base (0-based).
    """
    alts = list(alts)
    _, location, ref, alts = _fix_empty_alleles(chromosome, location, ref, alts, ref_lookup)

    if len(alts) == 0 or all(a == ref for a in alts):
        return location, ref, alts

    changed = True
    while changed:
        changed = False
        right = {ref[-1]} | {a[-1] for a in alts}
        if len(right) == 1:
            ref = ref[:-1]
            alts = [a[:-1] for a in alts]
            changed = True
        fixed, location, ref, alts = _fix_empty_alleles(chromosome, location, ref, alts, ref_lookup)
        changed = changed or fixed

    while len(ref) > 1 and min(len(a) for a in alts) > 1:
        left = {ref[0]} | {a[0] for a in alts}
        if len(left) != 1:
            break
        location += 1
        ref = ref[1:]
        alts = [a[1:] for a in alts]

    return location, ref, alts


def make_record(chromosome, position, ref_allele, alt_alleles, genotypes,
                ref_lookup, qual=30.0, qualifier="PASS", info="."):
    """Create a normalised VcfRecord, or None if there is nothing to emit."""
    if len(alt_alleles) == 0:
        return None
    location, ref, alts = normalize_site(chromosome, position, ref_allele,
                                         alt_alleles, ref_lookup)
    if len(alts) == 0 or all(a == ref for a in alts):
        return None
    return VcfRecord(chromosome, location, ref, alts, tuple(genotypes),
                     qual=qual, filter=qualifier, info=info)


VCF_HEADER = """##fileformat=VCFv4.2
##source=hello_tpu
{contigs}##FILTER=<ID=PASS,Description="All filters passed">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE
"""


def format_record(r: VcfRecord) -> str:
    return "%s\t%d\t.\t%s\t%s\t%f\t%s\t%s\tGT\t%s" % (
        r.chromosome, r.position + 1, r.ref, ",".join(r.alt), r.qual,
        r.filter, r.info, "/".join(str(g) for g in r.gt))


def record_sort_key(contigs: Optional[Dict[str, int]] = None):
    """Output ordering for VCFs: record order must follow the ##contig header
    order; lexicographic chromosome sort (chr1, chr10, chr11, ..., chr2)
    would break tabix/bcftools on multi-chromosome outputs."""
    if contigs:
        order = {name: i for i, name in enumerate(contigs)}
        return lambda r: (order.get(r.chromosome, len(order)),
                          r.chromosome, r.position)
    return lambda r: (r.chromosome, r.position)


def write_vcf(path: str, records: Iterable[VcfRecord],
              contigs: Optional[Dict[str, int]] = None, sort: bool = True):
    """Write records to a VCF file with a minimal header.

    With ``sort=False`` the records stream straight to disk (no
    materialisation) — the caller asserts they are already in output order.
    A ``.gz`` path writes BGZF-compressed with a tabix .tbi index alongside
    (write_vcf_gz), so ``--out calls.vcf.gz`` works through every caller,
    the spiller, and the multi-shard merge."""
    if path.endswith(".gz"):
        write_vcf_gz(path, records, contigs=contigs, sort=sort)
        return
    if sort:
        records = sorted(records, key=record_sort_key(contigs))
    contig_lines = ""
    if contigs:
        contig_lines = "".join(
            f"##contig=<ID={name},length={length}>\n" for name, length in contigs.items())
    with open(path, "w") as fh:
        fh.write(VCF_HEADER.format(contigs=contig_lines))
        for r in records:
            fh.write(format_record(r) + "\n")


def _open_maybe_gz(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def iter_vcf(path: str):
    """Parse a VCF lazily into records (positions converted to 0-based).

    GT is taken from the first sample column when present; '.' alleles and
    phased separators are handled.
    """
    with _open_maybe_gz(path) as fh:
        yield from iter_vcf_lines(
            line for line in fh if not line.startswith("#"))


def read_vcf(path: str) -> List[VcfRecord]:
    """Parse a VCF into a record list (see iter_vcf)."""
    return list(iter_vcf(path))


def left_align_normalize(chromosome: str, position: int, ref: str, alt: str,
                         ref_lookup) -> Tuple[int, str, str]:
    """Canonical variant normalisation (left-align + parsimony, vt-style).

    Used for representation-invariant comparison of call sets: two equivalent
    representations of the same indel (e.g. the caller's parsimony form vs a
    truth set's form) normalise to the same (position, ref, alt).
    """
    ref, alt = ref, alt
    while True:
        if ref and alt and ref[-1] == alt[-1] and (len(ref) > 1 or len(alt) > 1):
            ref, alt = ref[:-1], alt[:-1]
            if ref and alt:
                continue
        if not ref or not alt:
            position -= 1
            base = ref_lookup(chromosome, position)
            if not base:          # chromosome start: cannot extend further
                position += 1
                ref, alt = ref or "N", alt or "N"
                break
            ref, alt = base + ref, base + alt
            continue
        break
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref, alt = ref[1:], alt[1:]
        position += 1
    return position, ref, alt


class _UnsortedInput(Exception):
    pass


def merge_vcfs(paths: Sequence[str], out_path: str,
               contigs: Optional[Dict[str, int]] = None,
               max_open: int = 256):
    """Merge per-shard VCFs into one sorted output (replaces the reference's
    cat + vcf-sort step, reference prepareVcf.py:185-260).

    Per-shard outputs are written sorted, so the merge streams: a k-way heap
    over lazy readers holds one record per input — O(shards) memory, not
    O(records), which is what whole-genome merges need.  More than
    ``max_open`` inputs merge hierarchically (groups into intermediate
    shards, then a final pass) so the heap never holds more than ``max_open``
    open file handles.  An input that turns out not to be internally sorted
    (foreign VCFs are accepted, like the reference's vcf-sort) aborts the
    stream and falls back to an in-memory sort of everything."""
    import heapq
    import os

    key = record_sort_key(contigs)

    # the output may be among the inputs (e.g. a rerun of
    # `merge --inputs 'dir/*.vcf' --out dir/calls.vcf` globs the previous
    # output): write_vcf would truncate it before the lazy readers open it,
    # silently dropping its records — stage through a sibling temp file
    out_real = os.path.realpath(out_path)
    if any(os.path.realpath(p) == out_real for p in paths):
        suffix = ".gz" if out_path.endswith(".gz") else ""
        staged = out_path + ".merging.tmp" + suffix
        try:
            merge_vcfs(paths, staged, contigs=contigs, max_open=max_open)
            os.replace(staged, out_path)
            if os.path.exists(staged + ".tbi"):     # .gz staging wrote one
                os.replace(staged + ".tbi", out_path + ".tbi")
        finally:
            for leftover in (staged, staged + ".tbi"):
                if os.path.exists(leftover):
                    try:
                        os.unlink(leftover)
                    except OSError:
                        pass
        return

    if len(paths) > max_open:
        import tempfile
        out_dir = os.path.dirname(os.path.abspath(out_path)) or "."
        intermediates = []
        try:
            for i in range(0, len(paths), max_open):
                # intermediates live next to the output (same filesystem,
                # not a possibly-small /tmp) — they can be GBs
                fd, tmp = tempfile.mkstemp(suffix=".merge.vcf", dir=out_dir)
                os.close(fd)
                intermediates.append(tmp)
                merge_vcfs(paths[i:i + max_open], tmp, contigs=contigs,
                           max_open=max_open)
            merge_vcfs(intermediates, out_path, contigs=contigs,
                       max_open=max_open)
        finally:
            for tmp in intermediates:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return

    def _checked_merge():
        last = None
        for r in heapq.merge(*(iter_vcf(p) for p in paths), key=key):
            k = key(r)
            if last is not None and k < last:
                raise _UnsortedInput
            last = k
            yield r

    try:
        write_vcf(out_path, _checked_merge(), contigs=contigs, sort=False)
    except _UnsortedInput:
        all_records: List[VcfRecord] = []
        for p in paths:
            all_records.extend(read_vcf(p))
        write_vcf(out_path, all_records, contigs=contigs, sort=True)


# ---------------------------------------------------------------------------
# BGZF-compressed VCF (.vcf.gz) + tabix (.tbi) index
#
# The reference pipeline stops at plain sorted VCFs (prepareVcf.py merge +
# vcf-sort); production consumers then run bgzip + tabix externally.  The
# framework carries its own BGZF codec for BAM already (io/bam.py), so the
# compressed + indexed form is built in: write_vcf_gz streams records into
# BGZF blocks while building the standard tabix index (binning + 16 kb
# linear index, the same scheme as .bai), and fetch_vcf_gz answers region
# queries in O(region) via the index — the symmetric reader that also
# serves as the index's self-verification (no htslib in this environment).
# ---------------------------------------------------------------------------


class _BgzfTextWriter:
    """Streaming BGZF writer that exposes htslib virtual offsets
    (``coffset << 16 | in-block offset``) for index construction."""

    BLOCK = 60000          # uncompressed payload per block (max 65535)

    def __init__(self, fh):
        self._fh = fh
        self._buf = bytearray()
        self._coffset = 0

    @property
    def voffset(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= self.BLOCK:
            self._flush(self.BLOCK)

    def _flush(self, n: Optional[int] = None):
        from .bam import _bgzf_compress_block
        chunk = bytes(self._buf[:n] if n else self._buf)
        del self._buf[:len(chunk)]
        block = _bgzf_compress_block(chunk)
        self._fh.write(block)
        self._coffset += len(block)

    def close(self):
        from .bam import BGZF_EOF
        if self._buf:
            self._flush()
        self._fh.write(BGZF_EOF)


def write_vcf_gz(path: str, records: Iterable[VcfRecord],
                 contigs: Optional[Dict[str, int]] = None, sort: bool = True,
                 index: bool = True) -> str:
    """Write a BGZF-compressed VCF with a tabix ``.tbi`` index alongside.

    Returns the index path (or the empty string with ``index=False``).
    Records must arrive in output order when ``sort=False`` (as write_vcf).
    """
    import struct

    from .bam import BaiIndex

    if sort:
        records = sorted(records, key=record_sort_key(contigs))
    contig_lines = ""
    if contigs:
        contig_lines = "".join(
            f"##contig=<ID={name},length={length}>\n"
            for name, length in contigs.items())

    names: List[str] = []          # contigs in order of appearance
    ids: Dict[str, int] = {}
    idx = BaiIndex(0)              # bins/linear grown on demand
    with open(path, "wb") as fh:
        w = _BgzfTextWriter(fh)
        w.write(VCF_HEADER.format(contigs=contig_lines).encode())
        for r in records:
            rid = ids.get(r.chromosome)
            if rid is None:
                rid = ids[r.chromosome] = len(names)
                names.append(r.chromosome)
                idx.bins.append({})
                idx.linear.append([])
            vbeg = w.voffset
            w.write((format_record(r) + "\n").encode())
            idx.add_record(rid, r.position, r.position + len(r.ref),
                           vbeg, w.voffset)
        w.close()

    if not index:
        return ""
    nm = b"".join(n.encode() + b"\0" for n in names)
    out = bytearray(b"TBI\x01")
    out += struct.pack("<8i", len(names), 2, 1, 2, 0, ord("#"), 0, len(nm))
    out += nm
    for bins, linear in zip(idx.bins, idx.linear):
        out += struct.pack("<i", len(bins))
        for bin_id in sorted(bins):
            chunks = bins[bin_id]
            out += struct.pack("<Ii", bin_id, len(chunks))
            for vbeg, vend in chunks:
                out += struct.pack("<QQ", vbeg, vend)
        out += struct.pack("<i", len(linear))
        for ioffset in linear:
            out += struct.pack("<Q", ioffset)
    tbi_path = path + ".tbi"
    with open(tbi_path, "wb") as fh:
        fh.write(bytes(out))
    return tbi_path


def fetch_vcf_gz(path: str, chromosome: str, start: int, stop: int):
    """Region query over an indexed ``.vcf.gz``: yields VcfRecords whose
    [position, position + len(ref)) overlaps [start, stop) — O(region)
    through the .tbi linear index, like the BAM region fetch."""
    import struct

    from .bam import BgzfFile, BgzfStream

    with open(path + ".tbi", "rb") as fh:
        data = fh.read()
    if data[:4] != b"TBI\x01":
        raise ValueError(f"not a tabix index: {path}.tbi")
    n_ref, _fmt, _cs, _cb, _ce, _meta, _skip, l_nm = struct.unpack_from(
        "<8i", data, 4)
    pos = 36
    names = bytes(data[pos:pos + l_nm]).split(b"\0")[:-1]
    pos += l_nm
    linear_by_ref: List[List[int]] = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, pos)
        pos += 4
        for _b in range(n_bin):
            _bin_id, n_chunk = struct.unpack_from("<Ii", data, pos)
            pos += 8 + 16 * n_chunk
        (n_intv,) = struct.unpack_from("<i", data, pos)
        pos += 4
        linear_by_ref.append(
            list(struct.unpack_from(f"<{n_intv}Q", data, pos)))
        pos += 8 * n_intv

    try:
        rid = names.index(chromosome.encode())
    except ValueError:
        return
    voffset = None
    lin = linear_by_ref[rid]
    for w in range(start >> 14, len(lin)):
        if lin[w]:
            voffset = lin[w]
            break
    if voffset is None:
        return

    bgzf = BgzfFile(path)
    try:
        stream = BgzfStream(bgzf, voffset)
        tail = b""
        while True:
            chunk = stream.read(65536)
            if not chunk:
                break
            tail += chunk
            *lines, tail = tail.split(b"\n")
            for line in lines:
                if not line or line.startswith(b"#"):
                    continue
                for r in iter_vcf_lines([line.decode()]):
                    if r.chromosome != chromosome or r.position >= stop:
                        return
                    if r.position + len(r.ref) <= start:
                        continue
                    yield r
    finally:
        bgzf.close()


def iter_vcf_lines(lines: Iterable[str]):
    """Parse VCF body lines (no header) into records — the line-level core
    of iter_vcf, shared with the indexed .vcf.gz fetch path."""
    for line in lines:
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 8:
            continue
        chrom, p, _id, ref, alt = (fields[0], int(fields[1]) - 1, fields[2],
                                   fields[3], fields[4])
        try:
            qual = float(fields[5])
        except ValueError:
            qual = 0.0
        gt = (0, 0)
        if len(fields) >= 10:
            fmt = fields[8].split(":")
            sample = fields[9].split(":")
            if "GT" in fmt:
                gtstr = sample[fmt.index("GT")]
                sep = "|" if "|" in gtstr else "/"
                vals = [0 if x == "." else int(x) for x in gtstr.split(sep)]
                if len(vals) == 1:
                    vals = vals * 2
                gt = tuple(vals[:2])
        alts = [] if alt in (".", "") else alt.split(",")
        yield VcfRecord(chrom, p, ref, alts, gt, qual=qual,
                        filter=fields[6], info=fields[7])
