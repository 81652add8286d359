"""BAM reading and writing (self-contained BGZF + BAM record codec + BAI).

The reference pipeline reads alignments through pysam/htslib (indexed
``bam.fetch``, reference python/PileupContainerLite.py:505-527).  This
framework ships its own codec so the host layer has no external dependency;
the C++ native engine mirrors it for production throughput.  Supports:

  * BGZF block (de)compression with the standard EOF marker, including
    virtual-offset (coffset << 16 | uoffset) seeks;
  * BAM header and alignment record parsing (sequence, qualities, cigar,
    flags, mapq, aux tags — HP haplotag extracted);
  * **indexed region fetch** through standard ``.bai`` files — O(region)
    block decoding via the 16 kb linear index — with automatic index
    construction (one streaming pass, persisted next to the BAM) when a
    sorted BAM has no index, and a linear-scan fallback for unsorted input;
  * BAM + BAI writing for simulators and tests.

Coordinates are 0-based half-open throughout.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..reads import AlignedRead

logger = logging.getLogger(__name__)

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODES = "=ACMGRSVTWYHKDBN"
BAM_CREF_SKIP_OP = 3
BAM_CSOFT_CLIP_OP = 4
MAX_CIGAR_OPS = 65535          # uint16 n_cigar_op; beyond this the CG tag rules


# ---------------------------------------------------------------------------
# BGZF layer
# ---------------------------------------------------------------------------

def _bgzf_compress_block(data: bytes) -> bytes:
    compressor = zlib.compressobj(6, zlib.DEFLATED, -15)
    compressed = compressor.compress(data) + compressor.flush()
    crc = zlib.crc32(data) & 0xFFFFFFFF
    bsize = len(compressed) + 25 + 1  # header(18) + footer(8) minus 1 stored
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,              # mtime, xfl, os
        6,                       # xlen
        0x42, 0x43, 2,           # BC subfield
        bsize - 1 + 0,           # BSIZE - 1
    )
    footer = struct.pack("<II", crc, len(data))
    return header + compressed + footer


def bgzf_write(path: str, payload: bytes, block_size: int = 60000):
    """Write payload as BGZF; returns the compressed offset of each block
    (for virtual-offset index construction)."""
    offsets = []
    with open(path, "wb") as fh:
        pos = 0
        for i in range(0, len(payload), block_size):
            offsets.append(pos)
            block = _bgzf_compress_block(payload[i:i + block_size])
            fh.write(block)
            pos += len(block)
        fh.write(BGZF_EOF)
    return offsets


def _block_bsize(extra: bytes) -> int:
    """Total compressed block size from the gzip FEXTRA BC subfield."""
    off = 0
    while off + 4 <= len(extra):
        si1, si2 = extra[off], extra[off + 1]
        slen = struct.unpack_from("<H", extra, off + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            return struct.unpack_from("<H", extra, off + 4)[0] + 1
        off += 4 + slen
    raise ValueError("not a BGZF file (no BC subfield)")


class BgzfFile:
    """Random-access BGZF block decoder over an open file handle."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def read_block(self, coffset: int):
        """Decompress the block at compressed offset ``coffset``.

        Returns ``(payload, next_coffset)``; ``next_coffset == coffset``
        signals end of file."""
        fh = self._fh
        fh.seek(coffset)
        header = fh.read(18)
        if len(header) < 18:
            return b"", coffset
        xlen = struct.unpack_from("<H", header, 10)[0]
        extra = header[12:18] + (fh.read(xlen - 6) if xlen > 6 else b"")
        bsize = _block_bsize(extra[:xlen])
        rest = fh.read(bsize - 12 - xlen)
        cdata = rest[:len(rest) - 8]
        isize = struct.unpack_from("<I", rest, len(rest) - 4)[0]
        payload = zlib.decompress(cdata, -15) if isize else b""
        return payload, coffset + bsize


class BgzfStream:
    """Sequential reader over BGZF payload starting at a virtual offset
    (``coffset << 16 | uoffset``, the htslib convention)."""

    def __init__(self, bgzf: BgzfFile, voffset: int = 0):
        self._bgzf = bgzf
        self._next_coffset = voffset >> 16
        self._block = b""
        self._block_coffset = self._next_coffset
        self._off = 0
        skip = voffset & 0xFFFF
        if self._advance_block():
            self._off = min(skip, len(self._block))

    def _advance_block(self) -> bool:
        while True:
            coffset = self._next_coffset
            payload, nxt = self._bgzf.read_block(coffset)
            if nxt == coffset:          # end of file
                self._block, self._off = b"", 0
                return False
            self._block_coffset = coffset
            self._next_coffset = nxt
            self._block, self._off = payload, 0
            if payload:                 # skip empty blocks (EOF marker)
                return True

    @property
    def voffset(self) -> int:
        if self._off >= len(self._block):
            return self._next_coffset << 16
        return (self._block_coffset << 16) | self._off

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._off >= len(self._block):
                if not self._advance_block():
                    break
            take = min(n, len(self._block) - self._off)
            out += self._block[self._off:self._off + take]
            self._off += take
            n -= take
        return bytes(out)


def bgzf_read(path: str) -> bytes:
    """Decompress a whole BGZF file into one payload buffer."""
    out = []
    bgzf = BgzfFile(path)
    try:
        coffset = 0
        while True:
            payload, nxt = bgzf.read_block(coffset)
            if nxt == coffset:
                break
            if payload:
                out.append(payload)
            coffset = nxt
    finally:
        bgzf.close()
    return b"".join(out)


# ---------------------------------------------------------------------------
# BAM records
# ---------------------------------------------------------------------------

def _encode_seq(seq: str) -> bytes:
    codes = {c: i for i, c in enumerate(_SEQ_CODES)}
    out = bytearray((len(seq) + 1) // 2)
    for i, base in enumerate(seq):
        code = codes.get(base.upper(), 15)
        if i % 2 == 0:
            out[i // 2] = code << 4
        else:
            out[i // 2] |= code
    return bytes(out)


def _decode_seq(data: bytes, length: int) -> str:
    out = []
    for i in range(length):
        byte = data[i // 2]
        code = (byte >> 4) if i % 2 == 0 else (byte & 0xF)
        out.append(_SEQ_CODES[code])
    return "".join(out)


def _scan_aux(aux: bytes, want: bytes):
    """Yield (tag, typ, payload offset, payload length) for each aux field;
    stops early once every tag in ``want`` has been seen."""
    pos = 0
    n = len(aux)
    sizes = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4, b"A": 1}
    found = set()
    while pos + 3 <= n:
        tag = aux[pos:pos + 2]
        typ = aux[pos + 2:pos + 3]
        pos += 3
        if typ in sizes:
            yield tag, typ, pos, sizes[typ]
            pos += sizes[typ]
        elif typ in (b"Z", b"H"):
            end = aux.index(b"\x00", pos)
            yield tag, typ, pos, end - pos
            pos = end + 1
        elif typ == b"B":
            sub = aux[pos:pos + 1]
            count = struct.unpack_from("<I", aux, pos + 1)[0]
            length = 5 + sizes[sub] * count
            yield tag, typ, pos, length
            pos += length
        else:
            return
        found.add(bytes(tag))
        if want and want <= found:
            return


def _parse_aux_hp(aux: bytes) -> int:
    """Extract the HP:i tag from an aux blob; 0 when absent."""
    fmt = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i", b"I": "<I"}
    for tag, typ, pos, _length in _scan_aux(aux, {b"HP"}):
        if tag == b"HP" and typ in fmt:
            return struct.unpack_from(fmt[typ], aux, pos)[0]
    return 0


def _parse_aux_cg_cigar(aux: bytes):
    """The real cigar from a CG:B,I aux tag (SAM spec: alignments with more
    than 65535 cigar ops store a kS/mN placeholder in the cigar field and the
    true run here); None when absent."""
    for tag, typ, pos, _length in _scan_aux(aux, {b"CG"}):
        if tag == b"CG" and typ == b"B" and aux[pos:pos + 1] == b"I":
            count = struct.unpack_from("<I", aux, pos + 1)[0]
            vals = struct.unpack_from(f"<{count}I", aux, pos + 5)
            return [(v & 0xF, v >> 4) for v in vals]
    return None


class BaiIndex:
    """Standard ``.bai`` index: per-reference binning + 16 kb linear index.

    The region-fetch path here uses the linear index only (seek to the
    smallest virtual offset of alignments overlapping the first 16 kb
    window of the region, then stream until past the region) — O(region)
    decoding with at most one extra window of lead-in, matching early
    samtools behaviour.  Bins are read and written for interoperability
    with htslib tooling."""

    MAGIC = b"BAI\x01"
    SHIFT = 14                       # 16 kb linear-index windows

    def __init__(self, n_ref: int):
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = [
            {} for _ in range(n_ref)]
        self.linear: List[List[int]] = [[] for _ in range(n_ref)]

    def add_record(self, ref_id: int, pos: int, end: int,
                   vbeg: int, vend: int):
        end = max(end, pos + 1)
        chunks = self.bins[ref_id].setdefault(_reg2bin(pos, end), [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        lin = self.linear[ref_id]
        w1, w2 = pos >> self.SHIFT, (end - 1) >> self.SHIFT
        if len(lin) <= w2:
            lin.extend([0] * (w2 + 1 - len(lin)))
        for w in range(w1, w2 + 1):
            if lin[w] == 0 or vbeg < lin[w]:
                lin[w] = vbeg

    def first_voffset(self, ref_id: int, start: int) -> Optional[int]:
        """Seek point for a fetch beginning at ``start``: the first non-empty
        linear-index entry at or after start's window (an alignment
        overlapping [start, ...) must overlap one of those windows)."""
        if not (0 <= ref_id < len(self.linear)):
            return None
        lin = self.linear[ref_id]
        for w in range(start >> self.SHIFT, len(lin)):
            if lin[w]:
                return lin[w]
        return None

    def save(self, path: str):
        out = bytearray(self.MAGIC)
        out += struct.pack("<i", len(self.bins))
        for bins, linear in zip(self.bins, self.linear):
            out += struct.pack("<i", len(bins))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for vbeg, vend in chunks:
                    out += struct.pack("<QQ", vbeg, vend)
            out += struct.pack("<i", len(linear))
            for ioffset in linear:
                out += struct.pack("<Q", ioffset)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(out)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != cls.MAGIC:
            raise ValueError(f"{path}: not a BAI index")
        n_ref = struct.unpack_from("<i", data, 4)[0]
        idx = cls(n_ref)
        pos = 8
        for r in range(n_ref):
            n_bin = struct.unpack_from("<i", data, pos)[0]
            pos += 4
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, pos)
                pos += 8
                chunks = []
                for _ in range(n_chunk):
                    vbeg, vend = struct.unpack_from("<QQ", data, pos)
                    pos += 16
                    chunks.append((vbeg, vend))
                # bin 37450 is htslib's metadata pseudo-bin; skip
                if bin_id != 37450:
                    idx.bins[r][bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, pos)[0]
            pos += 4
            idx.linear[r] = list(struct.unpack_from(f"<{n_intv}Q", data, pos))
            pos += 8 * n_intv
        return idx


def _bai_cache_path(path: str) -> str:
    """Fallback .bai location for BAMs in read-only directories: a per-user
    cache keyed by the BAM's absolute path."""
    import hashlib
    digest = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()
    return os.path.join(os.path.expanduser("~/.cache/hello_tpu/bai"),
                        digest + ".bai")


def _bai_path_for(path: str) -> Optional[str]:
    for cand in (path + ".bai", os.path.splitext(path)[0] + ".bai",
                 _bai_cache_path(path)):
        if os.path.exists(cand):
            return cand
    return None


class UnsortedBamError(ValueError):
    pass


_REC_HEAD = struct.Struct("<iiBBHHHiiii")


def _parse_record(rec: bytes):
    """Decode one alignment record blob into
    (r_id, pos, ref_span, flag, mapq, name, cigars, seq, quals, hp)."""
    (r_id, p, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_rid, _next_pos, _tlen) = _REC_HEAD.unpack_from(rec, 0)
    off = 32
    name = rec[off:off + l_read_name - 1].decode()
    off += l_read_name
    cigars = []
    ref_span = 0
    for i in range(n_cigar):
        v = struct.unpack_from("<I", rec, off + 4 * i)[0]
        op, length = v & 0xF, v >> 4
        cigars.append((op, length))
        if op in (0, 2, 3, 7, 8):
            ref_span += length
    off += 4 * n_cigar
    seq = _decode_seq(rec[off:off + (l_seq + 1) // 2], l_seq)
    off += (l_seq + 1) // 2
    quals = list(rec[off:off + l_seq])
    if quals and quals[0] == 0xFF:
        quals = [30] * l_seq
    off += l_seq
    hp = _parse_aux_hp(rec[off:])
    if (len(cigars) == 2 and cigars[0] == (BAM_CSOFT_CLIP_OP, l_seq)
            and cigars[1][0] == BAM_CREF_SKIP_OP):
        # >65535-op alignment: kS/mN placeholder, true cigar in CG:B,I
        real = _parse_aux_cg_cigar(rec[off:])
        if real is not None:
            cigars = real
    return r_id, p, ref_span, flag, mapq, name, cigars, seq, quals, hp


def _record_span(rec: bytes):
    """(r_id, pos, end) without decoding sequence/name (for indexing)."""
    (r_id, p, _lrn, _mapq, _bin, n_cigar, _flag, _l_seq,
     _nr, _np, _tl) = _REC_HEAD.unpack_from(rec, 0)
    off = 32 + (rec[8])  # l_read_name at byte 8
    ref_span = 0
    for i in range(n_cigar):
        v = struct.unpack_from("<I", rec, off + 4 * i)[0]
        if (v & 0xF) in (0, 2, 3, 7, 8):
            ref_span += v >> 4
    return r_id, p, p + ref_span


def build_index(path: str, write: bool = True) -> BaiIndex:
    """Build a ``.bai`` for a coordinate-sorted BAM in one streaming pass
    (persisted next to the BAM when the directory is writable, so the cost
    is paid once per file ever).  Raises :class:`UnsortedBamError` when the
    input is not coordinate-sorted."""
    bgzf = BgzfFile(path)
    try:
        stream = BgzfStream(bgzf, 0)
        if stream.read(4) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", stream.read(4))[0]
        stream.read(l_text)
        n_ref = struct.unpack("<i", stream.read(4))[0]
        for _ in range(n_ref):
            l_name = struct.unpack("<i", stream.read(4))[0]
            stream.read(l_name + 4)
        idx = BaiIndex(n_ref)
        last = (-1, -1)
        while True:
            vbeg = stream.voffset
            head = stream.read(4)
            if len(head) < 4:
                break
            block_size = struct.unpack("<i", head)[0]
            rec = stream.read(block_size)
            if len(rec) < block_size:
                break
            r_id, pos, end = _record_span(rec)
            vend = stream.voffset
            if r_id < 0:
                continue                     # unmapped tail
            key = (r_id, pos)
            if key < last:
                raise UnsortedBamError(
                    f"{path}: not coordinate-sorted at {key} after {last}")
            last = key
            idx.add_record(r_id, pos, end, vbeg, vend)
    finally:
        bgzf.close()
    if write:
        try:
            idx.save(path + ".bai")
        except OSError:
            # read-only directory: persist in the per-user cache instead
            # (found again by _bai_path_for, incl. by the native reader)
            try:
                cache = _bai_cache_path(path)
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                idx.save(cache)
            except OSError:
                pass                         # cache also unwritable: in-memory
    return idx


class BamReader:
    """Indexed BAM reader: lazy header parse, BAI-seek region fetch with a
    linear-scan fallback, and whole-file iteration."""

    def __init__(self, path: str, pacbio: bool = False):
        self.path = path
        self.pacbio = pacbio
        self._bgzf = BgzfFile(path)
        stream = BgzfStream(self._bgzf, 0)
        if stream.read(4) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", stream.read(4))[0]
        stream.read(l_text)
        n_ref = struct.unpack("<i", stream.read(4))[0]
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", stream.read(4))[0]
            blob = stream.read(l_name + 4)
            name = blob[:l_name - 1].decode()
            l_ref = struct.unpack_from("<i", blob, l_name)[0]
            self.references.append((name, l_ref))
        self._records_voffset = stream.voffset
        self._index = None        # None = not yet resolved; False = unavailable

    def close(self):
        self._bgzf.close()

    def _ensure_index(self) -> Optional[BaiIndex]:
        if self._index is None:
            bai = _bai_path_for(self.path)
            try:
                self._index = (BaiIndex.load(bai) if bai
                               else build_index(self.path))
            except UnsortedBamError:
                self._index = False
            except Exception:
                # corrupt/truncated/foreign .bai: the index is an access-path
                # optimisation — fall back to the linear scan, never crash
                logger.warning("unusable BAM index for %s; falling back to "
                               "linear scan", self.path, exc_info=True)
                self._index = False
        return self._index or None

    def _records_from_stream(self, stream: BgzfStream,
                             ref_id: Optional[int] = None,
                             start: Optional[int] = None,
                             stop: Optional[int] = None,
                             assume_sorted: bool = False
                             ) -> Iterator[AlignedRead]:
        indexed = assume_sorted and ref_id is not None and start is not None
        while True:
            head = stream.read(4)
            if len(head) < 4:
                return
            block_size = struct.unpack("<i", head)[0]
            rec = stream.read(block_size)
            if len(rec) < block_size:
                return
            (r_id, p, ref_span, flag, mapq, name, cigars, seq, quals,
             hp) = _parse_record(rec)
            if ref_id is not None and r_id != ref_id:
                if indexed and (r_id < 0 or r_id > ref_id):
                    return               # sorted order: past the chromosome
                continue
            if start is not None:
                if indexed and p >= stop:
                    return               # sorted order: past the region
                if not (p < stop and start < p + ref_span):
                    continue
            chrom = (self.references[r_id][0]
                     if 0 <= r_id < len(self.references) else "*")
            yield AlignedRead(
                name=name, flag=flag, chromosome=chrom, reference_start=p,
                mapq=mapq, cigartuples=cigars, sequence=seq, qualities=quals,
                hp=hp, pacbio=self.pacbio)

    def __iter__(self) -> Iterator[AlignedRead]:
        return self._records_from_stream(
            BgzfStream(self._bgzf, self._records_voffset))

    def _ref_id(self, chromosome: str) -> Optional[int]:
        for i, (name, _len) in enumerate(self.references):
            if name == chromosome:
                return i
        return None

    def fetch(self, chromosome: str, start: int, stop: int
              ) -> Iterator[AlignedRead]:
        """Reads overlapping [start, stop): O(region) via the BAI linear
        index when available, linear scan otherwise."""
        ref_id = self._ref_id(chromosome)
        if ref_id is None:
            return iter(())
        index = self._ensure_index()
        if index is None:
            # unsorted input: full scan with overlap filter
            return self._records_from_stream(
                BgzfStream(self._bgzf, self._records_voffset),
                ref_id=ref_id, start=start, stop=stop)
        voffset = index.first_voffset(ref_id, start)
        if voffset is None:
            return iter(())
        return self._records_from_stream(
            BgzfStream(self._bgzf, voffset),
            ref_id=ref_id, start=start, stop=stop, assume_sorted=True)


def detect_chr_prefix(bam_references, fasta_chromosomes) -> str:
    """Detect the chromosome-name prefix difference between a BAM and a FASTA
    (e.g. BAM "chr20" vs FASTA "20") — reference python/find_chr_prefixes.py.

    Returns the prefix to prepend to FASTA names to obtain BAM names
    ("" when they already match); raises when no consistent prefix exists."""
    bam_names = {name for name, _l in bam_references}
    fasta_names = list(fasta_chromosomes)
    for prefix in ("", "chr", "Chr", "CHR"):
        if all((prefix + c) in bam_names for c in fasta_names):
            return prefix
    # BAM "20" vs FASTA "chr20" cannot be fixed by PREPENDING a prefix —
    # raise with a hint instead of returning a misleading ""
    stripped = {c[3:] if c.lower().startswith("chr") else c for c in fasta_names}
    if all(c in bam_names for c in stripped):
        raise ValueError(
            "BAM names lack the FASTA's 'chr' prefix (e.g. BAM '20' vs FASTA "
            "'chr20'): strip the prefix from the FASTA names — no prefix can "
            "be prepended to reconcile them")
    raise ValueError(
        f"no consistent chromosome prefix: bam={sorted(bam_names)[:5]} "
        f"fasta={fasta_names[:5]}")


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_read_record(read: AlignedRead, rid: int) -> bytes:
    """One BAM alignment record (block_size prefix included)."""
    name_b = read.name.encode() + b"\x00"
    cigartuples = read.cigartuples
    aux_b = b""
    if len(cigartuples) > MAX_CIGAR_OPS:
        # SAM spec long-cigar encoding: kS/mN placeholder in the cigar
        # field, real run in the CG:B,I aux tag
        ref_span = read.reference_end - read.reference_start
        aux_b += b"CGBI" + struct.pack("<I", len(cigartuples)) + b"".join(
            struct.pack("<I", (length << 4) | op)
            for op, length in cigartuples)
        cigartuples = [(BAM_CSOFT_CLIP_OP, len(read.sequence)),
                       (BAM_CREF_SKIP_OP, ref_span)]
    cigar_b = b"".join(
        struct.pack("<I", (length << 4) | op) for op, length in cigartuples)
    seq_b = _encode_seq(read.sequence)
    qual_b = bytes(min(q, 93) for q in read.qualities)
    if read.hp:
        aux_b += b"HP" + b"i" + struct.pack("<i", read.hp)
    bin_ = _reg2bin(read.reference_start, read.reference_end)
    rec = struct.pack(
        "<iiBBHHHiiii", rid, read.reference_start, len(name_b), read.mapq,
        bin_, len(cigartuples), read.flag, len(read.sequence),
        -1, -1, 0)
    rec += name_b + cigar_b + seq_b + qual_b + aux_b
    return struct.pack("<i", len(rec)) + rec


class BamStreamWriter:
    """Incremental coordinate-sorted BAM writer with bounded memory.

    ``write_bam`` materialises the whole uncompressed payload, which a
    genome-scale simulation (tens of millions of reads) cannot afford; this
    writer compresses fixed-size BGZF blocks as the payload fills and builds
    the ``.bai`` index on the fly, so memory stays O(block) regardless of
    file size.  Reads must arrive in coordinate order (reference order, then
    position) — the order ``write_bam`` would have detected as sorted.
    Produces byte-identical output to ``write_bam`` on the same reads."""

    def __init__(self, path: str, references: Sequence[Tuple[str, int]],
                 write_index: bool = True, block_size: int = 60000):
        self.path = path
        self.block_size = block_size
        self.write_index = write_index
        self.references = list(references)
        self._ref_index = {name: i for i, (name, _l) in enumerate(references)}
        self._fh = open(path, "wb")
        self._cpos = 0                 # compressed bytes written so far
        self._coffsets: List[int] = []  # compressed offset of each full block
        self._buf = bytearray()        # pending uncompressed payload tail
        self._base = 0                 # uncompressed offset of _buf[0]
        self._spans: List[Tuple[int, int, int, int, int]] = []
        self._idx = BaiIndex(len(self.references)) if write_index else None
        self._last_key = (-1, -1)
        self.is_sorted = True

        header_text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n"
                              for n, l in self.references)
        hdr = bytearray()
        hdr += b"BAM\x01"
        hdr += struct.pack("<i", len(header_text))
        hdr += header_text.encode()
        hdr += struct.pack("<i", len(self.references))
        for name, length in self.references:
            hdr += struct.pack("<i", len(name) + 1)
            hdr += name.encode() + b"\x00"
            hdr += struct.pack("<i", length)
        self._append(bytes(hdr))

    def _append(self, data: bytes):
        self._buf += data
        flushed = False
        while len(self._buf) >= self.block_size:
            block = _bgzf_compress_block(bytes(self._buf[:self.block_size]))
            self._coffsets.append(self._cpos)
            self._fh.write(block)
            self._cpos += len(block)
            del self._buf[:self.block_size]
            self._base += self.block_size
            flushed = True
        if flushed:
            self._resolve_spans()

    def _voffset(self, payload_offset: int) -> int:
        return (self._coffsets[payload_offset // self.block_size] << 16) \
            | (payload_offset % self.block_size)

    def _resolve_spans(self, final: bool = False):
        """Feed spans whose blocks are flushed (so compressed offsets are
        known) into the index; only the current partial block's records stay
        pending."""
        if self._idx is None:
            self._spans.clear()
            return
        done = len(self._coffsets) * self.block_size
        keep = []
        for begin, end_off, rid, pos, end in self._spans:
            if final or (end_off - 1 < done and begin < done):
                self._idx.add_record(rid, pos, end, self._voffset(begin),
                                     self._voffset(end_off - 1) + 1)
            else:
                keep.append((begin, end_off, rid, pos, end))
        self._spans = keep

    def add_reads(self, reads: Sequence[AlignedRead]):
        for read in reads:
            rid = self._ref_index[read.chromosome]
            key = (rid, read.reference_start)
            if key < self._last_key:
                self.is_sorted = False
            self._last_key = key
            rec = _encode_read_record(read, rid)
            begin = self._base + len(self._buf)
            self._spans.append((begin, begin + len(rec), rid,
                                read.reference_start, read.reference_end))
            self._append(rec)

    def close(self):
        if self._fh is None:
            return
        if self._buf:
            block = _bgzf_compress_block(bytes(self._buf))
            self._coffsets.append(self._cpos)
            self._fh.write(block)
            self._cpos += len(block)
            self._base += len(self._buf)
            self._buf.clear()
        self._resolve_spans(final=True)
        self._fh.write(BGZF_EOF)
        self._fh.close()
        self._fh = None
        if self._idx is not None and self.is_sorted:
            self._idx.save(self.path + ".bai")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_bam(path: str, references: Sequence[Tuple[str, int]],
              reads: Sequence[AlignedRead], write_index: bool = True):
    """Write reads to a BAM file; when they are coordinate-sorted, a ``.bai``
    index is written alongside (``write_index=False`` disables)."""
    w = BamStreamWriter(path, references, write_index=write_index)
    w.add_reads(reads)
    w.close()
