"""Indexed FASTA access (replaces the reference's pysam FASTA wrapper,
reference python/PySamFastaWrapper.py).

Uses the standard .fai index when present and builds one on the fly otherwise.
All coordinates are 0-based half-open.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


class FastaFile:
    def __init__(self, path: str):
        self.path = path
        self.index: Dict[str, Tuple[int, int, int, int]] = {}  # length, offset, linebases, linewidth
        self._order: List[str] = []
        fai = path + ".fai"
        if os.path.exists(fai):
            self._load_fai(fai)
        else:
            self._build_index()
            # persist the index (samtools faidx behaviour): rebuilding means
            # scanning the whole file, which a multi-process genome run would
            # otherwise pay per worker per chunk (~2 s per 100 MB)
            try:
                self._save_fai(fai)
            except OSError:
                pass              # read-only location: in-memory index only
        self._fh = open(path, "rb")

    def _save_fai(self, fai):
        tmp = f"{fai}.tmp{os.getpid()}"    # concurrent workers: atomic replace
        with open(tmp, "w") as fh:
            for name in self._order:
                length, offset, linebases, linewidth = self.index[name]
                fh.write(f"{name}\t{length}\t{offset}\t{linebases}\t"
                         f"{linewidth}\n")
        os.replace(tmp, fai)

    def _load_fai(self, fai):
        with open(fai) as fh:
            for line in fh:
                name, length, offset, linebases, linewidth = line.split()[:5]
                self.index[name] = (int(length), int(offset), int(linebases), int(linewidth))
                self._order.append(name)

    def _build_index(self):
        with open(self.path, "rb") as fh:
            name = None
            length = 0
            offset = 0
            linebases = 0
            linewidth = 0
            pos = 0
            first_line = True
            for raw in fh:
                line_len = len(raw)
                line = raw.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        self.index[name] = (length, offset, linebases, linewidth)
                        self._order.append(name)
                    name = line[1:].split()[0].decode()
                    length = 0
                    offset = pos + line_len
                    first_line = True
                else:
                    if first_line and line:
                        linebases = len(line)
                        linewidth = line_len
                        first_line = False
                    length += len(line)
                pos += line_len
            if name is not None:
                self.index[name] = (length, offset, linebases, linewidth)
                self._order.append(name)

    def chromosomes(self) -> List[str]:
        return list(self._order)

    def length(self, chrom: str) -> int:
        return self.index[chrom][0]

    # decoded-block cache granularity for small fetches (the record-assembly
    # paths look up single bases hundreds of thousands of times per run,
    # with strong positional locality; a seek+read syscall each was ~10-20%
    # of the decode stage at 100 Mb scale)
    _CACHE_BLOCK = 1 << 16

    def fetch(self, chrom: str, start: int, stop: int) -> str:
        """Fetch [start, stop) uppercased; out-of-range positions are clipped."""
        length = self.index[chrom][0]
        start = max(0, start)
        stop = min(length, stop)
        if stop <= start:
            return ""
        if stop - start <= 256:
            B = self._CACHE_BLOCK
            key = (chrom, start // B)
            # single-slot cache read/swapped as ONE attribute (GIL-atomic,
            # safe for a concurrent reader without a lock)
            blk = getattr(self, "_blk", None)
            if blk is None or blk[0] != key:
                b0 = key[1] * B
                blk = (key, b0, self._fetch_raw(chrom, b0,
                                                min(length, b0 + 2 * B)))
                self._blk = blk
            if stop - blk[1] <= len(blk[2]):
                off = start - blk[1]
                return blk[2][off:off + (stop - start)]
        return self._fetch_raw(chrom, start, stop)

    def _fetch_raw(self, chrom: str, start: int, stop: int) -> str:
        length, offset, linebases, linewidth = self.index[chrom]
        line0 = start // linebases
        byte0 = offset + line0 * linewidth + (start % linebases)
        line1 = (stop - 1) // linebases
        byte1 = offset + line1 * linewidth + ((stop - 1) % linebases) + 1
        self._fh.seek(byte0)
        data = self._fh.read(byte1 - byte0)
        return data.replace(b"\n", b"").replace(b"\r", b"").decode().upper()


class ChromView:
    """Stateful per-chromosome view supporting __getitem__ slicing, mirroring
    how the reference pipeline accesses references (chrom + slice)."""

    def __init__(self, fasta: FastaFile, chrom: str | None = None):
        self.fasta = fasta
        self.chrom = chrom

    def __len__(self):
        return self.fasta.length(self.chrom)

    def __getitem__(self, index):
        if isinstance(index, slice):
            return self.fasta.fetch(self.chrom, index.start, index.stop)
        return self.fasta.fetch(self.chrom, index, index + 1)


def write_fasta(path: str, sequences: Dict[str, str], line_width: int = 60):
    """Write a FASTA file (+ .fai index) — used by tests and simulators."""
    with open(path, "w") as fh:
        for name, seq in sequences.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i:i + line_width] + "\n")
    # build the index eagerly so downstream opens are cheap
    f = FastaFile(path)
    with open(path + ".fai", "w") as fh:
        for name in f.chromosomes():
            length, offset, linebases, linewidth = f.index[name]
            fh.write(f"{name}\t{length}\t{offset}\t{linebases}\t{linewidth}\n")
