"""Run-artifact archiving: collect intermediate pipeline outputs into one
tar.gz and optionally remove the originals.

Fills the role of the reference's workspace cleanup tool (reference
python/cleanup.py, 87 LoC): after a calling or dump run, the working
directory holds shard files, worker logs, per-expert VCF streams, and
feature pickles that should be archived together rather than left loose.
"""

from __future__ import annotations

import argparse
import fnmatch
import logging
import os
import tarfile
from typing import List, Sequence

logger = logging.getLogger(__name__)

# artifact classes produced by the dump / call pipelines
DEFAULT_PATTERNS = (
    "*.memmap", "*.index", "*.lst",          # training shards
    "*.metrics.jsonl", "*.log",              # telemetry / worker logs
    "*_expert[0-9]*.vcf", "*_best.vcf",      # per-expert VCF streams
    "*.features.pkl",                        # per-site feature dumps
)


def find_artifacts(directory: str,
                   patterns: Sequence[str] = DEFAULT_PATTERNS) -> List[str]:
    """Relative paths of matching artifacts under ``directory`` (sorted)."""
    out = []
    for root, _dirs, files in os.walk(directory):
        for name in files:
            if any(fnmatch.fnmatch(name, pat) for pat in patterns):
                out.append(os.path.relpath(os.path.join(root, name), directory))
    return sorted(out)


def archive(directory: str, out_path: str,
            patterns: Sequence[str] = DEFAULT_PATTERNS,
            delete: bool = False) -> List[str]:
    """Tar-gzip matching artifacts; optionally delete the originals.

    Returns the archived relative paths.  The archive is written first and
    originals are only removed after it is closed, so a failure mid-archive
    never loses data.
    """
    paths = find_artifacts(directory, patterns)
    if not paths:
        logger.info("no artifacts matched under %s", directory)
        return []
    with tarfile.open(out_path, "w:gz") as tar:
        for rel in paths:
            tar.add(os.path.join(directory, rel), arcname=rel)
    logger.info("archived %d artifacts to %s", len(paths), out_path)
    if delete:
        for rel in paths:
            os.remove(os.path.join(directory, rel))
        logger.info("removed %d originals", len(paths))
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(description="hello_tpu artifact cleanup")
    parser.add_argument("--dir", required=True, help="run working directory")
    parser.add_argument("--out", required=True, help="output .tar.gz path")
    parser.add_argument("--patterns", default=None,
                        help="comma-separated glob overrides")
    parser.add_argument("--delete", action="store_true",
                        help="remove originals after archiving")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    patterns = tuple(args.patterns.split(",")) if args.patterns \
        else DEFAULT_PATTERNS
    paths = archive(args.dir, args.out, patterns, delete=args.delete)
    logger.info("archived: %d files", len(paths))
    logger.info("Completed running the script")


if __name__ == "__main__":
    main()
