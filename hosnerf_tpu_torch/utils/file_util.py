"""File helpers (ref: 2nd.../core/utils/file_util.py)."""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def list_files(directory: str, exts: Sequence[str]) -> List[str]:
    """Sorted file paths under `directory` with one of `exts`."""
    return sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if any(f.endswith(e) for e in exts))


def split_path(path: str) -> Tuple[str, str, str]:
    """path -> (dirname, stem, ext)."""
    d, base = os.path.split(path)
    stem, ext = os.path.splitext(base)
    return d, stem, ext
