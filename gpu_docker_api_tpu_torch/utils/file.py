"""Filesystem + size-unit helpers.

Reference parity: utils/file.go (DirSize :12-21, ToBytes :23-46); unlike
the reference's ToBytes we reject malformed sizes loudly instead of
returning 0.

The part of the JAX control plane's utils/file.py the ported modules use
(to_bytes, dir_size). The services copy and move directories through
utils/copyfast.py directly; the rest (the size formatting and checks the
REST routes use) comes with the REST slice.
"""

from __future__ import annotations

import os
import stat

SIZE_UNITS = ("KB", "MB", "GB", "TB")

_UNIT_BYTES = {
    "KB": 1024,
    "MB": 1024 ** 2,
    "GB": 1024 ** 3,
    "TB": 1024 ** 4,
}


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def to_bytes(size: str) -> int:
    """"30GB" -> 32212254720. Raises ValueError on unknown unit/garbage
    (the reference's ToBytes silently returns 0, utils/file.go:23-46)."""
    s = size.strip().upper()
    if len(s) <= 2 or s[-2:] not in _UNIT_BYTES:
        raise ValueError(f"unsupported size {size!r}; supported units: {', '.join(SIZE_UNITS)}")
    num = s[:-2]
    if not _is_number(num):
        raise ValueError(f"unsupported size {size!r}")
    return int(float(num) * _UNIT_BYTES[s[-2:]])


def dir_size(path: str) -> int:
    """Total size in bytes of all regular files under path (utils/file.go:12-21).

    Hardlinked files are counted ONCE (deduped by (st_dev, st_ino)) — they
    occupy one set of blocks, and quota checks billing them per link would
    refuse legitimate volume shrinks."""
    total = 0
    seen: set[tuple[int, int]] = set()
    for root, _dirs, files in os.walk(path):
        for f in files:
            fp = os.path.join(root, f)
            try:
                st = os.lstat(fp)
            except OSError:
                continue
            if stat.S_ISLNK(st.st_mode):
                continue
            if st.st_nlink > 1:
                key = (st.st_dev, st.st_ino)
                if key in seen:
                    continue
                seen.add(key)
            total += st.st_size
    return total
