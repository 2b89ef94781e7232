"""Filesystem + size-unit helpers.

Reference parity: utils/file.go (DirSize :12-21, ToBytes :23-46, IsDir :48-57)
and utils/copy.go (CopyDir :17-27, done there as a `(cd src; tar c .)|(cd dst;
tar x)` shell pipe). We avoid the shell and use tarfile/os.walk, preserving
symlinks and permissions; unlike the reference's ToBytes we reject malformed
sizes loudly instead of returning 0.

The port's copy of the JAX control plane's utils/file.py, unchanged.
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


def valid_size_unit(size: str) -> bool:
    """True when `size` ends with a supported unit (e.g. "30GB")."""
    s = size.strip().upper()
    return len(s) > 2 and s[-2:] in _UNIT_BYTES and _is_number(s[:-2])


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


def from_bytes(n: int) -> str:
    """Bytes -> largest exact-ish human unit, inverse of to_bytes.

    Fixes reference bug: rollback re-renders Memory as
    fmt.Sprintf("%dGB", bytes/1024/1024) — MB count labelled GB, a 1024x
    inflation (internal/services/replicaset.go:407-409)."""
    # largest unit that divides exactly -> clean integer string
    for unit in reversed(SIZE_UNITS):
        b = _UNIT_BYTES[unit]
        if n >= b and n % b == 0:
            return f"{n // b}{unit}"
    # otherwise KB with an exact float: n/1024 is a power-of-two division, so
    # repr() round-trips losslessly through to_bytes for any n < 2**53
    return f"{n / 1024!r}KB"


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


def is_dir(path: str) -> bool:
    return os.path.isdir(path)


def copy_dir(src: str, dest: str) -> None:
    """Recursively copy src/* into dest (created if missing), preserving
    metadata and symlinks. Replaces the reference's tar-pipe shell-out
    (utils/copy.go:17-27) with an in-process copy.

    Existing symlinks in dest are kept (not clobbered): during rolling
    replacement the NEW container's bind mounts are already materialized as
    links, and the new spec's binds must win over the old layer's.

    Since the copyfast subsystem this is a thin wrapper over
    :func:`copyfast.clone_tree` — same semantics plus directory-metadata
    preservation (the old os.makedirs dropped src's mode/times) and the
    reflink / copy_file_range / threaded-pool mode ladder."""
    from .copyfast import clone_tree
    clone_tree(src, dest)


def move_dir_contents(src: str, dest: str) -> None:
    """Move src/* into dest. Used for volume scale data migration — the
    reference does this with a throwaway ubuntu:22.04 helper container
    running `mv` (utils/copy.go:75-128); we move in-process, via
    :func:`copyfast.move_dir_contents`: same-FS rename fast path, parallel
    cross-FS fallback, and collision tolerance (a crashed partial move
    re-runs clean instead of raising from shutil.move)."""
    from .copyfast import move_dir_contents as _fast_move
    _fast_move(src, dest)
