"""WAL file format v1: CRC-framed records, shared by both engines.

The port's copy of gpu_docker_api_tpu/store/walio.py, the same format
byte for byte: a WAL or snapshot written by one package replays in the
other. Scrub a file with `python -m gpu_docker_api_tpu_torch.store.walio
PATH` (a JSON report, see scrub()).

The v0 WAL was bare JSONL — a torn tail was survivable (the last line
fails to parse and is skipped) but a flipped bit anywhere simply produced
a silently different history, and a torn write could not be told apart
from mid-log damage. v1 keeps the line-oriented shape (both engines stay
fgets/readline-compatible; JSON escaping keeps payloads newline-free) but
adds a file header and a per-record frame:

    TDWAL1\n                                   <- magic, first 7 bytes
    crc32(payload):08x SP len(payload) SP payload \n    <- each record

Replay classification (this module is the single implementation — the
native engine's open path runs it through the wrapper, so the two engines
cannot drift):

- bad frames ONLY at the physical tail -> torn write during a crash; the
  tail is truncated to the end of the last valid frame and replay
  continues. (A bit flip inside the final record is indistinguishable
  from a torn write and is treated the same — docs/durability.md.)
- any valid frame AFTER a bad frame -> mid-log corruption; raise the
  typed `WalCorruptError`, which points at the scrub tool instead of
  letting a half-replayed store boot.
- a file whose first line is neither the magic nor a '{' JSONL record is
  only openable when it is a torn prefix of the magic itself.

v0 files keep their legacy semantics (no CRC, skip-unparseable) so an
upgraded daemon boots on an old data dir with no migration; appends to a
v0 file stay v0 (homogeneous files), and every rewrite (maintain /
snapshot / backup) produces v1.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Optional

#: v1 file header — exactly the first 7 bytes of a v1 WAL
MAGIC = b"TDWAL1\n"

#: scrub-tool invocation embedded in WalCorruptError messages
SCRUB_HINT = "python -m gpu_docker_api_tpu_torch.cli store scrub"


class WalCorruptError(RuntimeError):
    """Mid-log WAL corruption: a damaged record with valid records after
    it. Unlike a torn tail (truncated transparently), this means history
    acknowledged BEFORE later durable writes is damaged — refusing to
    boot beats silently serving a hole. The scrub tool localizes it."""

    def __init__(self, path: str, offset: int, detail: str = ""):
        self.path = path
        self.offset = offset
        self.detail = detail
        super().__init__(
            f"WAL corrupt at byte {offset} of {path}"
            + (f" ({detail})" if detail else "")
            + f" — inspect with `{SCRUB_HINT} {path}`")


def frame(payload: bytes) -> bytes:
    """One v1 record line for `payload` (a JSON record, no newlines)."""
    return b"%08x %d " % (zlib.crc32(payload), len(payload)) + payload + b"\n"


def parse_frame(line: bytes) -> Optional[bytes]:
    """Payload of one complete v1 line (trailing newline included), or
    None when the frame is damaged/incomplete."""
    if not line.endswith(b"\n"):
        return None
    # crc(8 hex) SP len(decimal) SP payload NL
    if len(line) < 11 or line[8:9] != b" ":
        return None
    try:
        crc = int(line[:8], 16)
    except ValueError:
        return None
    sp = line.find(b" ", 9)
    if sp < 0:
        return None
    try:
        n = int(line[9:sp])
    except ValueError:
        return None
    payload = line[sp + 1:-1]
    if len(payload) != n or zlib.crc32(payload) != crc:
        return None
    return payload


@dataclass
class WalScan:
    """Replay-ready classification of one WAL file."""
    fmt: int                            # 0 = legacy JSONL, 1 = framed
    payloads: list = field(default_factory=list)   # record bytes, in order
    truncate_to: Optional[int] = None   # torn tail: keep [0, truncate_to)
    corrupt_at: Optional[int] = None    # mid-log damage at this offset
    detail: str = ""
    bad_frames: int = 0                 # damaged v1 frames / v0 junk lines


def scan(path: str) -> WalScan:
    """Read + classify a WAL file without mutating it. The caller decides
    whether to truncate (the engines do; scrub never does)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return WalScan(fmt=1)
    if not data:
        return WalScan(fmt=1)
    if not data.startswith(MAGIC):
        if MAGIC.startswith(data):
            # torn write of the header itself: an empty v1 WAL
            return WalScan(fmt=1, truncate_to=0,
                           detail="torn magic header")
        if data[:1] == b"{":
            return _scan_v0(data)
        return WalScan(fmt=1, corrupt_at=0,
                       detail="unrecognized WAL header")
    out = WalScan(fmt=1)
    off = len(MAGIC)
    good_end = off             # end of the last valid frame
    first_bad: Optional[int] = None
    first_bad_detail = ""
    while off < len(data):
        nl = data.find(b"\n", off)
        line = data[off:] if nl < 0 else data[off:nl + 1]
        payload = parse_frame(line)
        if payload is None:
            out.bad_frames += 1
            if first_bad is None:
                first_bad = off
                first_bad_detail = ("truncated frame" if nl < 0
                                    else "bad frame (length/CRC)")
        else:
            if first_bad is not None:
                # a valid record AFTER damage: mid-log corruption, not a
                # torn tail — report the damage, keep nothing after it
                out.corrupt_at = first_bad
                out.detail = first_bad_detail
                return out
            out.payloads.append(payload)
            good_end = off + len(line)
        off += len(line)
    if first_bad is not None:
        out.truncate_to = good_end
        out.detail = first_bad_detail
    return out


def _scan_v0(data: bytes) -> WalScan:
    out = WalScan(fmt=0)
    for raw in data.split(b"\n"):
        raw = raw.strip()
        if not raw:
            continue
        # legacy tolerance: unparseable lines are skipped wherever they
        # sit (v0 cannot distinguish a torn tail from damage — that gap
        # is why v1 exists)
        try:
            json.loads(raw)
        except ValueError:
            out.bad_frames += 1
            continue
        out.payloads.append(raw)
    return out


def scrub(path: str) -> dict:
    """Verify a WAL/backup file end to end; never mutates it.

    Returns a report dict (the `store scrub` CLI prints it as JSON):
    format, records, ok, and — when damaged — tornTailAt (recoverable:
    the engine truncates there on open) or corruptAt (mid-log, fatal on
    open). For v0 files `skippedLines` counts unparseable lines; v0 has
    no integrity guarantees to verify, which the report says out loud.
    """
    if not os.path.exists(path):
        return {"path": path, "ok": False, "error": "no such file"}
    s = scan(path)
    rep: dict = {
        "path": path,
        "format": s.fmt,
        "records": len(s.payloads),
        "ok": s.corrupt_at is None,
    }
    if s.fmt == 0:
        rep["skippedLines"] = s.bad_frames
        rep["note"] = ("legacy v0 JSONL — no checksums; rewrite as v1 "
                       "via backup/restore or the engine's maintain()")
        return rep
    if s.corrupt_at is not None:
        rep["corruptAt"] = s.corrupt_at
        rep["detail"] = s.detail
    elif s.truncate_to is not None:
        rep["tornTailAt"] = s.truncate_to
        rep["detail"] = s.detail
    # the frames checked out — now the payloads must also be valid
    # records, or replay would crash after the CRC pass
    for i, payload in enumerate(s.payloads):
        try:
            rec = json.loads(payload)
            if not isinstance(rec, dict) or "op" not in rec:
                raise ValueError("not a record object")
        except ValueError as e:
            rep["ok"] = False
            rep["badRecord"] = {"index": i, "error": str(e)}
            break
    return rep


if __name__ == "__main__":
    import sys
    reports = [scrub(p) for p in sys.argv[1:]]
    print(json.dumps(reports if len(reports) != 1 else reports[0], indent=2))
    sys.exit(0 if reports and all(r["ok"] for r in reports) else 1)
