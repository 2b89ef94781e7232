"""Reduction of a torch.profiler trace to the numbers the per-layer readers
take: device time by kernel family, the union of kernel intervals (busy
time) inside the traced window, the longest-running device operations and
the idle gaps, each named by what the host was doing meanwhile.

The window is the CPU event named WINDOW (record_function) that the
driver puts around the traced work; device intervals are clipped to it.
"""

from __future__ import annotations

import bisect

WINDOW = "bench.window"
TOP = 10

# A device function whose name holds one of these belongs to that flash
# kernel (the wgmma and f32 variants, and the dK/dV kernel's delta
# pre-pass); matched before the library families.
FLASH = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
GEMM_MARKS = ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")
SORT_MARKS = ("sort", "radix")
INDEX_MARKS = ("index", "scatter", "gather")


def family(name: str) -> str:
    for k in FLASH:
        if k in name:
            return k.replace("_kernel", "")
    low = name.lower()
    if any(m in low for m in GEMM_MARKS):
        return "gemm"
    if any(m in low for m in SORT_MARKS):
        return "sort"
    if any(m in low for m in INDEX_MARKS):
        return "index"
    return "other"


def union(intervals: list) -> list:
    """Sorted, merged [(start, end)]."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi] not covered by the merged `busy`."""
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def host_label(ops: list, starts: list, t: float) -> str:
    """The innermost host op running at time t (ops sorted by start)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 400), -1):
        name, s, e = ops[j]
        if e >= t and (best is None or s > best[1]):
            best = ops[j]
    return best[0] if best else "host (no op recorded)"


def summarize(kernels: list, host_ops: list, window: tuple) -> dict:
    """kernels: [(name, start_us, end_us)] of device operations; host_ops:
    [(name, start_us, end_us)] of CPU ops; window: (start_us, end_us).
    -> {window_s, busy_s, family_s, top_ops, idle_gaps}."""
    lo, hi = window
    fam: dict = {}
    by_name: dict = {}
    spans = []
    for name, s, e in kernels:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        d = (e - s) / 1e6
        f = family(name)
        fam[f] = fam.get(f, 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
        spans.append((s, e))
    busy = union(spans)
    ops = sorted((n, s, e) for n, s, e in host_ops
                 if e > lo and s < hi and n != WINDOW
                 and not n.startswith(("cuda", "cu")))
    ops.sort(key=lambda o: o[1])
    starts = [o[1] for o in ops]
    idle: dict = {}
    for s, e in gaps(busy, lo, hi):
        label = host_label(ops, starts, (s + e) / 2)
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "family_s": fam,
        "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
    }


def from_profiler(prof) -> dict:
    """summarize() over a finished torch.profiler.profile whose traced work
    ran inside record_function(WINDOW)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host, window = [], [], None
    for evt in prof.events():
        s, e = evt.time_range.start, evt.time_range.end
        if evt.device_type == cuda:
            # a record_function span shows on the device's timeline too,
            # as an annotation: it is no device operation
            if not (evt.name == WINDOW
                    or getattr(evt, "is_user_annotation", False)):
                kernels.append((evt.name, s, e))
        elif evt.name == WINDOW:
            window = (s, e) if window is None else (min(window[0], s),
                                                    max(window[1], e))
        else:
            host.append((evt.name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return summarize(kernels, host, window)


def breakdown(summary: dict) -> dict:
    return {"device_ops": [[n, s] for n, s in summary["top_ops"]],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
