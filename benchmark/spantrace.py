"""Attribution of a torch.profiler trace to the program's hot-path spans
(the port's obs/trace.hot ranges: train.* inside Trainer.step, serve.*
inside the batcher's tick), on the profiler's clock, which the kernels
share.

- Each device operation goes to the span that was innermost on the traced
  thread when the operation was launched. The launch is the runtime call
  (cudaLaunchKernel and its kin) that shares the operation's correlation
  id, else the CPU op the operation is linked to. The traced thread is the
  one that opened the most spans (the stepping or the scheduler thread):
  the autograd engine launches the backward's kernels from threads of its
  own while the stepping thread sits in train.backward, and the launch's
  time puts them there.
- Each idle stretch of the window's device timeline (devtrace.gaps of the
  busy union) goes to the spans innermost while it lasts, cut at their
  edges.
- Idle gaps are named as devtrace names them (the innermost host op open
  at the gap's middle), with the innermost span where no op is open.

    from_profiler(prof) -> {"span_device_s": {span: s},
                            "span_idle_s": {span: s},
                            "unattributed_device_s": s,
                            "span_idle_gaps": [[label, s], ...]}

A trace with no spans (a program without them) gives empty maps, every
device second unattributed.
"""

from __future__ import annotations

import bisect
from collections import Counter

import devtrace

SPAN_PREFIXES = ("train.", "serve.")
RUNTIME_PREFIXES = ("cuda", "cu")
NO_OP = "host (no op recorded)"


def is_span(name: str) -> bool:
    return name.startswith(SPAN_PREFIXES)


def innermost(spans: list) -> list:
    """[(start, end, name)], in time order and disjoint, of the innermost
    span at each moment covered by `spans` [(name, start, end)], which
    nest as one thread's lexical ranges do (a child that outlasts its
    parent by clock rounding is cut at the parent's end)."""
    out: list = []
    stack: list = []            # (name, end)
    t = None

    def emit(lo, hi, name):
        if hi > lo:
            out.append((lo, hi, name))

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            top, end = stack.pop()
            emit(t, end, top)
            t = end
        if stack:
            emit(t, s, stack[-1][0])
            e = min(e, stack[-1][1])
        stack.append((name, e))
        t = s
    while stack:
        top, end = stack.pop()
        emit(t, end, top)
        t = end
    return out


def at(segments: list, starts: list, t: float):
    """The name of the segment covering time t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segments[i][1] >= t:
        return segments[i][2]
    return None


def attribute(kernels: list, spans: list, host_ops: list,
              window: tuple) -> dict:
    """kernels: [(name, start, end, launch time or None)] of device
    operations; spans: [(name, start, end)] of the traced thread; host_ops:
    [(name, start, end)] of the other CPU events; window: (start, end);
    times in us. -> the keys of from_profiler."""
    lo, hi = window
    segs = innermost(spans)
    starts = [s for s, _, _ in segs]
    device: dict = {}
    unattributed = 0.0
    busy = []
    for _, s, e, launch in kernels:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        busy.append((s, e))
        name = at(segs, starts, launch) if launch is not None else None
        if name is None:
            unattributed += (e - s) / 1e6
        else:
            device[name] = device.get(name, 0.0) + (e - s) / 1e6
    idle: dict = {}
    labels: dict = {}
    ops = sorted((o for o in host_ops if o[2] > lo and o[1] < hi),
                 key=lambda o: o[1])
    op_starts = [o[1] for o in ops]
    j = 0
    for gs, ge in devtrace.gaps(devtrace.union(busy), lo, hi):
        label = devtrace.host_label(ops, op_starts, (gs + ge) / 2)
        if label == NO_OP:
            label = at(segs, starts, (gs + ge) / 2) or NO_OP
        labels[label] = labels.get(label, 0.0) + (ge - gs) / 1e6
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < ge:
            s, e, name = segs[k]
            cut = min(e, ge) - max(s, gs)
            if cut > 0:
                idle[name] = idle.get(name, 0.0) + cut / 1e6
            k += 1
    return {"span_device_s": device, "span_idle_s": idle,
            "unattributed_device_s": unattributed,
            "span_idle_gaps": [[n, v] for n, v in sorted(
                labels.items(), key=lambda kv: -kv[1])[:devtrace.TOP]]}


def from_profiler(prof) -> dict:
    """attribute() over a finished torch.profiler.profile whose traced
    work ran inside record_function(devtrace.WINDOW)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, spans, host = [], [], []
    runtime, ops = {}, {}
    window = None
    for evt in prof.events():
        s, e = evt.time_range.start, evt.time_range.end
        name = evt.name
        if evt.device_type == cuda:
            if not (name == devtrace.WINDOW or is_span(name)
                    or getattr(evt, "is_user_annotation", False)):
                device.append((name, s, e, evt.id,
                               getattr(evt, "linked_correlation_id", 0)))
        elif name == devtrace.WINDOW:
            window = (s, e) if window is None else (min(window[0], s),
                                                    max(window[1], e))
        elif is_span(name):
            spans.append((name, s, e, evt.thread))
        elif name.startswith(RUNTIME_PREFIXES):
            runtime[evt.id] = s
        else:
            ops[evt.id] = s
            host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {devtrace.WINDOW} span")
    thread = Counter(t for *_, t in spans).most_common(1)
    traced = [(n, s, e) for n, s, e, t in spans
              if thread and t == thread[0][0]]
    kernels = [(n, s, e, runtime.get(corr,
                                     ops.get(linked) if linked else None))
               for n, s, e, corr, linked in device]
    return attribute(kernels, traced, host, window)
