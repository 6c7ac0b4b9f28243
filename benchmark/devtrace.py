"""The traced sections of a `--trace 1` run: torch.profiler over whole
images, reduced to what the per-layer metrics and the result's
`breakdown` read.  The section the metrics read records device activity
alone, since recording every host operation about doubles a host-bound
image's wall time; the idle gaps are credited to host events in a
second, shorter section that records both.

It reads the profiler's raw Kineto events, not its averaged tables, so a
section of a few hundred thousand device operations reduces in seconds:

  busy_s       the union of the device operations' intervals
  window_s     the host's wall time of the section, ending in a sync
  device_ops   the number of device operations (kernels, copies, sets)
  kernel_s     device seconds summed by operation name
  idle_gaps    the gaps between device operations, each credited to the
               innermost host event open at its middle (what the host
               was doing while the device waited), summed by name
"""

from __future__ import annotations

import time
from collections import defaultdict


def run_traced(fn, device, host: bool = False):
    """(fn()'s result, summary dict) with fn run under the profiler:
    device activity, and host operations too with `host`; on a CPU
    device (the tests) only host events are recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    acts = (([ProfilerActivity.CPU] if host or not cuda else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    dev, ops = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur, e.name()))
        else:
            ops.append((start, start + dur, e.name()))
    return out, summarize(dev, ops, wall)


def summarize(dev: list, host: list, wall_s: float) -> dict:
    """Reduce device intervals and host events [(start_ns, end_ns,
    name)] of one section."""
    dev.sort()
    kernel_s = defaultdict(float)
    merged = []
    for s, e, name in dev:
        kernel_s[name] += (e - s) * 1e-9
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    busy_s = sum(e - s for s, e in merged) * 1e-9
    gaps = [(merged[k][1], merged[k + 1][0])
            for k in range(len(merged) - 1)
            if merged[k + 1][0] > merged[k][1]]
    return {"busy_s": busy_s, "window_s": wall_s, "device_ops": len(dev),
            "kernel_s": dict(kernel_s), "idle_gaps": _credit(gaps, host)}


def _credit(gaps: list, host: list) -> dict:
    """Seconds of device idle by the innermost host event open at each
    gap's middle ("(python, no op open)" where none is)."""
    host = sorted(host)
    mids = sorted(((a + b) // 2, (b - a) * 1e-9) for a, b in gaps)
    out = defaultdict(float)
    stack = []                       # open host events, innermost last
    k = 0
    for mid, dur in mids:
        while k < len(host) and host[k][0] <= mid:
            s, e, name = host[k]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            k += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        out[stack[-1][1] if stack else "(python, no op open)"] += dur
    return dict(out)


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
