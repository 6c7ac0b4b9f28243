"""The program's own spans and counters (`nori_tpu_torch.spans`) in a
traced run, reduced to what the span metrics and the breakdown read.

The port records a span around each stage of its render drivers and a
`sync.<site>` span around each host read of a device value, on the
clock of the profiler's Kineto events, so a device trace and the spans
share one timeline.  Two sections use them:

  profiled(fn, device)   fn under torch.profiler (device activity
                         only, as devtrace's metric section) with spans
                         on: devtrace's summary, plus each idle gap
                         credited to the innermost span open at its
                         middle (`idle_by_span`, `idle_unspanned_s`,
                         `idle_s`), device seconds by the span that
                         launched them (`device_by_span`) and the
                         section's records
  span_section(fn, s)    images with spans on and no profiler, for at
                         least s seconds: the records and counters that
                         the host-side span metrics read

`credit_spans`, `credit` and `self_seconds` are the reductions.  A
program without `nori_tpu_torch.spans` records nothing: the profiled
section then carries no span keys, `span_section` returns None, and the
span metrics read nothing.
"""

from __future__ import annotations

import time
from collections import defaultdict

from benchmark import devtrace

def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from nori_tpu_torch import spans
    except ImportError:
        return None
    return spans


def _records(taken) -> list:
    """Records as plain [id, parent, image, name, start_ns, end_ns]."""
    return [list(r) for r in taken["records"]]


def gaps_of(dev: list) -> list:
    """The idle gaps [(start_ns, end_ns)] between the union of device
    intervals [(start_ns, end_ns, name)], as devtrace.summarize finds
    them."""
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(merged[k][1], merged[k + 1][0])
            for k in range(len(merged) - 1)
            if merged[k + 1][0] > merged[k][1]]


def credit_spans(gaps: list, records: list):
    """(seconds of device idle by the innermost span open at each gap's
    middle, seconds of it at which no span was open).  records: [id,
    parent, image, name, start_ns, end_ns], nested as one thread's spans
    are."""
    return credit([((a + b) // 2, (b - a) * 1e-9) for a, b in gaps],
                  records)


def credit(points: list, records: list):
    """(seconds by the innermost span open at each point, seconds of the
    points at which no span was open); points: [(time_ns, seconds)]."""
    spans = sorted(records, key=lambda r: (r[4], -r[5]))
    out = defaultdict(float)
    unspanned = 0.0
    stack = []                       # open spans (end, name), innermost last
    k = 0
    for t, dur in sorted(points):
        while k < len(spans) and spans[k][4] <= t:
            s, e, name = spans[k][4], spans[k][5], spans[k][3]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            k += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        if stack:
            out[stack[-1][1]] += dur
        else:
            unspanned += dur
    return dict(out), unspanned


def self_seconds(records: list) -> dict:
    """Host self seconds by span name: each span's duration less the
    durations of its children (one thread's spans do not overlap their
    siblings, so that is what the children cover)."""
    child = defaultdict(int)
    for r in records:
        child[r[1]] += r[5] - r[4]
    out = defaultdict(float)
    for r in records:
        out[r[3]] += (r[5] - r[4] - child[r[0]]) * 1e-9
    return dict(out)


def profiled(fn, device):
    """(fn()'s result, summary) with fn run under the profiler (device
    activity only; on a CPU device, the tests, host events only) and the
    program's spans on.  The summary is devtrace.summarize's, and with
    spans `records`, `counters`, `idle_by_span`, `idle_unspanned_s`
    (idle seconds at which no span was open), `idle_s` (all idle
    seconds between device operations) and `device_by_span`: each
    device operation's seconds by the innermost span open when the host
    launched it, where the trace links the operation to its launch by
    correlation id (empty where it does not)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sp = recorder()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    if sp is not None:
        sp.take()
        sp.enable()
    try:
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
    finally:
        if sp is not None:
            sp.disable()
    dev, ops, launched, corr = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur, e.name()))
            launched.append((e.correlation_id(), dur * 1e-9))
        else:
            ops.append((start, start + dur, e.name()))
            corr[e.correlation_id()] = start
    summary = devtrace.summarize(dev, ops, wall)
    if sp is not None:
        taken = sp.take()
        recs = _records(taken)
        gaps = gaps_of(dev)
        by_span, unspanned = credit_spans(gaps, recs)
        summary.update(records=recs, counters=dict(taken["counters"]),
                       idle_by_span=by_span, idle_unspanned_s=unspanned,
                       idle_s=sum(b - a for a, b in gaps) * 1e-9,
                       device_by_span=credit(
                           [(corr[c], s) for c, s in launched
                            if c and c in corr], recs)[0])
    return out, summary


def span_section(one_image, min_s: float):
    """Images one_image(k) for k = 0, 1, ... with spans on and no
    profiler, at least one and for at least min_s seconds.  Returns
    {"records", "counters", "images": one_image's records, "seconds"},
    or None where the program has no spans."""
    sp = recorder()
    if sp is None:
        return None
    sp.take()
    sp.enable()
    try:
        images, t0 = [], time.perf_counter()
        while not images or time.perf_counter() - t0 < min_s:
            images.append(one_image(len(images)))
        seconds = time.perf_counter() - t0
    finally:
        sp.disable()
    taken = sp.take()
    return {"records": _records(taken), "counters": dict(taken["counters"]),
            "images": images, "seconds": seconds}
