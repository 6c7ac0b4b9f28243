"""CUDA graphs over a static carry, shared by the render drivers.

A driver that replays its work as CUDA graphs keeps the state it
carries from one call to the next (its carry: a dict of tensors and
host values, or a tuple of such a dict and tensors) at fixed addresses,
the static carry.  A graph is captured once from a function of the
static carry and ends in copies of the new carry into it, so each
replay advances the static carry in place.  The wavefront's stepper
(wavefront._GraphedStep) replays one step a call, the batch driver
(render._GraphedBatch) one stage of a batch a call.

A kernel wrapper of accel.sweep counts its launches, and a driver's
work may count spans' counters, while it runs on the host; capture runs
the host code once and launches nothing, and a replay runs no host
code, so Capture moves what capture counted onto each replay.
"""

from __future__ import annotations

import torch

from nori_tpu_torch import config, spans
from nori_tpu_torch.accel.sweep import launch_counters


def graph_replay(device) -> bool:
    """Does a driver on `device` replay its work as CUDA graphs?  On a
    CUDA device with the sweep backend; the CPU has no graphs, and the
    "scan" and "bvh" backends run eagerly (intersect_bvh reads on the
    host whether a ray still walks)."""
    return device.type == "cuda" and config.resolve_accel() == "pallas"


class Graph:
    """fn's work on `device`, captured once as a CUDA graph: fn runs
    during capture and launches nothing; each replay() runs its work
    again, on the same memory, on the device's current stream."""

    def __init__(self, fn, device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            with torch.cuda.graph(self.graph,
                                  stream=torch.cuda.Stream(device),
                                  capture_error_mode="thread_local"):
                fn()

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()

    def reset(self):
        self.graph.reset()


def carry_into(dst, src):
    """Write carry src into carry dst in place, tensor by tensor; a
    tensor that already is dst's (the record log, q0, q_hi) is left, and
    a host value has to equal dst's."""
    if isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"carry keys {sorted(src)} differ from the "
                             f"static carry's {sorted(dst)}")
        pairs = [(dst[k], src[k]) for k in dst]
    else:
        pairs = list(zip(dst, src))
    for a, b in pairs:
        if isinstance(a, (dict, tuple)):
            carry_into(a, b)
        elif not torch.is_tensor(a):
            if a != b:
                raise ValueError(f"host value {b!r} differs from the "
                                 f"static carry's {a!r}")
        elif a.data_ptr() != b.data_ptr() or a.stride() != b.stride():
            a.copy_(b)


class Capture:
    """fn's work captured once as a CUDA graph (Graph), with what the
    capture counted: the launches of accel.sweep's kernel wrappers and
    spans' counters (such as `sweeps.streamed`).  Capture takes both
    back (span `capture`), and each replay() adds them, so a replay
    counts what fn run eagerly does."""

    def __init__(self, fn, device):
        counters = list(launch_counters().values())
        before = [f.launches for f in counters]
        counted = spans.counters()
        with spans.span("capture"):
            self._graph = Graph(fn, device)
        self._gain = [(f, f.launches - n) for f, n in zip(counters, before)
                      if f.launches != n]
        for f, n in zip(counters, before):
            f.launches = n
        self._counted = [(k, n - counted.get(k, 0))
                         for k, n in spans.counters().items()
                         if n != counted.get(k, 0)]
        for name, n in self._counted:
            spans.count(name, -n)

    def replay(self):
        self._graph.replay()
        for f, n in self._gain:
            f.launches += n
        for name, n in self._counted:
            spans.count(name, n)

    def reset(self):
        self._graph.reset()


class StaticCarry:
    """A driver's static carry on `device` and the graphs that advance
    it.

    keep(carry) takes a carry that ran eagerly: the first becomes the
    static carry, each later one is written into it (carry_into).
    replay(key, fn) replays graph `key`, captured the first time from
    fn(static carry) -> the next carry (Capture), and returns the static
    carry.  drop_graphs() resets the graphs, which a driver does when
    what they read besides the carry changes (a new sd or seed);
    release() drops the carry too."""

    def __init__(self, device):
        self.device = device
        self.carry = None
        self._graphs = {}

    def keep(self, carry):
        if self.carry is None:
            self.carry = carry
        else:
            carry_into(self.carry, carry)
        return self.carry

    def replay(self, key, fn):
        graph = self._graphs.get(key)
        if graph is None:
            static = self.carry
            graph = self._graphs[key] = Capture(
                lambda: carry_into(static, fn(static)), self.device)
        graph.replay()
        return self.carry

    def drop_graphs(self):
        for graph in self._graphs.values():
            graph.reset()
        self._graphs = {}

    def release(self):
        self.drop_graphs()
        self.carry = None
