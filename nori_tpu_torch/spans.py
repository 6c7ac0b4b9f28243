"""Spans and counters of the render drivers, on the profiler's clock.

Recording is off by default.  Off, `span` and `sync` return one shared
no-op context and `count` returns after a single flag test, so a site
costs the drivers one function call.  `enable()` turns recording on,
`disable()` off; `take()` returns what was recorded and clears it.

A record is `Record(id, parent, image, name, start_ns, end_ns)`: the
span's id, its parent's id (-1 at the top), the id of the `image` span
it lies in (-1 outside one; a span named `image` starts a new image),
its name, and its start and end in integer nanoseconds of
`time.time_ns()`.  That is the clock of the profiler's Kineto events (a
`record_function` event starts within 0.3 ms of it on torch 2.13), so
spans and a device trace of the same section share one timeline.

Spans never read the device: a span adds no synchronise and changes no
value.  The host's reads of device values are `sync(site)` spans, named
`sync.<site>`, each of which adds 1 to the counters `host_syncs` and
`host_syncs.<site>`.

One thread: the recorder keeps one stack of open spans (the ranks of
parallel.py are processes, each with its own), and keeps its records in
memory until `take()`.
"""

from __future__ import annotations

import time
from typing import NamedTuple


class Record(NamedTuple):
    id: int
    parent: int
    image: int
    name: str
    start_ns: int
    end_ns: int


class _Off:
    """The context every site gets while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_rec", "_name", "_id", "_parent", "_image", "_start")

    def __init__(self, rec: "Recorder", name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        rec = self._rec
        self._parent, self._image = rec.stack[-1] if rec.stack else (-1, -1)
        self._id = rec.next_id
        rec.next_id += 1
        if self._name == "image":
            self._image = rec.next_image
            rec.next_image += 1
        rec.stack.append((self._id, self._image))
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self._rec
        rec.stack.pop()
        rec.records.append(Record(self._id, self._parent, self._image,
                                  self._name, self._start, end))
        return False


class Recorder:
    """Open spans, closed records and counters of one process."""

    def __init__(self):
        self.on = False
        self.stack: list = []            # (id, image) of open spans
        self.records: list = []
        self.counters: dict = {}
        self.next_id = 0
        self.next_image = 0

    def span(self, name: str):
        if not self.on:
            return _OFF
        return _Span(self, name)

    def sync(self, site: str):
        if not self.on:
            return _OFF
        self.count("host_syncs")
        self.count("host_syncs." + site)
        return _Span(self, "sync." + site)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def take(self) -> dict:
        out = {"records": self.records, "counters": self.counters}
        self.records, self.counters = [], {}
        return out


_REC = Recorder()


def span(name: str):
    """Context manager: a span `name` around its block."""
    return _REC.span(name)


def sync(site: str):
    """Context manager around a host read of a device value at `site`:
    the span `sync.<site>`, counted in `host_syncs` and
    `host_syncs.<site>`."""
    return _REC.sync(site)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _REC.count(name, n)


def counters() -> dict:
    """A copy of the counters recorded since the last take, which stay."""
    return dict(_REC.counters)


def enabled() -> bool:
    """Is recording on?"""
    return _REC.on


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


def take() -> dict:
    """{"records": [Record], "counters": {name: n}} recorded since the
    last take, which are then cleared; open spans stay open."""
    return _REC.take()
