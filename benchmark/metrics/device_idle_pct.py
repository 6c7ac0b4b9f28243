"""Share of an image's wall time in which no operation ran on the
device: 100 x (1 - device-busy seconds an image in the traced section /
wall seconds an image in the window).  The busy seconds are the trace's
(the union of device operations, from a trace of device activity
alone); the wall seconds are the untraced window's, since tracing even
device activity alone adds some 40% to a host-bound image's wall time
(on an H100, a living-room image: 8.6 s traced, 6.1 s in the window)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0 or not tr["images"] or not ctx["images"]:
        return None
    busy = tr["busy_s"] / len(tr["images"])
    wall = ctx["window_s"] / len(ctx["images"])
    return 100.0 * (1.0 - busy / wall)
