"""Device milliseconds a wavefront step of the streamed sweep K5 (its
plan and its persistent sweep, found by the function names
`stream_plan` and `stream_sweep*` as sweep_ms_per_mray.base_name reads
them) in the traced section: the closest sweep of every bounce and the
any-hit sweep of every shadow query on a streamed scene."""

from benchmark.metrics.sweep_ms_per_mray import base_name

PREFIXES = ("stream_plan", "stream_sweep")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    steps = sum(im.get("steps") or 0 for im in tr["images"])
    secs = sum(s for name, s in tr["kernel_s"].items()
               if base_name(name).startswith(PREFIXES))
    if steps <= 0 or secs <= 0:
        return None
    return 1e3 * secs / steps
