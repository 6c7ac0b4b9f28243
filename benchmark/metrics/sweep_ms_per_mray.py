"""Device milliseconds of the port's intersection kernels per million
rays traced in the traced section.  The kernels are found by their
function names (K1 entry_min, K2/K4 resident_*, K3 lane_keys, K5
stream_*, K6 mt_*), read from the profiler's demangled names such as
"void resident_first_pass<1, true, false>(float const*, ...)"; the work
unit, rays, does not depend on how the kernels are written."""

PREFIXES = ("entry_min", "resident_", "lane_keys", "stream_plan",
            "stream_sweep", "mt_plan", "mt_sweep")


def base_name(name: str) -> str:
    """The function's own name in a demangled kernel signature."""
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.split()[-1] if head else ""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    rays = sum(im["rays"] for im in tr["images"])
    secs = sum(s for name, s in tr["kernel_s"].items()
               if base_name(name).startswith(PREFIXES))
    if rays <= 0 or secs <= 0:
        return None
    return 1e3 * secs / (rays / 1e6)
