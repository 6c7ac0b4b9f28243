"""Share of the device's idle time at which no program span was open:
100 x the idle seconds between device operations whose middle lies
outside every span, over all such idle seconds, in the profiled section
with spans on (benchmark.spantrace.profiled).  Low means the spans
account for the idle time."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("idle_s"):
        return None
    return 100.0 * tr["idle_unspanned_s"] / tr["idle_s"]
