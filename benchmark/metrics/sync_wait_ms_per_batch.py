"""Host milliseconds a batch of the batch driver spends in its host
reads of device values (`sync.*` spans: the depth loops' `alive.any()`,
the ray count and the image's copy to the host), over the batches the
span section counted.  Read from the program's spans (ctx["spans"],
benchmark.spantrace.span_section)."""


def read(ctx):
    sp = ctx.get("spans")
    batches = sp["counters"].get("batches", 0) if sp else 0
    if not batches:
        return None
    ns = sum(r[5] - r[4] for r in sp["records"] if r[3].startswith("sync."))
    return ns * 1e-6 / batches
