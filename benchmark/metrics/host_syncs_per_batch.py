"""Host reads of device values per batch of the batch driver: the
program's counter `host_syncs` over its counter `batches`, both from
the span section (ctx["spans"], benchmark.spantrace.span_section)."""


def read(ctx):
    sp = ctx.get("spans")
    batches = sp["counters"].get("batches", 0) if sp else 0
    if not batches:
        return None
    return sp["counters"].get("host_syncs", 0) / batches
