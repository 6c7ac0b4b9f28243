"""Host milliseconds a wavefront step spends in its `step` span (the
stepper's enqueues: path vertex, regeneration, coherence sort, record
window), over the steps the span section counted.  Read from the
program's spans (ctx["spans"], benchmark.spantrace.span_section)."""


def read(ctx):
    sp = ctx.get("spans")
    steps = sp["counters"].get("steps", 0) if sp else 0
    if not steps:
        return None
    ns = sum(r[5] - r[4] for r in sp["records"] if r[3] == "step")
    return ns * 1e-6 / steps
