"""Host milliseconds of an image's set-up: its `prepare` span (the
compiled scene's upload and the integrator's preprocess) and its
`build` spans (the steppers and the dense splat, or the batch pass),
over the span section's images (ctx["spans"],
benchmark.spantrace.span_section)."""


def read(ctx):
    sp = ctx.get("spans")
    images = sum(r[3] == "image" for r in sp["records"]) if sp else 0
    if not images:
        return None
    ns = sum(r[5] - r[4] for r in sp["records"]
             if r[3] in ("prepare", "build"))
    return ns * 1e-6 / images
