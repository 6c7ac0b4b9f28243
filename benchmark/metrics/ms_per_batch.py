"""Milliseconds per batch of the batch driver: the window images'
render seconds over the batches the driver ran."""


def read(ctx):
    batches = sum(im.get("batches") or 0 for im in ctx["images"])
    if not batches:
        return None
    return 1e3 * sum(im["seconds"] for im in ctx["images"]) / batches
