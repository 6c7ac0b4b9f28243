"""Device operations per batch of the batch driver in the traced
section."""


def read(ctx):
    tr = ctx.get("trace")
    batches = sum(im.get("batches") or 0 for im in tr["images"]) if tr \
        else 0
    if not batches or not tr["device_ops"]:
        return None
    return tr["device_ops"] / batches
