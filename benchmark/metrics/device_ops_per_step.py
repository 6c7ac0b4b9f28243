"""Device operations per wavefront step in the traced section."""


def read(ctx):
    tr = ctx.get("trace")
    steps = sum(im.get("steps") or 0 for im in tr["images"]) if tr else 0
    if not steps or not tr["device_ops"]:
        return None
    return tr["device_ops"] / steps
