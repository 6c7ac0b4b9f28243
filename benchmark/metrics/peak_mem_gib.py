"""Peak device memory allocated by the program over the window
(torch.cuda.max_memory_allocated after a reset at the end of set-up),
GiB."""


def read(ctx):
    b = ctx.get("peak_bytes")
    return None if not b else b / 2 ** 30
