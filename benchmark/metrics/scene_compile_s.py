"""Host seconds of the port's scene compile in set-up (BVH order, tiles
or slabs, the Baldwin-Weber operand): scene.compile_arrays."""


def read(ctx):
    return ctx.get("compile_s")
