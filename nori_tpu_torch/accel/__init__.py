"""Ray-acceleration structures: the host-built wide BVH (bvh.py, used
for the triangle order), the sweep kernels (sweep.py) and the
intersection queries built on them (traverse.py)."""
