"""The comparison that decides `correct`.

Each image of the window, or a sample of them drawn from the run's seed,
is judged by blocks of pixels drawn from the seed: the image's own values in each block against the plain
reference's (`reference/`), which renders the very samples of those
pixels again from the raw scene (the same seeds and work items).  For
each checked pixel the error is

    max over rgb |image - reference| / (max over rgb reference + FLOOR)

and the numbers compared are the median and the 90th percentile of it
over all checked pixels of the run, and the largest of the checked
images' own medians (`img_p50_max`), so that one wrong image among
dozens fails the run too.  `failed` counts the images whose median is
over that number's limit.  Their limits are the cell's
(`cells/<workload>.json`, "limits"), set between what sound runs of the
program read and what the control reads (the reference with its path
state in bfloat16, `Reference(lowp=True)`), as PERF.md records.
"""

from __future__ import annotations

import numpy as np

#: radiance added to the denominator, so that near-black pixels do not
#: turn rounding into large relative errors
FLOOR = 1e-2
#: the numbers compared, in the order they are printed
NUMBERS = ("err_p50", "err_p90", "img_p50_max")


def mix_seed(seed: int, i: int) -> int:
    """The render seed (32 bits) of image i of a run with `seed`
    (splitmix64 of the pair)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) \
        & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def block_corners(seed: int, i: int, width: int, height: int, size: int,
                  count: int) -> list:
    """`count` top-left corners of size x size blocks inside the image,
    drawn from (seed, image i)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, i])
    xs = rng.integers(0, width - size + 1, count)
    ys = rng.integers(0, height - size + 1, count)
    return [(int(x), int(y)) for x, y in zip(xs, ys)]


def choose(seed: int, n_images: int, per_image: int, cap: int) -> list:
    """(image, block) pairs to check: every block of every image when
    there are at most `cap` images, else every block of `cap` images
    drawn from the seed.  An image is judged on all its blocks, so that
    one block where shadow rays graze (and any two renderers round some
    of them onto the other side) is never most of what it is judged on.
    """
    images = range(n_images)
    if n_images > cap:
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 1 << 20])
        images = sorted(int(i) for i in rng.choice(n_images, cap,
                                                     replace=False))
    return [(i, b) for i in images for b in range(per_image)]


def pixel_errors(image_blocks: np.ndarray, ref_blocks: np.ndarray):
    """Per-pixel relative error of (B, S, S, 3) blocks."""
    img = np.asarray(image_blocks, np.float64)
    ref = np.asarray(ref_blocks, np.float64)
    bad = ~np.isfinite(img).all(-1)
    err = np.abs(img - ref).max(-1) / (ref.max(-1) + FLOOR)
    return np.where(bad, np.inf, err)


def image_medians(cmp: dict) -> dict:
    """Each checked image's median pixel error."""
    return {i: float(np.quantile(e, 0.5)) for i, e in cmp["by_image"].items()}


def numbers(cmp: dict) -> dict:
    """The numbers compared, from `compare`'s result."""
    e = np.asarray(cmp["err"], np.float64).reshape(-1)
    med = image_medians(cmp)
    return {"err_p50": float(np.quantile(e, 0.5)),
            "err_p90": float(np.quantile(e, 0.9)),
            "img_p50_max": max(med.values()) if med else float("inf")}


def failed_images(cmp: dict, limits: dict) -> int:
    """Checked images whose median pixel error is over its limit."""
    return sum(not m <= limits["img_p50_max"]
               for m in image_medians(cmp).values())


def judge(values: dict, limits: dict) -> bool:
    """Every number at or under its limit (a missing or non-finite
    number fails)."""
    return all(np.isfinite(values.get(k, np.inf))
               and values[k] <= limits[k] for k in NUMBERS)


def compare(reference, images: dict, seeds: dict, corners: dict,
            pairs: list, size: int) -> dict:
    """Run the reference over the chosen (image, block) pairs, all in
    one batch, and compare.  images[i]: the image's blocks, each
    (S, S, 3); seeds[i]: its render seed; corners[i]: its block
    corners.  Returns {"err": all pixel errors, "by_image": {i: its
    pixels' errors}}."""
    if not pairs:
        return {"err": np.array([np.inf]), "by_image": {}}
    ref = reference.blocks([(seeds[i], *corners[i][b]) for i, b in pairs],
                           size)
    mine = np.stack([images[i][b] for i, b in pairs])
    err = pixel_errors(mine, ref)
    by_image = {}
    for k, (i, _) in enumerate(pairs):
        by_image.setdefault(i, []).append(err[k].reshape(-1))
    return {"err": err.reshape(-1),
            "by_image": {i: np.concatenate(v) for i, v in by_image.items()}}
