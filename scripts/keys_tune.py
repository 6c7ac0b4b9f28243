#!/usr/bin/env python3
"""Time variants of the two key kernels (K1 sweep.entry_min, K3
sweep.lane_keys) on one CUDA card.

    python3 scripts/keys_tune.py

Builds the kernel library once per variant, each with extra -D flags for
nvcc: KEY_GROUP (csrc/common.cuh: the boxes under one gate box of K1; 0
is the dense form, every box for every live ray), KEY_TURN
(csrc/entry_min.cu: the entering rays a run of lanes tests per turn) and
LANE_BLOCK (csrc/lane_keys.cu: lanes per block).  On the inputs of
scripts/keys_inputs.py it times K1 through its wrapper and K3 through the
library's entry point with every group width (0: the walk over every
box), each result first held equal to the plain version's on the first
65,536 rays.  Device times by keys_inputs.kernel_ms.  One JSON line per
variant; the last line is the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: variant -> (nvcc flags, which kernels it changes)
VARIANTS = {
    "default (groups of 16, 2 per turn, 256 lanes)": ([], "k1 k3"),
    "K1 groups of 32": (["-DKEY_GROUP=32"], "k1"),
    "K1 dense": (["-DKEY_GROUP=0"], "k1"),
    "K1 1 per turn": (["-DKEY_TURN=1"], "k1"),
    "K1 4 per turn": (["-DKEY_TURN=4"], "k1"),
    "K3 128 lanes": (["-DLANE_BLOCK=128"], "k3"),
    "K3 64 lanes": (["-DLANE_BLOCK=64"], "k3"),
}


def main() -> int:
    import torch
    import chip_smoke as cs
    from nori_tpu_torch import cuda_build
    from nori_tpu_torch.accel import sweep
    from keys_inputs import ajax_inputs, kernel_ms, room_inputs
    from keys_visits import ptxas_lines

    dev = torch.device("cuda:0")
    cs.build_kernels()
    _, _, k1, k3 = room_inputs(cs, dev)
    _, a1, a3 = ajax_inputs(cs, dev)
    k1.update(a1)
    k3.update(a3)
    base = list(cuda_build.NVCC_FLAGS)
    for name, (flags, kernels) in VARIANTS.items():
        cuda_build.NVCC_FLAGS = base + flags
        cuda_build._lib = None
        lib = cuda_build.load()
        row = dict(variant=name, ptxas=[
            ln for ln in ptxas_lines(cuda_build.build_log) if "Used" in ln])
        for label, (bounds, rays) in k1.items() if "k1" in kernels else ():
            head = rays[:, :65536].contiguous()
            if not torch.equal(
                    sweep.entry_min(bounds, head).view(torch.int32),
                    sweep.entry_min_plain(bounds, head).view(torch.int32)):
                raise AssertionError(f"{name}: k1 {label} differs")
            row[f"k1 {label}"] = kernel_ms(
                lambda: sweep.entry_min(bounds, rays))
        for label, (bounds, rays) in k3.items() if "k3" in kernels else ():
            n, n_tt = rays.shape[1], bounds.shape[0]
            key1 = torch.empty(n, dtype=torch.int32, device=dev)
            key2 = torch.empty(n, dtype=torch.int32, device=dev)
            ref = sweep.lane_keys_plain(bounds, rays[:, :65536].contiguous())
            for group in (0, sweep.LANE_GROUP, 2 * sweep.LANE_GROUP):
                def launch():
                    err = lib.lane_keys_launch(
                        bounds.data_ptr(), n_tt, -(-n_tt // 128) * 128,
                        rays.data_ptr(), n, key1.data_ptr(),
                        key2.data_ptr(), group,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"lane_keys_launch: {err}")

                launch()
                if not (torch.equal(key1[:65536], ref[0])
                        and torch.equal(key2[:65536], ref[1])):
                    raise AssertionError(f"{name}: k3 {label} group {group} "
                                         "differs")
                row[f"k3 {label} group {group}"] = kernel_ms(launch)
        print(json.dumps(row), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
