#!/usr/bin/env python3
"""The two key kernels (K1 sweep.entry_min, K3 sweep.lane_keys) at the
shapes the renders launch them, and what a gate on groups of consecutive
boxes would leave of their ray-box tests, on one CUDA card.

    python3 scripts/keys_visits.py [ROOT]

With the kernels of the checkout at ROOT (default: this one), on the
inputs of scripts/keys_inputs.py (the living room's 404 tiles and 101
coarsened groups, the ajax stand-in's 1,058 slabs; chip_smoke's check
rays and the rays of a steady 524,288-lane wavefront step and of whitted
batch 36), one JSON line per kernel and input:

* the kernel's device time (keys_inputs.kernel_ms: CUDA events around 20 launches
  queued behind a spinning kernel, so no wait for the host is counted)
  and that the kernel equals its plain version bit for bit there;
* from the inputs alone (keys_inputs.gate_counts): the candidate boxes of
  a ray, and the ray-box tests per ray that a gate on groups of 4, 8, 16
  and 32 consecutive boxes leaves when a group's boxes are tested for the
  rays that enter its box, or for every ray of a warp in which one does;
* for K1, where the checkout's wrapper offers it, the time of the form
  that stores packed keys, held equal to the plain expression first;
* a time per test from the dense count (ms x 132 SMs x 4 schedulers x the
  SM clock nvidia-smi reports / (rays x boxes / 32)): the scheduler slots
  a warp's test costs if the kernel kept every scheduler busy.

Before them: what ptxas reports for the two kernels (registers, shared
memory, spills).  The last line is the card's name and power limit.
"""

from __future__ import annotations

import inspect
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
sys.path.insert(0, ROOT)

from keys_inputs import kernel_ms  # noqa: E402


def ptxas_lines(log: str) -> list[str]:
    """The ptxas lines of the K1 and K3 kernels in an nvcc -Xptxas -v
    log: one string per kernel."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("entry_min" in name or "lane_keys" in name) and (
                "Used" in line or "spill" in line):
            rows.append(f"{name}: {line.strip()}")
    return rows


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0])


def plain_in_slices(plain, bounds, rays, chunk: int = 65536):
    """The plain version on slices of the rays (whole ray tiles), joined:
    its temporaries grow with rays x boxes."""
    import torch

    parts = [plain(bounds, rays[:, c:c + chunk].contiguous())
             for c in range(0, rays.shape[1], chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def packed_ms(fn, bounds, rays):
    """The time of K1 storing packed keys (idx_bits), first held equal to
    the plain expression on the distances it stores by default; None for
    a checkout whose wrapper takes no idx_bits."""
    import torch

    if "idx_bits" not in inspect.signature(fn).parameters:
        return None
    bits = max(1, (bounds.shape[0] - 1).bit_length())
    idx = torch.arange(bounds.shape[0], dtype=torch.int32,
                       device=rays.device)
    packed = ((fn(bounds, rays).view(torch.int32) & ~((1 << bits) - 1))
              | idx[None, :])
    if not torch.equal(fn(bounds, rays, idx_bits=bits), packed):
        raise AssertionError("k1: the packed keys differ")
    return kernel_ms(lambda: fn(bounds, rays, idx_bits=bits))


def main() -> int:
    import torch
    import chip_smoke as cs
    from nori_tpu_torch import cuda_build
    from nori_tpu_torch.accel import sweep
    from keys_inputs import ajax_inputs, gate_counts, room_inputs

    dev = torch.device("cuda:0")
    cs.build_kernels()
    for line in ptxas_lines(cuda_build.build_log):
        print("ptxas " + line, flush=True)
    clock = sm_clock_mhz()
    _, _, k1, k3 = room_inputs(cs, dev)
    _, a1, a3 = ajax_inputs(cs, dev)
    k1.update(a1)
    k3.update(a3)
    for kernel, fn, plain, inputs in (
            ("k1", sweep.entry_min, sweep.entry_min_plain, k1),
            ("k3", sweep.lane_keys, sweep.lane_keys_plain, k3)):
        for label, (bounds, rays) in inputs.items():
            got = fn(bounds, rays)
            ref = plain_in_slices(plain, bounds, rays)
            torch.cuda.synchronize()
            if kernel == "k1":
                equal = torch.equal(got.view(torch.int32),
                                    ref.view(torch.int32))
            else:
                equal = all(torch.equal(a, b) for a, b in zip(got, ref))
            del got, ref
            ms = kernel_ms(lambda: fn(bounds, rays))
            n, n_tt = rays.shape[1], bounds.shape[0]
            row = dict(kernel=kernel, input=label, rays=n, boxes=n_tt,
                       live=int((rays[6] <= rays[7]).sum()), ms=ms,
                       equals_plain=equal,
                       slots_per_test=ms * 1e-3 * 132 * 4 * clock * 1e6
                       / (n * n_tt / 32),
                       gate=gate_counts(bounds, rays))
            if equal and kernel == "k1":
                row["ms_packed"] = packed_ms(fn, bounds, rays)
            print(json.dumps(row), flush=True)
            if not equal:
                raise AssertionError(f"{kernel} {label}: differs from its "
                                     "plain version")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
