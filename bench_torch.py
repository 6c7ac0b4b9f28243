#!/usr/bin/env python3
"""Benchmark of nori_tpu_torch on one CUDA card (nori_tpu_torch.bench):

    python bench_torch.py [--device cuda] [--scenes DIR]

The last line printed is always a complete JSON record; without a CUDA
device it is an "unavailable" record and the exit code is 2.
"""

import sys

from nori_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
