"""nori_tpu_torch.core.rng with Python-int arguments: the hash folds them
on the host, and its bits equal those of the same values passed as 0-d
tensors and those of numpy's uint32 arithmetic.

A Python-int seed, stream or constant must never become a tensor on
its own: on a card that is a copy from pageable host memory, which
waits for the card.  Here, on the CPU, that shows as a tensor made from
a host value (`aten.lift_fresh`) among the operations the hash
dispatches.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nori_tpu_torch.core import rng

from torch_threads import one_torch_thread  # noqa: F401

EDGES = [0, 7, 2**31, 2**32 - 1, 2**32 + 5, 2**40 + 3]
LANES = np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 12345678, 3],
                   np.int64)


def _np_pcg(x):
    with np.errstate(over="ignore"):
        state = x * np.uint32(747796405) + np.uint32(2891336453)
        word = ((state >> ((state >> np.uint32(28)) + np.uint32(4)))
                ^ state) * np.uint32(277803737)
    return (word >> np.uint32(22)) ^ word


def _np_hash(*ints):
    acc = np.uint32(0x9E3779B9)
    for v in ints:
        with np.errstate(over="ignore"):
            acc = _np_pcg(acc + (np.asarray(v, np.uint64)
                                 & 0xFFFFFFFF).astype(np.uint32))
    return _np_pcg(acc)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("stream", EDGES)
@pytest.mark.parametrize("seed", EDGES)
def test_int_arguments_equal_tensor_arguments(seed, stream):
    lanes = torch.from_numpy(LANES)
    as_t = (torch.tensor(seed, dtype=torch.int64),
            torch.tensor(stream, dtype=torch.int64))
    got = rng.hash_combine(seed, lanes, stream)
    ref = rng.hash_combine(as_t[0], lanes, as_t[1])
    assert got.dtype == torch.int64
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(
        got.numpy().astype(np.uint32), _np_hash(seed, LANES, stream))
    for fn in (rng.uniform, rng.uniform2):
        a = fn(seed, lanes, stream)
        b = fn(as_t[0], lanes, as_t[1])
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("seed", EDGES)
def test_all_int_hash(seed):
    """Every argument an int: the host fold, returned as a 0-d int64
    tensor on the default device, equal to numpy's uint32 chain."""
    got = rng.hash_combine(seed, 2**32 - 1, 2**31)
    assert got.dim() == 0 and got.dtype == torch.int64
    assert got.device == torch.empty(0).device
    assert int(got) == int(_np_hash(seed, 2**32 - 1, 2**31))
    assert 0 <= int(got) < 2**32


@pytest.mark.parametrize("where", ["seed", "lane", "stream"])
def test_mixed_call_lands_on_the_tensor_device(where):
    """One tensor argument, the others ints: the result is a tensor on
    that tensor's device (the meta device stands in for a card)."""
    t = torch.arange(5, dtype=torch.int64, device="meta")
    args = {"seed": 2**32 + 9, "lane": 3, "stream": 0xF000}
    args[where] = t
    for fn in (rng.hash_combine, rng.uniform):
        out = fn(args["seed"], args["lane"], args["stream"])
        assert isinstance(out, torch.Tensor) and out.device == t.device
        assert out.shape == (5,)
    out2 = rng.uniform2(args["seed"], args["lane"], args["stream"])
    assert out2.device == t.device and out2.shape == (5, 2)


@pytest.mark.parametrize("fn", ["hash_combine", "uniform", "uniform2"])
def test_int_arguments_make_no_tensor(fn):
    lanes = torch.from_numpy(LANES)
    with _Ops() as ops:
        getattr(rng, fn)(2**31 + 5, lanes, 0xF000)
    assert ops.names and "aten.lift_fresh.default" not in ops.names
