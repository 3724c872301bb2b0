"""What a CUDA graph capture refuses, caught on the CPU.

A capture records the card's work and nothing else, so a body that turns
host data into a tensor or reads a tensor back on the host cannot be
captured (and a capture that did not refuse would replay stale data). On the
CPU neither is an error, so `capture_guard()` makes them one:

  - a TorchDispatchMode raises on aten.lift_fresh (torch.tensor of host
    data) and aten._local_scalar_dense (.item(), bool(), int() of a tensor);
  - torch.from_numpy, torch.as_tensor of host data, Tensor.numpy and
    Tensor.tolist, which reach no dispatcher op on CPU tensors, are patched
    to raise for the guard's duration.

`rehearse_captures()` runs every utils/aotcache.py::AotJit call on CPU
tensors the way the card's first two calls of a key run it: once eagerly,
then again under the guard (the capture), returning the guarded result. It
yields the list of the tags so run.
"""

from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from celo_bls_snark_tpu_torch.utils import aotcache


class CaptureUnsafe(AssertionError):
    pass


class _Guard(TorchDispatchMode):
    REFUSED = {
        torch.ops.aten.lift_fresh.default: "host data becomes a tensor",
        torch.ops.aten._local_scalar_dense.default: "a tensor is read on the host",
    }

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.REFUSED:
            raise CaptureUnsafe(f"{func}: {self.REFUSED[func]}")
        return func(*args, **(kwargs or {}))


def _refuse(what):
    def fn(*args, **kwargs):
        raise CaptureUnsafe(what)
    return fn


@contextmanager
def capture_guard():
    as_tensor = torch.as_tensor

    def guarded_as_tensor(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise CaptureUnsafe("torch.as_tensor of host data")
        return as_tensor(data, *args, **kwargs)

    patches = [(torch, "from_numpy", _refuse("torch.from_numpy")),
               (torch, "as_tensor", guarded_as_tensor),
               (torch.Tensor, "numpy", _refuse("Tensor.numpy")),
               (torch.Tensor, "tolist", _refuse("Tensor.tolist"))]
    saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        with _Guard():
            yield
    finally:
        for obj, name, old in saved:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


@contextmanager
def rehearse_captures():
    call = aotcache.AotJit.__call__
    tags = []

    def rehearsed(self, *args):
        tensors = [x for x in aotcache.tree_leaves(args) if isinstance(x, torch.Tensor)]
        if not tensors or any(t.device.type != "cpu" for t in tensors):
            return call(self, *args)
        self.fn(*args)  # the first, eager call
        with capture_guard():
            out = self.fn(*args)
        tags.append(self.tag)
        return out

    aotcache.AotJit.__call__ = rehearsed
    try:
        yield tags
    finally:
        aotcache.AotJit.__call__ = call
