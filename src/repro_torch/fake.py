"""Fake tensors: what the port does when it plans a step instead of running
it (:mod:`repro_torch.launch.dryrun`).

Under ``torch._subclasses.fake_tensor.FakeTensorMode`` every tensor holds a
shape, a dtype, strides and a device, and no data.  The dry-run traces one
rank of a production mesh that way (on device ``"cuda"``, or ``"meta"``
where PyTorch is built without CUDA).  The port's code takes the same path
as on the card, with these exceptions, each keyed on
:func:`fake_mode_active` or :func:`is_fake` and never taken by a real
tensor:

* each kernel wrapper has a fake route that allocates the outputs the
  kernel writes (and nothing where the kernel writes in place), launches
  and builds nothing, and counts the call in :data:`FAKE_CALLS` (apart
  from the wrappers' ``LAUNCHES``), by route in :data:`FAKE_ROUTES`, with
  the kernel's own FLOP and byte counts; a route that reads addresses
  reads a fake tensor's offset in its storage (:func:`address`);
* host-side plans that read values run on real CPU tensors with every
  mode off (:func:`host_values`), or, where the values would take memory
  the size of a model block (the gradient norm's ranges), are derived from
  the plan's fields;
* the rails run their calls in program order on the caller's thread, with
  no stream.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch

FAKE_CALLS: Counter = Counter()     # fake-route calls by kernel
FAKE_ROUTES: Counter = Counter()    # by (kernel, route)
FAKE_FLOPS: Counter = Counter()     # the kernels' FLOPs, by kernel
FAKE_BYTES: Counter = Counter()     # bytes each call reads and writes
_LOCK = threading.Lock()

# The card's caching allocator starts every block at a multiple of 512
# bytes, so a tensor's address modulo any alignment up to 512 bytes is its
# offset in its storage (:func:`address`).
STORAGE_ALIGN = 512


def fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is on the dispatch stack."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def is_fake(*tensors) -> bool:
    """Whether any of ``tensors`` is a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in tensors)


def address(t: torch.Tensor) -> int:
    """``t.data_ptr()``; for a fake tensor, which has no address, the byte
    offset of its first element in its storage: the same residue modulo
    any alignment up to :data:`STORAGE_ALIGN` as on the card."""
    if is_fake(t):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def count_fake(name: str, route: str | None = None, flops: float = 0.0,
               nbytes: float = 0.0) -> None:
    """One call of kernel ``name``'s fake route (on ``route``), with the
    FLOPs the kernel would do and the bytes it would read and write."""
    with _LOCK:
        FAKE_CALLS[name] += 1
        if route is not None:
            FAKE_ROUTES[name, route] += 1
        FAKE_FLOPS[name] += flops
        FAKE_BYTES[name] += nbytes


def reset_fake_counts() -> None:
    with _LOCK:
        for c in (FAKE_CALLS, FAKE_ROUTES, FAKE_FLOPS, FAKE_BYTES):
            c.clear()


@contextlib.contextmanager
def host_values():
    """Real CPU tensors for host-side planning that reads values (a GQA
    map, a range plan): every dispatch mode on the stack (the dry-run's
    fake mode and its counters) is off within the block, which is a no-op
    outside a dry-run."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield
