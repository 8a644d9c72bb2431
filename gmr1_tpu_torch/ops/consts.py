"""Constant host tables on a device, uploaded once.

A jitted JAX function carries its numpy constants (sync references, index
and sign tables, generator matrices) inside the compiled program.  Run
eagerly, the port would upload each of them again at every call, a small
pageable host-to-device copy each.  `table` makes and uploads one once per
device, through pinned memory on the card, and keeps it; `upload` is that
host-to-device path for any host array.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on the card through pinned memory and a
    non-blocking copy (no pageable upload); on the CPU the array itself."""
    t = torch.as_tensor(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@lru_cache(maxsize=None)
def _resident(fn, args: tuple, device: torch.device) -> torch.Tensor:
    return upload(np.array(fn(*args)), device)


def table(fn, *args, device) -> torch.Tensor:
    """fn(*args) on `device`, made and uploaded at the first call for
    (fn, args, device) and kept.  fn is a module-level pure function of
    its hashable args that returns a numpy array; callers never write the
    tensor."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _resident(fn, args, dev)
