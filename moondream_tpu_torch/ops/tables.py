"""Constant host tables on the card without a host sync: the crop kernel's
tap bands, the stitch's gather indices and the projection's pooling
matrices. Each table goes up once per device, from pinned memory with a
non_blocking copy, under a lock (server threads encode at once); every
later caller's stream waits on the event recorded after that copy, so a
table uploaded on one stream is safe to read on another (a CUDA graph
capture skips the wait: the table was uploaded before it began)."""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, Tuple

import torch

_lock = threading.Lock()
_tables: Dict[tuple, Tuple[Tuple[torch.Tensor, ...], object]] = {}


def on_device(key: Hashable, make: Callable[[], Tuple[torch.Tensor, ...]],
              device) -> Tuple[torch.Tensor, ...]:
    """The CPU tensors that make() returns for `key`, on `device`: as they
    are on the CPU; on a card copied up at the first call per device."""
    device = torch.device(device)
    if device.type == "cpu":
        return make()
    with _lock:
        entry = _tables.get((key, device))
        if entry is None:
            up = tuple(t.pin_memory().to(device, non_blocking=True) for t in make())
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            entry = _tables[(key, device)] = (up, event)
    if not torch.cuda.is_current_stream_capturing():  # a capture may not wait on it
        torch.cuda.current_stream(device).wait_event(entry[1])
    return entry[0]
