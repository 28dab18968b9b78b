"""Named spans and counters inside the port, for the profiler's trace.

``span(name)`` marks a layer of the model or the step (``norm``,
``attention``, ``ffn``, ``head_ce``, ``global_norm``, ``batch_norm``)
where its work is launched.  Off, the default, it is one shared object
that does nothing: no torch call, no allocation, one flag test.  On
(``enabled()``), it is ``torch.profiler.record_function("ptt." +
name)``, a range in the same ``torch.profiler`` trace as the device's
records, so each kernel can be put down to the span that launched it
and each idle gap to the span the host was in.  Spans of different
names never nest; a recomputed layer (a checkpoint) opens its spans
again, on the thread that recomputes it.

``count(name, tensor)`` keeps a device tensor while spans are on (no
copy, no sync); ``take_counts()`` hands them over and forgets them.
The switch is one flag for the whole process, not per thread: the
backward and the recompute run on autograd's threads.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "ptt."

_on = False
_counts: list[tuple[str, torch.Tensor]] = []
_OFF = contextlib.nullcontext()  # every span while spans are off


def span(name: str):
    """A context manager around the work of layer ``name``."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def enabled(on: bool = True):
    """Spans and counters on (or off) inside the block, as they were
    after it."""
    global _on
    before, _on = _on, on
    try:
        yield
    finally:
        _on = before


def count(name: str, tensor: torch.Tensor) -> None:
    """Keep ``tensor`` (detached, on its device) under ``name`` while
    spans are on."""
    if _on:
        _counts.append((name, tensor.detach()))


def take_counts() -> list[tuple[str, torch.Tensor]]:
    """Every ``(name, tensor)`` kept since the last call, in order."""
    global _counts
    out, _counts = _counts, []
    return out
