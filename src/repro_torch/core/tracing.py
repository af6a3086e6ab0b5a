"""Spans inside the SPH step: named stretches of it on a profiler's
timeline.

A span is a ``torch.profiler.record_function`` range, entered only while
a torch profiler is recording (the flag torch sets when a profile
starts), so an untraced step pays one attribute read a span. The ranges
land on the same Kineto timeline as the device's own events, on its
clock. To trace, open a ``torch.profiler.profile`` around the steps;
there is no other switch.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    records, else a shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap
