"""The host services the oracle takes from its caller.

The oracle journals events (a flight recorder), times its ticks and
metric reads (a profiler) and publishes gauges (a telemetry registry).
The port owns none of these: its caller hands them in as one `Hooks`
object, and each hook does nothing until the caller supplies it.

`emit` passes its keyword arguments through untouched: the oracle's
user-event record carries the caller's trace context (none given), while
its flap journal passes `trace_id=""` so that a membership flap is never
stamped with the trace of whichever request surfaced it.
"""

from __future__ import annotations

import base64
import contextlib
from typing import Callable, Optional


class NullRegistry:
    """A gauge sink that drops every gauge."""

    def set_gauge(self, name, value, labels=None) -> None:
        pass


class Hooks:
    """emit(name, labels=None, **kw), observe(name, seconds), span(name)
    (a context manager) and registry() (an object with set_gauge), each
    forwarded to the callable given for it, else a no-op."""

    def __init__(self, emit: Optional[Callable] = None,
                 observe: Optional[Callable] = None,
                 span: Optional[Callable] = None,
                 registry: Optional[Callable] = None):
        self._emit = emit
        self._observe = observe
        self._span = span
        self._registry = registry

    def emit(self, name: str, labels=None, **kw) -> None:
        if self._emit is not None:
            self._emit(name, labels=labels, **kw)

    def observe(self, name: str, seconds: float) -> None:
        if self._observe is not None:
            self._observe(name, seconds)

    def span(self, name: str):
        if self._span is not None:
            return self._span(name)
        return contextlib.nullcontext()

    def registry(self):
        if self._registry is not None:
            return self._registry()
        return NullRegistry()


def decode_key(key_b64: str) -> bytes:
    """A gossip encryption key from its base64 text: 16, 24 or 32 bytes
    (memberlist's AES-128/192/256 keys), else ValueError."""
    raw = base64.b64decode(key_b64)
    if len(raw) not in (16, 24, 32):
        raise ValueError(
            f"gossip key must be 16/24/32 bytes, got {len(raw)}")
    return raw
