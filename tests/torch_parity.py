"""Helpers for the tests that hold the PyTorch port (consul_tpu_torch) to
the JAX package: state dicts through numpy, and leaf-by-leaf comparison
with int/bool leaves bit-equal and float leaves within a stated rtol."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The port's CPU path runs many small ops per tick; one intra-op thread
# keeps it fast and keeps xdist workers from oversubscribing the cores.
torch.set_num_threads(1)


def jax_dict(state) -> dict:
    """A JAX (flax struct) state as {field: numpy array}."""
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between float32 arrays of one
    sign (the draws compared here never straddle zero differently)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def assert_leaves(ref: dict, got: dict, rtol: float = 1e-6,
                  only=None, where: str = "") -> None:
    """Every int/bool leaf of `ref` bit-equal (dtype included) in `got`;
    float leaves within `rtol` (atol 0)."""
    names = only if only is not None else list(ref)
    for name in names:
        a, b = np.asarray(ref[name]), np.asarray(got[name])
        assert a.dtype == b.dtype, f"{where}{name}: dtype {a.dtype} vs {b.dtype}"
        assert a.shape == b.shape, f"{where}{name}: shape {a.shape} vs {b.shape}"
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0,
                                       err_msg=f"{where}{name}")
        else:
            diff = int((a != b).sum())
            assert diff == 0, f"{where}{name}: {diff} elements differ"


def int_leaves(d: dict) -> list:
    return [k for k, v in d.items() if np.asarray(v).dtype.kind != "f"]


def consul_hooks():
    """The port oracle's host hooks wired to the JAX package's flight
    recorder, tick profiler and telemetry registry, as an agent of the
    host package would wire them."""
    from consul_tpu import flight, telemetry
    from consul_tpu.profiler import default_profiler
    from consul_tpu_torch import host
    return host.Hooks(
        emit=flight.emit,
        observe=lambda name, seconds: default_profiler().observe(name, seconds),
        span=lambda name: default_profiler().span(name),
        registry=telemetry.default_registry)
