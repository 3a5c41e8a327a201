#!/usr/bin/env python3
"""Crash-to-convergence tick count of the JAX package (the reference the
PyTorch port is held to), at one pool size, on the CPU.

    JAX_PLATFORMS=cpu python reference_ticks.py 262144

Runs the repo's bench.run_convergence (seed 7, victim 123456, 200-tick
scans) and prints one JSON line with the ticks to >99.9% believed-down.
chip_smoke.py holds the port's count on the card to this number.

Where jax is installed without flax, the JAX package's one use of flax —
`flax.struct.dataclass`, a frozen dataclass registered as a pytree with
a `replace` method — is provided here, so the reference runs unchanged.
"""

import dataclasses
import json
import sys
import time
import types


def _provide_flax_struct() -> None:
    try:
        import flax.struct  # noqa: F401
        return
    except ModuleNotFoundError:
        pass
    import jax

    def dataclass(clz):
        clz = dataclasses.dataclass(frozen=True)(clz)
        clz.replace = lambda self, **kw: dataclasses.replace(self, **kw)
        names = [f.name for f in dataclasses.fields(clz)]
        jax.tree_util.register_dataclass(clz, data_fields=names,
                                         meta_fields=[])
        return clz

    struct = types.ModuleType("flax.struct")
    struct.dataclass = dataclass
    flax = types.ModuleType("flax")
    flax.struct = struct
    sys.modules["flax"] = flax
    sys.modules["flax.struct"] = struct


def main() -> None:
    n = int(sys.argv[1])
    _provide_flax_struct()
    import bench
    if n <= bench.VICTIM:
        sys.exit(f"n_nodes must exceed the bench victim {bench.VICTIM}")
    t0 = time.time()
    r = bench.run_convergence(n_nodes=n)
    print(json.dumps({"n_nodes": n, "ticks": r["ticks"],
                      "converged": bool(r["converged"]), "f1": r["f1"],
                      "false_commits": r["false_commits"],
                      "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
