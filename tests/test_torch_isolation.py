"""The port stands alone: importing every module of consul_tpu_torch and
chip_smoke.py loads no JAX, no flax and nothing of the JAX package; its
entry points never land on the CPU unasked; its kernel wrappers refuse
bad tensors before anything is launched."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import consul_tpu_torch
from consul_tpu_torch import bench, config, kernels
from consul_tpu_torch.models import serf

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "jaxlib", "consul_tpu")
             or m.startswith(("jax.", "flax.", "jaxlib.", "consul_tpu.")))
print(len(sys.argv) - 1, "modules")
if bad:
    sys.exit("imported: " + ", ".join(bad[:20]))
"""


def _port_modules():
    names = ["consul_tpu_torch"]
    for info in pkgutil.walk_packages(consul_tpu_torch.__path__,
                                      prefix="consul_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax_and_no_reference_package():
    names = _port_modules()
    assert {"consul_tpu_torch.models.swim", "consul_tpu_torch.ops.gossip",
            "consul_tpu_torch.kernels", "consul_tpu_torch.bench"} <= set(names)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE, *names, "chip_smoke"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"{len(names) + 1} modules" in proc.stdout


def test_port_sources_never_name_the_reference_package():
    for path in [*Path(consul_tpu_torch.__file__).parent.rglob("*.py"),
                 REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                mod = stripped.split()[1]
                assert mod.split(".")[0] not in ("jax", "flax", "consul_tpu"), \
                    f"{path}: {stripped}"


def test_entry_points_raise_without_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = serf.make_params(config.GossipConfig.lan(),
                              config.SimConfig(n_nodes=64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serf.init_state(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_convergence(n_nodes=64, victim=21)
    assert serf.init_state(params, device="cpu").swim.up.device.type == "cpu"


def test_kernel_wrappers_reject_bad_tensors_before_launching():
    before = dict(kernels.LAUNCHES)
    n, s = 16, 8
    know = torch.zeros(n, s, dtype=torch.bool)
    args = dict(know=know, sends_left=torch.zeros(n, s, dtype=torch.int16),
                offsets=torch.tensor([1, 2, 3], dtype=torch.int32),
                sender_ok=torch.ones(n, dtype=torch.bool),
                receiver_ok=torch.ones(n, dtype=torch.bool),
                slot_active=torch.ones(s, dtype=torch.bool), ok=None,
                limit=4, new_know=torch.empty_like(know),
                new_sends=torch.empty(n, s, dtype=torch.int8),
                newly=torch.empty_like(know),
                counters=torch.empty(3, dtype=torch.float32))
    with pytest.raises(ValueError, match="sends_left"):
        kernels.launch_gossip(**args)
    args["sends_left"] = torch.zeros(n, s, dtype=torch.int8)
    args["offsets"] = torch.ones(17, dtype=torch.int32)
    with pytest.raises(ValueError, match="contacts"):
        kernels.launch_gossip(**args)
    with pytest.raises(ValueError, match="elements"):
        kernels.launch_threefry((0, 7), 10, 1, torch.empty(9))
    assert kernels.LAUNCHES == before      # a refused launch is not counted
