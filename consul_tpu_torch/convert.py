"""Carry simulator state across the two packages as dicts of numpy arrays.

`d` is keyed by the JAX dataclass field names (a SwimState's fields, or
for a ClusterState {"swim": ..., "coords": ..., "events": ...}), as a
caller gets them with `np.asarray(getattr(state, name))`.  Dtypes are
preserved exactly; the scalar ticks and the Vivaldi cursor become the
port's host mirrors.  `oracle_from_numpy` carries a whole oracle's pool.
A WanState's JAX dict holds its batched LAN pool as one ClusterState
dict whose leaves lead with the DC axis [D, ...]; the port keeps D pools
and the bridge ring on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch import oracle
from consul_tpu_torch.models import antientropy, events, serf, swim, vivaldi, wan
from consul_tpu_torch.parallel import mesh as meshlib
from consul_tpu_torch.utils import devices


def _tensor(v, device) -> torch.Tensor:
    return torch.from_numpy(np.array(v, copy=True, order="C")).to(device)


def swim_state_from_numpy(d: dict, device=None) -> swim.SwimState:
    device = devices.resolve(device)
    fields = {name: _tensor(d[name], device) for name in swim.TENSOR_FIELDS}
    return swim.SwimState(tick=int(np.asarray(d["tick"])),
                          bulk_live=bool(np.asarray(d["bulk_member"]).any()),
                          **fields)


def swim_state_to_numpy(s: swim.SwimState) -> dict:
    out = {name: getattr(s, name).cpu().numpy() for name in swim.TENSOR_FIELDS}
    out["tick"] = np.int32(s.tick)
    return out


def vivaldi_state_from_numpy(d: dict, device=None) -> vivaldi.VivaldiState:
    device = devices.resolve(device)
    return vivaldi.VivaldiState(
        coords=_tensor(d["coords"], device), height=_tensor(d["height"], device),
        error=_tensor(d["error"], device),
        adj_window=_tensor(d["adj_window"], device),
        adj_index=int(np.asarray(d["adj_index"])),
        adjustment=_tensor(d["adjustment"], device))


def vivaldi_state_to_numpy(s: vivaldi.VivaldiState) -> dict:
    return {"coords": s.coords.cpu().numpy(), "height": s.height.cpu().numpy(),
            "error": s.error.cpu().numpy(),
            "adj_window": s.adj_window.cpu().numpy(),
            "adj_index": np.int32(s.adj_index),
            "adjustment": s.adjustment.cpu().numpy()}


def event_state_from_numpy(d: dict, device=None) -> events.EventState:
    device = devices.resolve(device)
    fields = {name: _tensor(d[name], device) for name in events.TENSOR_FIELDS}
    return events.EventState(
        tick=int(np.asarray(d["tick"])),
        active_host=tuple(bool(a) for a in np.asarray(d["e_active"])),
        start_host=tuple(int(t) for t in np.asarray(d["e_start"])),
        **fields)


def event_state_to_numpy(s: events.EventState) -> dict:
    out = {name: getattr(s, name).cpu().numpy() for name in events.TENSOR_FIELDS}
    out["tick"] = np.int32(s.tick)
    return out


def cluster_state_from_numpy(d: dict, device=None) -> serf.ClusterState:
    device = devices.resolve(device)
    return serf.ClusterState(
        swim=swim_state_from_numpy(d["swim"], device),
        coords=vivaldi_state_from_numpy(d["coords"], device),
        events=event_state_from_numpy(d["events"], device))


def cluster_state_to_numpy(s: serf.ClusterState) -> dict:
    return {"swim": swim_state_to_numpy(s.swim),
            "coords": vivaldi_state_to_numpy(s.coords),
            "events": event_state_to_numpy(s.events)}


def ae_state_from_numpy(d: dict, device=None) -> antientropy.AEState:
    device = devices.resolve(device)
    fields = {name: _tensor(d[name], device)
              for name in antientropy.TENSOR_FIELDS}
    return antientropy.AEState(tick=int(np.asarray(d["tick"])), **fields)


def ae_state_to_numpy(s: antientropy.AEState) -> dict:
    out = {name: getattr(s, name).cpu().numpy()
           for name in antientropy.TENSOR_FIELDS}
    out["tick"] = np.int32(s.tick)
    return out


def _dc(d, i):
    """DC i's slice of a batched state dict (nested dicts of [D, ...])."""
    if isinstance(d, dict):
        return {k: _dc(v, i) for k, v in d.items()}
    return np.asarray(d)[i]


def _stack(dicts):
    if isinstance(dicts[0], dict):
        return {k: _stack([x[k] for x in dicts]) for k in dicts[0]}
    return np.stack([np.asarray(x) for x in dicts])


def wan_state_from_numpy(d: dict, device=None) -> wan.WanState:
    """d: {"lan": a ClusterState dict with [D, ...] leaves, "wan": a
    ClusterState dict, "bridged": [D, B] int32, "bridged_ptr": [D]
    int32}."""
    device = devices.resolve(device)
    bridged = np.asarray(d["bridged"])
    return wan.WanState(
        lan=tuple(cluster_state_from_numpy(_dc(d["lan"], i), device)
                  for i in range(bridged.shape[0])),
        wan=cluster_state_from_numpy(d["wan"], device),
        bridged=tuple(tuple(int(v) for v in row) for row in bridged),
        bridged_ptr=tuple(int(p) for p in np.asarray(d["bridged_ptr"])))


def wan_state_to_numpy(s: wan.WanState) -> dict:
    return {"lan": _stack([cluster_state_to_numpy(c) for c in s.lan]),
            "wan": cluster_state_to_numpy(s.wan),
            "bridged": np.array(s.bridged, dtype=np.int32),
            "bridged_ptr": np.array(s.bridged_ptr, dtype=np.int32)}


def oracle_from_numpy(gossip, sim, state: dict, provisioned, device=None,
                      hooks=None, mesh=None):
    """A port GossipOracle for (gossip, sim) that holds the ClusterState
    `state` (a cluster_state dict as above) and the provisioned mask
    `provisioned` ([N] bool): a JAX oracle's pool carried across
    mid-run, so both can be asked the same reads.  With `mesh` the pool
    is node-sharded over it."""
    o = oracle.GossipOracle(gossip, sim, device=device, hooks=hooks,
                            mesh=mesh)
    prov = np.array(provisioned, dtype=bool, copy=True)
    if prov.shape != (sim.n_nodes,):
        raise ValueError(f"provisioned has shape {prov.shape}, want "
                         f"({sim.n_nodes},)")
    st = cluster_state_from_numpy(state, o.device)
    o._state = st if mesh is None else meshlib.shard_state(st, mesh)
    o._provisioned = prov
    o._prov_dev = o._node_vector(torch.tensor(prov))
    return o
