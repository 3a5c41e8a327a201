"""The port's mesh (consul_tpu_torch/parallel/mesh.py) against the JAX
package's (consul_tpu/parallel/mesh.py) on the CPU.

A mesh here is a list of devices (the CPU B times); the node axis is cut
into B blocks of L = N / B rows, each its own allocation.  Held for B in
{2, 4, 8} and N in {64, 256}: `_node_shardable` equals the reference's
predicate; `state_sharding` places every SerfState leaf as the
reference's does wherever the leaf leads with the node axis, and keeps
the [U] / [E] tables whole; shard_state / unshard_state round-trip every
leaf bit for bit; a Blocks value refuses torch ops, numpy and iteration;
the rolls block path (d = s*L + r) equals the reference's
pull_multi/pull/push with `blocks=B`, offsets at multiples of L and N - 1
included; `_top_k_sharded` equals the reference's and lax.top_k with
ties, k > L included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_dict

from consul_tpu import config as jconfig
from consul_tpu.models import serf as jserf
from consul_tpu.models import swim as jswim
from consul_tpu.ops import rolls as jrolls
from consul_tpu.parallel import mesh as jmesh
from consul_tpu_torch import config, convert
from consul_tpu_torch.models import serf, swim
from consul_tpu_torch.ops import rolls
from consul_tpu_torch.parallel import mesh

BLOCKS = (2, 4, 8)
SIZES = (64, 256)
GRID = [(b, n) for b in BLOCKS for n in SIZES]


def _cpu_mesh(blocks):
    return mesh.make_mesh(["cpu"] * blocks)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_node_shardable_matches_reference(blocks):
    for dim in range(0, 300):
        assert mesh._node_shardable(dim, blocks) \
            == jmesh._node_shardable(dim, blocks), dim


def _states(n, u=16, e=16):
    """A JAX SerfState at N, U, E and the port's copy of it, a few ticks in
    (the kill gives rumors and counters to carry)."""
    jp = jserf.make_params(jconfig.GossipConfig.lan(), jconfig.SimConfig(
        n_nodes=n, rumor_slots=u, p_loss=0.05, seed=3), event_slots=e)
    js = jserf.init_state(jp)
    js = js.replace(swim=jswim.kill(js.swim, 5))
    js, _ = jax.jit(jserf.run, static_argnums=(0, 2, 3))(jp, js, 7, None)
    d = {"swim": jax_dict(js.swim), "coords": jax_dict(js.coords),
         "events": jax_dict(js.events)}
    return js, convert.cluster_state_from_numpy(d, "cpu")


def _tensor_leaves(ts) -> dict:
    """{"part.field": tensor} of a port ClusterState."""
    return {f"{p}.{f.name}": getattr(getattr(ts, p), f.name)
            for p in ("swim", "coords", "events")
            for f in dataclasses.fields(getattr(ts, p))
            if isinstance(getattr(getattr(ts, p), f.name), torch.Tensor)}


@pytest.mark.parametrize("blocks,n", GRID)
def test_state_sharding_matches_reference_choice(blocks, n):
    """Every leaf that leads with the node axis is placed as the reference
    places it; the other leaves are replicated, except that the reference
    also shards a [U] / [E] table whose size passes _node_shardable (a
    layout of GSPMD's), which the port keeps whole."""
    js, ts = _states(n)
    jm = jmesh.make_mesh(jax.devices()[:blocks])
    want = jmesh.state_sharding(js, jm)
    got = mesh.state_sharding(ts, _cpu_mesh(blocks))
    shardable_tables = 0
    for path, leaf in _tensor_leaves(ts).items():
        part, field = path.split(".")
        ref = tuple(getattr(getattr(want, part), field).spec)
        mine = getattr(getattr(got, part), field)
        if leaf.dim() >= 1 and leaf.shape[0] == n:
            assert mine == ref == ("nodes",), path
        else:
            assert mine == (), path
            table = leaf.dim() >= 1 and jmesh._node_shardable(
                leaf.shape[0], blocks)
            shardable_tables += table
            assert ref == (("nodes",) if table else ()), path
    # U = E = 16: the reference shards its tables at B = 2 and 4, not 8
    assert (shardable_tables > 0) == (blocks < 8)


@pytest.mark.parametrize("blocks,n", GRID)
def test_shard_unshard_round_trip(blocks, n):
    _, ts = _states(n)
    m = _cpu_mesh(blocks)
    sh = mesh.shard_state(ts, m)
    ell = n // blocks
    for part in ("swim", "coords", "events"):
        for f in getattr(ts, part).__dataclass_fields__:
            v, w = getattr(getattr(ts, part), f), getattr(getattr(sh, part), f)
            if not isinstance(v, torch.Tensor):
                assert v == w
            elif v.dim() >= 1 and v.shape[0] == n:
                mesh.assert_node_sharded(w, blocks, f)
                assert w.shape == tuple(v.shape) and w.rows == ell
                assert all(p.shape[0] == ell for p in w.parts)
            else:
                assert isinstance(w, mesh.Replicated)
                assert w.home.data_ptr() != v.data_ptr()
    back = mesh.unshard_state(sh)
    for part in ("swim", "coords", "events"):
        for f in getattr(ts, part).__dataclass_fields__:
            v, w = getattr(getattr(ts, part), f), getattr(getattr(back, part), f)
            if isinstance(v, torch.Tensor):
                assert v.dtype == w.dtype and torch.equal(
                    v.reshape(-1).view(torch.uint8),
                    w.reshape(-1).view(torch.uint8)), f
            else:
                assert v == w
    assert sh.swim.mesh == m and ts.swim.mesh is None
    assert sh.swim.device == torch.device("cpu")


def test_blocks_refuse_what_would_gather_them():
    x = mesh.shard_state(torch.arange(64), _cpu_mesh(4), 64)
    with pytest.raises(TypeError, match="gather"):
        torch.where(x.parts[0] > 0, x, 0)
    with pytest.raises(TypeError, match="gather"):
        torch.add(x, 1)
    with pytest.raises(TypeError, match="gather"):
        np.asarray(x)
    with pytest.raises(TypeError, match="gather"):
        list(x)
    with pytest.raises(TypeError):
        torch.cat(x)
    r = mesh.Replicated.of(torch.arange(4), [torch.device("cpu")])
    with pytest.raises(TypeError, match="copy by copy"):
        torch.add(r, 1)


def test_shard_state_and_make_mesh_refuse_bad_input(monkeypatch):
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_state(torch.zeros(64), _cpu_mesh(3), 64)
    with pytest.raises(ValueError, match="same shape"):
        mesh.Blocks([torch.zeros(4), torch.zeros(5)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    m = mesh.make_mesh(["cpu", "cpu"])
    assert m.size == 2 and m.distinct == (torch.device("cpu"),)
    assert m.shape == {mesh.NODE_AXIS: 2} and mesh.DC_AXIS == "dc"


def _offsets(n, ell):
    return sorted({0, 1, ell - 1, ell, 2 * ell, ell + 3, n - ell, n - ell + 1,
                   n - 1, n // 3, 7 % n})


@pytest.mark.parametrize("blocks,n", GRID)
def test_rolls_block_path_matches_reference(blocks, n):
    ell = n // blocks
    rng = np.random.default_rng(blocks * 1000 + n)
    mat = rng.integers(-100, 100, size=(n, 3)).astype(np.int32)
    m = _cpu_mesh(blocks)
    bmat = mesh.shard_state(torch.from_numpy(mat), m, n)
    offs = _offsets(n, ell)
    want = jrolls.pull_multi(jnp.asarray(mat), jnp.asarray(offs, jnp.int32),
                             blocks=blocks)
    got = rolls.pull_multi(bmat, torch.tensor(offs, dtype=torch.int32))
    for d, a, b in zip(offs, want, got):
        assert isinstance(b, mesh.Blocks)
        np.testing.assert_array_equal(mesh.unshard_state(b).numpy(),
                                      np.asarray(a), err_msg=f"d={d}")
    for d in (0, ell, n - 1, 5 % n):
        d32 = torch.tensor(d, dtype=torch.int32)
        np.testing.assert_array_equal(
            mesh.unshard_state(rolls.pull(bmat, d32)).numpy(),
            np.asarray(jrolls.pull(jnp.asarray(mat), jnp.int32(d),
                                   blocks=blocks)))
        np.testing.assert_array_equal(
            mesh.unshard_state(rolls.push(bmat, d32)).numpy(),
            np.asarray(jrolls.push(jnp.asarray(mat), jnp.int32(d),
                                   blocks=blocks)))
    # a 1-D leaf, as the gossip pass rotates its row counts
    vec = mesh.shard_state(torch.from_numpy(mat[:, 0].copy()), m, n)
    np.testing.assert_array_equal(
        mesh.unshard_state(rolls.pull(vec, torch.tensor(n - 1))).numpy(),
        np.roll(mat[:, 0], -(n - 1)))


@pytest.mark.parametrize("blocks,n", GRID)
def test_top_k_sharded_matches_reference_with_ties(blocks, n):
    ell = n // blocks
    rng = np.random.default_rng(blocks + n)
    for values in (rng.integers(0, 4, size=n),          # many ties
                   rng.integers(0, 2, size=n),          # a 0/1 mask
                   np.zeros(n, np.int64)):              # all tied
        x = values.astype(np.int32)
        bx = mesh.shard_state(torch.from_numpy(x), _cpu_mesh(blocks), n)
        for k in sorted({1, 3, ell // 2 or 1, ell, ell + 1,
                         min(2 * ell + 3, n), n}):
            v, i = swim._top_k_sharded(bx, k)
            jv, ji = jswim._top_k_sharded(jnp.asarray(x), k, blocks)
            lv, li = jax.lax.top_k(jnp.asarray(x), k)
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(i.numpy(), np.asarray(li))
            assert i.dtype == torch.int32
    t = torch.tensor([3, 1, 3, 2], dtype=torch.int32)
    assert swim._top_k_sharded(t, 2)[1].tolist() == [0, 2]


def test_sharded_params_need_divisible_blocks():
    with pytest.raises(ValueError, match="must divide"):
        swim.make_params(config.GossipConfig.lan(),
                         config.SimConfig(n_nodes=100, shard_blocks=8))
    assert serf.make_params(config.GossipConfig.lan(), config.SimConfig(
        n_nodes=64, shard_blocks=8)).swim.shard_blocks == 8
