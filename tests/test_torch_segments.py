"""The assertions of tests/test_segments.py (all nine) against the port's
SegmentedOracle on the CPU: one port GossipOracle per segment, with the
agent-level cases answered through `agent_bind.bind`."""

import json

import pytest

from torch_parity import consul_hooks

from consul_tpu.agent import Agent
from consul_tpu.api.client import ApiError, Client
from consul_tpu.cli.main import main
from consul_tpu import config as jconfig
from consul_tpu_torch import agent_bind
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.oracle import GossipOracle
from consul_tpu_torch.segments import SegmentedOracle


def segmented(spec):
    g = GossipConfig.lan()
    return SegmentedOracle({seg: (g, SimConfig(**sim))
                            for seg, sim in spec.items()},
                           device="cpu", hooks=consul_hooks())


def make_segmented(n_default=8, n_alpha=4, n_beta=4):
    return segmented({
        "": dict(n_nodes=n_default, rumor_slots=8, p_loss=0.0, seed=81),
        "alpha": dict(n_nodes=n_alpha, rumor_slots=8, p_loss=0.0, seed=82),
        "beta": dict(n_nodes=n_beta, rumor_slots=8, p_loss=0.0, seed=83),
    })


def test_pools_are_port_oracles_on_the_device_given():
    so = make_segmented()
    assert all(isinstance(p, GossipOracle) and p.device.type == "cpu"
               for p in so.pools.values())
    assert all(p.hooks is so.hooks for p in so.pools.values())


def test_membership_is_segment_scoped():
    so = make_segmented()
    assert so.segments() == ["", "alpha", "beta"]
    assert so.n_nodes == 16
    all_rows = so.members()
    assert len(all_rows) == 16
    alpha = so.members(segment="alpha")
    assert len(alpha) == 4
    assert all(r["segment"] == "alpha" for r in alpha)
    assert all(r["name"].startswith("alpha-node") for r in alpha)
    with pytest.raises(KeyError):
        so.members(segment="nope")


def test_failure_detection_stays_segment_local():
    so = make_segmented()
    so.kill("alpha-node1")
    so.advance(300)
    assert so.status("alpha-node1") == "failed"
    assert so.members_summary()["failed"] == 1
    assert all(r["status"] == "alive" for r in so.members(segment=""))
    assert all(r["status"] == "alive" for r in so.members(segment="beta"))
    d = so.members_delta()
    assert ("alpha", 1, "failed") in d["changed"] and d["count"] == 16


def test_cross_segment_rtt_is_undefined():
    so = make_segmented()
    so.advance(50)
    assert so.rtt("alpha-node0", "alpha-node1") >= 0.0
    with pytest.raises(KeyError):
        so.rtt("alpha-node0", "beta-node0")
    out = so.sort_by_rtt("alpha-node0",
                         ["beta-node1", "alpha-node2", "alpha-node1"])
    assert set(out[:2]) == {"alpha-node1", "alpha-node2"}
    assert out[2] == "beta-node1"


def test_events_reach_every_segment():
    so = make_segmented()
    so.fire_event("deploy", b"v2", origin="node0")
    so.advance(120)
    ev = so.event_list()
    assert ev and ev[0]["name"] == "deploy"
    assert so.event_coverage(ev[0]["id"]) > 0.99


def test_pagination_spans_pools_in_order():
    so = make_segmented()
    page1 = so.members(limit=10, offset=0)
    page2 = so.members(limit=10, offset=10)
    names = [r["name"] for r in page1 + page2]
    assert len(names) == 16 and len(set(names)) == 16
    assert names[0].startswith("node")
    assert names[8].startswith("alpha-node")
    assert names[12].startswith("beta-node")


SEG_SPEC = {"": dict(n_nodes=8, rumor_slots=8, seed=84),
            "alpha": dict(n_nodes=4, rumor_slots=8, seed=85)}


@pytest.fixture(scope="module")
def seg_agent(tmp_path_factory):
    cfg = tmp_path_factory.mktemp("segcfg") / "seg.json"
    cfg.write_text(json.dumps({
        "sim": SEG_SPEC[""],
        "segments": [{"name": "alpha", "sim": SEG_SPEC["alpha"]}],
    }))
    a = Agent.from_config(config_files=[str(cfg)])
    agent_bind.bind(a, segmented(SEG_SPEC))
    a.start(tick_seconds=0.0, reconcile_interval=0.2)
    yield a
    a.stop()


def test_agent_http_segment_filter(seg_agent):
    assert isinstance(seg_agent.oracle, SegmentedOracle)
    c = Client(seg_agent.http_address)
    rows = c.agent_members()
    assert len(rows) == 12
    alpha = c.agent_members(segment="alpha")
    assert len(alpha) == 4
    assert all(m["Tags"]["segment"] == "alpha" for m in alpha)
    with pytest.raises(ApiError) as ei:
        c.agent_members(segment="nope")
    assert ei.value.code == 400
    segs = c._call("GET", "/v1/operator/segment")[0]
    assert segs == ["<default>", "alpha"]


def test_members_cli_segment_flag(seg_agent, capsys):
    assert main(["-http-addr", seg_agent.http_address, "members",
                 "-segment", "alpha"]) == 0
    out = capsys.readouterr().out
    assert "alpha-node0" in out and "node0\t" not in out


def test_unsegmented_agent_rejects_segment_param():
    a = Agent(jconfig.GossipConfig.lan(),
              jconfig.SimConfig(n_nodes=8, rumor_slots=8, p_loss=0.0,
                                seed=86))
    agent_bind.bind(a, GossipOracle(
        GossipConfig.lan(), SimConfig(n_nodes=8, rumor_slots=8, p_loss=0.0,
                                      seed=86),
        device="cpu", hooks=consul_hooks()))
    a.start(tick_seconds=0.0, reconcile_interval=0.5)
    try:
        c = Client(a.http_address)
        with pytest.raises(ApiError) as ei:
            c.agent_members(segment="alpha")
        assert ei.value.code == 400
    finally:
        a.stop()


def test_member_addresses_unique_across_segments(seg_agent):
    c = Client(seg_agent.http_address)
    rows = c.agent_members()
    addrs = [(m["Addr"], m["Port"]) for m in rows]
    assert len(addrs) == len(set(addrs)), "Addr collision across pools"
