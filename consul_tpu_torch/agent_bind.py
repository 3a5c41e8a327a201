"""Give an already built agent the port's oracle.

The agent of the host package (HTTP API, DNS, remote exec, the server's
reconcile loop) reads the gossip pool through one oracle object that it
builds itself.  `bind` points every holder of that object at a port
oracle (a `GossipOracle` or `SegmentedOracle` of this package) before the
agent starts, so those surfaces answer from the card.  The caller builds
the agent and hands it in; this module imports nothing of the host
package.
"""

from __future__ import annotations

import sys


def bind(agent, oracle):
    """Point `agent`'s oracle holders at `oracle`, carrying over the
    keyring of the oracle it replaces (an agent built with `encrypt`
    keeps its key).  Call it before `agent.start()`; returns `oracle`."""
    if getattr(agent, "_running", False):
        raise RuntimeError("bind the oracle before the agent starts")
    old = agent.oracle
    ring = old.keyring_list()
    for key in ring["Keys"]:
        oracle.keyring_install(key)
    for key in ring["PrimaryKeys"]:
        oracle.keyring_use(key)
    agent.oracle = oracle
    api = agent.api
    api.oracle = oracle
    api.query_executor.oracle = oracle
    # the HTTP front's handler class closes over the oracle it was built
    # with: build it again, with the api's own module, for the new one
    api.httpd._handler_cls = sys.modules[type(api).__module__] \
        ._make_handler(api)
    agent.dns.oracle = oracle
    agent.remote_exec.oracle = oracle
    if getattr(agent.store, "_oracle", None) is not None:
        agent.store._oracle = oracle
    return oracle
