"""Infection-style dissemination — the shared gossip pass (kernel K2).

One gossip tick: every live node pulls the queued item masks of `fanout`
ring peers at per-tick random offsets into its own [N, S] knowledge row
(consul_tpu/ops/gossip.py:45-127, the non-chaos path).  Memberlist
pushes; receivers pull here, with the same spread rate, and the serving
budget reproduces push's bounded per-node transmission count.

`disseminate` launches kernel K2 (kernels/csrc/gossip.cu) on CUDA
tensors and runs `disseminate_plain` on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from consul_tpu_torch import kernels
from consul_tpu_torch.ops import rolls
from consul_tpu_torch.utils import prng


class GossipResult(NamedTuple):
    know: torch.Tensor        # [N, S] bool
    sends_left: torch.Tensor  # [N, S] int8
    newly: torch.Tensor       # [N, S] bool — learned this tick
    # device-side tick counters (0-d float32): newly learned cells, cell
    # transmissions attempted, cell transmissions dropped to loss
    delivered: torch.Tensor
    served: torch.Tensor
    lost: torch.Tensor


def loss_mask(key, p_loss: float, n: int, fanout: int, device):
    """[N, G] contact-delivered mask (one UDP packet per contact), or None
    when there is no loss."""
    if p_loss > 0.0 and key is not None:
        return prng.bernoulli(key, 1.0 - p_loss, (n, fanout), device)
    return None


def disseminate_plain(offs: torch.Tensor, know: torch.Tensor,
                      sends_left: torch.Tensor, sender_ok: torch.Tensor,
                      receiver_ok: torch.Tensor, slot_active: torch.Tensor,
                      retransmit_limit: int,
                      ok: Optional[torch.Tensor]) -> GossipResult:
    """The plain PyTorch version of K2: G ring views of the serve mask,
    loss per contact, the OR, and the budget update."""
    fanout = offs.shape[0]
    serve = know & (sends_left > 0) & sender_ok[:, None]
    views = rolls.pull_multi(serve, offs)
    cells = serve.sum(1)                                       # [N] int64
    served = cells.sum().to(torch.float32) * fanout
    lost = torch.zeros((), dtype=torch.float32, device=know.device)
    if ok is not None:
        carried = torch.stack(rolls.pull_multi(cells, offs), dim=1)
        lost = torch.where(ok, 0, carried).sum().to(torch.float32)
        views = [v & ok[:, g:g + 1] for g, v in enumerate(views)]
    got = views[0]
    for v in views[1:]:
        got = got | v
    received = got & receiver_ok[:, None] & slot_active[None, :]
    newly = received & ~know
    new_know = know | newly
    budget = torch.clamp_min(sends_left - fanout, 0).to(torch.int8)
    new_sends = torch.where(newly, retransmit_limit,
                            torch.where(serve, budget, sends_left))
    return GossipResult(know=new_know, sends_left=new_sends, newly=newly,
                        delivered=newly.sum().to(torch.float32),
                        served=served, lost=lost)


def disseminate_kernel(offs: torch.Tensor, know: torch.Tensor,
                       sends_left: torch.Tensor, sender_ok: torch.Tensor,
                       receiver_ok: torch.Tensor, slot_active: torch.Tensor,
                       retransmit_limit: int,
                       ok: Optional[torch.Tensor]) -> GossipResult:
    """K2 on the card: one launch, fresh output buffers."""
    new_know = torch.empty_like(know)
    new_sends = torch.empty_like(sends_left)
    newly = torch.empty_like(know)
    counters = torch.empty(3, dtype=torch.float32, device=know.device)
    kernels.launch_gossip(know, sends_left, offs.to(torch.int32).contiguous(),
                          sender_ok.contiguous(), receiver_ok.contiguous(),
                          slot_active.contiguous(), ok, retransmit_limit,
                          new_know, new_sends, newly, counters)
    return GossipResult(know=new_know, sends_left=new_sends, newly=newly,
                        delivered=counters[0], served=counters[1],
                        lost=counters[2])


def disseminate(offs: torch.Tensor, know: torch.Tensor,
                sends_left: torch.Tensor, sender_ok: torch.Tensor,
                receiver_ok: torch.Tensor, slot_active: torch.Tensor,
                retransmit_limit: int, p_loss: float = 0.0,
                key=None, blocks: int = 1) -> GossipResult:
    """One fanout round.

    offs: [G] int32 ring offsets on the device (node i pulls from
    (i + offs[g]) % N); sender_ok/receiver_ok: [N] bool; slot_active: [S]
    bool.  `p_loss` (with `key`) drops whole contacts: all slots of one
    peer's packet vanish together."""
    if blocks != 1:
        raise NotImplementedError("node-axis sharding is not ported yet")
    ok = loss_mask(key, p_loss, know.shape[0], offs.shape[0], know.device)
    fn = disseminate_kernel if know.is_cuda else disseminate_plain
    return fn(offs, know, sends_left, sender_ok, receiver_ok, slot_active,
              retransmit_limit, ok)
