"""Infection-style dissemination — the shared gossip pass (kernel K2).

One gossip tick: every live node pulls the queued item masks of `fanout`
ring peers at per-tick random offsets into its own [N, S] knowledge row
(consul_tpu/ops/gossip.py:45-127).  Memberlist pushes; receivers pull
here, with the same spread rate, and the serving budget reproduces
push's bounded per-node transmission count.  The nemesis build passes a
partition `group` and a per-node delivery rate `node_ok`: a contact then
exists only between same-group endpoints and delivers at (1 - p_loss) *
ok_i * ok_j, from the same draw as the loss mask (K2's chaos mode).

The swim caller also stamps the learn tick of every newly learned cell
and adds the three gossip counters to its counter vector
(consul_tpu/models/swim.py:1152-1181); `disseminate` takes both steps on
request, so on the card they run inside K2 with the per-contact loss
draw, and `newly` is written only for a caller that asks for it (the
events layer).

`disseminate` launches kernel K2 (kernels/csrc/gossip.cu: a pack launch
and an exchange launch) on CUDA tensors and runs `disseminate_plain` on
CPU tensors.
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
    newly: Optional[torch.Tensor]  # [N, S] bool — learned this tick
    # device-side tick counters (0-d float32): newly learned cells, cell
    # transmissions attempted, cell transmissions dropped to loss
    delivered: torch.Tensor
    served: torch.Tensor
    lost: torch.Tensor
    learn_tick: Optional[torch.Tensor] = None  # [N, S] int16, stamped
    ctr: Optional[torch.Tensor] = None         # the three counters added


def loss_mask(key, p_loss: float, n: int, fanout: int, device):
    """[N, G] contact-delivered mask (one UDP packet per contact), or None
    when there is no loss: jax.random.bernoulli's bits, from the plain
    threefry hash (the kernel draws them itself)."""
    if p_loss > 0.0 and key is not None:
        u = prng.unit_floats(prng.threefry_bits_plain(key, n * fanout, device))
        return u.reshape(n, fanout) < prng.f32(1.0 - p_loss)
    return None


def chaos_mask(key, p_loss: float, n: int, offs: torch.Tensor,
               group: Optional[torch.Tensor], node_ok: Optional[torch.Tensor]):
    """The nemesis build's [N, G] contact masks (consul_tpu/ops/gossip.py:
    82-99): (delivered, exists).  Contact (i, g) exists where the groups of
    i and its sender agree, and is delivered where it exists and the loss
    draw's uniform float is < ((1 - p_loss) * ok_i) * ok_sender, in
    float32 and in that order."""
    fanout, dev = offs.shape[0], offs.device
    p_ok = torch.full((n, fanout), prng.f32(1.0 - p_loss), dtype=torch.float32,
                      device=dev)
    if node_ok is not None:
        senders = torch.stack(rolls.pull_multi(node_ok, offs), dim=1)
        p_ok = p_ok * node_ok[:, None] * senders
    u = prng.unit_floats(prng.threefry_bits_plain(key, n * fanout, dev))
    ok = u.reshape(n, fanout) < p_ok
    exists = None
    if group is not None:
        exists = torch.stack(rolls.pull_multi(group, offs), dim=1) \
            == group[:, None]
        ok = ok & exists
    return ok, exists


def disseminate_plain(offs: torch.Tensor, know: torch.Tensor,
                      sends_left: torch.Tensor, sender_ok: torch.Tensor,
                      receiver_ok: torch.Tensor, slot_active: torch.Tensor,
                      retransmit_limit: int, p_loss: float = 0.0, key=None,
                      learn_tick: Optional[torch.Tensor] = None,
                      tick16: int = 0, ctr: Optional[torch.Tensor] = None,
                      want_newly: bool = True,
                      group: Optional[torch.Tensor] = None,
                      node_ok: Optional[torch.Tensor] = None) -> GossipResult:
    """The plain PyTorch version of K2: the loss (or chaos) mask, G ring
    views of the serve mask, the OR, the budget update; then the stamp and
    the counter add when asked."""
    fanout = offs.shape[0]
    exists = None
    if (group is not None or node_ok is not None) and key is not None:
        ok, exists = chaos_mask(key, p_loss, know.shape[0], offs, group,
                                node_ok)
    else:
        ok = loss_mask(key, p_loss, know.shape[0], fanout, know.device)
    serve = know & (sends_left > 0) & sender_ok[:, None]
    views = rolls.pull_multi(serve, offs)
    cells = serve.sum(1)                                       # [N] int64
    served = cells.sum().to(torch.float32) * fanout
    lost = torch.zeros((), dtype=torch.float32, device=know.device)
    if ok is not None:
        carried = torch.stack(rolls.pull_multi(cells, offs), dim=1)
        if exists is not None:      # a severed link is a partition, not loss
            carried = torch.where(exists, carried, 0)
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
    delivered = newly.sum().to(torch.float32)
    new_learn = new_ctr = None
    if learn_tick is not None:
        new_learn = torch.where(newly, tick16, learn_tick)
    if ctr is not None:
        incr = torch.zeros_like(ctr)
        incr[-3:] = torch.stack([delivered, served, lost])
        new_ctr = ctr + incr
    return GossipResult(know=new_know, sends_left=new_sends,
                        newly=newly if want_newly else None,
                        delivered=delivered, served=served, lost=lost,
                        learn_tick=new_learn, ctr=new_ctr)


def disseminate_kernel(offs: torch.Tensor, know: torch.Tensor,
                       sends_left: torch.Tensor, sender_ok: torch.Tensor,
                       receiver_ok: torch.Tensor, slot_active: torch.Tensor,
                       retransmit_limit: int, p_loss: float = 0.0, key=None,
                       learn_tick: Optional[torch.Tensor] = None,
                       tick16: int = 0, ctr: Optional[torch.Tensor] = None,
                       want_newly: bool = True,
                       group: Optional[torch.Tensor] = None,
                       node_ok: Optional[torch.Tensor] = None) -> GossipResult:
    """K2 on the card: the pack and exchange launches (the exchange in its
    chaos mode when a group or delivery rate is given with a key), fresh
    outputs."""
    n, s = know.shape
    word = torch.int32 if s <= 32 else torch.int64
    new_know = torch.empty_like(know)
    new_sends = torch.empty_like(sends_left)
    new_learn = torch.empty_like(learn_tick) if learn_tick is not None else None
    newly = torch.empty_like(know) if want_newly else None
    new_ctr = torch.empty_like(ctr) if ctr is not None else None
    counters = torch.empty(3, dtype=torch.float32, device=know.device)
    chaotic = (group is not None or node_ok is not None) and key is not None
    lossy = chaotic or (p_loss > 0.0 and key is not None)
    kernels.launch_gossip(
        know, sends_left, offs, sender_ok, receiver_ok, slot_active,
        retransmit_limit, new_know, new_sends,
        torch.empty(n, dtype=word, device=know.device),
        torch.empty(n, dtype=word, device=know.device), counters,
        key=key if lossy else None, p_ok=prng.f32(1.0 - p_loss),
        learn_tick=learn_tick, new_learn=new_learn, tick16=tick16,
        newly=newly, ctr=ctr, ctr_out=new_ctr,
        group=group if chaotic else None, node_ok=node_ok if chaotic else None)
    return GossipResult(know=new_know, sends_left=new_sends, newly=newly,
                        delivered=counters[0], served=counters[1],
                        lost=counters[2], learn_tick=new_learn, ctr=new_ctr)


def disseminate(offs: torch.Tensor, know: torch.Tensor,
                sends_left: torch.Tensor, sender_ok: torch.Tensor,
                receiver_ok: torch.Tensor, slot_active: torch.Tensor,
                retransmit_limit: int, p_loss: float = 0.0,
                key=None, blocks: int = 1, *,
                learn_tick: Optional[torch.Tensor] = None, tick16: int = 0,
                ctr: Optional[torch.Tensor] = None,
                want_newly: bool = True,
                group: Optional[torch.Tensor] = None,
                node_ok: Optional[torch.Tensor] = None) -> GossipResult:
    """One fanout round.

    offs: [G] int32 ring offsets on the device (node i pulls from
    (i + offs[g]) % N); sender_ok/receiver_ok: [N] bool; slot_active: [S]
    bool.  `p_loss` (with `key`) drops whole contacts: all slots of one
    peer's packet vanish together.  With `learn_tick` ([N, S] int16) the
    result carries it stamped with `tick16` where a cell was newly
    learned; with `ctr` ([C] float32, its last three entries the
    delivered, served and lost totals) it carries ctr plus this round's.
    `want_newly=False` leaves `newly` out (None).  The nemesis hooks,
    with `key`: `group` [N] int16 partition ids (a contact exists only
    between same-group endpoints, and a severed one is not counted lost)
    and `node_ok` [N] float32 delivery rates (a contact between i and j
    delivers at (1 - p_loss) * ok_i * ok_j).  `blocks`, the JAX package's
    shard-count lowering hint, changes nothing on one device."""
    fn = disseminate_kernel if know.is_cuda else disseminate_plain
    return fn(offs, know, sends_left, sender_ok, receiver_ok, slot_active,
              retransmit_limit, p_loss, key, learn_tick, tick16, ctr,
              want_newly, group, node_ok)
