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
CPU tensors.  On a node-sharded pool (parallel/mesh.py: the [N, S] and
[N] leaves Blocks, the offsets, slot mask and counters Replicated) it
launches K2 over block tables (`kernels.launch_gossip_blocks`: a pack
and an exchange a block, one combine) on the card and runs
`disseminate_blocks_plain`, the same pass block by block, on the CPU;
both give Blocks whose concatenation is the unsharded pass's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from consul_tpu_torch import kernels
from consul_tpu_torch.ops import rolls
from consul_tpu_torch.parallel.mesh import Blocks, Replicated
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


def _home(x):
    return x.home if isinstance(x, Replicated) else x


def _stack_views(views, b: int) -> torch.Tensor:
    """[L, G] of block b of G Blocks views."""
    return torch.stack([v.parts[b] for v in views], dim=1)


def disseminate_blocks_plain(offs, know: Blocks, sends_left: Blocks,
                             sender_ok: Blocks, receiver_ok: Blocks,
                             slot_active, retransmit_limit: int,
                             p_loss: float = 0.0, key=None,
                             learn_tick: Optional[Blocks] = None,
                             tick16: int = 0, ctr=None,
                             want_newly: bool = True,
                             group: Optional[Blocks] = None,
                             node_ok: Optional[Blocks] = None) -> GossipResult:
    """disseminate_plain over a node-sharded pool, block by block: the ring
    views through rolls' block rotations (no [N] buffer), each block's
    loss draws as its rows' elements i*G + g of the stream, the counters
    as the blocks' integer totals added in block order (so their float32
    values are the unsharded pass's).  Returns Blocks, the counters on
    the first block's device and ctr Replicated."""
    offs_home = _home(offs)
    fanout = offs_home.shape[0]
    nb, ell = know.n_blocks, know.rows
    home = know.device
    chaotic = (group is not None or node_ok is not None) and key is not None
    serve = know.map(lambda k, sl, so: k & (sl > 0) & so[:, None],
                     sends_left, sender_ok)
    views = rolls.pull_multi(serve, offs_home)
    cells = serve.map(lambda v: v.sum(1))
    lossy = chaotic or (p_loss > 0.0 and key is not None)
    carried = rolls.pull_multi(cells, offs_home) if lossy else None
    senders = rolls.pull_multi(node_ok, offs_home) \
        if chaotic and node_ok is not None else None
    groups = rolls.pull_multi(group, offs_home) \
        if chaotic and group is not None else None
    p_ok = prng.f32(1.0 - p_loss)
    parts = {k: [] for k in ("know", "sends", "learn", "newly")}
    tot = [torch.zeros((), dtype=torch.int64, device=home) for _ in range(3)]
    for b in range(nb):
        dev = know.parts[b].device
        got = None
        ok = None
        if lossy:
            # element i*G + g of the stream for the block's global rows i,
            # a column a contact (no flat [L*G] buffer)
            u = torch.stack([prng.unit_floats(prng.threefry_bits_plain(
                key, ell, dev, start=b * ell * fanout + g, step=fanout))
                for g in range(fanout)], dim=1)
            if chaotic:
                thr = torch.full((ell, fanout), p_ok, dtype=torch.float32,
                                 device=dev)
                if node_ok is not None:
                    thr = thr * node_ok.parts[b][:, None] \
                        * _stack_views(senders, b)
                ok = u < thr
                exists = None
                if group is not None:
                    exists = _stack_views(groups, b) == group.parts[b][:, None]
                    ok = ok & exists
            else:
                ok = u < p_ok
                exists = None
            carry = _stack_views(carried, b)
            if exists is not None:  # a severed link is a partition, not loss
                carry = torch.where(exists, carry, 0)
            tot[2] = tot[2] + torch.where(ok, 0, carry).sum().to(home)
        for g, v in enumerate(views):
            vb = v.parts[b] & ok[:, g:g + 1] if ok is not None else v.parts[b]
            got = vb if got is None else got | vb
        active = slot_active.on(dev) if isinstance(slot_active, Replicated) \
            else slot_active
        kb, sb = know.parts[b], sends_left.parts[b]
        received = got & receiver_ok.parts[b][:, None] & active[None, :]
        newly = received & ~kb
        budget = torch.clamp_min(sb - fanout, 0).to(torch.int8)
        parts["know"].append(kb | newly)
        parts["sends"].append(torch.where(
            newly, retransmit_limit, torch.where(serve.parts[b], budget, sb)))
        parts["newly"].append(newly)
        if learn_tick is not None:
            parts["learn"].append(torch.where(newly, tick16,
                                              learn_tick.parts[b]))
        tot[0] = tot[0] + newly.sum().to(home)
        tot[1] = tot[1] + cells.parts[b].sum().to(home)
    delivered = tot[0].to(torch.float32)
    served = tot[1].to(torch.float32) * fanout
    lost = tot[2].to(torch.float32)
    new_ctr = None
    if ctr is not None:
        def add(c):
            incr = torch.zeros_like(c)
            incr[-3:] = torch.stack([delivered, served, lost]).to(c.device)
            return c + incr
        new_ctr = ctr.map(add) if isinstance(ctr, Replicated) else add(ctr)
    return GossipResult(
        know=Blocks(parts["know"]), sends_left=Blocks(parts["sends"]),
        newly=Blocks(parts["newly"]) if want_newly else None,
        delivered=delivered, served=served, lost=lost,
        learn_tick=Blocks(parts["learn"]) if learn_tick is not None else None,
        ctr=new_ctr)


def disseminate_blocks_kernel(offs, know: Blocks, sends_left: Blocks,
                              sender_ok: Blocks, receiver_ok: Blocks,
                              slot_active, retransmit_limit: int,
                              p_loss: float = 0.0, key=None,
                              learn_tick: Optional[Blocks] = None,
                              tick16: int = 0, ctr=None,
                              want_newly: bool = True,
                              group: Optional[Blocks] = None,
                              node_ok: Optional[Blocks] = None) -> GossipResult:
    """K2 over block tables on the card: a pack and an exchange a block
    and one combine (kernels.launch_gossip_blocks), fresh Blocks out; the
    counter vector's new copies are the combine's output on the first
    block's device and copies of it on the others."""
    s = know.shape[1]
    word = torch.int32 if s <= 32 else torch.int64
    empty = torch.empty_like
    new_know, new_sends = know.map(empty), sends_left.map(empty)
    new_learn = learn_tick.map(empty) if learn_tick is not None else None
    newly = know.map(empty) if want_newly else None
    words = [know.map(lambda k: torch.empty(k.shape[0], dtype=word,
                                            device=k.device))
             for _ in range(2)]
    home = know.device
    counters = torch.empty(3, dtype=torch.float32, device=home)
    ctr_home = _home(ctr) if ctr is not None else None
    ctr_out = torch.empty_like(ctr_home) if ctr is not None else None
    chaotic = (group is not None or node_ok is not None) and key is not None
    lossy = chaotic or (p_loss > 0.0 and key is not None)
    kernels.launch_gossip_blocks(
        know, sends_left, offs, sender_ok, receiver_ok, slot_active,
        retransmit_limit, new_know, new_sends, words[0], words[1], counters,
        key=key if lossy else None, p_ok=prng.f32(1.0 - p_loss),
        learn_tick=learn_tick, new_learn=new_learn, tick16=tick16,
        newly=newly, ctr=ctr_home, ctr_out=ctr_out,
        group=group if chaotic else None, node_ok=node_ok if chaotic else None)
    new_ctr = None
    if ctr is not None:
        new_ctr = Replicated([ctr_out] + [ctr_out.to(c.device) for c in
                                          ctr.copies[1:]]) \
            if isinstance(ctr, Replicated) else ctr_out
    return GossipResult(know=new_know, sends_left=new_sends, newly=newly,
                        delivered=counters[0], served=counters[1],
                        lost=counters[2], learn_tick=new_learn, ctr=new_ctr)


def disseminate(offs, know, sends_left, sender_ok, receiver_ok, slot_active,
                retransmit_limit: int, p_loss: float = 0.0,
                key=None, blocks: int = 1, *,
                learn_tick=None, tick16: int = 0, ctr=None,
                want_newly: bool = True, group=None,
                node_ok=None) -> GossipResult:
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
    shard-count lowering hint, changes nothing; a node-sharded pool
    (Blocks leaves) runs the sharded pass."""
    if isinstance(know, Blocks):
        fn = disseminate_blocks_kernel if know.is_cuda \
            else disseminate_blocks_plain
    else:
        fn = disseminate_kernel if know.is_cuda else disseminate_plain
    return fn(offs, know, sends_left, sender_ok, receiver_ok, slot_active,
              retransmit_limit, p_loss, key, learn_tick, tick16, ctr,
              want_newly, group, node_ok)
