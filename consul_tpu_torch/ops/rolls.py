"""Ring-shift peer exchange: out[i] = mat[(i + d) % N].

Every node exchanges with its ring neighbour at a per-tick random offset
d, so the whole exchange is a rotation of the node axis (memberlist walks
a shuffled ring for probe targets; the shift keeps that one-prober-per-
subject-per-round structure).  The offsets are drawn on the device
(`offsets`: one K1 launch) and stay there: views are built by index arithmetic on the
device-side offset, `(arange(N) + d) % N`, because `torch.roll` needs a
host integer and reading one back would sync the device every tick.

`blocks` is the node-axis shard count (`SimConfig.shard_blocks`): the
JAX package's lowering hint, the same permutation for any value.  On a
tensor every `blocks` gives the one-device views.  On a node-sharded
leaf (`parallel/mesh.Blocks`, B blocks of L rows) `pull_multi` rotates
block by block as the JAX package lowers a sharded rotation
(consul_tpu/ops/rolls.py:53-74): d = s*L + r with d on the device,
log2(B) static block rotations selected by the bits of s, then each
block paired with its successor and cut at r.  No host read of d, and
each view moves O(L log B) rows a device, never a buffer of N rows.
"""

from __future__ import annotations

import torch

from consul_tpu_torch.parallel.mesh import Blocks
from consul_tpu_torch.utils import prng


def offsets_draw(key, n: int, k: int) -> prng.Draw:
    """The draw of `offsets`, for a caller that makes it beside others."""
    return prng.Draw("randint", key, (k,), 1, n)


def offsets(key, n: int, k: int, device) -> torch.Tensor:
    """k nonzero ring offsets shared by all nodes this tick ([k] int32)."""
    return prng.draw([offsets_draw(key, n, k)], device)[0]


def _rows(n: int, d, device) -> torch.Tensor:
    d = torch.as_tensor(d, dtype=torch.int64, device=device)
    return (torch.arange(n, dtype=torch.int64, device=device) + d % n) % n


def _blocks_view(mat: Blocks, d) -> Blocks:
    """out[i] = mat[(i + d) % N] over blocks: block a of the result is
    rows [aL + r, aL + r + L) of the rotation by s blocks."""
    nb, ell = mat.n_blocks, mat.rows
    n = nb * ell
    home = mat.device
    d = torch.as_tensor(d, dtype=torch.int64, device=home) % n
    s, r = d // ell, d % ell
    rot = list(mat.parts)
    step = 1
    while step < nb:
        take = (s // step) % 2 == 1
        rot = [torch.where(take.to(p.device),
                           rot[(a + step) % nb].to(p.device), p)
               for a, p in enumerate(rot)]
        step *= 2
    out = []
    for a, p in enumerate(rot):
        nxt = rot[(a + 1) % nb].to(p.device)
        at = torch.arange(ell, dtype=torch.int64, device=p.device) \
            + r.to(p.device)
        wrap = at >= ell
        here = p.index_select(0, torch.where(wrap, 0, at))
        there = nxt.index_select(0, torch.where(wrap, at - ell, 0))
        wrap = wrap.reshape((ell,) + (1,) * (p.dim() - 1))
        out.append(torch.where(wrap, there, here))
    return Blocks(out)


def pull_multi(mat, offs, blocks: int = 1) -> list:
    """k ring views: out[g][i] = mat[(i + offs[g]) % N].  A tensor gives
    tensors (for any `blocks`: one device holds every block); a Blocks
    leaf gives Blocks, rotated block by block."""
    if isinstance(mat, Blocks):
        return [_blocks_view(mat, offs[g]) for g in range(len(offs))]
    n = mat.shape[0]
    return [mat.index_select(0, _rows(n, offs[g], mat.device))
            for g in range(len(offs))]


def pull(mat, d, blocks: int = 1):
    """Row view from each node's ring peer: out[i] = mat[(i + d) % N]."""
    return pull_multi(mat, [d], blocks=blocks)[0]


def push(mat, d, blocks: int = 1):
    """Inverse view: out[j] = mat[(j - d) % N] — what node j receives when
    every node i sends to (i + d) % N."""
    n = mat.shape[0]
    d = torch.as_tensor(d, dtype=torch.int64, device=mat.device) % n
    return pull(mat, n - d, blocks=blocks)
