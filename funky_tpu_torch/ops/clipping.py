"""Near-plane triangle clipping with a static number of extra slots
(port of funky_tpu/ops/clipping.py::expand_near_clipped).

Triangles crossing clip w = w_eps become up to two sub-triangles whose
corners are barycentric combinations of the original corners; they are
appended after the T originals (ids >= T), K = min(capacity, T) slots
each for the "A" and "B" halves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling
from .compact import compact_indices


class ClippedGeometry(NamedTuple):
    tri_clip: torch.Tensor   # (T + 2K, 3, 4)
    blocks: torch.Tensor     # (T + 2K, 3, B), inv_w in the last slot
    tri_flags: torch.Tensor  # (T + 2K,) int32
    valid: torch.Tensor      # (T + 2K,) bool
    overflow: torch.Tensor   # () bool


def near_crossing(tri_clip: torch.Tensor, num_triangles: int | None,
                  w_eps: float = 1e-2):
    """(inside (T, 3), real (T,), crossing (T,)): the corners in front of
    w = w_eps, the triangles below num_triangles, and the real ones with
    one or two corners in front, which expand_near_clipped splits."""
    t = tri_clip.shape[0]
    dev = tri_clip.device
    w = tri_clip[..., 3]
    inside = w > w_eps
    n_in = inside.sum(dim=-1)
    real = (torch.arange(t, device=dev) < num_triangles
            if num_triangles is not None
            else torch.ones((t,), dtype=torch.bool, device=dev))
    return inside, real, (n_in > 0) & (n_in < 3) & real


def expand_near_clipped(tri_clip: torch.Tensor, blocks: torch.Tensor,
                        tri_flags: torch.Tensor,
                        num_triangles: int | None,
                        capacity: int = 64,
                        w_eps: float = 1e-2,
                        drops: str | None = None) -> ClippedGeometry:
    """clipping.py:51-146. `drops` names the counter (utils/profiling.
    DROP_COUNTERS) that the crossing triangles past the K slots are added
    to on the device."""
    dev = tri_clip.device
    t = tri_clip.shape[0]
    k = min(capacity, t)
    inside, real, crossing = near_crossing(tri_clip, num_triangles, w_eps)

    comp = compact_indices(crossing, k)
    if drops is not None:
        profiling.count_drops(drops, torch.clamp(comp.count - k, min=0))
    safe = comp.idx.clamp(min=0).long()
    c = tri_clip[safe]
    b = blocks[safe]
    f = tri_flags[safe]
    ins = inside[safe]
    cnt = ins.sum(dim=-1)

    # jnp.argmax on bool: torch's argmax takes no bool, so cast first.
    # Both return the first maximal index.
    idx_in = torch.argmax(ins.to(torch.uint8), dim=-1).to(torch.int32)
    idx_out = torch.argmax((~ins).to(torch.uint8), dim=-1).to(torch.int32)
    r = torch.where(cnt == 1, idx_in, (idx_out + 1) % 3)
    perm = (r[:, None] + torch.arange(3, dtype=torch.int32,
                                      device=dev)[None, :]) % 3
    perm = perm.long()[..., None]
    cr = torch.gather(c, 1, perm.expand(-1, -1, c.shape[-1]))
    br = torch.gather(b, 1, perm.expand(-1, -1, b.shape[-1]))
    wr = cr[..., 3]

    def isect(wa, wb):
        d = wb - wa
        tt = (w_eps - wa) / torch.where(torch.abs(d) > 1e-30, d, 1e-30)
        return tt.clamp(0.0, 1.0)[:, None]

    e = torch.eye(3, dtype=torch.float32, device=dev)
    t01 = isect(wr[:, 0], wr[:, 1])
    t02 = isect(wr[:, 0], wr[:, 2])
    t12 = isect(wr[:, 1], wr[:, 2])

    is1 = (cnt == 1)[:, None]
    q0 = e[0].expand(t01.shape[0], 3)
    q1 = torch.where(is1, e[0] * (1.0 - t01) + e[1] * t01, e[1])
    q2 = torch.where(is1, e[0] * (1.0 - t02) + e[2] * t02,
                     e[1] * (1.0 - t12) + e[2] * t12)
    q3 = e[0] * (1.0 - t02) + e[2] * t02
    quad = torch.stack([q0, q1, q2, q3], dim=1)

    quad_clip = torch.einsum("kqj,kjc->kqc", quad, cr)
    attr = torch.einsum("kqj,kjc->kqc", quad, br[..., :-1])
    inv_w = 1.0 / torch.clamp(quad_clip[..., 3], min=1e-12)
    quad_blocks = torch.cat([attr, inv_w[..., None]], dim=-1)

    def corners_a(q):                  # quad corners (0, 1, 2)
        return q[:, 0:3]

    def corners_b(q):                  # quad corners (0, 2, 3), by slices:
        return torch.cat([q[:, 0:1], q[:, 2:4]], dim=1)  # no host index

    valid_a = comp.slot_valid
    valid_b = comp.slot_valid & (cnt == 2)
    valid_orig = real & torch.all(inside, dim=-1)

    return ClippedGeometry(
        tri_clip=torch.cat([tri_clip, corners_a(quad_clip),
                            corners_b(quad_clip)], dim=0),
        blocks=torch.cat([blocks, corners_a(quad_blocks),
                          corners_b(quad_blocks)], dim=0),
        tri_flags=torch.cat([tri_flags, f, f], dim=0),
        valid=torch.cat([valid_orig, valid_a, valid_b], dim=0),
        overflow=comp.count > k,
    )
