"""The output check: what the window's frames produced, against the plain
reference that the cell's configuration names (reference/render.py unless
it names another) on the same scene and poses.

A frame is judged on what it hands on: its RGBA, and the state the next
frame reads, the shadow history and the depth (`prev_depth`). The
reference follows the program one frame at a time: for each frame checked
it starts from the state the program carried into that frame, and the
first frame of the window it renders from its own initial state. So each
check covers one whole frame, and the first one covers the start.

Each number is the share of a frame's pixels on which the program and the
reference differ by more than a per-element tolerance, the worst over the
frames checked. The tolerances are those of the port's own frame tests
(tests/test_torch_frame.py: colour and shadow within 3/255, depth within
4e-5): a raster edge or a shadow-map compare that rounds the other way
moves a few pixels by more; a wrong or missing stage moves many.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

COLOR_TOL = 3.0 / 255.0
DEPTH_TOL = 4e-5
NUMBERS = ("rgba_bad_share", "history_bad_share", "depth_bad_share")


class Kept(NamedTuple):
    """One checked frame of the program: its pose's position in the arc,
    the state it started from (None: the initial state), its RGBA and the
    state it handed on."""
    frame: int
    pose: int
    pre: tuple | None
    rgba: torch.Tensor
    history: torch.Tensor
    depth: torch.Tensor


def numbers(rgba, history, depth, ref_rgba, ref_history,
            ref_depth) -> Dict[str, float]:
    d = (rgba - ref_rgba).abs().amax(dim=-1)
    dh = (history - ref_history).abs()
    dd = (depth - ref_depth).abs()
    # NaN differences count as bad: a comparison with NaN is false
    return {
        "rgba_bad_share": float((~(d <= COLOR_TOL)).float().mean()),
        "history_bad_share": float((~((dh[..., 0] <= COLOR_TOL)
                                      & (dh[..., 1] <= DEPTH_TOL)))
                                   .float().mean()),
        "depth_bad_share": float((~(dd <= DEPTH_TOL)).float().mean()),
    }


def check(kept: List[Kept], ref_scene, ref_poses, opt, device,
          rr) -> tuple:
    """(worst of each number over the kept frames, [per-frame numbers]),
    against the reference module `rr`."""
    worst = {k: 0.0 for k in NUMBERS}
    per = []
    with torch.no_grad():
        for k in kept:
            state = (rr.init_state(opt, device) if k.pre is None
                     else rr.State(*k.pre))
            rgba, nxt = rr.render(ref_scene, ref_poses[k.pose], state, opt)
            got = numbers(k.rgba, k.history, k.depth, rgba,
                          nxt.shadow_history, nxt.prev_depth)
            per.append(got)
            for name, v in got.items():
                worst[name] = max(worst[name], v)
            del rgba, nxt, state
    return worst, per


def ref_pose(pose, device, rr):
    """The reference module `rr`'s Pose of a traffic pose."""
    return rr.Pose(*(torch.as_tensor(getattr(pose, f), dtype=torch.float32)
                     .to(device) for f in rr.Pose._fields))


def bfloat16_store(x: torch.Tensor) -> torch.Tensor:
    """The control's buffers: each rounded to bfloat16 where a stage hands
    it on."""
    return x.to(torch.bfloat16).to(torch.float32)
