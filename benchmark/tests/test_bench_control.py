"""The output check's control and its faults, at a size the CPU holds: the
reference with its buffers in bfloat16 in the program's place, and runs
whose timed path is broken underneath, each come out as not correct."""

import pytest
import torch

from bench_tiny import SEED, SIZE, tiny_cell, tiny_run


def test_control_in_bfloat16_is_not_correct():
    import control

    cell = tiny_cell(poses=6)
    for seed in (SEED, 12345, 2**33 + 1):
        got = control.control_run(cell, seed, 8, "cpu", SIZE)
        assert not got["correct"], got
        assert got["frames_checked"][0] == 0 and len(
            got["frames_checked"]) >= 3


def _state_unchanged(fn):
    """The frame renders, but hands back the state it was given."""
    def frame(scene, params, state):
        rgba, _ = fn(scene, params, state)
        return rgba, state
    return frame


def _half_left_out(fn):
    """The lower half of each frame is never shaded: the clear colour, and
    the history it was given."""
    def frame(scene, params, state):
        old = state.shadow_history.clone()
        rgba, new = fn(scene, params, state)
        h = rgba.shape[0] // 2
        rgba = rgba.clone()
        rgba[h:] = torch.tensor([0.53, 0.81, 0.92, 1.0])
        new.shadow_history[h:] = old[h:]
        return rgba, new
    return frame


def _answer_altered(fn):
    """Each frame's colour is altered where it is produced, on a block of
    16 x 16 pixels."""
    def frame(scene, params, state):
        rgba, new = fn(scene, params, state)
        rgba = rgba.clone()
        rgba[40:56, 60:76, :3] += 0.25
        return rgba, new
    return frame


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
def test_a_broken_frame_is_not_correct(fault):
    out = tiny_run(seconds=1.0, frame_fn=fault)["result"]
    assert not out["correct"] and out["failed"] > 0
