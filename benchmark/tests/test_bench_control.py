"""The output check's control and its faults, at a size the CPU holds: the
reference with its buffers in bfloat16 in the program's place, and runs
whose timed path is broken underneath, each come out as not correct, in
the shipped cell and in the light-space one."""

import pytest
import torch

from bench_tiny import SEED, SIZE, tiny_cell, tiny_run


LIGHT = "lightspace-multimesh-orbit"


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


def test_light_space_control_in_bfloat16_is_not_correct():
    """The light-space reference, its buffers in bfloat16, against itself
    in float32 under the light-space cell's limits."""
    import control

    cell = tiny_cell(LIGHT, poses=6)
    assert cell.reference.__name__ == "reference.lightspace"
    for seed in (SEED, 12345, 2**33 + 1):
        got = control.control_run(cell, seed, 8, "cpu", SIZE)
        assert not got["correct"], got


def _zeroed_light_maps(monkeypatch):
    """Every light map the frame builds reads 0: the ground penumbrae that
    fetch from them go black."""
    from funky_tpu_torch.passes import shadow_lightspace

    build = shadow_lightspace.build_light_shadow_map
    monkeypatch.setattr(shadow_lightspace, "build_light_shadow_map",
                        lambda *a, **k: torch.zeros_like(build(*a, **k)))


def _light_map_reads(monkeypatch) -> list:
    """The number of pixels that each light-map fetch of the frame reads,
    appended as the frame runs."""
    from funky_tpu_torch.passes import shadow_filter

    reads = []
    fetch = shadow_filter._fetch_rows

    def counted(rows, origin, wc, uv, s):
        reads.append(uv.shape[0])
        return fetch(rows, origin, wc, uv, s)

    monkeypatch.setattr(shadow_filter, "_fetch_rows", counted)
    return reads


def test_the_sound_light_space_frame_is_correct(monkeypatch):
    """At the size of the faults below the unbroken light-space cell is
    correct and its ground pixels read the light maps, so what fails
    there is the fault."""
    reads = _light_map_reads(monkeypatch)
    out = tiny_run(tiny_cell(LIGHT), seconds=1.0)["result"]
    assert out["correct"] and out["failed"] == 0, out
    assert sum(reads) > 0, "no pixel read a light map"


@pytest.mark.parametrize("fault", [_zeroed_light_maps, _state_unchanged,
                                   _half_left_out, _answer_altered])
def test_a_broken_light_space_frame_is_not_correct(fault, monkeypatch):
    reads = _light_map_reads(monkeypatch)
    if fault is _zeroed_light_maps:
        fault(monkeypatch)
        frame_fn = None
    else:
        frame_fn = fault
    out = tiny_run(tiny_cell(LIGHT), seconds=1.0,
                   frame_fn=frame_fn)["result"]
    assert not out["correct"] and out["failed"] > 0
    assert sum(reads) > 0, "no pixel read a light map"
