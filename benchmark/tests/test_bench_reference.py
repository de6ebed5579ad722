"""The plain references and the scenes, found by name: the multimesh scene
and the reference's options as they were before they moved into files of
their own, and the light-space reference against the program's own
light-space frame on the CPU."""

import dataclasses
import hashlib
import json
import pathlib
import tempfile

import pytest
import torch

from bench_tiny import BENCH, ROOT

# sha256 of the multimesh GLB and of the reference's packed tables as
# harness/scene.py and reference/scene.py made them before the scenes
# moved to scenes/<name>.py
GLB_SHA = "7f866e3022a3c4174c2dbbd44f1645203fdd08511ae0e34f4b2bcd227cf5534b"
TABLES_SHA = {
    "multimesh":
        "a3809a69909ab7232954051f70999f40290a3ba68be67315667d01f0c954f37b",
    "none": "aefe06b9aef5413a918e56c25c334beb963d7fb0e5d1c1893e7c92f83143ffa3",
}
TABLES = ("positions", "normals", "uvs", "colors", "vert_object",
          "tri_indices", "tri_flags", "texture", "texture_sizes")


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_multimesh_glb_is_byte_identical(tmp_path):
    from harness import scene as scenes

    glb = scenes.write_glb(scenes.build("multimesh"), tmp_path / "s.glb")
    assert hashlib.sha256(glb.read_bytes()).hexdigest() == GLB_SHA


@pytest.mark.parametrize("name", sorted(TABLES_SHA))
def test_packed_reference_tables_are_identical(name):
    from harness import scene as scenes
    from reference import scene as rs

    packed = rs.pack(scenes.build(name), "cpu")
    h = hashlib.sha256()
    for f in TABLES:
        t = getattr(packed, f)
        h.update(f.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    h.update(str(packed.num_triangles).encode())
    assert h.hexdigest() == TABLES_SHA[name]


def test_render_options_of_the_shipped_configuration():
    """render.options builds the Options the harness built before from the
    three flags it read, and refuses a configuration whose flags it does
    not follow."""
    from harness import manifest

    rr = manifest.load_module("reference", "render")
    cfg = _config("shipped")
    assert rr.options(cfg, cfg["frame"]) == rr.Options(
        1920, 1080, 2048, use_pcss=True, use_shadow_taa=True,
        enable_contact_shadows=True)
    with pytest.raises(ValueError):
        rr.options(_config("lightspace"), cfg["frame"])


def test_each_cell_names_a_reference_that_follows_it():
    from harness import manifest

    m = manifest.load(ROOT)
    for w in m["workloads"]:
        cell = manifest.cell(m, w["name"], ROOT)
        opt = cell.reference.options(cell.config, cell.config["frame"])
        assert (opt.width, opt.height) == (1920, 1080)
    ls = manifest.cell(m, "lightspace-multimesh-orbit", ROOT).reference
    assert ls.__name__ == "reference.lightspace"


# A size at which the light maps are read: at 512^2 maps the cubes'
# ground penumbrae span enough texels to need taps. The capacities hold
# every pair, and the light maps' windows cover the whole map: at maps
# this coarse the per-pixel filter, which the program runs outside its
# windows, finds the ground's own depth in its taps (reference/
# lightspace.py).
W, H, S = 192, 128, 512


def test_light_space_reference_matches_the_programs_frame(monkeypatch):
    """lightspace.render against the port's eager light-space frame with
    the back-face skip, on multimesh, two frames chained (the second from
    the state the program handed on): within the cell's limits, with the
    light maps read."""
    from funky_tpu_torch import frame
    from funky_tpu_torch.passes import shadow_filter
    from harness import compare, manifest, program, traffic
    from harness import scene as scenes
    from reference import scene as rs

    cell = manifest.cell(manifest.load(ROOT), "lightspace-multimesh-orbit",
                         ROOT)
    ls = cell.reference
    size = {"width": W, "height": H, "shadow_map_size": S}
    cfg = dataclasses.replace(program.config(cell.config, size),
                              shadow_pen_capacity=2 * W * H,
                              light_window_sizes=(S,) * 4)
    cfg = dataclasses.replace(cfg, flags=dataclasses.replace(
        cfg.flags, committed=False))
    fetched = []
    fetch = shadow_filter._fetch_rows

    def counted(rows, origin, wc, uv, s):
        fetched.append(uv.shape[0])
        return fetch(rows, origin, wc, uv, s)

    monkeypatch.setattr(shadow_filter, "_fetch_rows", counted)
    spec = scenes.build("multimesh")
    tr = cell.traffic
    base = traffic.base_pose(tr, float(spec.bounds_min[1]))
    with tempfile.TemporaryDirectory() as td:
        scene = program.load_scene(spec, pathlib.Path(td) / "s.glb", "cpu")
    opt = ls.options(cell.config, size)
    ref_scene = rs.pack(spec, "cpu")
    state = program.init_state(cfg, "cpu")
    for i, at in enumerate((0, 7)):
        pose = traffic.orbit_pose(base, tr, at)
        pre = ls.init_state(opt, "cpu") if i == 0 else ls.State(
            *(t.clone() for t in state))
        fetched.clear()
        rgba, state = frame.render_gltf_frame(
            scene, program.params(pose, "cpu"), state, cfg)
        assert fetched, "the program read no light map"
        with torch.no_grad():
            ref, nxt = ls.render(ref_scene, compare.ref_pose(pose, "cpu", ls),
                                 pre, opt)
        got = compare.numbers(rgba, state.shadow_history, state.prev_depth,
                              ref, nxt.shadow_history, nxt.prev_depth)
        assert all(got[k] <= cell.limits[k] for k in got), (i, got)
