"""The per-layer readers and the trace reduction on synthetic inputs: the
stage charging rule, busy and idle time, K10's byte count from shapes."""

import pytest
import torch

from bench_tiny import ROOT


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_stage_charging_by_launch_inside_ranges():
    """A kernel is charged to every stage range open when it was launched,
    whenever it ran; a launch outside any range to none."""
    from harness import trace

    evs = [
        _ev("user_annotation", "stage: frame.outer", 0, 100),
        _ev("user_annotation", "stage: passes.shadow.inner", 10, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=3),
        _ev("kernel", "k1", 500, 1000, corr=1),
        _ev("kernel", "k2", 1600, 250, corr=2),
        _ev("gpu_memcpy", "copy", 1900, 50, corr=3),
    ]
    ran, charges = trace.stage_charges(evs)
    assert ran == {"frame.outer", "passes.shadow.inner"}
    assert trace.stages_ms(ran, charges, ["frame.outer"]) == \
        pytest.approx(1.25)
    assert trace.stages_ms(ran, charges, ["passes.shadow.inner"]) == \
        pytest.approx(1.0)
    assert trace.stages_ms(ran, charges, ["passes.taa.x"]) is None


def test_nested_stages_of_one_reader_count_once():
    """deferred.interpolate calls interpolate_at through its module
    global, so with both wrapped their ranges nest: a reader that lists
    both, or that lists a stage and one nested in it, still counts each
    kernel once."""
    from harness import trace
    from metrics._stages import stage_sum

    evs = [
        _ev("user_annotation", "stage: passes.deferred.interpolate", 0, 100),
        _ev("user_annotation", "stage: passes.deferred.interpolate_at",
            10, 50),
        _ev("user_annotation", "stage: passes.taa.apply_shadow_taa", 200,
            50),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 1, corr=3),
        _ev("kernel", "setup", 300, 100, corr=1),
        _ev("kernel", "interp", 400, 1000, corr=2),
        _ev("kernel", "taa", 1500, 500, corr=3),
    ]
    ctx = {"stages": trace.stage_charges(evs)}
    both = (("passes.deferred", "interpolate"),
            ("passes.deferred", "interpolate_at"),
            ("passes.taa", "apply_shadow_taa"))
    assert stage_sum(ctx, both) == pytest.approx(1.6)
    assert stage_sum(ctx, both[:1]) == pytest.approx(1.1)
    assert stage_sum(ctx, both[1:2]) == pytest.approx(1.0)


def test_a_missing_stage_function_raises():
    """A stage a reader lists that the program no longer has fails the
    run, so a renamed stage cannot read as nothing."""
    from harness import trace

    with pytest.raises(AttributeError, match="no_such_stage"):
        with trace.wrapped([("passes.deferred", "no_such_stage")]):
            pass


def test_every_listed_stage_exists():
    """Each stage function the readers list is in funky_tpu_torch."""
    import importlib

    from harness import manifest

    m = manifest.load(ROOT)
    listed = [s for p in m["per_layer"]
              for s in getattr(manifest.reader(p["name"]), "STAGES", ())]
    assert listed
    for module, attr in listed:
        mod = importlib.import_module(f"funky_tpu_torch.{module}")
        assert callable(getattr(mod, attr)), (module, attr)


def test_busy_span_idle_and_top_ops():
    from harness import trace

    evs = [_ev("kernel", "a", 0, 10), _ev("kernel", "b", 5, 10),
           _ev("gpu_memset", "m", 30, 10), _ev("kernel", "a", 50, 50),
           _ev("cuda_runtime", "cudaEventSynchronize", 14, 40)]
    ops = trace.device_ops(evs)
    busy, span = trace.busy_and_span(ops)
    assert busy == pytest.approx(75e-6) and span == pytest.approx(100e-6)
    assert trace.top_ops(ops)[0] == ["a", pytest.approx(60e-6)]
    gaps = dict(trace.idle_gaps(ops, evs))
    assert sum(gaps.values()) == pytest.approx(25e-6)
    assert gaps["host cudaEventSynchronize / before m"] == \
        pytest.approx(15e-6)


def test_replay_readers():
    from harness import manifest

    ops = [("class_maps_kernel(Params)", 0.0, 100.0, "kernel"),
           ("other", 150.0, 50.0, "kernel"),
           ("class_maps_kernel(Params)", 300.0, 100.0, "kernel"),
           ("copy", 400.0, 100.0, "gpu_memcpy")]

    class Cfg:
        shadow_map_size = 2048
        class_coarse = 16

    ctx = {"replay_ops": ops, "replays": 2, "cfg": Cfg()}
    assert manifest.reader("graph_kernels").read(ctx) == 1.5
    assert manifest.reader("device_idle_pct").read(ctx) == \
        pytest.approx(100.0 * 150 / 500)
    assert manifest.reader("replay_busy_ms").read(ctx) == \
        pytest.approx(1e3 * 350e-6 / 2)
    roof = manifest.reader("class_maps_roofline")
    want = 100.0 * (4 * 2048 * 2048 * 4 + 4 * 128 * 128 * 32 + 64) \
        / 3.35e12 / 100e-6
    assert roof.read(ctx) == pytest.approx(want)
    none = {"replay_ops": None, "replays": 5, "cfg": Cfg(), "stages": None}
    for name in ("graph_kernels", "device_idle_pct", "replay_busy_ms",
                 "class_maps_roofline", "contact_ms", "back_half_ms"):
        assert manifest.reader(name).read(none) is None


def test_k10_bytes_from_shapes():
    """The class maps' bytes, worked out from the configuration, are what
    chip_smoke.py::stage_work counts on the kernel's own arguments: the
    maps read once, the cell rows written once, the planes read."""
    from harness import manifest
    from funky_tpu_torch.passes import shadow_classify

    roof = manifest.reader("class_maps_roofline")
    for s, coarse in ((2048, 16), (1024, 16), (512, 8)):
        maps = torch.zeros((4, s, s))
        rows = shadow_classify._class_rows_plain(
            maps, coarse, 4.0, torch.zeros((4, 3)), torch.zeros(4)) \
            if s <= 512 else None
        cells = 4 * (s // coarse) ** 2
        if rows is not None:
            assert rows.shape == (cells, 8) and rows.dtype == torch.float32
        assert roof.class_map_bytes(s, coarse) == \
            maps.numel() * 4 + cells * 8 * 4 + 4 * 16


def test_k5_bytes_from_shapes():
    """The light maps' bytes, worked out from the tuned configuration, are
    what chip_smoke.py::light_map_work counts: each haloed window read
    once, the packed parameters (ops/lightmap_cuda.py::param_sizes) and
    the rows written; 0.0065 ms at the shipped window sizes."""
    from harness import manifest
    from funky_tpu_torch.ops import lightmap_cuda
    from funky_tpu_torch.passes import shadow_lightspace

    roof = manifest.reader("light_maps_roofline")
    for pcss, rungs in ((True, 6), (True, 2), (False, 6)):
        assert roof.param_words(pcss, rungs) == sum(
            lightmap_cuda.param_sizes(pcss, rungs, shadow_lightspace.PHASES))
    assert roof.halo_texels(4.0) == shadow_lightspace.halo_texels(4.0)
    sizes = (768, 512, 384, 256)
    want = sum(4 * (wc + 36) ** 2 + 4 * roof.param_words(True, 6)
               + 16 * wc * wc for wc in sizes)
    got = roof.light_map_bytes(sizes, 2048, 4.0, True, 6)
    assert got == want
    assert got / 3.35e12 == pytest.approx(6.537e-6, rel=1e-3)
    # a window is never wider than the map; a cascade without one reads
    # nothing
    assert roof.light_map_bytes((512, 0), 256, 4.0, True, 6) == \
        4 * 292 ** 2 + 4 * roof.param_words(True, 6) + 16 * 256 ** 2

    class Flags:
        use_pcss = True

    class Cfg:
        shadow_map_size = 2048
        light_window_sizes = sizes
        max_softness = 4.0
        light_pcf_rungs = 6
        flags = Flags()

    ops = [("void light_map_kernel(float const*)", 0.0, 30.0, "kernel"),
           ("other", 40.0, 50.0, "kernel"),
           ("void light_map_kernel(float const*)", 100.0, 35.0, "kernel")]
    ctx = {"replay_ops": ops, "replays": 1, "cfg": Cfg()}
    assert roof.read(ctx) == pytest.approx(100.0 * got / 3.35e12 / 65e-6)
    Cfg.light_window_sizes = None
    assert roof.read(ctx) is None
    assert roof.read({"replay_ops": ops[1:2], "replays": 1,
                      "cfg": Cfg()}) is None


def test_stage_readers_sum_their_stages():
    from harness import manifest

    ms = {"passes.shadow.synthesize_shadow_maps": 2.0,
          "frame.quad_pack": 1.5, "passes.deferred.interpolate": 1.0,
          "passes.taa.apply_shadow_taa": 0.5,
          "passes.shading.shade_gltf": 0.25}
    ctx = {"stages": (set(ms), [(v, frozenset([k])) for k, v in ms.items()])}
    assert manifest.reader("cascade_maps_ms").read(ctx) == 3.5
    assert manifest.reader("back_half_ms").read(ctx) == 1.75
    assert manifest.reader("contact_ms").read(ctx) is None
    assert manifest.reader("autotune_s").read({"autotune_s": 3.0}) == 3.0
