"""The contact kernels K8 and K9 (funky_tpu_torch/csrc/contact.cu through
ops/contact_cuda.py: contact_front, contact_certify,
contact_certify_compact, contact_march) against their plain twins
(passes/contact.py::_contact_front_plain, _contact_certify_plain,
_contact_certify_compact_plain, _contact_march_plain), on the card. The
inputs are a default frame's own (GltfConfig() at 256x144 on the
multimesh scene, two chained frames, every dispatcher call recorded),
cut and re-indexed for the cases no frame reaches, for the front re-laid
in memory (LAYOUTS), and for the march also seeded rays drawn from the
frame's payload (tests/torch_scenes.py::contact_rays) at each layout of
chip_smoke.MARCH_LAYOUTS (contact_cuda.LANES_LIVE_MAX patched). Every
test here needs an NVIDIA GPU and skips without one. The module imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_contact_cuda.py

Tolerance: none; masks, payloads, certificates and terms are compared
bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from funky_tpu_torch import frame as tf
from funky_tpu_torch.ops import contact_cuda
from funky_tpu_torch.ops.compact import Compacted
from funky_tpu_torch.passes import contact as tcontact
from tests.torch_scenes import contact_rays

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def calls():
    """{dispatcher: [(args, kwargs)]} of two chained default frames on the
    card (parked, then orbit pose 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    dev = torch.device("cuda:0")
    chip_smoke._GPU = chip_smoke.gpu_line()
    gltf, scene = chip_smoke.load_scene(dev, large=False)
    params = chip_smoke.scene_params(gltf, dev)
    cfg = dataclasses.replace(chip_smoke.default_config(), width=256,
                              height=144)
    out = {name: [] for name in ("contact_front", "contact_certify_compact",
                                 "contact_march")}
    saved = {name: getattr(tcontact, name) for name in out}

    def recorder(name):
        def record(*args, **kwargs):
            out[name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        return record

    for name in out:
        setattr(tcontact, name, recorder(name))
    try:
        state = tf.init_frame_state(cfg, dev)
        for pose in (params, tf.orbit_params(params, 1)):
            _, state = tf.render_gltf_frame(scene, pose, state, cfg)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(tcontact, name, fn)
    assert all(len(v) == 2 for v in out.values())
    return out


def same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def front_both(*args, **kwargs):
    before = contact_cuda.FRONT_LAUNCHES
    got = tcontact.contact_front(*args, **kwargs)
    assert contact_cuda.FRONT_LAUNCHES - before == 1
    want = tcontact._contact_front_plain(*args, **kwargs)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("mode", ["frame", "dense", "no_valid", "slab_int",
                                  "slab_tensor"])
def test_front_equal_to_plain(calls, mode):
    """K8 == the twin bit for bit on the frames' own calls (valid blocks,
    frag, the pyramid), without the pyramid (the dense path), without
    `valid`, and on a row slab of the frame with its jitter from y0 (an
    int and an int32 tensor)."""
    for args, kwargs in calls["contact_front"]:
        a = dict(zip(("world", "normal", "uni", "depth_shape", "valid", "y0",
                      "frag", "pyr"), args), **kwargs)
        if mode == "dense":
            a.update(pyr=None, valid=None)
        elif mode == "no_valid":
            a.update(valid=None)
        elif mode.startswith("slab"):
            n = a["world"].reshape(-1, 3).shape[0] // 256 * 256
            world = a["world"].reshape(-1, 3)[:n].reshape(-1, 256, 3)
            normal = a["normal"].reshape(-1, 3)[:n].reshape(-1, 256, 3)
            y0 = 17 if mode == "slab_int" else torch.tensor(
                17, dtype=torch.int32, device=world.device)
            a.update(world=world, normal=normal, valid=None, frag=None,
                     y0=y0)
        got, want = front_both(**a)
        for g, w in zip(got, want):
            assert same(g, w)


def test_facing_sum_order(calls):
    """n.l near 0 with three nonzero products (the cases where the order
    of torch's sum decides its sign): the kernel's cand == the twin's."""
    args, kwargs = calls["contact_front"][0]
    uni = args[2]
    dev = uni.light_dir.device
    l = uni.light_dir.double().cpu().numpy()
    rng = np.random.default_rng(0)
    n = 1 << 16
    a = rng.normal(size=(n, 3))
    a -= (a @ l)[:, None] * l[None]          # perpendicular to the light
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    a += l[None] * rng.normal(0.0, 1e-7, (n, 1))
    normal = torch.from_numpy(a.astype(np.float32)).to(dev)
    world = torch.zeros((n, 3), device=dev)
    frag = torch.zeros((n, 2), device=dev)
    got, want = front_both(world, normal, uni, (144, 256), frag=frag)
    assert same(got[0], want[0])


def test_jitter_remainder(calls):
    """The IGN jitter's torch.remainder over pixel centres of a 4K frame
    and far-off and negative ones, at frame indices 0, 1 and 1000: the
    payload's jitter column == the twin's bit for bit."""
    args, _ = calls["contact_front"][0]
    uni = args[2]
    dev = uni.light_dir.device
    rng = np.random.default_rng(1)
    n = 1 << 16
    frag = np.concatenate([rng.uniform(0, 4096, (n // 2, 2)),
                           rng.uniform(-1e5, 1e5, (n // 2, 2))])
    frag = torch.from_numpy(frag.astype(np.float32)).to(dev)
    world = torch.zeros((n, 3), device=dev)
    normal = torch.zeros((n, 3), device=dev)
    for frame in (0.0, 1.0, 1000.0):
        flags = uni.debug_flags.clone()
        flags[3] = frame
        u = uni._replace(debug_flags=flags)
        got, want = front_both(world, normal, u, (144, 256), frag=frag)
        assert same(got[2][:, 6], want[2][:, 6])


# How a front call's world, normal and frag rows may lie in memory: the
# deferred pass's 11-float attribute rows (world, then normal), the same
# rows 4 bytes off a 16-byte boundary, contiguous (n, 3) rows at and off
# the boundary, the normal before the world in its rows, and rows of 20
# floats.
LAYOUTS = ("rows11", "unaligned_rows11", "contiguous",
           "unaligned_contiguous", "normal_first", "wide_stride")


def _laid_out(world, normal, frag, layout):
    """world, normal (n, 3) and frag (n, 2) or None copied into `layout`
    (views of random-filled buffers)."""
    n, dev = world.shape[0], world.device
    gen = torch.Generator(device=dev).manual_seed(3)

    def rows(width, offset):
        return torch.rand((n * width + offset,), generator=gen,
                          device=dev)[offset:].view(n, width)

    def place(width, offset, parts):
        buf = rows(width, offset)
        for at, t in parts:
            buf[:, at:at + t.shape[1]] = t
        return [buf[:, at:at + t.shape[1]] for at, t in parts]

    if layout == "contiguous":
        w, nn = world.contiguous(), normal.contiguous()
    elif layout == "unaligned_contiguous":
        (w,), (nn,) = place(3, 1, [(0, world)]), place(3, 2, [(0, normal)])
    else:
        width, offset, w_at, n_at = {
            "rows11": (11, 0, 0, 3), "unaligned_rows11": (11, 1, 0, 3),
            "normal_first": (11, 0, 3, 0), "wide_stride": (20, 0, 5, 12)}[
                layout]
        w, nn = place(width, offset, [(w_at, world), (n_at, normal)])
    if frag is not None and layout != "contiguous":
        width = 20 if layout == "wide_stride" else 5
        (frag,) = place(width, 1, [(1, frag)])
    return w, nn, frag


def _front_case(calls, inputs):
    """The last frame's front call cut to a pixel count that is no
    multiple of a block's pixels: (world, normal, frag) as (n, 3) and (n,
    2) rows, and the call's other arguments."""
    args, kwargs = calls["contact_front"][-1]
    a = dict(zip(("world", "normal", "uni", "depth_shape", "valid", "y0",
                  "frag", "pyr"), args), **kwargs)
    world, normal = a["world"].reshape(-1, 3), a["normal"].reshape(-1, 3)
    n = world.shape[0]
    if inputs == "slab":
        m = n // 250 * 250
        frag = valid = None
    else:
        m = n - 37
        frag = a["frag"].reshape(-1, 2)[:m]
        valid = None if inputs == "no_valid" else a["valid"].reshape(-1)[:m]
    pyr = None if inputs == "no_pyr" else a["pyr"]
    return world[:m], normal[:m], frag, dict(
        uni=a["uni"], depth_shape=a["depth_shape"], valid=valid, pyr=pyr)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("inputs", ["all", "no_valid", "no_pyr", "slab"])
def test_front_layouts(calls, layout, inputs):
    """K8 == the twin bit for bit with world, normal and frag in every
    layout of LAYOUTS, on n pixels that end inside a block: with frag,
    valid and the pyramid, without valid, without the pyramid, and on a
    (rows, 250) slab without frag."""
    world, normal, frag, kw = _front_case(calls, inputs)
    world, normal, frag = _laid_out(world, normal, frag, layout)
    if inputs == "slab":
        world = world.reshape(-1, 250, 3)
        normal = normal.reshape(-1, 250, 3)
        kw.update(y0=5)
    else:
        kw.update(frag=frag)
    got, want = front_both(world, normal, **kw)
    for g, w in zip(got, want):
        assert same(g, w)


@pytest.mark.parametrize("layout", ["rows11", "unaligned_contiguous"])
def test_front_graph_replay(calls, layout):
    """K8 recorded as a CUDA graph on laid-out rows, replayed after new
    normals are copied into them: == the twin on the new rows."""
    world, normal, frag, kw = _front_case(calls, "all")
    world, normal, frag = _laid_out(world, normal, frag, layout)
    tcontact.contact_front(world, normal, frag=frag, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tcontact.contact_front(world, normal, frag=frag, **kw)
    normal.copy_(torch.roll(normal, 1, dims=0))
    graph.replay()
    torch.cuda.synchronize()
    want = tcontact._contact_front_plain(world, normal, frag=frag, **kw)
    for g, w in zip(out, want):
        assert same(g, w)


def certify_both(pyr, payload, shape, idx=None, count=None):
    before = contact_cuda.CERTIFY_LAUNCHES
    got = tcontact.contact_certify(pyr, payload, shape, idx, count)
    assert contact_cuda.CERTIFY_LAUNCHES - before == 1
    want = tcontact._contact_certify_plain(pyr, payload, shape, idx, count)
    torch.cuda.synchronize()
    return got, want


def _count(v, dev):
    return torch.tensor(v, dtype=torch.int32, device=dev)


def _certify_calls(calls):
    """(pyr, payload, shape, idx, count) of the frames' certificates: the
    compacting calls' stage-2 slots."""
    for args, kwargs in calls["contact_certify_compact"]:
        a = dict(zip(("pyr", "payload", "depth_shape", "comp2", "cap3"),
                     args), **kwargs)
        yield (a["pyr"], a["payload"], a["depth_shape"], a["comp2"].idx,
               a["comp2"].count)


@pytest.mark.parametrize("case", ["frame", "identity", "empty", "one",
                                  "odd", "at_capacity", "past_capacity",
                                  "no_count"])
def test_certify_equal_to_plain(calls, case):
    """K9's certificate (its mask mode) == the twin bit for bit on the
    frames' stage-2 slots, over every payload row (the probe's identity
    index), and with live counts of 0, 1, an odd split, the capacity,
    past it and none."""
    for pyr, payload, shape, idx, count in _certify_calls(calls):
        dev = payload.device
        m = idx.shape[0]
        if case == "identity":
            idx, count = None, None
        elif case != "frame":
            live = {"empty": 0, "one": 1, "odd": m // 2 + 1,
                    "at_capacity": m, "past_capacity": m + 5,
                    "no_count": None}[case]
            idx = torch.randint(0, payload.shape[0], (m,), dtype=torch.int32,
                                device=dev)
            count = None if live is None else _count(live, dev)
        got, want = certify_both(pyr, payload, shape, idx, count)
        assert same(got, want)


def compact_both(pyr, payload, shape, comp2, cap3):
    before = contact_cuda.CERTIFY_LAUNCHES
    got = tcontact.contact_certify_compact(pyr, payload, shape, comp2, cap3)
    assert contact_cuda.CERTIFY_LAUNCHES - before == 1
    want = tcontact._contact_certify_compact_plain(pyr, payload, shape,
                                                   comp2, cap3)
    torch.cuda.synchronize()
    return got, want


def _comp2(payload, m, live, gen, valid="prefix"):
    """Stage-2 slots over m random payload rows: slot_valid before
    min(live, m) (or at random), count `live`."""
    dev = payload.device
    idx = torch.randint(0, payload.shape[0], (m,), generator=gen,
                        dtype=torch.int32, device=dev)
    slot_valid = (torch.arange(m, device=dev) < live if valid == "prefix"
                  else torch.rand(m, generator=gen, device=dev) < 0.7)
    return Compacted(idx=idx, slot_valid=slot_valid, count=_count(live, dev))


# case -> (slots, live count, cap3); None: the frame's own
COMPACT_CASES = {"frame": None, "overflow": (20_000, 20_000, 64),
                 "no_live": (20_000, 0, 512), "all_live": (20_000, 20_000,
                                                           20_000),
                 "past_slots": (20_000, 20_007, 8_000),
                 "inside_a_chunk": (20_000, 9_999, 4_096),
                 "cap3_above_slots": (3_000, 2_500, 5_000),
                 "one_slot": (1, 1, 1), "random_valid": (20_000, 15_000,
                                                         8_000)}


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_certify_compact_equal_to_plain(calls, case):
    """K9's compacting certificate == the twin bit for bit (idx, slot_valid
    and the true count): on the frames' own calls, and on random stage-2
    slots at capacities and live counts no frame takes (stage 3 past cap3,
    no live slot, every slot live, a count past the slots, a count inside
    a chunk, cap3 past the slots, one slot, slot_valid not a prefix)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for args, kwargs in calls["contact_certify_compact"]:
        pyr, payload, shape, comp2, cap3 = (list(args) + [None] * 5)[:5]
        comp2 = kwargs.get("comp2", comp2)
        cap3 = kwargs.get("cap3", cap3)
        if COMPACT_CASES[case] is not None:
            m, live, cap3 = COMPACT_CASES[case]
            comp2 = _comp2(payload, m, live, gen,
                           "random" if case == "random_valid" else "prefix")
        got, want = compact_both(pyr, payload, shape, comp2, cap3)
        for g, w in zip(got, want):
            assert same(g, w)


def test_certify_compact_graph_replays(calls):
    """The compacting certificate recorded as a CUDA graph after an eager
    call, replayed twice in a row (the status words the last block resets
    serve the second replay) and again after an eager call between, with
    new stage-2 slots copied in before the third: == the twin each time."""
    args, kwargs = calls["contact_certify_compact"][-1]
    pyr, payload, shape, comp2, cap3 = args
    gen = torch.Generator(device="cuda").manual_seed(12)
    comp2 = _comp2(payload, 20_000, 17_000, gen)
    tcontact.contact_certify_compact(pyr, payload, shape, comp2, 1_024)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tcontact.contact_certify_compact(pyr, payload, shape, comp2,
                                               1_024)
    want = tcontact._contact_certify_compact_plain(pyr, payload, shape,
                                                   comp2, 1_024)
    for step in range(3):
        if step == 2:
            got, _ = compact_both(pyr, payload, shape,
                                  _comp2(payload, 5_000, 4_000, gen), 900)
            new = _comp2(payload, 20_000, 9_000, gen)
            for dst, src in zip(comp2, new):
                dst.copy_(src)
            want = tcontact._contact_certify_compact_plain(
                pyr, payload, shape, comp2, 1_024)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(out, want):
            assert same(g, w)


def test_certify_compact_first_call_in_capture_raises(calls, monkeypatch):
    """The status words are made at a device's first call, eagerly: a
    first call inside a capture raises, naming the warm-up it needs."""
    args, _ = calls["contact_certify_compact"][-1]
    pyr, payload, shape, comp2, cap3 = args
    monkeypatch.setattr(contact_cuda, "_SYNC", {})
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="eagerly before the capture"):
        with torch.cuda.graph(graph):
            tcontact.contact_certify_compact(pyr, payload, shape, comp2,
                                             cap3)
    assert contact_cuda._SYNC == {}


def march_both(depth, payload, **kw):
    before = contact_cuda.MARCH_LAUNCHES
    got = tcontact.contact_march(depth, payload, **kw)
    assert contact_cuda.MARCH_LAUNCHES - before == 1
    want = tcontact._contact_march_plain(depth, payload, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.fixture(params=list(chip_smoke.MARCH_LAYOUTS))
def layout(request, monkeypatch):
    """Each layout of the march: the shipped live-count switch, one thread
    a slot and 8 lanes a slot at every live count (LANES_LIVE_MAX
    patched), so that each layout marches the seeded rays."""
    live_max = chip_smoke.MARCH_LAYOUTS[request.param]
    if live_max is not None:
        monkeypatch.setattr(contact_cuda, "LANES_LIVE_MAX", live_max)
    return request.param


@pytest.mark.parametrize("case", ["frame", "every_ray", "empty", "odd",
                                  "at_capacity"])
def test_march_equal_to_plain(calls, case, layout):
    """K9's march == the twin bit for bit on the frames' stage-3 slots,
    over every ray with the candidate mask (the dense path and the
    fallback), and with live counts of 0, an odd split and the
    capacity, in every layout."""
    for (args, kwargs), (fargs, fkw) in zip(calls["contact_march"],
                                            calls["contact_front"]):
        depth, payload = args[:2]
        kw = dict(zip(("idx", "count", "mask", "window"), args[2:]),
                  **kwargs)
        dev = payload.device
        if case == "every_ray":
            cand, _, _ = tcontact._contact_front_plain(*fargs, **fkw)
            kw = dict(mask=cand.reshape(-1))
        elif case != "frame":
            m = (payload.shape[0] // 4 if kw.get("idx") is None
                 else kw["idx"].shape[0])
            live = {"empty": 0, "odd": m // 2 + 1, "at_capacity": m}[case]
            kw.pop("mask", None)
            kw["idx"] = torch.randperm(payload.shape[0], device=dev)[:m].to(
                torch.int32)
            kw["count"] = _count(live, dev)
        got, want = march_both(depth, payload, **kw)
        assert same(got, want)


@pytest.mark.parametrize("call", ["indexed", "masked", "windowed"])
def test_march_seeded_rays(calls, call, layout):
    """K9's march == the twin bit for bit on rays drawn from the frame's
    payload (contact_rays: first hits on every linear probe, hits after
    an out-of-bounds probe, misses, NaN rows) in every layout:
    through an index with a live count inside a warp, every ray with a
    random mask, and through a window."""
    args, _ = calls["contact_march"][-1]
    depth, payload = args[:2]
    dev = payload.device
    rows = torch.from_numpy(contact_rays(payload.cpu().numpy(), 3, 50_001)
                            ).to(dev)
    n = rows.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(13)
    if call == "indexed":
        kw = dict(idx=torch.randperm(n, generator=gen, device=dev)[:40_000]
                  .to(torch.int32), count=_count(39_989, dev))
    elif call == "masked":
        kw = dict(mask=torch.rand(n, generator=gen, device=dev) < 0.8)
    else:
        kw = dict(idx=torch.arange(n, dtype=torch.int32, device=dev),
                  count=_count(n, dev), window=(torch.tensor(
                      (depth.shape[0] // 4, depth.shape[1] // 5),
                      dtype=torch.int32, device=dev), 96))
    got, want = march_both(depth, rows, **kw)
    assert same(got, want)
    assert (want < 1.0).any()


@pytest.mark.parametrize("origin", ["corner", "far_corner", "negative",
                                    "past", "middle"])
@pytest.mark.parametrize("cw", [32, 100])
def test_march_window_equal_to_plain(calls, origin, cw):
    """The march through a (cw, cw) window at a device origin: at (0, 0),
    at (H - cw, W - cw), negative (dynamic_slice counts it from the end),
    past the map (clamped) and in the middle; every ray marches its
    probes through the window."""
    args, _ = calls["contact_march"][-1]
    depth, payload = args[:2]
    h, w = depth.shape
    o = {"corner": (0, 0), "far_corner": (h - cw, w - cw),
         "negative": (-7, -300), "past": (h + 5, w - 1),
         "middle": (h // 3, w // 3)}[origin]
    dev = payload.device
    org = torch.tensor(o, dtype=torch.int32, device=dev)
    idx = torch.arange(payload.shape[0], dtype=torch.int32, device=dev)
    got, want = march_both(depth, payload, idx=idx, count=_count(
        payload.shape[0] - 3, dev), window=(org, cw))
    assert same(got, want)


def test_graph_replay(calls):
    """The frame's front, compacting certify and march recorded as one
    CUDA graph and replayed twice: == the eager kernels bit for bit, one
    launch each at capture and none on a replay."""
    (fa, fk), (ca, ck), (ma, mk) = (calls[n][-1] for n in (
        "contact_front", "contact_certify_compact", "contact_march"))

    def run():
        cand, stage2, payload = tcontact.contact_front(*fa, **fk)
        comp3 = tcontact.contact_certify_compact(ca[0], payload, *ca[2:],
                                                 **ck)
        # the frame's march: over stage 3's slots, or (its overflow
        # fallback) every ray with its mask
        slots = (comp3.idx, comp3.count) if len(ma) > 2 else ()
        return (cand, stage2, payload, *comp3, tcontact.contact_march(
            ma[0], payload, *slots, *ma[4:], **mk))

    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = (contact_cuda.FRONT_LAUNCHES, contact_cuda.CERTIFY_LAUNCHES,
              contact_cuda.MARCH_LAUNCHES)
    with torch.cuda.graph(graph):
        out = run()
    after = (contact_cuda.FRONT_LAUNCHES, contact_cuda.CERTIFY_LAUNCHES,
             contact_cuda.MARCH_LAUNCHES)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert same(a, b)
