"""The contact kernels K8 and K9 (funky_tpu_torch/csrc/contact.cu through
ops/contact_cuda.py: contact_front, contact_certify, contact_march)
against their plain twins (passes/contact.py::_contact_front_plain,
_contact_certify_plain, _contact_march_plain), on the card. The inputs
are a default frame's own (GltfConfig() at 256x144 on the multimesh
scene, two chained frames, every dispatcher call recorded), cut and
re-indexed for the cases no frame reaches. Every test here needs an
NVIDIA GPU and skips without one. The module imports no jax:

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
from funky_tpu_torch.passes import contact as tcontact

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
    out = {name: [] for name in ("contact_front", "contact_certify",
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


def certify_both(pyr, payload, shape, idx=None, count=None):
    before = contact_cuda.CERTIFY_LAUNCHES
    got = tcontact.contact_certify(pyr, payload, shape, idx, count)
    assert contact_cuda.CERTIFY_LAUNCHES - before == 1
    want = tcontact._contact_certify_plain(pyr, payload, shape, idx, count)
    torch.cuda.synchronize()
    return got, want


def _count(v, dev):
    return torch.tensor(v, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("case", ["frame", "identity", "empty", "one",
                                  "odd", "at_capacity", "past_capacity",
                                  "no_count"])
def test_certify_equal_to_plain(calls, case):
    """K9's certificate == the twin bit for bit on the frames' stage-2
    slots, over every payload row (the probe's identity index), and with
    live counts of 0, 1, an odd split, the capacity, past it and none."""
    for args, kwargs in calls["contact_certify"]:
        pyr, payload, shape, idx, count = (list(args) + [None] * 5)[:5]
        idx = kwargs.get("idx", idx)
        count = kwargs.get("count", count)
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


def march_both(depth, payload, **kw):
    before = contact_cuda.MARCH_LAUNCHES
    got = tcontact.contact_march(depth, payload, **kw)
    assert contact_cuda.MARCH_LAUNCHES - before == 1
    want = tcontact._contact_march_plain(depth, payload, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("case", ["frame", "every_ray", "empty", "odd",
                                  "at_capacity"])
def test_march_equal_to_plain(calls, case):
    """K9's march == the twin bit for bit on the frames' stage-3 slots,
    over every ray with the candidate mask (the dense path and the
    fallback), and with live counts of 0, an odd split and the
    capacity."""
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
    """The frame's front, certify and march recorded as one CUDA graph
    and replayed: == the eager kernels bit for bit, one launch each at
    capture and none on a replay."""
    (fa, fk), (ca, ck), (ma, mk) = (calls[n][-1] for n in (
        "contact_front", "contact_certify", "contact_march"))

    def run():
        cand, stage2, payload = tcontact.contact_front(*fa, **fk)
        cert = tcontact.contact_certify(ca[0], payload, *ca[2:], **ck)
        return cand, stage2, payload, cert, tcontact.contact_march(
            ma[0], payload, *ma[2:], **mk)

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
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert same(a, b)
