"""Port parity: the contact shadows' front, certificate and march.

passes/contact.py's dispatchers send CUDA tensors to the kernels K8 and K9
(funky_tpu_torch/ops/contact_cuda.py: contact_front, contact_certify,
contact_certify_compact, contact_march) and CPU tensors to the plain twins
_contact_front_plain, _contact_certify_plain,
_contact_certify_compact_plain and _contact_march_plain. Here the twins,
with their slot index and live count, are held against the JAX package's
_ray_setup + _jitter_at + contact_classify, _stage2_certify, stage 3's
compaction (contact.py:760-770) and _march + _soft_term on the same
numpy-seeded inputs (a ground of rays toward the light over a depth
buffer with an occluder block); a live count below the capacity is shown
to change no slot before it; torch models of K9's lane decompositions (the
certificate's probes on 8 lanes and its compaction by chunks, warps and
look-back; the march's linear probes on 8 lanes and its bisection as a
speculative tree) are held to the twins bit for bit; each
check_* is held to the calls its kernel takes and refuses; and every
dispatcher call of a dense, a default and a tuned shipped frame passes
its check_*, so that no frame call raises on the card. The kernels run on
the card only (tests/test_torch_contact_cuda.py, chip_smoke.py).

Tolerances and why:
- the stage-2 certificate and stage 3's compaction: bit-equal to JAX run
  op by op (the same f32 operations in the same order, no division by a
  host number but the power-of-two cell size);
- the lane models: bit-equal to the twins (the same torch operations on
  the same values, evaluated per probe or per tree node);
- the front's payload within 2e-6 relative (JAX's einsum sums the clip
  products in its own order, the port as math3d.apply_rows does), its
  masks on at most 0.5% of pixels apart (a ray whose clip or certificate
  sits on the rounding edge);
- the march's terms: the contact gate of tests/test_torch_passes.py and
  tests/test_torch_sparse.py (|diff| > 1e-2 on at most 0.5% of rays; torch
  evaluates NEAR * FAR / denom as reciprocal(denom) * 10, JAX divides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funky_tpu_torch.frame as tf
from funky_tpu.ops import compact as jcompact
from funky_tpu.ops.sampling import quad_pack as jquad_pack
from funky_tpu.passes import contact as jcontact
from funky_tpu_torch.ops import contact_cuda as k9
from funky_tpu_torch.ops.compact import Compacted
from funky_tpu_torch.ops.sampling import quad_pack
from funky_tpu_torch.passes import contact as tcontact

from .test_taa_contact import _uniforms
from .test_torch_gather import _shipped_config
from .torch_scenes import contact_rays
from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, port_uniforms, t2n)

H, W = 48, 64
F32 = np.float32


def T(x):
    return torch.from_numpy(np.array(x))


def frac_over(a, b, tol):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > tol).mean())


def contact_case(seed):
    """(juni, world (H, W, 3), normal, frag (H, W, 2), valid, depth (H, W),
    plane (3,)) on tests/test_taa_contact.py's camera: ground points in
    front of it (x in [-1.5, 1.5], z in [-0.5, 2.5]) with normals tilted at
    random about +y; the stored depth the fitted ground plane's (a ray
    there is certified) but for a wall 3 cm in front of the points' mean
    depth over a block of the screen (rays there hit it, as in
    tests/test_torch_sparse.py's near-wall test) and the sky's 1.0 over
    the top rows."""
    rng = np.random.default_rng(seed)
    juni = _uniforms(aspect_ratio=W / H, frame_index=jnp.asarray(
        seed, jnp.int32))
    juni = juni._replace(prev_view_proj=juni.view_proj)
    world = np.stack([
        np.broadcast_to(np.linspace(-1.5, 1.5, W)[None, :], (H, W)),
        np.zeros((H, W)),
        np.broadcast_to(np.linspace(-0.5, 2.5, H)[:, None], (H, W)),
    ], -1)
    normal = np.tile([0.0, 1.0, 0.0], (H, W, 1))
    normal += rng.normal(0.0, 0.15, normal.shape)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    vp = np.asarray(juni.view_proj, np.float64)
    hom = np.concatenate([world + 0.01 * normal, np.ones((H, W, 1))], -1)
    clip = hom @ vp.T
    near, far = 0.1, 100.0
    d_surface = near * far / (far - clip[..., 2] / clip[..., 3]
                              * (far - near))
    d_wall = d_surface.mean() - 0.03
    z_wall = far * (d_wall - near) / (d_wall * (far - near))
    plane = np.asarray(jcontact.fit_ground_plane(
        juni.prev_view_proj, W, H, juni.camera_pos), np.float64)
    jj, ii = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    depth = np.minimum(plane[0] * jj + plane[1] * ii + plane[2], 1.0)
    depth[H // 4:3 * H // 4, W // 4:W // 2] = z_wall
    depth[:4] = 1.0
    valid = rng.random((H, W)) < 0.9
    return (juni, world.astype(F32), normal.astype(F32),
            np.stack([jj, ii], -1).astype(F32), valid, depth.astype(F32),
            plane.astype(F32))


def port_pyramid(depth, plane):
    return tcontact.build_residual_pyramid(T(depth), T(plane))


def jax_pyramid(tpyr):
    """The port's pyramid as the JAX package's, so the certificate is
    compared on the same rows."""
    return jcontact.ResidualPyramid(
        rows=jnp.asarray(t2n(tpyr.rows)), lw=tpyr.lw, lh=tpyr.lh,
        base=tpyr.base, plane=jnp.asarray(t2n(tpyr.plane)),
        eps=jnp.asarray(t2n(tpyr.eps)), occl_lo=jnp.asarray(
            t2n(tpyr.occl_lo)), occl_hi=jnp.asarray(t2n(tpyr.occl_hi)))


def front(seed, frag=True, with_pyr=True):
    juni, world, normal, fr, valid, depth, plane = contact_case(seed)
    tpyr = port_pyramid(depth, plane)
    out = tcontact.contact_front(
        T(world), T(normal), port_uniforms(juni), depth.shape,
        valid=T(valid) if with_pyr else None, frag=T(fr) if frag else None,
        pyr=tpyr if with_pyr else None)
    return juni, world, normal, fr, valid, depth, plane, tpyr, out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("domain", ["frag", "slab"])
def test_front_twin_matches_jax(seed, domain):
    """_contact_front_plain (the dispatcher on CPU tensors, no launch) ==
    JAX's _ray_setup, _jitter_at / _jitter and contact_classify: the
    payload [march start, march dir, jitter], cand and the stage-2 mask;
    a slab's jitter at y0 = 5 from its own pixel centres."""
    before = k9.FRONT_LAUNCHES
    juni, world, normal, fr, valid, depth, plane, tpyr, out = front(
        seed, frag=domain == "frag")
    assert k9.FRONT_LAUNCHES == before
    cand, stage2, payload = (t2n(x) for x in out)
    ms, md, on_screen, facing = jcontact._ray_setup(
        jnp.asarray(world), jnp.asarray(normal), juni)
    jit = (jcontact._jitter_at(jnp.asarray(fr), juni.debug_flags[3])
           if domain == "frag" else
           jcontact._jitter(H, W, 0, juni.debug_flags[3]))
    jcand = np.asarray(facing & on_screen) & valid
    jstage2 = np.asarray(jcontact.contact_classify(
        jax_pyramid(tpyr), ms, md, jnp.asarray(jcand), depth.shape))
    want = np.concatenate([np.asarray(ms), np.asarray(md),
                           np.asarray(jit)[..., None]], -1).reshape(-1, 7)
    np.testing.assert_allclose(payload, want, rtol=2e-6, atol=2e-6)
    assert (cand != jcand).mean() <= 0.005
    assert (stage2 != jstage2).mean() <= 0.005
    assert 0.0 < stage2.mean() < cand.mean()
    if domain == "slab":
        slab = tcontact.contact_front(
            T(world[5:20]), T(normal[5:20]), port_uniforms(juni),
            depth.shape, y0=5)
        np.testing.assert_array_equal(t2n(slab[2])[:, 6],
                                      payload.reshape(H, W, 7)[5:20, :, 6]
                                      .reshape(-1))


def slots(seed, payload_rows, cap, live):
    """A compacted set as the frame makes one: the first `live` candidate
    rows in raster order, then -1 padding, count = live."""
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(payload_rows, size=live, replace=False))
    idx = np.full((cap,), -1, np.int32)
    idx[:live] = pick
    return idx, np.asarray(live, np.int32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("live", [0, 1, 333, 512])
def test_certify_twin_matches_jax(seed, live):
    """_contact_certify_plain over a slot index with its live count ==
    JAX's _stage2_certify on the same payload rows, bit for bit, and true
    at and past the count (an empty set, one slot, an odd count and a full
    capacity of 512)."""
    *_, depth, _, tpyr, (cand, stage2, payload) = front(seed)
    idx, count = slots(seed, payload.shape[0], 512, live)
    got = t2n(tcontact.contact_certify(tpyr, payload, depth.shape, T(idx),
                                       T(count)))
    rows = t2n(payload)[np.maximum(idx, 0)]
    with jax.disable_jit():
        want = np.asarray(jcontact._stage2_certify(
            jax_pyramid(tpyr), jnp.asarray(rows[:, 0:3]),
            jnp.asarray(rows[:, 3:6]), jnp.asarray(rows[:, 6]),
            jnp.asarray([W, H], jnp.float32)))
    np.testing.assert_array_equal(got[:live], want[:live])
    assert got[live:].all()
    every = t2n(tcontact.contact_certify(tpyr, payload, depth.shape))
    assert every.shape == (payload.shape[0],) and 0.0 < every.mean() < 1.0


def jax_march(depth, rows, window=None):
    packed = jquad_pack(jnp.asarray(depth))
    win = None
    if window is not None:
        (oy, ox), cw = window
        win = (jax.lax.dynamic_slice(packed, (oy, ox, 0), (cw, cw, 4)),
               (jnp.asarray(oy), jnp.asarray(ox)), depth.shape)
    inter, max_t, last_pen = jcontact._march(
        packed, jnp.asarray(rows[:, 0:3]), jnp.asarray(rows[:, 3:6]),
        jnp.asarray(rows[:, 6]), win)
    return inter, max_t, last_pen


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("window", [None, (12, 16, 32), (16, 0, 48)],
                         ids=["packed", "window", "window_edge"])
def test_march_twin_matches_jax(seed, window):
    """_contact_march_plain over a slot index with its live count ==
    JAX's _march + _soft_term scattered into ones, within the contact
    gate; read through the whole depth and through (cw, cw) windows at a
    device origin (one touching the map's left edge)."""
    *_, depth, _, tpyr, (cand, stage2, payload) = front(seed)
    n = payload.shape[0]
    idx, count = slots(seed + 7, n, 1024, 700)
    win = None if window is None else (
        T(np.asarray(window[:2], np.int32)), window[2])
    got = t2n(tcontact.contact_march(T(depth), payload, T(idx), T(count),
                                     window=win))
    rows = t2n(payload)[np.maximum(idx, 0)]
    inter, max_t, last_pen = jax_march(
        depth, rows, None if window is None else (window[:2], window[2]))
    live = np.arange(idx.shape[0]) < count
    term = np.asarray(jcontact._soft_term(inter & live, max_t, last_pen))
    want = np.ones((n,), F32)
    want[idx[live]] = term[live]
    assert frac_over(got, want, 1e-2) <= 0.005
    assert (got < 1.0).any()
    untouched = np.ones((n,), bool)
    untouched[idx[live]] = False
    assert (got[untouched] == 1.0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_march_every_ray_matches_jax(seed):
    """Without an index (the dense path and the overflow fallback) every
    ray marches and is lit where its mask is false == JAX's
    _soft_term(inter & cand), within the contact gate; the dense
    compute_contact_shadow == JAX's."""
    juni, world, normal, fr, valid, depth, plane, tpyr, out = front(seed)
    cand, _, payload = out
    got = t2n(tcontact.contact_march(T(depth), payload,
                                     mask=cand.reshape(-1)))
    inter, max_t, last_pen = jax_march(depth, t2n(payload))
    want = np.asarray(jcontact._soft_term(inter & t2n(cand).reshape(-1),
                                          max_t, last_pen))
    assert frac_over(got, want, 1e-2) <= 0.005
    dense = t2n(tcontact.compute_contact_shadow(
        T(world), T(normal), port_uniforms(juni), T(depth), frag=T(fr)))
    jdense = np.asarray(jcontact.compute_contact_shadow(
        jnp.asarray(world), jnp.asarray(normal), juni, jnp.asarray(depth),
        frag=jnp.asarray(fr)))
    assert frac_over(dense, jdense, 1e-2) <= 0.005
    assert (dense < 1.0).mean() > 0.005


@pytest.mark.parametrize("live", [0, 1, 250, 699])
def test_live_count_changes_no_slot_before_it(live):
    """A live count below the capacity changes no slot before it: the
    certificates of those slots and the march's terms at their pixels
    equal those of the full count bit for bit; past it the certificate is
    true and the march writes nothing (the output stays 1 there)."""
    *_, depth, _, tpyr, (cand, stage2, payload) = front(3)
    n = payload.shape[0]
    idx, full = slots(5, n, 700, 700)
    cut = T(np.asarray(live, np.int32))
    c_full = t2n(tcontact.contact_certify(tpyr, payload, depth.shape,
                                          T(idx), T(full)))
    c_cut = t2n(tcontact.contact_certify(tpyr, payload, depth.shape,
                                         T(idx), cut))
    np.testing.assert_array_equal(c_cut[:live], c_full[:live])
    assert c_cut[live:].all()
    m_full = t2n(tcontact.contact_march(T(depth), payload, T(idx), T(full)))
    m_cut = t2n(tcontact.contact_march(T(depth), payload, T(idx), cut))
    np.testing.assert_array_equal(m_cut[idx[:live]], m_full[idx[:live]])
    assert (m_cut[idx[live:]] == 1.0).all()
    assert (m_full[idx] < 1.0).any()


# ---------------------------------------------------------------------------
# Stage 3's compaction (contact_certify_compact) against JAX
# ---------------------------------------------------------------------------

def stage2_slots(seed, payload_rows, m, count):
    """comp2 as the frame makes one over m slots: sorted candidate rows,
    -1 padding past min(count, m), slot_valid where the slot is before
    it."""
    rng = np.random.default_rng(seed)
    live = min(count, m)
    idx = np.full((m,), -1, np.int32)
    idx[:live] = np.sort(rng.choice(payload_rows, size=live, replace=False))
    return idx, np.arange(m) < live, np.asarray(count, np.int32)


def jax_stage3(tpyr, payload, idx, slot_valid, cap3):
    """JAX's contact.py:760-770 on the payload rows at idx."""
    rows = t2n(payload)[np.maximum(idx, 0)]
    with jax.disable_jit():
        cert2 = jcontact._stage2_certify(
            jax_pyramid(tpyr), jnp.asarray(rows[:, 0:3]),
            jnp.asarray(rows[:, 3:6]), jnp.asarray(rows[:, 6]),
            jnp.asarray([W, H], jnp.float32))
        stage3 = jnp.asarray(slot_valid) & ~cert2
        local = jcompact.compact_indices(stage3, cap3)
        idx3 = jnp.where(local.slot_valid,
                         jnp.asarray(idx)[jnp.maximum(local.idx, 0)], -1)
    return np.asarray(idx3), np.asarray(local.slot_valid), int(local.count)


# case -> (slots, count, cap3)
STAGE3_CASES = {"fits": (512, 333, 256), "overflow": (512, 512, 16),
                "no_survivor": (512, 0, 128),
                "count_above_cap2": (512, 512 + 9, 512),
                "cap3_above_slots": (512, 400, 700)}


@pytest.mark.parametrize("case", sorted(STAGE3_CASES))
def test_certify_compact_twin_matches_jax(case):
    """_contact_certify_compact_plain (the dispatcher on CPU tensors) ==
    JAX's stage 3 (contact.py:760-770: the certificate, slot_valid & ~cert,
    compact_indices, comp2's indices gathered) bit for bit: idx,
    slot_valid and the true count, with survivors that fit cap3,
    overflow it, none, a stage-2 count above the slots, and cap3 above
    the slots (min(cap3, m) slots out)."""
    m, count, cap3 = STAGE3_CASES[case]
    *_, depth, _, tpyr, (cand, stage2, payload) = front(4)
    idx, slot_valid, cnt = stage2_slots(6, payload.shape[0], m, count)
    before = k9.CERTIFY_LAUNCHES
    got = tcontact.contact_certify_compact(
        tpyr, payload, depth.shape,
        Compacted(idx=T(idx), slot_valid=T(slot_valid), count=T(cnt)), cap3)
    assert k9.CERTIFY_LAUNCHES == before
    want_idx, want_valid, want_count = jax_stage3(tpyr, payload, idx,
                                                  slot_valid, cap3)
    np.testing.assert_array_equal(t2n(got.idx), want_idx)
    np.testing.assert_array_equal(t2n(got.slot_valid), want_valid)
    assert t2n(got.count).shape == () and int(got.count) == want_count
    assert got.idx.dtype == torch.int32 and got.count.dtype == torch.int32
    if case == "overflow":
        assert want_count > cap3
    elif case == "no_survivor":
        assert want_count == 0
    else:
        assert 0 < want_count <= min(cap3, m)


# ---------------------------------------------------------------------------
# Torch models of K9's lane decompositions
# ---------------------------------------------------------------------------

def certify_lanes(pyr, rows, size):
    """The certificate as K9 splits it: lane k of a slot's 8 evaluates
    probe k alone; the slot is certified where the ballot of the lanes'
    failures is 0."""
    fails = torch.zeros(rows.shape[0], dtype=torch.int64)
    for k in range(tcontact.LINEAR_STEPS):
        t = (k + rows[:, 6]) / tcontact.LINEAR_STEPS
        cs = rows[:, 0:3] + rows[:, 3:6] * t[:, None]
        uv = cs[:, :2] * 0.5 + 0.5
        inb = ((uv[:, 0] >= 0.0) & (uv[:, 0] <= 1.0)
               & (uv[:, 1] >= 0.0) & (uv[:, 1] <= 1.0))
        q = uv * size
        ok = (cs[:, 2] <= tcontact._probe_bound(pyr, q, size)
              + tcontact._point_min_l0(pyr, q) - pyr.eps)
        fails |= (inb & ~ok).to(torch.int64) << k
    return fails == 0


def look_back(aggregates, rng):
    """Each chunk's exclusive prefix as the kernel's look-back reads it:
    predecessors' status words in windows of 32, nearest first, summed up
    to the nearest inclusive one; which predecessors have published an
    inclusive prefix (and not only their aggregate) is drawn at random,
    chunk 0 always."""
    inclusive = np.cumsum(aggregates)
    published = rng.random(len(aggregates)) < 0.3
    published[0] = True
    out = []
    for c in range(len(aggregates)):
        prefix, top = 0, c - 1
        while c > 0:
            window = [top - lane for lane in range(32)]
            incl = [q < 0 or published[q] for q in window]
            stop = incl.index(True) if any(incl) else 31
            prefix += sum(0 if q < 0 else (inclusive[q] if published[q]
                                           else aggregates[q])
                          for q in window[:stop + 1])
            if any(incl):
                break
            top -= 32
        out.append(prefix)
    return np.asarray(out)


def compact_lanes(comp2, cert, cap3, rng):
    """Stage 3 as K9's compact mode places it: thread t of a block owns
    slot t of its chunk of CHUNK; a survivor's place is the chunk's
    look-back prefix, its warp's prefix of the block's warp counts and
    the popcount of the lower lanes' ballot."""
    m = comp2.idx.shape[0]
    live = min(max(int(comp2.count), 0), m)
    flags = np.zeros(-(-m // k9.CHUNK) * k9.CHUNK, bool)
    flags[:live] = t2n(comp2.slot_valid)[:live] & ~t2n(cert)[:live]
    used = -(-live // k9.CHUNK) * k9.CHUNK
    chunks = flags[:used].reshape(-1, k9.CHUNK // 32, 32)
    warp_counts = chunks.sum(-1)
    warp_off = np.cumsum(warp_counts, -1) - warp_counts
    lane_off = np.cumsum(chunks, -1) - chunks
    pos = (look_back(warp_counts.sum(-1), rng)[:, None, None]
           + warp_off[..., None] + lane_off).reshape(-1)
    cap = min(cap3, m)
    idx = np.full((cap,), -1, np.int32)
    valid = np.zeros((cap,), bool)
    for s in np.flatnonzero(chunks.reshape(-1)):
        if pos[s] < cap:
            idx[pos[s]] = t2n(comp2.idx)[s]
            valid[pos[s]] = True
    return idx, valid, int(chunks.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_certify_lane_model(seed):
    """K9's certificate split over lanes == _contact_certify_plain bit for
    bit on seeded rays (NaN rows among them), and its compaction (each
    chunk's slots placed by warp counts, lane ballots and the look-back)
    == _contact_certify_compact_plain at a live count that ends inside a
    chunk, with cap3 below and above the survivors; the certificate's
    probe layout (slot p * 32 + warp * 4 + group of a chunk) gives each
    slot one group of 8 lanes."""
    rng = np.random.default_rng(seed)
    *_, depth, _, tpyr, (cand, stage2, payload) = front(seed)
    rows = T(contact_rays(t2n(payload), seed, 3000))
    cert = tcontact._contact_certify_plain(tpyr, rows, depth.shape)
    np.testing.assert_array_equal(
        t2n(certify_lanes(tpyr, rows, tcontact._size(depth.shape, "cpu"))),
        t2n(cert))
    assert 0.0 < float(cert.float().mean()) < 1.0
    layout = [p * 32 + w * 4 + g for p in range(8) for w in range(8)
              for g in range(4)]
    assert sorted(layout) == list(range(k9.CHUNK))
    m = rows.shape[0]
    idx = np.arange(m, dtype=np.int32)
    for count, cap3 in ((2900, 50), (2900, 3000), (m + 4, 1000)):
        comp2 = Compacted(idx=T(idx), slot_valid=T(np.arange(m) < count),
                          count=T(np.asarray(count, np.int32)))
        want = tcontact._contact_certify_compact_plain(
            tpyr, rows, depth.shape, comp2, cap3)
        c2 = tcontact._contact_certify_plain(tpyr, rows, depth.shape,
                                             comp2.idx, comp2.count)
        got = compact_lanes(comp2, c2, cap3, rng)
        np.testing.assert_array_equal(got[0], t2n(want.idx))
        np.testing.assert_array_equal(got[1], t2n(want.slot_valid))
        assert got[2] == int(want.count)


def march_probe(packed, rows, t):
    """One probe of passes/contact.py::_march at t (n,): (hit, pen,
    in bounds)."""
    cs = rows[:, 0:3] + rows[:, 3:6] * t[:, None]
    uv = cs[:, :2] * 0.5 + 0.5
    inb = ((uv[:, 0] >= 0.0) & (uv[:, 0] <= 1.0)
           & (uv[:, 1] >= 0.0) & (uv[:, 1] <= 1.0))
    d_max, d_min = tcontact._sample_depth_dual(packed, uv)
    ray = tcontact._linearize(cs[:, 2])
    pen = ray - d_min
    return (d_max - ray < 0.0) & (pen < tcontact.DEPTH_THICKNESS), pen, inb


def march_lanes(depth, rows):
    """The march as K9 splits it over 8 lanes a ray: the 8 linear probes
    side by side, the first in-bounds hit and the last in-bounds miss
    before it found by index; the bisection's midpoints as a tree in heap
    order (node n's hit child 2n + 1, its miss child 2n + 2), each node's
    interval from (min_t, max_t) along its path bits, the 7 of depths 0-2
    probed, a walk down the path, then the one node of depth 3 on the
    path. Returns the terms and
    each ray's first hit (-1: none) and whether an out-of-bounds probe
    came before it."""
    packed = quad_pack(depth)
    n = rows.shape[0]
    col = torch.arange(n)
    k = torch.arange(tcontact.LINEAR_STEPS)[:, None]
    t = (k + rows[None, :, 6]) / tcontact.LINEAR_STEPS
    hit, pen, inb = (torch.stack(x) for x in zip(
        *[march_probe(packed, rows, t[j]) for j in range(t.shape[0])]))
    hits = hit & inb
    inter = hits.any(0)
    first = torch.argmax(hits.to(torch.int32), 0)
    max_t = torch.where(inter, t[first, col], 1.0)
    last_pen = torch.where(inter, pen[first, col], 0.0)
    miss = torch.where(inb & ~hit & (k < first), k, -1).amax(0)
    min_t = torch.where(inter & (miss >= 0), t[miss.clamp(min=0), col], 0.0)
    probed = []
    for node in range(7):
        lo, hi = min_t, max_t
        path = node + 1
        for d in range(path.bit_length() - 2, -1, -1):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if (path >> d) & 1 else (lo, mid)
        probed.append(march_probe(packed, rows, 0.5 * (lo + hi))[:2])
    node_hit = torch.stack([h for h, _ in probed])
    node_pen = torch.stack([p for _, p in probed])
    node = torch.zeros(n, dtype=torch.long)
    for _ in range(3):
        mid = 0.5 * (min_t + max_t)
        h = node_hit[node, col]
        max_t = torch.where(h, mid, max_t)
        last_pen = torch.where(h, node_pen[node, col], last_pen)
        min_t = torch.where(h, min_t, mid)
        node = 2 * node + torch.where(h, 1, 2)
    mid = 0.5 * (min_t + max_t)
    h, p, _ = march_probe(packed, rows, mid)
    max_t = torch.where(h, mid, max_t)
    last_pen = torch.where(h, p, last_pen)
    oob_first = inter & (~inb & (k < first)).any(0)
    return (tcontact._soft_term(inter, max_t, last_pen),
            torch.where(inter, first, -1), oob_first)


@pytest.mark.parametrize("seed", [0, 1])
def test_march_lane_model(seed):
    """K9's march split over 8 lanes a ray == _contact_march_plain bit
    for bit on seeded rays (two draws) whose first hits fall on every
    linear probe (0 and 7 among them), some after an out-of-bounds probe,
    some missing every probe, and NaN rows."""
    *_, depth, _, tpyr, (cand, stage2, payload) = front(0)
    rows = T(contact_rays(t2n(payload), seed, 2048))
    term, first, oob_first = march_lanes(T(depth), rows)
    want = tcontact._contact_march_plain(T(depth), rows)
    assert torch.equal(term.view(torch.int32), want.view(torch.int32))
    hist = np.bincount(t2n(first) + 1, minlength=9)
    assert (hist > 0).all(), hist      # no hit, and a first hit on each probe
    assert int(oob_first.sum()) > 0
    assert bool(rows.isnan().any(dim=1).any())


# ---------------------------------------------------------------------------
# check_front / check_certify / check_march
# ---------------------------------------------------------------------------

def _front_args():
    world = torch.zeros((4, 8, 3))
    return dict(world=world, normal=torch.zeros((4, 8, 3)),
                light_dir=torch.zeros((3,)), vp=torch.zeros((4, 4)),
                frame=torch.zeros(()), depth_shape=(16, 16),
                valid=torch.zeros((4, 8), dtype=torch.bool), y0=0,
                frag=torch.zeros((4, 8, 2)), pyr=port_pyramid(
                    np.zeros((16, 16), F32), np.zeros((3,), F32)))


def _front_refused():
    a = _front_args()
    return {
        "f64 world": ("world", dict(world=a["world"].double())),
        "world not (..., 3)": ("world", dict(world=torch.zeros((4, 8, 4)))),
        "normal of another batch": ("normal",
                                    dict(normal=torch.zeros((4, 7, 3)))),
        "light_dir of 4": ("light_dir", dict(light_dir=torch.zeros((4,)))),
        "vp transposed": ("vp", dict(vp=torch.zeros((4, 4)).T)),
        "vp of 3x3": ("vp", dict(vp=torch.zeros((3, 3)))),
        "frame of (1,)": ("frame", dict(frame=torch.zeros((1,)))),
        "depth_shape of 3": ("depth_shape", dict(depth_shape=(4, 4, 4))),
        "int valid": ("valid", dict(valid=torch.zeros((4, 8),
                                                      dtype=torch.int32))),
        "frag of another batch": ("frag", dict(frag=torch.zeros((4, 7, 2)))),
        "flat batch without frag": ("world", dict(
            world=torch.zeros((32, 3)), normal=torch.zeros((32, 3)),
            valid=None, frag=None)),
        "float y0": ("y0", dict(frag=None, y0=2.0)),
        "bool y0": ("y0", dict(frag=None, y0=torch.zeros((),
                                                         dtype=torch.bool))),
        "y0 on another device": ("y0", dict(frag=None, y0=torch.zeros(
            (), dtype=torch.int32, device="meta"))),
        "normal on another device": ("normal", dict(
            normal=torch.zeros((4, 8, 3), device="meta"))),
        "pyr plane of 2": ("pyr.plane", dict(pyr=a["pyr"]._replace(
            plane=torch.zeros((2,))))),
        "f64 pyr eps": ("pyr.eps", dict(pyr=a["pyr"]._replace(
            eps=torch.zeros((), dtype=torch.float64)))),
    }


@pytest.mark.parametrize("case", sorted(_front_refused()))
def test_check_front_refuses(case):
    name, change = _front_refused()[case]
    args = {**_front_args(), **change}
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        k9.check_front(**args)


def _slot_refused():
    payload = torch.zeros((64, 7))
    idx = torch.zeros((16,), dtype=torch.int32)
    return {
        "payload of 6": ("payload", dict(payload=torch.zeros((64, 6)))),
        "strided payload": ("payload", dict(
            payload=torch.zeros((64, 14))[:, ::2])),
        "f16 payload": ("payload", dict(payload=payload.half())),
        "int64 idx": ("idx", dict(idx=idx.long())),
        "2-D idx": ("idx", dict(idx=idx.reshape(4, 4))),
        "strided idx": ("idx", dict(
            idx=torch.zeros((32,), dtype=torch.int32)[::2])),
        "count of 2": ("count", dict(count=torch.zeros((2,),
                                                       dtype=torch.int32))),
        "int64 count": ("count", dict(count=torch.zeros((),
                                                        dtype=torch.int64))),
        "idx on another device": ("idx", dict(idx=idx.to("meta"))),
    }


@pytest.mark.parametrize("case", sorted(_slot_refused()))
@pytest.mark.parametrize("kernel", ["certify", "march"])
def test_check_slots_refuse(case, kernel):
    name, change = _slot_refused()[case]
    args = dict(payload=torch.zeros((64, 7)),
                idx=torch.zeros((16,), dtype=torch.int32),
                count=torch.zeros((), dtype=torch.int32), **{})
    args.update(change)
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        if kernel == "certify":
            k9.check_certify(port_pyramid(np.zeros((16, 16), F32),
                                          np.zeros((3,), F32)),
                             args["payload"], (16, 16), args["idx"],
                             args["count"])
        else:
            k9.check_march(torch.zeros((16, 16)), args["payload"],
                           args["idx"], args["count"])


def _march_refused():
    return {
        "prev_depth of 3 axes": ("prev_depth", dict(
            prev_depth=torch.zeros((1, 16, 16)))),
        "transposed prev_depth": ("prev_depth", dict(
            prev_depth=torch.zeros((16, 32)).T)),
        "mask with an index": ("mask", dict(
            idx=torch.zeros((8,), dtype=torch.int32),
            mask=torch.zeros((64,), dtype=torch.bool))),
        "mask of another length": ("mask", dict(
            mask=torch.zeros((63,), dtype=torch.bool))),
        "window origin of 3": ("window origin", dict(window=(
            torch.zeros((3,), dtype=torch.int32), 8))),
        "window origin f32": ("window origin", dict(window=(
            torch.zeros((2,)), 8))),
        "window past the map": ("window cw", dict(window=(
            torch.zeros((2,), dtype=torch.int32), 17))),
        "window not a pair": ("window", dict(window=(8,))),
    }


@pytest.mark.parametrize("case", sorted(_march_refused()))
def test_check_march_refuses(case):
    name, change = _march_refused()[case]
    args = dict(prev_depth=torch.zeros((16, 16)),
                payload=torch.zeros((64, 7)))
    args.update(change)
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        k9.check_march(**args)


def test_certify_refuses_a_bad_pyramid():
    pyr = port_pyramid(np.zeros((16, 16), F32), np.zeros((3,), F32))
    for name, bad in (("pyr.rows", pyr._replace(rows=pyr.rows[:, :3])),
                      ("pyr.base", pyr._replace(base=0)),
                      ("pyr.plane", pyr._replace(plane=pyr.plane[:2]))):
        with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
            k9.check_certify(bad, torch.zeros((8, 7)), (16, 16))


def _comp2(m=16):
    return Compacted(idx=torch.zeros((m,), dtype=torch.int32),
                     slot_valid=torch.zeros((m,), dtype=torch.bool),
                     count=torch.zeros((), dtype=torch.int32))


def _compact_refused():
    comp2 = _comp2()
    idx = comp2.idx
    return {
        "comp2 a tuple": ("comp2", dict(comp2=tuple(comp2))),
        "comp2 without a count": ("comp2", dict(comp2=comp2._replace(
            count=None))),
        "int64 comp2 idx": ("idx", dict(comp2=comp2._replace(
            idx=idx.long()))),
        "int64 comp2 count": ("count", dict(comp2=comp2._replace(
            count=comp2.count.long()))),
        "slot_valid of another length": ("comp2.slot_valid", dict(
            comp2=comp2._replace(slot_valid=torch.zeros(
                (15,), dtype=torch.bool)))),
        "int slot_valid": ("comp2.slot_valid", dict(comp2=comp2._replace(
            slot_valid=torch.zeros((16,), dtype=torch.int32)))),
        "strided slot_valid": ("comp2.slot_valid", dict(comp2=comp2._replace(
            slot_valid=torch.zeros((32,), dtype=torch.bool)[::2]))),
        "slot_valid on another device": ("comp2.slot_valid", dict(
            comp2=comp2._replace(slot_valid=torch.zeros(
                (16,), dtype=torch.bool, device="meta")))),
        "negative cap3": ("cap3", dict(cap3=-1)),
        "float cap3": ("cap3", dict(cap3=8.0)),
        "bool cap3": ("cap3", dict(cap3=True)),
    }


@pytest.mark.parametrize("case", sorted(_compact_refused()))
def test_check_certify_compact_refuses(case):
    name, change = _compact_refused()[case]
    args = dict(pyr=port_pyramid(np.zeros((16, 16), F32),
                                 np.zeros((3,), F32)),
                payload=torch.zeros((64, 7)), depth_shape=(16, 16),
                comp2=_comp2(), cap3=8)
    k9.check_certify_compact(**args)
    args.update(change)
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        k9.check_certify_compact(**args)


def test_wrappers_refuse_cpu_tensors():
    """Each wrapper launches its kernel or raises: CPU tensors are refused
    by name (the pass above takes the twins for them)."""
    a = _front_args()
    with pytest.raises(ValueError, match="^world:"):
        k9.contact_front(**a)
    with pytest.raises(ValueError, match="^payload:"):
        k9.contact_certify(a["pyr"], torch.zeros((8, 7)), (16, 16))
    with pytest.raises(ValueError, match="^prev_depth:"):
        k9.contact_march(torch.zeros((16, 16)), torch.zeros((8, 7)))
    with pytest.raises(ValueError, match="^payload:"):
        k9.contact_certify_compact(a["pyr"], torch.zeros((8, 7)), (16, 16),
                                   _comp2(4), 4)


# ---------------------------------------------------------------------------
# Every frame call passes its check
# ---------------------------------------------------------------------------

def _record_contact(monkeypatch):
    """Replace the four twins by recorders that pass each call through
    its kernel's check first; returns the list of (kernel, sizes)."""
    calls = []
    front_plain = tcontact._contact_front_plain
    certify_plain = tcontact._contact_certify_plain
    compact_plain = tcontact._contact_certify_compact_plain
    march_plain = tcontact._contact_march_plain

    def front_rec(world, normal, uni, depth_shape, valid=None, y0=0,
                  frag=None, pyr=None):
        k9.check_front(world, normal, uni.light_dir, uni.proj @ uni.view,
                       uni.debug_flags[3], depth_shape, valid, y0, frag, pyr)
        calls.append(("front", tuple(world.shape), pyr is not None))
        return front_plain(world, normal, uni, depth_shape, valid, y0, frag,
                           pyr)

    def certify_rec(pyr, payload, depth_shape, idx=None, count=None):
        k9.check_certify(pyr, payload, depth_shape, idx, count)
        calls.append(("certify", tuple(payload.shape), idx is not None))
        return certify_plain(pyr, payload, depth_shape, idx, count)

    def compact_rec(pyr, payload, depth_shape, comp2, cap3):
        k9.check_certify_compact(pyr, payload, depth_shape, comp2, cap3)
        calls.append(("certify_compact", tuple(payload.shape), True))
        return compact_plain(pyr, payload, depth_shape, comp2, cap3)

    def march_rec(prev_depth, payload, idx=None, count=None, mask=None,
                  window=None):
        k9.check_march(prev_depth, payload, idx, count, mask, window)
        calls.append(("march", tuple(payload.shape), window is not None))
        return march_plain(prev_depth, payload, idx, count, mask, window)

    monkeypatch.setattr(tcontact, "_contact_front_plain", front_rec)
    monkeypatch.setattr(tcontact, "_contact_certify_plain", certify_rec)
    monkeypatch.setattr(tcontact, "_contact_certify_compact_plain",
                        compact_rec)
    monkeypatch.setattr(tcontact, "_contact_march_plain", march_rec)
    return calls


@pytest.mark.parametrize("path", ["dense", "default", "shipped"])
def test_frame_contact_calls_pass_checks(path, monkeypatch):
    """Every contact dispatcher call of two chained frames (parked, orbit
    pose 1) on the multimesh scene passes its kernel's check: the dense
    frame (front without the pyramid, march over every ray), GltfConfig()
    at 256x144 (front, the compacting certify over the stage-2 slots,
    whose twin runs the certify over them, march over the stage-3 slots)
    and the tuned shipped configuration at 480x272 (the
    same, the march through its window where the tune set one); and the
    probe the autotune and the retune read (contact_occupancy: front and
    certify over every pixel)."""
    from funky_tpu_torch.utils import diagnostics

    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    cfg = {"dense": lambda: tf.GltfConfig(
               width=256, height=144, flags=tf.GltfFrameFlags(
                   sparse_shadows=False, sparse_contact=False)),
           "default": lambda: tf.GltfConfig(width=256, height=144),
           "shipped": lambda: _shipped_config(scene, params)}[path]()
    calls = _record_contact(monkeypatch)
    state = tf.init_frame_state(cfg, "cpu")
    for pose in (params, tf.orbit_params(params, 1)):
        _, state = tf.render_gltf_frame(scene, pose, state, cfg)
    kinds = [c[0] for c in calls]
    if path == "dense":
        assert kinds == ["front", "march"] * 2
        assert not any(c[2] for c in calls)
    else:
        assert kinds == ["front", "certify_compact", "certify", "march"] * 2
        assert all(c[2] for c in calls if c[0] != "march")
    if path == "shipped":
        assert calls[3][2] == (cfg.contact_window is not None
                               and cfg.contact_window < min(cfg.height,
                                                            cfg.width))
        del calls[:]
        diagnostics.probe_occupancy(scene, params, state, cfg)
        assert [c[0] for c in calls] == ["front", "certify"]
        assert not calls[1][2]
