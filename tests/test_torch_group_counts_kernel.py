"""Port parity: the sparse shadow filter's per-group pair histogram.
passes/shadow_filter.py::_group_counts sends CUDA tensors to the kernel K7
(funky_tpu_torch/ops/group_counts_cuda.py::group_counts) and CPU tensors to
the plain twin _group_counts_plain; here the twin is held against the JAX
package's `counts_c` (funky_tpu/passes/shadow_filter.py:714-716, the
per-group masked sums, evaluated here as that expression), `check_args` is
held to the calls the kernel takes and refuses, and every histogram of a
default and a tuned shipped frame is shown to pass `check_args`, so that
no frame call raises on the card. The kernel itself runs on the card only
(tests/test_torch_group_counts_cuda.py, chip_smoke.py).

Tolerance: none; the counts are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funky_tpu_torch.frame as tf
from funky_tpu_torch.ops import group_counts_cuda
from funky_tpu_torch.passes import shadow_filter as tsf

from .test_torch_gather import _shipped_config
from .torch_parity import (multimesh_jax_scene, multimesh_params,
                           port_params, port_scene, t2n)


def jax_counts(needs, group_key, n_groups):
    """funky_tpu/passes/shadow_filter.py:714-716."""
    needs, group_key = jnp.asarray(needs), jnp.asarray(group_key)
    return np.asarray(jnp.stack([
        jnp.sum(needs & (group_key == g), dtype=jnp.int32)
        for g in range(n_groups)]))


def histogram_case(seed, shape, n_groups, p_need):
    rng = np.random.default_rng(seed)
    needs = rng.random(shape) < p_need
    key = rng.integers(0, n_groups, shape).astype(np.int32)
    return needs, key


@pytest.mark.parametrize("shape", [(2, 37, 53), (2, 4096), (2, 1)],
                         ids=str)
@pytest.mark.parametrize("n_groups", [4, 8, 12, 16])
@pytest.mark.parametrize("p_need", [0.0, 0.05, 1.0])
def test_twin_matches_jax(shape, n_groups, p_need):
    """The dispatcher on CPU tensors (the twin, no launch) == JAX's masked
    sums, for every group count the frame builds (4 cascades times 1 to 4
    kinds), no, a few and all entries needed."""
    needs, key = histogram_case(n_groups, shape, n_groups, p_need)
    before = group_counts_cuda.LAUNCHES
    got = tsf._group_counts(torch.from_numpy(needs), torch.from_numpy(key),
                            n_groups)
    assert group_counts_cuda.LAUNCHES == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_groups,)
    np.testing.assert_array_equal(t2n(got), jax_counts(needs, key, n_groups))
    group_counts_cuda.check_args(torch.from_numpy(needs),
                                 torch.from_numpy(key), n_groups)


def _refused():
    """(argument named in the error, needs, group_key, n_groups) of calls
    the kernel does not take. The meta device stands in for a second
    device."""
    needs = torch.zeros((2, 64), dtype=torch.bool)
    key = torch.zeros((2, 64), dtype=torch.int32)
    return {
        "int8 needs": ("needs", needs.to(torch.int8), key, 8),
        "int64 key": ("group_key", needs, key.long(), 8),
        "needs not a tensor": ("needs", [True] * 8, key, 8),
        "non-contiguous needs": ("needs", torch.zeros(
            (64, 2), dtype=torch.bool).T, key, 8),
        "non-contiguous key": ("group_key", needs, torch.zeros(
            (64, 2), dtype=torch.int32).T, 8),
        "key of another shape": ("group_key", needs, key[:, :32].clone(), 8),
        "key on another device": ("group_key", needs, key.to("meta"), 8),
        "no groups": ("n_groups", needs, key, 0),
        "too many groups": ("n_groups", needs, key, 65),
        "n_groups not an int": ("n_groups", needs, key, 8.0),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_check_args_refuses(case):
    """Each call the kernel cannot take raises, naming the argument."""
    name, needs, key, n_groups = _refused()[case]
    with pytest.raises((TypeError, ValueError), match=f"^{name}:"):
        group_counts_cuda.check_args(needs, key, n_groups)


def test_wrapper_refuses_cpu_tensors():
    """group_counts launches the kernel or raises: a CPU tensor is refused
    by name (the pass above takes the twin for it)."""
    with pytest.raises(ValueError, match="^needs:"):
        group_counts_cuda.group_counts(
            torch.zeros((2, 8), dtype=torch.bool),
            torch.zeros((2, 8), dtype=torch.int32), 4)


@pytest.mark.parametrize("path", ["default", "shipped"])
def test_frame_histograms_pass_check_args(path, monkeypatch):
    """Every _group_counts call of two chained frames (parked, orbit pose
    1) on the multimesh scene passes check_args: GltfConfig() at 256x144
    with its 2048^2 maps, and the tuned shipped configuration at 480x272
    (radius-only and routed kinds among its groups where the tune sets
    them). One call per frame, each == JAX's masked sums on its inputs."""
    scene = port_scene(multimesh_jax_scene())
    params = port_params(multimesh_params())
    cfg = {"default": lambda: tf.GltfConfig(width=256, height=144),
           "shipped": lambda: _shipped_config(scene, params)}[path]()
    calls = []
    plain = tsf._group_counts_plain

    def record(needs, group_key, n_groups):
        group_counts_cuda.check_args(needs, group_key, n_groups)
        out = plain(needs, group_key, n_groups)
        calls.append((t2n(needs), t2n(group_key), n_groups, t2n(out)))
        return out

    monkeypatch.setattr(tsf, "_group_counts_plain", record)
    state = tf.init_frame_state(cfg, "cpu")
    for pose in (params, tf.orbit_params(params, 1)):
        _, state = tf.render_gltf_frame(scene, pose, state, cfg)
    assert len(calls) == 2
    for needs, key, n_groups, out in calls:
        assert needs.shape[0] == 2 and n_groups % 4 == 0
        assert out.sum() > 0
        np.testing.assert_array_equal(out, jax_counts(needs, key, n_groups))
