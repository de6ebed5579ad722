"""The debug panel's overlay kernel K4 (funky_tpu_torch/csrc/overlay.cu
through ops/overlay_cuda.py::overlay_raster) against its plain twin
(passes/overlay.py::rasterize_overlay_plain), on the card. Every test here
needs an NVIDIA GPU and skips without one. The module imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_overlay_cuda.py

Tolerance: none. The kernel repeats the twin's f32 operations in the
twin's order without contraction, so the panels are equal bit for bit.
"""

import numpy as np
import pytest
import torch

from funky_tpu_torch.app import ui
from funky_tpu_torch.ops import overlay_cuda
from funky_tpu_torch.passes import overlay

from .torch_scenes import OVERLAY_CASES, overlay_case

pytestmark = pytest.mark.cuda

PANEL = (ui.PANEL_H, ui.PANEL_W)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def bits(x: torch.Tensor) -> np.ndarray:
    return x.cpu().reshape(-1).contiguous().numpy().view(np.uint8)


def kernel_and_plain(arrays, dev, panel_hw=PANEL):
    """(kernel, plain twin) panels of the same table on the card; the
    kernel launches once."""
    verts, uvs, cols, tris, n = arrays
    atlas = torch.from_numpy(ui.build_font_atlas()[0]).to(dev)
    table = torch.from_numpy(overlay.overlay_table(
        verts, uvs, cols, tris, int(n), panel_hw)).to(dev)
    before = overlay_cuda.LAUNCHES
    got = overlay_cuda.overlay_raster(table, atlas, panel_hw)
    torch.cuda.synchronize()
    assert overlay_cuda.LAUNCHES - before == 1
    want = overlay.rasterize_overlay_plain(table, atlas, panel_hw)
    return got, want


@pytest.mark.parametrize("data", [
    ui.UiData(),
    ui.UiData(fps=59.9, frame_time_ms=16.7, gltf_scale=0.0123,
              debug_cascades=True, use_pcss=False, use_shadow_taa=False,
              entity_count=3, component_count=7, gpu_info="NVIDIA H100",
              last_error="frame 3: boom")], ids=["default", "toggled"])
def test_panel_bit_equal_to_plain(dev, data):
    """The debug window's own panel: the defaults, and every checkbox
    toggled with the error line shown."""
    got, want = kernel_and_plain(ui.build_panel(data).arrays(), dev)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert float((got[..., 3] > 0.5).float().mean()) > 0.5   # drawn


@pytest.mark.parametrize("case", sorted(OVERLAY_CASES))
def test_triangle_sets_bit_equal_to_plain(dev, case):
    """Tiny triangles (the full-panel crop), slivers and degenerate ones,
    triangles across the panel's edges with uvs off the atlas."""
    got, want = kernel_and_plain(overlay_case(case), dev)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert float(got[..., 3].max()) > 0


def test_render_over_launches_the_kernel(dev):
    """DebugPanel.render_over on a card frame goes through K4 once and
    composites the kernel's panel."""
    panel = ui.DebugPanel(640, 360, device=dev)
    image = torch.zeros((360, 640, 4), device=dev)
    before = overlay_cuda.LAUNCHES
    out = panel.render_over(image, ui.UiData())
    torch.cuda.synchronize()
    assert overlay_cuda.LAUNCHES - before == 1
    assert out.shape == image.shape and bool(torch.isfinite(out).all())


def test_wrong_arguments_raise(dev):
    """A CUDA call the kernel cannot take raises; it never falls back."""
    atlas = torch.from_numpy(ui.build_font_atlas()[0]).to(dev)
    table = torch.zeros((4, overlay.TABLE_COLS), device=dev)
    with pytest.raises(TypeError, match="^table:"):
        overlay_cuda.overlay_raster(table.double(), atlas, PANEL)
    with pytest.raises(ValueError, match="^table:"):
        overlay_cuda.overlay_raster(table.cpu(), atlas, PANEL)
    with pytest.raises(ValueError, match="^atlas:"):
        overlay_cuda.overlay_raster(table, atlas[:, :, :3], PANEL)
