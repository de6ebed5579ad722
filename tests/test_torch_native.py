"""The port's native asset route (funky_tpu_torch/utils/native.py): the
counterparts of tests/test_native.py's cases on the port's own bindings
and decoders, native == numpy bit for bit on the repo's 4:2:0 JPEG, and
the decoders' ladders (native first). The library is built from native/
into funky_tpu_torch/build/native/ on first use."""

import io
import pathlib

import numpy as np
import pytest

from funky_tpu.utils import native as jnative

from funky_tpu_torch.models import jpeg_io, png_io
from funky_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parent.parent
JPEG = REPO / "tests" / "assets" / "quad_tex_420p.jpg"


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    return native


def test_library_is_the_ports_own(lib):
    assert lib._SO.is_relative_to(REPO / "funky_tpu_torch" / "build")
    assert lib._SO.exists()


def test_native_decodes_roundtrip(lib, tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    p = tmp_path / "t.png"
    png_io.write_png(p, img)
    np.testing.assert_array_equal(lib.decode_png(p.read_bytes()), img)


def test_native_matches_pure_on_all_filters(lib):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(6)
    x = np.linspace(0, 255, 96)
    img = (x[None, :, None] * np.ones((64, 1, 3))
           + rng.normal(0, 6, (64, 96, 3))).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, format="PNG")
    a = lib.decode_png(buf.getvalue())
    b = png_io._decode_png_pure(buf.getvalue())
    np.testing.assert_array_equal(a, b)


def test_native_duck_texture(lib, duck_gltf_path):
    raw = (duck_gltf_path.parent / "DuckCM.png").read_bytes()
    np.testing.assert_array_equal(lib.decode_png(raw),
                                  png_io._decode_png_pure(raw))


def test_native_srgb_lut(lib):
    lut = lib.srgb_lut()
    ref = png_io.srgb_to_linear(np.arange(256, dtype=np.float32) / 255.0)
    np.testing.assert_allclose(lut, ref, atol=1e-6)


def test_decode_prefers_native_transparently(lib, tmp_path):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    p = tmp_path / "t.png"
    png_io.write_png(p, img)
    np.testing.assert_array_equal(png_io.read_png(p), img)


def test_native_jpeg_equals_numpy(lib):
    """The repo's 4:2:0 JPEG: the native decoder == the port's numpy
    decoder == the JAX package's native decoder, bit for bit."""
    data = JPEG.read_bytes()
    got = lib.decode_jpeg(data)
    assert got is not None and got.shape[-1] == 4
    np.testing.assert_array_equal(got, jpeg_io.decode_jpeg_pure(data))
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.decode_jpeg(data))


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_ladders_try_native_first(lib, monkeypatch, tmp_path, fmt):
    """decode_png and decode_jpeg ask the native library first and fall
    through to numpy when it declines (returns None)."""
    if fmt == "png":
        want = np.random.default_rng(8).integers(0, 256, (9, 11, 4),
                                                 dtype=np.uint8)
        png_io.write_png(tmp_path / "t.png", want)
        data = (tmp_path / "t.png").read_bytes()
        decode = png_io.decode_png
    else:
        data = JPEG.read_bytes()
        decode, want = jpeg_io.decode_jpeg, jpeg_io.decode_jpeg_pure(data)
    name = f"decode_{fmt}"
    real = getattr(native, name)
    calls = []
    for declines in (False, True):
        def spy(d, declines=declines):
            calls.append(declines)
            return None if declines else real(d)

        monkeypatch.setattr(native, name, spy)
        np.testing.assert_array_equal(decode(data), want)
    assert calls == [False, True]
