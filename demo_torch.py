#!/usr/bin/env python3
"""Render every demo scene of the PyTorch/CUDA port to out/*.png.

    python demo_torch.py                       # on the card
    python demo_torch.py --cpu --scale 0.25    # on the CPU, small

The counterpart of demo.py over funky_tpu_torch, with the same five
outputs:
1. cube.png: the rotating cube, 512x512 (compiled_cube_frame);
2. duck_shadows_ui.png and duck_shadows.png: the glTF scene through the
   FrameDriver with the full shadow stack, with and without the debug
   panel. The multimesh GLB (models/sample_scenes.build_multimesh_glb)
   stands in for the Duck, which is not in the repository;
3. multimesh_pbr.png: the multimesh PBR scene through compiled_gltf_frame;
4. sdf.png: the raymarched SDF scene.
`--interactive` runs the terminal viewer over the driver instead.
"""

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


def multimesh_glb(td: str) -> pathlib.Path:
    from funky_tpu_torch.models.sample_scenes import build_multimesh_glb

    return build_multimesh_glb(pathlib.Path(td) / "multi.glb",
                               two_textures=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="out")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="resolution scale (1.0 = full)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU instead of the card")
    ap.add_argument("--interactive", action="store_true",
                    help="interactive terminal viewer (WASD/arrows camera,"
                         " ESC exit, 3=UI, f=fullscreen, n=minimize,"
                         " TAB=panel focus)")
    args = ap.parse_args()

    import torch

    from funky_tpu_torch.app.driver import FrameDriver
    from funky_tpu_torch.frame import GltfConfig
    from funky_tpu_torch.ops.raster import RasterConfig

    dev = "cpu" if args.cpu else "cuda"
    if dev == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --cpu to render on the CPU")
    s = args.scale

    if args.interactive:
        from funky_tpu_torch.app.viewer import TerminalViewer

        s = s if s != 1.0 else 0.25
        w = int(1920 * s) // 128 * 128 or 256
        h = int(1088 * s) // 64 * 64 or 128
        tile = RasterConfig(tile_h=16, tile_w=128, capacity=4480)
        cfg = GltfConfig(width=w, height=h, shadow_map_size=512,
                         raster=tile, shadow_raster=tile)
        with tempfile.TemporaryDirectory() as td:
            drv = FrameDriver(cfg, scene_path=multimesh_glb(td),
                              autotune=True, device=dev, gltf_scale=1.0)
        print("\x1b[2J", end="")
        TerminalViewer(drv, cols=100).run()
        return

    from funky_tpu_torch.frame import (FrameConfig, compiled_cube_frame,
                                       compiled_gltf_frame,
                                       default_cube_params,
                                       default_gltf_params, init_frame_state)
    from funky_tpu_torch.models.gltf import GltfScene
    from funky_tpu_torch.models.png_io import linear_to_srgb, write_png
    from funky_tpu_torch.models.scene import (build_cube_scene,
                                              build_device_scene)
    from funky_tpu_torch.models.sdf import (SdfConfig, compiled_sdf_frame,
                                            default_sdf_camera)

    out = pathlib.Path(args.out)
    out.mkdir(exist_ok=True)

    def save(name, img):
        write_png(out / name, linear_to_srgb(img[..., :3].cpu().numpy()))
        print("wrote", out / name)

    # 1. rotating cube
    cfg = FrameConfig(width=512, height=512)
    img = compiled_cube_frame(cfg)(build_cube_scene(device=dev),
                                   default_cube_params(0.6, device=dev))
    save("cube.png", img)

    # 2. the glTF scene with the full shadow stack, with the debug panel
    # and without (the multimesh scene in place of the absent Duck)
    w, h = int(1920 * s) // 128 * 128 or 256, int(1088 * s) // 64 * 64 or 128
    tile = RasterConfig(tile_h=16, tile_w=128, capacity=4480)
    gcfg = GltfConfig(width=w, height=h, shadow_map_size=2048 if s >= 1
                      else 512, raster=tile, shadow_raster=tile)
    with tempfile.TemporaryDirectory() as td:
        drv = FrameDriver(gcfg, scene_path=multimesh_glb(td), autotune=True,
                          device=dev, gltf_scale=1.0)
    for _ in range(3):
        drv.step()
    write_png(out / "duck_shadows_ui.png", drv.readback())
    print("wrote", out / "duck_shadows_ui.png")
    drv.toggle_ui()
    write_png(out / "duck_shadows.png", drv.readback())
    print("wrote", out / "duck_shadows.png")

    # 3. multi-mesh PBR scene (two PBR cubes + textured ground quad)
    with tempfile.TemporaryDirectory() as td:
        mscene = GltfScene.load(multimesh_glb(td))
    ds = build_device_scene(mscene, device=dev)
    mw = int(1280 * s) // 128 * 128 or 256
    mh = int(768 * s) // 64 * 64 or 128
    mcfg = GltfConfig(width=mw, height=mh,
                      shadow_map_size=1024 if s >= 1 else 256,
                      raster=RasterConfig(tile_h=16, tile_w=128),
                      shadow_raster=RasterConfig(tile_h=128, tile_w=128))
    mparams = default_gltf_params(gltf_min_y=float(mscene.bounds_min[1]),
                                  gltf_scale=1.0, device=dev)
    mframe = compiled_gltf_frame(mcfg)
    mstate = init_frame_state(mcfg, dev)
    for _ in range(3):
        rgba, mstate = mframe(ds, mparams, mstate)
    save("multimesh_pbr.png", rgba)

    # 4. SDF raymarch
    scfg = SdfConfig(width=int(960 * s) or 320, height=int(540 * s) or 180)
    pos, yaw, pitch, fov = default_sdf_camera(device=dev)
    save("sdf.png", compiled_sdf_frame(scfg)(1.2, pos, yaw, pitch, fov))


if __name__ == "__main__":
    main()
