from .gltf import GltfScene, GltfMesh, GltfMaterial, GltfTexture  # noqa: F401
from .primitives import cube_geometry, ground_plane_geometry  # noqa: F401
from .scene import DeviceScene, build_device_scene  # noqa: F401
