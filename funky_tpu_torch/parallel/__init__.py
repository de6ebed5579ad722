"""Row-sharded multi-device frame (port of funky_tpu/parallel/)."""

from .mesh import ROWS_AXIS, make_mesh  # noqa: F401
from .sharded_frame import sharded_gltf_frame  # noqa: F401
