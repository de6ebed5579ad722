from .camera import CameraController, Keys, update_camera  # noqa: F401
