"""No glTF at all: the program renders build_device_scene(None), the
ground plane alone."""


def build():
    return None
