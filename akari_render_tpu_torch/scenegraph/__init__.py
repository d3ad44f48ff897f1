from .model import SceneGraph, load_scene_json  # noqa: F401
