"""scene_load_s: host clock around load_scene, upload included (layer: scene
load; moves setup_s)."""


def read(run):
    return run["scene_load_s"]
