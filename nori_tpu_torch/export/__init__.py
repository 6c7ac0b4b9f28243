"""Scene exporters (Blender add-on + headless core)."""

from nori_tpu_torch.export.blender import (  # noqa: F401
    CameraSpec, MeshSpec, SceneExport, write_nori_scene,
)
