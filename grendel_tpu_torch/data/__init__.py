from .readers import (  # noqa: F401
    CameraInfo,
    PointCloud,
    SceneInfo,
    nerfpp_norm,
    read_blender_scene,
    read_city_scene,
    read_colmap_scene,
)
from .scene import Scene, SceneDataset  # noqa: F401
