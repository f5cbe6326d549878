from tracy_tpu_torch.scene.hostmesh import HostMesh
from tracy_tpu_torch.scene.scene import (
    SKY_MATERIAL_ID,
    SceneArrays,
    SceneBuilder,
    from_jax_arrays,
)
from tracy_tpu_torch.scene.scn_parser import default_scene, load_scene, sphere_grid

__all__ = ["HostMesh", "SceneArrays", "SceneBuilder", "SKY_MATERIAL_ID",
           "default_scene", "from_jax_arrays", "load_scene", "sphere_grid"]
