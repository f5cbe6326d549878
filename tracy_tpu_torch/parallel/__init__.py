from tracy_tpu_torch.parallel.mesh import (
    make_render_mesh,
    make_sharded_render_step,
    make_sharded_train_step,
    replicate_scene,
)

__all__ = [
    "make_render_mesh",
    "make_sharded_render_step",
    "make_sharded_train_step",
    "replicate_scene",
]
