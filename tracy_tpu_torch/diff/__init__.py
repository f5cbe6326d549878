from tracy_tpu_torch.diff.gradients import (
    GeometryDiffIntersector,
    TrainableParams,
    apply_params,
    extract_params,
    make_train_step,
    make_training_intersector,
    params_from_jax,
    render_loss,
)

__all__ = [
    "GeometryDiffIntersector",
    "TrainableParams",
    "apply_params",
    "extract_params",
    "make_train_step",
    "make_training_intersector",
    "params_from_jax",
    "render_loss",
]
