from tracy_tpu_torch.accel.tables import BVHTables, build_tables

__all__ = ["BVHTables", "build_tables"]
