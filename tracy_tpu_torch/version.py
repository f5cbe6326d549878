__version__ = "0.1.0"  # tracy_tpu's version, which the port tracks
