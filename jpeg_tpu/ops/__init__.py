"""Device-side (JAX/XLA) ops of the JPEG engine."""

from jpeg_tpu.ops import color, dct, dpcm, quant, subsample, tile, zigzag  # noqa: F401
