"""jpeg_tpu: a JPEG encode/decode engine for accelerators, in JAX/XLA.

Built from scratch against the capability contract of the reference C project
matthewT53/JPEG-Encoder-and-Decoder (see SURVEY.md): baseline JFIF encode with
quality scaling and 4:4:4/4:2:2/4:2:0 chroma subsampling, plus the decoder the
reference never wrote — with the transform pipeline running as fused XLA
programs on the device (an NVIDIA GPU) and entropy coding restructured for
parallelism.
"""

from jpeg_tpu.config import EncodeConfig, Subsampling  # noqa: F401
from jpeg_tpu.models.decoder import (  # noqa: F401
    YCbCrPlanes, decode, decode_batched, finish_ycbcr,
)
from jpeg_tpu.models.encoder import (  # noqa: F401
    encode, encode_batched, encode_bmp_to_jpeg, encode_rgb_to_jpeg,
)
from jpeg_tpu.models.multiscan import encode_noninterleaved  # noqa: F401
from jpeg_tpu.parallel.pipeline import decode_stream, encode_stream  # noqa: F401

__version__ = "0.1.0"
