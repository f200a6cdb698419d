"""Configuration for the JPEG engine.

Replaces the reference's positional-argument + compile-time-constant configuration
(`src/headers/jpg_encode.h:85`, constants at `jpg_encode.h:13-15`; see SURVEY.md §5
"Config / flag system") with an explicit immutable dataclass.
"""

from __future__ import annotations

import dataclasses
import enum


class Subsampling(enum.Enum):
    """Chroma subsampling mode (reference constants at jpg_encode.h:13-15).

    The reference only implements 4:4:4 (its 4:2:2/4:2:0 are "not ready yet" stubs,
    src/downsample.c:24-32); all three are first-class here.
    """

    YUV444 = "444"
    YUV422 = "422"
    YUV420 = "420"
    YUV411 = "411"  # luma (4, 1): 4x horizontal chroma decimation (DV/NTSC)
    YUV440 = "440"  # luma (1, 2): 2x vertical chroma decimation

    @property
    def h_factor(self) -> int:
        if self in (Subsampling.YUV444, Subsampling.YUV440):
            return 1
        return 4 if self is Subsampling.YUV411 else 2

    @property
    def v_factor(self) -> int:
        return 2 if self in (Subsampling.YUV420, Subsampling.YUV440) else 1

    @property
    def mcu_width(self) -> int:
        return 8 * self.h_factor

    @property
    def mcu_height(self) -> int:
        return 8 * self.v_factor

    @property
    def blocks_per_mcu(self) -> int:
        # h*v luma blocks + 1 Cb + 1 Cr
        return self.h_factor * self.v_factor + 2


def _as_subsampling(value) -> Subsampling:
    if isinstance(value, Subsampling):
        return value
    return Subsampling(str(value).replace(":", ""))


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """All knobs of the encoder.

    quality: IJG quality 1..100 (reference contract: 1-99, jpg_encode.h:85).
    subsampling: 4:4:4 / 4:2:2 / 4:2:0 / 4:1:1 / 4:4:0.
    restart_interval: MCUs between RSTn markers; 0 disables. Restart intervals are
        the spec-native parallel seam for both the DC-DPCM chain and entropy
        decode (SURVEY.md §5 "Long-context / sequence parallelism").
    optimize_tables: derive per-image optimal Huffman tables (the Annex K.2
        algorithm the reference attempts but hangs in, src/huffman.c:76-180)
        instead of the Annex K.3 typical tables.
    """

    quality: int = 75
    subsampling: Subsampling = Subsampling.YUV420
    restart_interval: int = 0
    optimize_tables: bool = False

    def __post_init__(self):
        object.__setattr__(self, "subsampling", _as_subsampling(self.subsampling))
        if not 1 <= int(self.quality) <= 100:
            raise ValueError(f"quality must be in [1, 100], got {self.quality}")
        if self.restart_interval < 0 or self.restart_interval > 65535:
            raise ValueError("restart_interval must be in [0, 65535]")
