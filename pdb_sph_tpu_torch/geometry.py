"""Block geometry of the hand-written CUDA window kernels.

The CUDA counterpart of `pdb_sph_tpu.geometry.KernelGeometry`. The kernels in
`csrc/pbf_window.cu` launch one thread block per own-chunk of `own`
consecutive cell-sorted particles, one thread per own particle, and stream
the chunk's candidate windows through shared memory `tile` particles at a
time. Nothing of the TPU geometry's lane-alignment machinery (shifted copies,
128-lane segments, DMA ring depth, grid batching, MXU switches) has a
counterpart here: the windows are exact element ranges and the loads are
plain coalesced 16-byte reads. The geometry is data, threaded through the
config like every other constant; no environment variable overrides it.
"""

from __future__ import annotations

import dataclasses

# float4 candidates staged per tile; the kernels use dynamic shared memory
# without raising the 48 KiB default opt-in limit
_MAX_SMEM_BYTES = 48 * 1024


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """Launch geometry of the density and project kernels."""

    own: int = 64    # own-chunk rows = threads per block
    tile: int = 128  # candidates staged in shared memory per round

    @property
    def threads(self) -> int:
        """Threads per block: one per own row."""
        return self.own

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory per block: `tile` float4 candidates."""
        return self.tile * 16

    def validate(self) -> None:
        if self.own not in (32, 64, 128, 256):
            raise ValueError(f"own ({self.own}) must be one of 32, 64, 128, "
                             "256 (whole warps, one thread per own row)")
        if self.tile <= 0 or self.tile % 32 != 0:
            raise ValueError(f"tile ({self.tile}) must be a positive "
                             "multiple of 32")
        if self.smem_bytes > _MAX_SMEM_BYTES:
            raise ValueError(f"tile ({self.tile}) needs {self.smem_bytes} "
                             f"bytes of shared memory (> {_MAX_SMEM_BYTES})")
