"""Block geometry of the hand-written CUDA window kernels.

The CUDA counterpart of `pdb_sph_tpu.geometry.KernelGeometry`. The FP32
kernels in `csrc/pbf_window.cu` launch one thread block per own-chunk of
`own` consecutive cell-sorted particles, one thread per own particle; the
tensor-core kernels in `csrc/pbf_tc.cu` launch one block per own-chunk with
one warp per 16 own rows. Both stream the chunk's candidate windows through
shared memory `tile` particles at a time. Nothing of the TPU geometry's
lane-alignment machinery (shifted copies, 128-lane segments, DMA ring depth,
grid batching) has a counterpart here: the windows are exact element ranges
and the loads are plain coalesced 16-byte reads.

The geometry is data, threaded through the config like every other
constant. `geometry_from_env()` is `SimConfig.geom`'s default factory, as in
the JAX package: it reads `PBF_OWN` and the tensor-core switches
`PBF_MXU_SUM`, `PBF_MXU_RD2` and `PBF_MXU_PROJ` when a config is built
without an explicit `geom`, and only then.
"""

from __future__ import annotations

import dataclasses
import os

# candidates staged per tile; the kernels use dynamic shared memory without
# raising the 48 KiB default opt-in limit
_MAX_SMEM_BYTES = 48 * 1024


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """Launch geometry of the density and project kernels.

    `mxu_sum`, `mxu_rd2` and `mxu_proj` keep the JAX names (the `PBF_MXU_*`
    variables are named after them) and select the tensor-core forms of the
    passes, `csrc/pbf_tc.cu`: row sums as a matrix-vector product
    (`mxu_sum`, both passes), rd2 as |p_i|^2 - 2 p_i.p_j + |p_j|^2 with a
    bf16 hi/lo split dot (`mxu_rd2`, density), and the project pass's rd2
    and delta-p contraction on the tensor cores (`mxu_proj`)."""

    own: int = 64    # own-chunk rows = threads per block (FP32 kernels)
    tile: int = 128  # candidates staged in shared memory per round
    mxu_sum: bool = False
    mxu_rd2: bool = False
    mxu_proj: bool = False

    @property
    def threads(self) -> int:
        """Threads per block of the FP32 kernels: one per own row."""
        return self.own

    @property
    def tc_threads(self) -> int:
        """Threads per block of the tensor-core kernels: one warp per 16
        own rows."""
        return self.own // 16 * 32

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory per block of the FP32 kernels: `tile`
        float4 candidates."""
        return self.tile * 16

    @property
    def tc_smem_bytes(self) -> int:
        """The largest dynamic shared memory of a tensor-core kernel:
        project_tc_kernel<kProjMma>'s five rd2 word planes, |c|^2, lambda
        and six bf16 delta-p planes (`project_tc_smem` in csrc/pbf_tc.cu)."""
        return 4 * (5 * (self.tile + 8) + 2 * self.tile
                    + 6 * (self.tile // 2 + 4))

    def validate(self) -> None:
        if self.own not in (32, 64, 128, 256):
            raise ValueError(f"own ({self.own}) must be one of 32, 64, 128, "
                             "256 (whole warps, one thread per own row)")
        if self.own % 16:
            raise ValueError(f"own ({self.own}) must be a multiple of 16 "
                             "(one tensor-core warp per 16 own rows)")
        if self.tile <= 0 or self.tile % 32 != 0:
            raise ValueError(f"tile ({self.tile}) must be a positive "
                             "multiple of 32")
        smem = max(self.smem_bytes, self.tc_smem_bytes)
        if smem > _MAX_SMEM_BYTES:
            raise ValueError(f"tile ({self.tile}) needs {smem} bytes of "
                             f"shared memory (> {_MAX_SMEM_BYTES})")


def geometry_from_env(env=None) -> KernelGeometry:
    """The default KernelGeometry, with PBF_* environment overrides.

    Reads the knobs that have a counterpart here, as
    `pdb_sph_tpu.geometry.geometry_from_env` does: `PBF_OWN`, and
    `PBF_MXU_SUM`, `PBF_MXU_RD2`, `PBF_MXU_PROJ`, each on when it equals
    "1". The Mosaic knobs `PBF_CC`, `PBF_CC_D`, `PBF_CC_P`, `PBF_NBUF`,
    `PBF_GB`, `PBF_SEG`, `PBF_MAXLANES`, `PBF_CHAINS`, `PBF_CHAINS_D`,
    `PBF_CHAINS_P` and `PBF_NCOPIES` have no counterpart and are not read.
    """
    env = os.environ if env is None else env
    g = KernelGeometry(
        own=int(env.get("PBF_OWN", 64)),
        mxu_sum=env.get("PBF_MXU_SUM", "0") == "1",
        mxu_rd2=env.get("PBF_MXU_RD2", "0") == "1",
        mxu_proj=env.get("PBF_MXU_PROJ", "0") == "1",
    )
    g.validate()
    return g
