"""Block geometry of the hand-written CUDA window kernels.

The CUDA counterpart of `pdb_sph_tpu.geometry.KernelGeometry`. Every pair
kernel (`csrc/pair_items.cuh`) splits each own-chunk's candidates into
segments of at most `seg` candidates and runs one work item per (chunk,
segment) on a persistent grid of four-warp blocks, the candidates
streaming through a ring of `STAGES` shared-memory stages of `STAGE_LEN`
rows. In the FP32 kernels (`csrc/pbf_window.cu`) each lane holds
`own / 32` own rows and the four warps share each stage's candidates; in
the tensor-core kernels (`csrc/pbf_tc.cu`) the warps split the own rows
into m16 tiles, `TC_COL_GROUPS` of them splitting each stage's candidates
instead, and the forms with an rd2 mma convert each stage into fragment
planes. Nothing of the TPU geometry's lane-alignment machinery (shifted
copies, 128-lane segments, DMA ring depth, grid batching) has a
counterpart here: the windows are exact element ranges.

The geometry is data, threaded through the config like every other
constant. `geometry_from_env()` is `SimConfig.geom`'s default factory, as in
the JAX package: it reads `PBF_OWN` and the tensor-core switches
`PBF_MXU_SUM`, `PBF_MXU_RD2` and `PBF_MXU_PROJ` when a config is built
without an explicit `geom`, and only then.
"""

from __future__ import annotations

import dataclasses
import os

# own-chunk sizes the kernels are instantiated for (csrc/*.cu)
OWNS = (32, 64, 128, 256)
# the kernels use dynamic shared memory without raising the 48 KiB default
# opt-in limit
_MAX_SMEM_BYTES = 48 * 1024
# every pair kernel's block: WARPS warps share each ring stage of STAGE_LEN
# candidates, STAGES stages in flight, which one more warp stages (kWarps,
# kStageLen and kStages in csrc/pair_items.cuh); a full and an empty
# mbarrier per stage head the shared memory (kBarBytes)
WARPS = 4
STAGES = 3
STAGE_LEN = 256
_BAR_BYTES = 2 * STAGES * 8
# the tensor-core kernels' warps that split each stage's candidates
# (kColGroups in csrc/pbf_tc.cu); the others split the own rows
TC_COL_GROUPS = 1
# bytes of a stage converted into the tensor-core fragment planes
# (kRd2PlaneBytes, kProjPlaneBytes in csrc/pbf_tc.cu): four rd2 word planes
# of STAGE_LEN + 8 words and |c|^2; delta-p adds lambda and six bf16 planes
# of STAGE_LEN / 2 + 4 words
_RD2_PLANE_BYTES = 4 * (4 * (STAGE_LEN + 8) + STAGE_LEN)
_PROJ_PLANE_BYTES = _RD2_PLANE_BYTES + 4 * (STAGE_LEN + 6 * (STAGE_LEN // 2
                                                             + 4))


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """Launch geometry of the density and project kernels.

    `mxu_sum`, `mxu_rd2` and `mxu_proj` keep the JAX names (the `PBF_MXU_*`
    variables are named after them) and select the tensor-core forms of the
    passes, `csrc/pbf_tc.cu`: row sums as a matrix-vector product
    (`mxu_sum`, both passes), rd2 as |p_i|^2 - 2 p_i.p_j + |p_j|^2 with a
    bf16 hi/lo split dot (`mxu_rd2`, density), and the project pass's rd2
    and delta-p contraction on the tensor cores (`mxu_proj`)."""

    own: int = 64  # own-chunk rows (FP32 kernels: own / 32 per lane)
    # the pair kernels' candidates per work item (the segment length S),
    # chosen by the sweep of benchmarks_torch/kernel_ab.py (PERF.md, PR 4)
    seg: int = 512
    mxu_sum: bool = False
    mxu_rd2: bool = False
    mxu_proj: bool = False

    @property
    def tc_col_groups(self) -> int:
        """Warps of a tensor-core block that split each stage's candidates:
        TC_COL_GROUPS, or more where the own rows are too few for one m16
        tile a warp (`col_groups` in csrc/pbf_tc.cu)."""
        return max(TC_COL_GROUPS, 64 // self.own)

    @property
    def tc_m_tiles(self) -> int:
        """m16 tiles of own rows that each warp of a tensor-core block
        carries."""
        return self.own * self.tc_col_groups // (16 * WARPS)

    @property
    def cull_groups(self) -> int:
        """Groups of own rows that the FP32 kernels cull each staged tile
        against (`kCull` in csrc/pbf_window.cu): two halves of the chunk
        where a lane holds two rows or more, else the whole chunk."""
        return 2 if self.own >= 64 else 1

    @property
    def smem_bytes(self) -> int:
        """Shared memory per block of the FP32 kernels. Dynamic: the ring of
        STAGES stages of float4 candidates and a float4 partial per own row
        and warp, after the stages' barriers (`smem_bytes` in
        csrc/pair_items.cuh). Static (`CullShared` in csrc/pbf_window.cu):
        the rows' keys and ranks, the partial boxes, each warp's survivor
        lists (a float4 per candidate of its share of a stage and cull
        group) and the warps' survivor counts, with up to 16 bytes of
        alignment."""
        g = self.cull_groups
        ranked = self.own if g > 1 else 4
        static = (8 * ranked + 4 * 6 * (WARPS + self.own // 32)
                  + 16 * g * STAGE_LEN + 4 * WARPS + 16)
        return (_BAR_BYTES + 16 * (STAGES * STAGE_LEN + WARPS * self.own)
                + static)

    @property
    def tc_smem_bytes(self) -> int:
        """The largest dynamic shared memory of a tensor-core kernel,
        project_tc_kernel<kProjMma>'s: the ring, a float4 partial per own
        row and column group, and two stages converted into fragment
        planes."""
        return (_BAR_BYTES
                + 16 * (STAGES * STAGE_LEN + self.tc_col_groups * self.own)
                + 2 * _PROJ_PLANE_BYTES)

    def validate(self) -> None:
        if self.own not in OWNS:
            raise ValueError(f"own ({self.own}) must be one of 32, 64, 128, "
                             "256 (whole warps, one thread per own row)")
        if self.seg <= 0 or self.seg % 32 != 0:
            raise ValueError(f"seg ({self.seg}) must be a positive multiple "
                             "of 32")
        smem = max(self.smem_bytes, self.tc_smem_bytes)
        if smem > _MAX_SMEM_BYTES:
            raise ValueError(f"own ({self.own}) needs {smem} bytes of "
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
