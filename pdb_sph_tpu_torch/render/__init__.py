"""host rendering of the PyTorch port (mirrors pdb_sph_tpu/render)."""
