"""checkpoint and frame I/O of the PyTorch port (mirrors pdb_sph_tpu/io)."""
