"""Wire formats of the port (partial copies of gnark_icicle_tpu/io/)."""
