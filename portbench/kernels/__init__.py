"""Operation and byte counts of the program's kernel families, one file
each, found by name (manifest.kernel): `mlp_update`, K4 and K6 of
csrc/mlp_update.cu on either set of passes."""
