"""Operation and byte counts of the program's kernel families, one file
each, found by name (manifest.kernel): `mlp_update`, K4 and K6 of
csrc/mlp_update.cu on either set of passes; `logreg_update`, the
operations of K1 and K2 of csrc/local_update.cu.  A model family names
its own (`COUNTS`)."""
