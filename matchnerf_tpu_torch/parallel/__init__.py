"""Several processes with one card each (counterpart of
matchnerf_tpu/parallel/): `distributed` brings up the process group and
gates the host's side effects, `mesh` holds the chunks, gathers and the
gradient average that the JAX package's device mesh gave it."""
