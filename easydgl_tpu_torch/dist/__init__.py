"""Distributed pieces of the port (``easydgl_tpu.dist``): the collectives
with their backwards, the vocab-sharded embedding and scoring, and the
exact distributed top-k."""
