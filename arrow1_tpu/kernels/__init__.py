"""Device kernels in plain JAX, left to XLA.

- hashtable.py: bucketed hash-table build/probe for the raw-key join.
- radix.py: minimal-width key packing for the engine's variadic sorts.
- blockscan.py: two-level prefix scans.

Every module here is plain `jax.numpy`/`lax`. A hand-written kernel
(Pallas or CUDA) earns a place only by beating XLA's plain version end
to end on the card at benchmark shapes (ROADMAP, Design aim).
"""
