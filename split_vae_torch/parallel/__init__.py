"""Data and tensor parallelism over processes, one a GPU (split_vae_tpu/parallel).

The JAX package also exports ``batch_sharding``, ``replicated_sharding`` and
``shard_batch``, which make and place ``jax.sharding`` objects; the port has
no such objects: each rank takes its rows of a batch (``mesh.rows``) and its
blocks of the sharded weights (``shard_state``).
"""

from split_vae_torch.parallel.mesh import create_mesh, infer_param_sharding, shard_state
