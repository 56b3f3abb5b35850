# the JAX package's `make_key`/`fold_key` (jax.random keys) are
# `make_generator`/`fold_seed` here (torch.Generator seeds)
from .seeding import seed_all, make_generator, fold_seed

__all__ = ["seed_all", "make_generator", "fold_seed"]
