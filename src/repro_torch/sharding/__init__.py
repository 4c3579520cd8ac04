"""The sharding layer (the JAX package's ``sharding/``): named specs, the
rules that give each parameter, batch input and decode-state leaf its
spec on a ``("pod",) "data", "model"`` mesh, and their DTensor
placements."""
from .compat import abstract_mesh, mesh_shape  # noqa: F401
from .rules import (FALLBACKS, NamedSharding, P, batch_specs,  # noqa: F401
                    decode_state_specs, dtensor_mesh, param_specs,
                    placements, shard_tree)
