"""Core of the PyTorch port (see the package docstring).

The push-sum simulator's names are exported here, as the JAX package's
``repro.core`` exports them, on first access: importing
``repro_torch.core.topology`` stays torch-free (the launcher validates its
flags before torch is imported).
"""
_PUSHSUM = ("PushSumState", "init_pushsum_state", "pushsum_gossip_round",
            "pushsum_debias", "run_pushsum_gossip")
_TOPOLOGY = ("DirectedTopology", "directed_ring", "random_digraph",
             "is_directed", "make_topology")
__all__ = list(_PUSHSUM + _TOPOLOGY)


def __getattr__(name):
    if name in _PUSHSUM:
        from . import choco_gossip
        return getattr(choco_gossip, name)
    if name in _TOPOLOGY:
        from . import topology
        return getattr(topology, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
