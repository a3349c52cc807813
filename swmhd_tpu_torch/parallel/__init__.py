"""Domain decomposition over processes (``torch.distributed``):
:mod:`.multihost` (process group, collectives, halo messages) and
:mod:`.decomposition` (meshes, tiles, the decomposed steppers)."""

from .decomposition import DomainDecomposition, make_mesh
from .multihost import initialize, process_local_slab

__all__ = ["DomainDecomposition", "make_mesh", "initialize",
           "process_local_slab"]
