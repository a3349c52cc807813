"""Domain decomposition over processes (``torch.distributed``):
:mod:`.multihost` (process group, collectives, halo messages) and
:mod:`.decomposition` (meshes, tiles, the decomposed steppers)."""
