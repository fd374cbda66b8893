"""Device-resident topology (paper §4.1–§4.3), batched over problems:

  tree.py          single-sort adaptive tree build (2 full sorts total,
                   then O(N) rank-partitions per split) and the level
                   geometry pass
  connectivity.py  theta-criterion interaction lists, each level
                   classified and compacted in one call, no sort:
                   through the backend's per-level hook (on the card,
                   one CUDA kernel launch a level) or its plain torch
                   contract, ``classify_level_reference``
  rounding.py      the exactly rounded hypot / fma / sqrt the lists'
                   bit parity with the JAX reference rests on
"""
from .tree import (LeafLayout, Tree, build_tree, build_tree_lexsort,
                   layout_builds, leaf_ids, leaf_layout,
                   leaf_particle_index, leaf_particle_index_loop)
from .connectivity import (MARGIN_CLASSES, Connectivity, build_connectivity,
                           classify_level_reference, connectivity_stats)

__all__ = [
    "Tree", "build_tree", "build_tree_lexsort", "leaf_ids",
    "leaf_particle_index", "leaf_particle_index_loop", "LeafLayout",
    "leaf_layout", "layout_builds",
    "Connectivity", "MARGIN_CLASSES", "build_connectivity",
    "classify_level_reference", "connectivity_stats",
]
