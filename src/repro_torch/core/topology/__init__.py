"""Device-resident topology (paper §4.1–§4.3), batched over problems:

  tree.py          single-sort adaptive tree build (2 full sorts total,
                   then O(N) rank-partitions per split) and the level
                   geometry pass
  connectivity.py  theta-criterion interaction lists, one batched
                   compaction sort, the leaf classification as a hook
                   (plain torch | CUDA kernel)
  rounding.py      the exactly rounded hypot / fma / sqrt the lists'
                   bit parity with the JAX reference rests on
"""
from .tree import (LeafLayout, Tree, build_tree, build_tree_lexsort,
                   layout_builds, leaf_ids, leaf_layout,
                   leaf_particle_index, leaf_particle_index_loop)
from .connectivity import (MARGIN_CLASSES, Connectivity, build_connectivity,
                           connectivity_stats, leaf_classify_reference)

__all__ = [
    "Tree", "build_tree", "build_tree_lexsort", "leaf_ids",
    "leaf_particle_index", "leaf_particle_index_loop", "LeafLayout",
    "leaf_layout", "layout_builds",
    "Connectivity", "MARGIN_CLASSES", "build_connectivity",
    "connectivity_stats", "leaf_classify_reference",
]
