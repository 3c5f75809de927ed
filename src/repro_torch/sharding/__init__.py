from .rules import (NamedSharding, P, axis_names, axis_sizes, cache_spec,
                    constrain, dp_axes, param_sharding_tree, param_spec,
                    placements, tp_axis, tree_paths)

__all__ = ["NamedSharding", "P", "axis_names", "axis_sizes", "cache_spec",
           "constrain", "dp_axes", "param_sharding_tree", "param_spec",
           "placements", "tp_axis", "tree_paths"]
