from .mesh import (Mesh, RowShard, make_mesh, normalise_weight,
                   pad_to_multiple, resolve_mesh, shard_problem_arrays,
                   shard_rows, whole_signal_arrays)

__all__ = ["Mesh", "RowShard", "make_mesh", "normalise_weight",
           "pad_to_multiple", "resolve_mesh", "shard_problem_arrays",
           "shard_rows", "whole_signal_arrays"]
