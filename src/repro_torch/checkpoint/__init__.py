from .convert import from_numpy_tree, to_numpy_tree
