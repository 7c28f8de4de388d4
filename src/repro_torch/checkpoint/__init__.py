from .checkpoint import (save_checkpoint, load_checkpoint, latest_checkpoint,
                         serialize_state, deserialize_state)
from .convert import from_numpy_tree, to_numpy_tree
