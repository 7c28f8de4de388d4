from . import overrides
