"""Hand-written Hopper kernels for the wire codec (``topk_compress``), their
plain PyTorch versions (``ref``) and the dispatch policy (``ops``)."""
