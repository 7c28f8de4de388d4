from .synthetic import (SyntheticLM, SyntheticImages, SyntheticSeq2Seq,
                        make_batch_iterator)
from .loader import ShardedLoader
