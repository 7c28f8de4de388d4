"""Model zoo: unified causal LM (dense/MoE/hybrid/xLSTM/VLM) + enc-dec."""
from . import (attention, causal_lm, encdec, layers, moe, opgraph_models,
               ssm, xlstm)
