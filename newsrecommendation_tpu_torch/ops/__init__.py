from newsrecommendation_tpu_torch.ops.attention import (  # noqa: F401
    attention_pooling,
    init_attention_pooling,
    init_multi_head_self_attention,
    masked_exp_normalize,
    mhsa_dropout_pool,
)
from newsrecommendation_tpu_torch.ops.common import dropout, linear  # noqa: F401
