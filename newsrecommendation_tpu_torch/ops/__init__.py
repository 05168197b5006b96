from newsrecommendation_tpu_torch.ops.attention import (  # noqa: F401
    attention_pooling,
    init_attention_pooling,
    init_multi_head_self_attention,
    masked_exp_normalize,
    mhsa_dropout_pool,
)
from newsrecommendation_tpu_torch.ops.common import dropout, linear  # noqa: F401
from newsrecommendation_tpu_torch.ops.conv import (  # noqa: F401
    conv1d_same,
    init_conv1d,
)
from newsrecommendation_tpu_torch.ops.experimental_blanes import (  # noqa: F401
    exp_mhsa_qkv_blanes,
    exp_mhsa_qkv_blanes_masked,
)
from newsrecommendation_tpu_torch.ops.experimental_fused_encoder import (  # noqa: E501,F401
    exp_mhsa_pool,
    exp_mhsa_pool_masked,
)
from newsrecommendation_tpu_torch.ops.experimental_qkv2d import (  # noqa: F401
    exp_mhsa_qkv_bias_2d,
)
from newsrecommendation_tpu_torch.ops.fused_attention import (  # noqa: F401
    exp_mhsa,
    exp_mhsa_masked,
)
