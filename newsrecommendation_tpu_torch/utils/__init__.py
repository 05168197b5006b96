from newsrecommendation_tpu_torch.utils.device import (  # noqa: F401
    rank_device,
    resolve_device,
    to_device,
)
