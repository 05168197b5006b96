from newsrecommendation_tpu_torch.utils.device import (  # noqa: F401
    resolve_device,
    to_device,
)
