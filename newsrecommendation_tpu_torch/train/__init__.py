from newsrecommendation_tpu_torch.train.loop import fit  # noqa: F401
from newsrecommendation_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
    trainable_mask,
)
from newsrecommendation_tpu_torch.train.step import (  # noqa: F401
    make_multi_step,
    make_train_step,
    weighted_accuracy,
    with_device_gather,
)
