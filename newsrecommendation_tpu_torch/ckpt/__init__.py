from newsrecommendation_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    snapshot_state,
)
