from hippomm_tpu_torch.train.contrastive import (  # noqa: F401
    contrastive_loss,
    init_train_state,
    make_train_step,
)
