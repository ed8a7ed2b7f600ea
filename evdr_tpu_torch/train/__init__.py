from evdr_tpu_torch.train.config import TrainConfig
from evdr_tpu_torch.train.harness import (
    DatasetBundle,
    init_student,
    load_dataset_bundle,
    run_training,
    train_dataset_mf,
)
