# Training substrate of the port: AdamW with f32 master weights, the
# synthetic data pipeline and the elastic utilities (copied from the
# reference), and checkpoints in the reference's on-disk layout.
from .checkpoint import (Checkpointer, latest_step, load_checkpoint,
                         save_checkpoint)
from .data import DataConfig, data_stream, synthetic_batch
from .elastic import StragglerDetector, elastic_targets, replan_after_loss
from .optimizer import (AdamWConfig, OptState, adamw_init, adamw_update,
                        cosine_lr, global_norm)

__all__ = [
    "Checkpointer", "latest_step", "load_checkpoint", "save_checkpoint",
    "DataConfig", "data_stream", "synthetic_batch",
    "StragglerDetector", "elastic_targets", "replan_after_loss",
    "AdamWConfig", "OptState", "adamw_init", "adamw_update", "cosine_lr",
    "global_norm",
]
