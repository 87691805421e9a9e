"""Training substrate: optimizer, data pipeline, fault-tolerant trainer."""
from .data import DataConfig, PackedStream, PrefetchLoader
from .optim import (OptimizerConfig, adamw_init, adamw_update, compress_grads,
                    cosine_schedule, decompress_grads, error_feedback_init,
                    global_norm)
from .trainer import StragglerWatchdog, Trainer, TrainerConfig, TrainProgram

__all__ = ["DataConfig", "PackedStream", "PrefetchLoader", "OptimizerConfig",
           "adamw_init", "adamw_update", "compress_grads", "cosine_schedule",
           "decompress_grads", "error_feedback_init", "global_norm",
           "StragglerWatchdog", "Trainer", "TrainerConfig", "TrainProgram"]
