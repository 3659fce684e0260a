from qavit_tpu_torch.data.augment import (AugConfig, apply_augment,
                                          augment_batch, draw_params,
                                          eval_batch)
from qavit_tpu_torch.data.datasets import STATS, Dataset, load_dataset
from qavit_tpu_torch.data.loader import BatchLoader, IndexLoader
from qavit_tpu_torch.data.pipelines import (PIPELINES, PipelineSpec,
                                            get_pipeline)

__all__ = [
    "AugConfig", "apply_augment", "augment_batch", "draw_params",
    "eval_batch",
    "STATS", "Dataset", "load_dataset",
    "BatchLoader", "IndexLoader",
    "PIPELINES", "PipelineSpec", "get_pipeline",
]
