from deepmetv2_tpu_torch.data.batching import (  # noqa: F401
    EventBatch,
    bucket_for,
    collate,
    to_device,
)
from deepmetv2_tpu_torch.data.loader import METDataset, fetch_dataloader  # noqa: F401
from deepmetv2_tpu_torch.data.synthetic import synthetic_events  # noqa: F401
