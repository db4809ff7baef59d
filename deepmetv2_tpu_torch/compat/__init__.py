"""Interop with the reference implementation's checkpoints."""

from deepmetv2_tpu_torch.compat.torch_import import (  # noqa: F401
    import_torch_checkpoint,
)
