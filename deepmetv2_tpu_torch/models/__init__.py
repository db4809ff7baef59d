from deepmetv2_tpu_torch.models.graph_met import (  # noqa: F401
    GraphMET,
    net_apply,
)
